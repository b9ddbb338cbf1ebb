"""Grid interpolation (bilinear / bicubic Catmull-Rom) as vectorised gathers.

Capability parity with pyRMT/interpolators.py:4-154, including the two
robustness contracts pinned by the reference tests
(tests/test_interp_extrap_energy.py:67-81):

  * non-finite query coordinates yield NaN (never a crash), and
  * huge-but-finite coordinates are clamped BEFORE the float->int conversion.

Design: one vectorised gather of the 4 (bilinear) / 16 (bicubic)
stencil corners for ALL query points at once. ``gather_bilinear_multi``
amortises a single departure-point computation over many advected fields —
something the reference cannot do (it re-runs the full backtrace per field).
"""
from __future__ import annotations

import jax.numpy as jnp


def _prepare_queries(xq, yq, dx, dy, Nx, Ny):
    x = xq / dx
    y = yq / dy
    finite = jnp.isfinite(x) & jnp.isfinite(y)
    # Clamp BEFORE the int cast: huge finite values would make the float->int
    # conversion undefined (reference guards the same way,
    # pyRMT/interpolators.py:31-42).
    x = jnp.clip(jnp.where(finite, x, 0.0), 0.0, Nx - 1.0)
    y = jnp.clip(jnp.where(finite, y, 0.0), 0.0, Ny - 1.0)
    return x, y, finite


def bilinear_interpolate(u, xq, yq, dx, dy, Nx=None, Ny=None):
    """Bilinear interpolation of ``u`` (Ny, Nx) at physical points (xq, yq).

    Parity: pyRMT/interpolators.py:4-62. Nx/Ny arguments accepted for
    signature compatibility; they are derived from ``u`` when omitted.
    """
    Ny_, Nx_ = u.shape
    out = gather_bilinear_multi(u[None], xq, yq, dx, dy)[0]
    del Nx, Ny, Nx_, Ny_
    return out


def gather_bilinear_multi(us, xq, yq, dx, dy):
    """Bilinearly interpolate a STACK of fields ``us`` (K, Ny, Nx) at the same
    query points. Indices and weights are computed once and shared.
    """
    K, Ny, Nx = us.shape
    x, y, finite = _prepare_queries(xq, yq, dx, dy, Nx, Ny)

    ix = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, Nx - 2)
    iy = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, Ny - 2)
    fx = (x - ix).astype(us.dtype)
    fy = (y - iy).astype(us.dtype)

    v00 = us[:, iy, ix]
    v10 = us[:, iy, ix + 1]
    v01 = us[:, iy + 1, ix]
    v11 = us[:, iy + 1, ix + 1]

    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = fx * (1.0 - fy)
    w01 = (1.0 - fx) * fy
    w11 = fx * fy
    out = w00 * v00 + w10 * v10 + w01 * v01 + w11 * v11
    return jnp.where(finite, out, jnp.nan)


def gather_bilinear_local(us, sx, sy):
    """Bilinear sampling of a stack ``us`` (K, Ny, Nx) at per-cell DISPLACED
    points (i + sx[j,i], j + sy[j,i]) with |sx|, |sy| < 1 — gather-free.

    Fast path for semi-Lagrangian advection: the adaptive CFL
    guarantees the RK4 backtrace never leaves the 3x3 neighbourhood
    (dt * max|u| < CFL * dx, pyRMT-parity compute_timestep), so the 4
    bilinear corners are among the 9 static shifts of the field and the
    whole interpolation becomes shifts + selects — no gather.

    Displacements are clamped into (-1, 1); queries that would leave the
    domain are clamped to the boundary exactly like the general
    (gather-based) path. Semantics at interior points match
    ``gather_bilinear_multi`` bit-for-bit in exact arithmetic.
    """
    K, Ny, Nx = us.shape
    jj = jnp.arange(Ny, dtype=sx.dtype)[:, None]
    ii = jnp.arange(Nx, dtype=sx.dtype)[None, :]

    finite = jnp.isfinite(sx) & jnp.isfinite(sy)
    sx = jnp.where(finite, sx, 0.0)
    sy = jnp.where(finite, sy, 0.0)
    # clamp the absolute query into the domain, then back to a displacement
    eps = 1e-6
    sx = jnp.clip(sx, -1.0 + eps, 1.0 - eps)
    sy = jnp.clip(sy, -1.0 + eps, 1.0 - eps)
    x = jnp.clip(ii + sx, 0.0, Nx - 1.0)
    y = jnp.clip(jj + sy, 0.0, Ny - 1.0)
    sx = x - ii
    sy = y - jj

    # corner offset selector: left neighbour is i-1 when s < 0, else i
    neg_x = sx < 0.0
    neg_y = sy < 0.0
    fx = (jnp.where(neg_x, sx + 1.0, sx)).astype(us.dtype)
    fy = (jnp.where(neg_y, sy + 1.0, sy)).astype(us.dtype)
    # guard the i = Nx-1, s = 0 case (ix must be <= Nx-2): treat as ix = i-1,
    # fx = 1 which reproduces the clamped-gather result exactly
    at_right = (ii >= Nx - 1.0) & ~neg_x
    neg_x = neg_x | at_right
    fx = jnp.where(at_right, 1.0, fx)
    at_top = (jj >= Ny - 1.0) & ~neg_y
    neg_y = neg_y | at_top
    fy = jnp.where(at_top, 1.0, fy)

    def shx(f, k):
        return _shift_x_pad(f, k)

    def shy(f, k):
        return _shift_y_pad(f, k)

    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = fx * (1.0 - fy)
    w01 = (1.0 - fx) * fy
    w11 = fx * fy

    # 9 static shifts per field; per-cell select of the 4 active corners
    vals = []
    for k in range(K):
        f = us[k]
        f_xm1 = shx(f, -1)
        f_xp1 = shx(f, 1)
        f_ym1 = shy(f, -1)
        f_yp1 = shy(f, 1)
        f_xm1_ym1 = shy(f_xm1, -1)
        f_xp1_ym1 = shy(f_xp1, -1)
        f_xm1_yp1 = shy(f_xm1, 1)
        f_xp1_yp1 = shy(f_xp1, 1)

        v00 = jnp.where(
            neg_x, jnp.where(neg_y, f_xm1_ym1, f_xm1),
            jnp.where(neg_y, f_ym1, f),
        )
        v10 = jnp.where(
            neg_x, jnp.where(neg_y, f_ym1, f),
            jnp.where(neg_y, f_xp1_ym1, f_xp1),
        )
        v01 = jnp.where(
            neg_x, jnp.where(neg_y, f_xm1, f_xm1_yp1),
            jnp.where(neg_y, f, f_yp1),
        )
        v11 = jnp.where(
            neg_x, jnp.where(neg_y, f, f_yp1),
            jnp.where(neg_y, f_xp1, f_xp1_yp1),
        )
        vals.append(w00 * v00 + w10 * v10 + w01 * v01 + w11 * v11)

    out = jnp.stack(vals)
    return jnp.where(finite[None], out, jnp.nan)


def gather_bicubic_local(us, sx, sy, cubic_mask=None):
    """Bicubic (Catmull-Rom) sampling of a stack ``us`` (K, Ny, Nx) at
    per-cell DISPLACED points (i + sx, j + sy), |sx|, |sy| < 1 — gather-free.

    Fast path: under the CFL < 1 backtrace bound the 4x4 stencil
    around the departure point lies within static ±2 shifts of the field, so
    the interpolation becomes shifts + selects + cubic arithmetic.
    Semantics (index clamping at edges, overshoot clamp to the stencil
    min/max, NaN on non-finite displacements) match ``gather_bicubic_multi``
    exactly: the edge-replicating pads of ``_shift_{x,y}_pad`` reproduce the
    gather path's per-index clipping for any overflow ≤ 2.

    ``cubic_mask`` (optional bool, broadcastable to (K, Ny, Nx)): cells where
    it is False take the BILINEAR sample instead — the band guard for
    reference-map advection, where bicubic's wide stencil must not read
    extrapolated data (see sim.RMTConfig.sl_band_guard).
    """
    K, Ny, Nx = us.shape
    jj = jnp.arange(Ny, dtype=sx.dtype)[:, None]
    ii = jnp.arange(Nx, dtype=sx.dtype)[None, :]

    finite = jnp.isfinite(sx) & jnp.isfinite(sy)
    sx = jnp.where(finite, sx, 0.0)
    sy = jnp.where(finite, sy, 0.0)
    eps = 1e-6
    sx = jnp.clip(sx, -1.0 + eps, 1.0 - eps)
    sy = jnp.clip(sy, -1.0 + eps, 1.0 - eps)
    x = jnp.clip(ii + sx, 0.0, Nx - 1.0)
    y = jnp.clip(jj + sy, 0.0, Ny - 1.0)
    sx = x - ii
    sy = y - jj

    # floor(i + s): the stencil base is i-1 for s < 0, else i
    neg_x = sx < 0.0
    neg_y = sy < 0.0
    fx = (jnp.where(neg_x, sx + 1.0, sx)).astype(us.dtype)
    fy = (jnp.where(neg_y, sy + 1.0, sy)).astype(us.dtype)

    vals = []
    for k in range(K):
        f = us[k]
        # All 25 static (ky, kx) shifts first, per-cell 4-way select LAST:
        # shifting an already-selected array would drag the NEIGHBOUR's
        # neg_x/neg_y choice into this cell (the masks are per target cell).
        sh = {}

        def shifted(ky, kx):
            if (ky, kx) not in sh:
                sh[(ky, kx)] = _shift_x_pad(_shift_y_pad(f, ky), kx)
            return sh[(ky, kx)]

        local_min = None
        local_max = None
        rows = []
        for m in range(4):
            cols = []
            for n in range(4):
                v = jnp.where(
                    neg_y,
                    jnp.where(neg_x, shifted(m - 2, n - 2),
                              shifted(m - 2, n - 1)),
                    jnp.where(neg_x, shifted(m - 1, n - 2),
                              shifted(m - 1, n - 1)),
                )
                cols.append(v)
                local_min = v if local_min is None else jnp.minimum(local_min, v)
                local_max = v if local_max is None else jnp.maximum(local_max, v)
            rows.append(cubic_convolution(cols[0], cols[1], cols[2], cols[3], fx))
        out = cubic_convolution(rows[0], rows[1], rows[2], rows[3], fy)
        vals.append(jnp.clip(out, local_min, local_max))

    out = jnp.stack(vals)
    if cubic_mask is not None:
        out = jnp.where(cubic_mask, out, gather_bilinear_local(us, sx, sy))
    return jnp.where(finite[None], out, jnp.nan)


def _shift_x_pad(f, k):
    if k > 0:
        return jnp.concatenate([f[:, k:], jnp.repeat(f[:, -1:], k, axis=1)], axis=1)
    if k < 0:
        return jnp.concatenate([jnp.repeat(f[:, 0:1], -k, axis=1), f[:, :k]], axis=1)
    return f


def _shift_y_pad(f, k):
    if k > 0:
        return jnp.concatenate([f[k:, :], jnp.repeat(f[-1:, :], k, axis=0)], axis=0)
    if k < 0:
        return jnp.concatenate([jnp.repeat(f[0:1, :], -k, axis=0), f[:k, :]], axis=0)
    return f


def cubic_convolution(v0, v1, v2, v3, t):
    """Catmull-Rom cubic along one axis (pyRMT/interpolators.py:143-154)."""
    a0 = -0.5 * v0 + 1.5 * v1 - 1.5 * v2 + 0.5 * v3
    a1 = v0 - 2.5 * v1 + 2.0 * v2 - 0.5 * v3
    a2 = -0.5 * v0 + 0.5 * v2
    return ((a0 * t + a1) * t + a2) * t + v1


def gather_bicubic_multi(us, xq, yq, dx, dy, cubic_mask=None):
    """Bicubic (Catmull-Rom) interpolation of a STACK of fields ``us``
    (K, Ny, Nx) at the same query points: indices and the per-axis cubic
    weights are computed once and shared across fields, with the reference's
    per-field overshoot clamp to the 4x4 stencil min/max
    (pyRMT/interpolators.py:136-139).

    ``cubic_mask`` (optional bool, broadcastable to the output): False cells
    take the BILINEAR sample instead (band guard — see gather_bicubic_local).
    """
    K, Ny, Nx = us.shape
    x, y, finite = _prepare_queries(xq, yq, dx, dy, Nx, Ny)

    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    fx = (x - ix).astype(us.dtype)
    fy = (y - iy).astype(us.dtype)

    rows = []
    local_min = jnp.full(us.shape, jnp.inf, us.dtype)
    local_max = jnp.full(us.shape, -jnp.inf, us.dtype)
    for m in range(4):
        yg = jnp.clip(iy - 1 + m, 0, Ny - 1)
        cols = []
        for n in range(4):
            xg = jnp.clip(ix - 1 + n, 0, Nx - 1)
            v = us[:, yg, xg]
            cols.append(v)
            local_min = jnp.minimum(local_min, v)
            local_max = jnp.maximum(local_max, v)
        rows.append(cubic_convolution(cols[0], cols[1], cols[2], cols[3], fx))

    out = cubic_convolution(rows[0], rows[1], rows[2], rows[3], fy)
    out = jnp.clip(out, local_min, local_max)
    if cubic_mask is not None:
        out = jnp.where(cubic_mask, out, gather_bilinear_multi(us, xq, yq, dx, dy))
    return jnp.where(finite, out, jnp.nan)


def bicubic_interpolate(u, xq, yq, dx, dy, Nx=None, Ny=None):
    """Bicubic (Catmull-Rom) interpolation with clamped 4x4 stencil and
    overshoot suppression: the result is clamped to the stencil min/max
    exactly as the reference does (pyRMT/interpolators.py:136-139).
    """
    Ny_, Nx_ = u.shape
    del Nx, Ny
    Nx, Ny = Nx_, Ny_
    x, y, finite = _prepare_queries(xq, yq, dx, dy, Nx, Ny)

    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    fx = (x - ix).astype(u.dtype)
    fy = (y - iy).astype(u.dtype)

    # 4x4 stencil with per-point index clamping (reference clamps each global
    # index into range rather than shifting the whole stencil).
    rows = []
    local_min = jnp.full_like(fx, jnp.inf)
    local_max = jnp.full_like(fx, -jnp.inf)
    for m in range(4):
        yg = jnp.clip(iy - 1 + m, 0, Ny - 1)
        cols = []
        for n in range(4):
            xg = jnp.clip(ix - 1 + n, 0, Nx - 1)
            v = u[yg, xg]
            cols.append(v)
            local_min = jnp.minimum(local_min, v)
            local_max = jnp.maximum(local_max, v)
        rows.append(cubic_convolution(cols[0], cols[1], cols[2], cols[3], fx))

    out = cubic_convolution(rows[0], rows[1], rows[2], rows[3], fy)
    out = jnp.clip(out, local_min, local_max)
    return jnp.where(finite, out, jnp.nan)
