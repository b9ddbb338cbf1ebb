"""Narrow-band extrapolation of the reference map into the fluid.

Capability parity with ``extrapolate_reference_map``
(pyRMT/functions.py:48-163): grow (X1, X2) layer-by-layer from the solid
(phi < 0) into the fluid. Each frontier cell (an unknown interior cell with a
known 3x3 neighbour) receives a Gaussian-weighted least-squares PLANE fit
a + b x + c y over the known cells in its 9x9 window, evaluated at the cell.

Re-design — the reference kernel is a serial per-cell loop with a
scalar Cramer solve; here the whole layer update becomes dense linear algebra:

  * The Gaussian weight depends only on the OFFSET (dist^2 <= r^2 with
    r = 4*sqrt(dx^2+dy^2) admits the entire 9x9 window, so the radius test is
    vacuous and the weight kernel is a fixed 9x9 array).
  * Fitting in cell-offset coordinates (a + b*di + c*dj; the value at the
    cell centre is just ``a``) makes ALL normal-equation entries fixed-kernel
    correlations of {known, known*X1, known*X2} — i.e. fixed 2D correlations
    (separable, see below). A plane fit is affine-equivariant, so the
    offset-coordinate fit returns exactly the same plane as the reference's
    absolute-coordinate fit (and is far better conditioned in float32).
  * The per-cell 3x3 solve is a branchless vectorised Cramer solve.

Known deviation (documented in SURVEY.md section 7, hard part 1): the
reference marks cells "known" sequentially WITHIN a layer, so late cells in a
sweep can see early cells of the same sweep; this update is layer-synchronous
(all frontier cells fit against the previous layer only). The band after
``max_layers`` sweeps is exactly ``max_layers`` cells wide — which is what the
narrow-band consistency check (benchmarks/common.py:70-91) requires — and the
fit is exact on linear maps either way (tests/test_interp_extrap_energy.py:33).
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


_WIN = 4  # window half-width: 9x9 window, matches the reference loops


def _kernels_1d(dx, dy, dtype=None):
    """Separable 1D factors of the 9x9 normal-equation kernels.

    The Gaussian weight factorises exactly: w(di,dj) = wx(di) * wy(dj) with
    wx = exp(-(di dx)^2/r^2), wy = exp(-(dj dy)^2/r^2), and every moment
    kernel is an outer product of 1D factors — so each 81-tap 2D correlation
    becomes two 9-tap 1D passes (an 8x FLOP cut).
    """
    offs = np.arange(-_WIN, _WIN + 1, dtype=np.float64)
    r_sq = (4.0 * np.sqrt(dx**2 + dy**2)) ** 2
    wx = np.exp(-((offs * dx) ** 2) / r_sq)
    wy = np.exp(-((offs * dy) ** 2) / r_sq)
    ones = np.ones_like(offs)
    fx = {
        "1": ones,
        "wx": wx,
        "wxd": wx * offs,
        "wxd2": wx * offs * offs,
    }
    fy = {
        "1": ones,
        "wy": wy,
        "wyd": wy * offs,
        "wyd2": wy * offs * offs,
    }
    # returned as host numpy: the taps enter the graph as scalar constants
    return fx, fy


def _shift_zero_x(f, k):
    """f[j, i+k] with zero fill (the reference's window clipping at edges)."""
    if k == 0:
        return f
    z = jnp.zeros_like(f[:, : abs(k)])
    if k > 0:
        return jnp.concatenate([f[:, k:], z], axis=1)
    return jnp.concatenate([z, f[:, :k]], axis=1)


def _shift_zero_y(f, k):
    if k == 0:
        return f
    z = jnp.zeros_like(f[: abs(k), :])
    if k > 0:
        return jnp.concatenate([f[k:, :], z], axis=0)
    return jnp.concatenate([z, f[:k, :]], axis=0)


def _corr1d_multi(f, taps_list, shift):
    """Correlate one field with several 9-tap kernels along one axis as
    constant-weighted shift-adds: all kernels share the same 9 shifted reads,
    so XLA fuses the whole set into a couple of elementwise passes — far
    faster than a grouped conv lowering at these shapes."""
    accs = [None] * len(taps_list)
    for k in range(-_WIN, _WIN + 1):
        s = shift(f, k)
        for m, taps in enumerate(taps_list):
            w = float(taps[k + _WIN])
            if w == 0.0:
                continue
            term = s * w if w != 1.0 else s
            accs[m] = term if accs[m] is None else accs[m] + term
    return [a if a is not None else jnp.zeros_like(f) for a in accs]


def _normal_equations_separable(kf, kX1, kX2, fx, fy):
    """All 13 normal-equation correlations via two shift-add 1D passes."""
    fxn, fyn = fx, fy

    # x pass: k x {1, wx, wxd, wxd2}; kX1 x {wx, wxd}; kX2 x {wx, wxd}
    k_1, k_wx, k_wxd, k_wxd2 = _corr1d_multi(
        kf, [fxn["1"], fxn["wx"], fxn["wxd"], fxn["wxd2"]], _shift_zero_x)
    x1_wx, x1_wxd = _corr1d_multi(kX1, [fxn["wx"], fxn["wxd"]], _shift_zero_x)
    x2_wx, x2_wxd = _corr1d_multi(kX2, [fxn["wx"], fxn["wxd"]], _shift_zero_x)

    # y pass: each intermediate with the y-factors it feeds
    count = _corr1d_multi(k_1, [fyn["1"]], _shift_zero_y)[0]
    s00, s02, s22 = _corr1d_multi(
        k_wx, [fyn["wy"], fyn["wyd"], fyn["wyd2"]], _shift_zero_y)
    s01, s12 = _corr1d_multi(k_wxd, [fyn["wy"], fyn["wyd"]], _shift_zero_y)
    s11 = _corr1d_multi(k_wxd2, [fyn["wy"]], _shift_zero_y)[0]
    b1_0, b1_2 = _corr1d_multi(x1_wx, [fyn["wy"], fyn["wyd"]], _shift_zero_y)
    b1_1 = _corr1d_multi(x1_wxd, [fyn["wy"]], _shift_zero_y)[0]
    b2_0, b2_2 = _corr1d_multi(x2_wx, [fyn["wy"], fyn["wyd"]], _shift_zero_y)
    b2_1 = _corr1d_multi(x2_wxd, [fyn["wy"]], _shift_zero_y)[0]

    return jnp.stack([count, s00, s01, s02, s11, s12, s22,
                      b1_0, b1_1, b1_2, b2_0, b2_1, b2_2])


def _kernels(dx, dy, dtype):
    """Fixed 9x9 correlation kernels for the weighted normal equations.

    Kernel index (kj, ki) in [0, 8] corresponds to the neighbour offset
    (dj, di) = (kj - 4, ki - 4): XLA's conv is a correlation, so
    out[j, i] = sum_{dj,di} field[j+dj, i+di] * kernel[4+dj, 4+di].
    """
    offs = np.arange(-_WIN, _WIN + 1)
    DI, DJ = np.meshgrid(offs, offs)  # DI: x-offset, DJ: y-offset
    r_sq = (4.0 * np.sqrt(dx**2 + dy**2)) ** 2
    dist_sq = (DI * dx) ** 2 + (DJ * dy) ** 2
    w = np.exp(-dist_sq / r_sq)
    # the radius test dist^2 <= r^2 admits every cell of the 9x9 window
    # (max dist^2 = 16(dx^2+dy^2) == r^2), so no mask is needed.
    ones = np.ones_like(w)
    di = DI.astype(np.float64)
    dj = DJ.astype(np.float64)
    ks = np.stack(
        [
            ones,        # count
            w,           # S00
            w * di,      # S01
            w * dj,      # S02
            w * di * di, # S11
            w * di * dj, # S12
            w * dj * dj, # S22
        ]
    )
    return jnp.asarray(ks, dtype=dtype)


def _correlate(fields, kernels):
    """Correlate a (C, Ny, Nx) stack of fields with (K, 9, 9) kernels,
    producing (C, K, Ny, Nx). Zero padding reproduces the reference's
    window clipping at the domain edge (out-of-bounds cells contribute 0)."""
    C, Ny, Nx = fields.shape
    K = kernels.shape[0]
    lhs = fields[:, None, :, :]  # (C, 1, Ny, Nx) — batch=C, feature=1
    rhs = kernels[:, None, :, :]  # (K, 1, 9, 9)
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1, 1),
        padding=[(_WIN, _WIN), (_WIN, _WIN)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return out  # (C, K, Ny, Nx)


def _interior_mask(Ny, Nx):
    jj = jnp.arange(Ny)[:, None]
    ii = jnp.arange(Nx)[None, :]
    return (jj > 0) & (jj < Ny - 1) & (ii > 0) & (ii < Nx - 1)


def _frontier_mask(known, interior, dtype):
    """Unknown interior cells with any known 3x3 neighbour (separable 3-tap
    max dilation via two 1D passes)."""
    from pyrmt_tpu.ops.fd import _shift_x, _shift_y

    kf = known.astype(dtype)
    row_max = jnp.maximum(jnp.maximum(_shift_x(kf, -1), kf), _shift_x(kf, 1))
    neigh = jnp.maximum(jnp.maximum(_shift_y(row_max, -1), row_max),
                        _shift_y(row_max, 1))
    return (~known) & (neigh > 0.0) & interior


def _dense_layer(X1e, X2e, known, frontier, fx, fy):
    """One layer-synchronous sweep: dense whole-grid normal equations via
    separable shift-add correlations + vectorised Cramer. Returns the updated
    (X1e, X2e, known)."""
    dtype = X1e.dtype
    kf = known.astype(dtype)
    cor = _normal_equations_separable(kf, kf * X1e, kf * X2e, fx, fy)
    count = cor[0]
    a00, a01, a02 = cor[1], cor[2], cor[3]
    a11, a12, a22 = cor[4], cor[5], cor[6]
    b1_0, b1_1, b1_2 = cor[7], cor[8], cor[9]
    b2_0, b2_1, b2_2 = cor[10], cor[11], cor[12]

    from pyrmt_tpu.ops.fd import solve3x3_sym

    # offset-coordinate fit: the plane value at the centre cell is the
    # constant coefficient. det threshold in offset units (the reference's
    # 1e-10 lives in absolute-coordinate units; offset units are O(1)).
    c1_0, _, _, det, ok1 = solve3x3_sym(
        a00, a01, a02, a11, a12, a22, b1_0, b1_1, b1_2, det_eps=1e-10
    )
    c2_0, _, _, _, _ = solve3x3_sym(
        a00, a01, a02, a11, a12, a22, b2_0, b2_1, b2_2, det_eps=1e-10
    )

    accept = frontier & (count >= 3.0) & ok1
    X1e = jnp.where(accept, c1_0, X1e)
    X2e = jnp.where(accept, c2_0, X2e)
    known = known | accept
    return X1e, X2e, known


@partial(jax.jit, static_argnames=("dx", "dy", "max_layers"))
def extrapolate_reference_map(X1, X2, phi, dx, dy, max_layers):
    """Extrapolate (X1, X2) from the solid (phi < 0) ``max_layers`` cells into
    the fluid. Returns (X1_ext, X2_ext)."""
    dtype = X1.dtype
    Ny, Nx = X1.shape
    fx, fy = _kernels_1d(dx, dy, dtype)
    interior = _interior_mask(Ny, Nx)

    known = phi < 0.0
    X1e, X2e = X1, X2

    for _ in range(max_layers):
        frontier = _frontier_mask(known, interior, dtype)
        X1e, X2e, known = _dense_layer(X1e, X2e, known, frontier, fx, fy)

    return X1e, X2e


def _moment_kernels_2d(dx, dy):
    """The 13 9x9 moment kernels as [a, b] = fy[a] * fx[b] outer products of
    the same 1D factors the dense path correlates with — the sparse per-cell
    sums therefore use bit-identical weights."""
    fx, fy = _kernels_1d(dx, dy)
    pairs = [  # (y-factor, x-factor), in cor[] row order
        ("1", "1"),        # count
        ("wy", "wx"),      # S00
        ("wy", "wxd"),     # S01
        ("wyd", "wx"),     # S02
        ("wy", "wxd2"),    # S11
        ("wyd", "wxd"),    # S12
        ("wyd2", "wx"),    # S22
        ("wy", "wx"),      # b*_0
        ("wy", "wxd"),     # b*_1
        ("wyd", "wx"),     # b*_2
    ]
    return np.stack([np.outer(fy[a], fx[b]) for a, b in pairs])


def _sparse_layer(X1e, X2e, known, frontier, moments, max_frontier):
    """One sweep restricted to the frontier cells: gather each frontier
    cell's 9x9 window, form the weighted normal equations per cell, Cramer
    solve, and scatter the accepted fits back. O(frontier * 81) instead of
    O(Ny * Nx * taps) — the CPU-backend fast path (XLA:CPU does not fuse the
    dense shift-add chains, making the dense layer ~100x slower than the
    frontier gather there). Frontier cells beyond ``max_frontier`` are NOT
    updated here; the caller guards with a dense fallback."""
    dtype = X1e.dtype
    Ny, Nx = X1e.shape
    K = max_frontier
    jj, ii = jnp.nonzero(frontier, size=K, fill_value=0)
    valid = jnp.arange(K) < jnp.sum(frontier)

    pad = [(_WIN, _WIN), (_WIN, _WIN)]
    kf = jnp.pad(known.astype(dtype), pad)
    X1p = jnp.pad(X1e, pad)
    X2p = jnp.pad(X2e, pad)
    ja = jj[:, None, None] + jnp.arange(2 * _WIN + 1)[None, :, None]
    ib = ii[:, None, None] + jnp.arange(2 * _WIN + 1)[None, None, :]
    win_k = kf[ja, ib]                 # (K, 9, 9)
    win_1 = win_k * X1p[ja, ib]
    win_2 = win_k * X2p[ja, ib]

    m = [jnp.asarray(mk, dtype) for mk in moments]
    s = lambda w, f: jnp.sum(w * f, axis=(1, 2))
    count = s(m[0], win_k)
    a00, a01, a02 = s(m[1], win_k), s(m[2], win_k), s(m[3], win_k)
    a11, a12, a22 = s(m[4], win_k), s(m[5], win_k), s(m[6], win_k)
    b1_0, b1_1, b1_2 = s(m[7], win_1), s(m[8], win_1), s(m[9], win_1)
    b2_0, b2_1, b2_2 = s(m[7], win_2), s(m[8], win_2), s(m[9], win_2)

    from pyrmt_tpu.ops.fd import solve3x3_sym

    c1_0, _, _, _, ok1 = solve3x3_sym(
        a00, a01, a02, a11, a12, a22, b1_0, b1_1, b1_2, det_eps=1e-10
    )
    c2_0, _, _, _, _ = solve3x3_sym(
        a00, a01, a02, a11, a12, a22, b2_0, b2_1, b2_2, det_eps=1e-10
    )

    accept = valid & (count >= 3.0) & ok1
    # scatter via masked .add deltas: the padding duplicates at (0, 0) all
    # carry accept=False -> add 0, so duplicate updates are harmless
    d1 = jnp.where(accept, c1_0 - X1e[jj, ii], jnp.zeros((), dtype))
    d2 = jnp.where(accept, c2_0 - X2e[jj, ii], jnp.zeros((), dtype))
    X1e = X1e.at[jj, ii].add(d1)
    X2e = X2e.at[jj, ii].add(d2)
    hits = jnp.zeros((Ny, Nx), jnp.int32).at[jj, ii].add(accept.astype(jnp.int32))
    known = known | (hits > 0)
    return X1e, X2e, known


@partial(jax.jit, static_argnames=("dx", "dy", "max_layers", "max_frontier"))
def extrapolate_reference_map_sparse(X1, X2, phi, dx, dy, max_layers,
                                     max_frontier=None):
    """Frontier-gather variant of ``extrapolate_reference_map`` — the same
    layer-synchronous LSQ sweeps, but each layer fits only the O(perimeter)
    frontier cells (static bound ``max_frontier``, default 6*(Ny+Nx)) via a
    windowed gather + scatter instead of whole-grid correlations. If a layer's
    frontier ever exceeds the bound, that layer falls back to the dense path
    (lax.cond), so results match the dense op for ANY input (pinned <=1e-12
    in tests/test_extrap.py; the only differences are f64 summation-order
    rounding). This is the default (``extrap_method='auto'``); on the CPU
    backend it is ~100x faster than the dense path."""
    dtype = X1.dtype
    Ny, Nx = X1.shape
    if max_frontier is None:
        max_frontier = max(256, 6 * (Ny + Nx))
    fx, fy = _kernels_1d(dx, dy, dtype)
    moments = _moment_kernels_2d(dx, dy)
    interior = _interior_mask(Ny, Nx)

    known = phi < 0.0
    X1e, X2e = X1, X2

    for _ in range(max_layers):
        frontier = _frontier_mask(known, interior, dtype)
        X1e, X2e, known = jax.lax.cond(
            jnp.sum(frontier) <= max_frontier,
            lambda a, b, k, f: _sparse_layer(a, b, k, f, moments, max_frontier),
            lambda a, b, k, f: _dense_layer(a, b, k, f, fx, fy),
            X1e, X2e, known, frontier,
        )

    return X1e, X2e
