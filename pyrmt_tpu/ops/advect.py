"""Reference-map advection schemes.

Capability parity with pyRMT/functions.py:194-477:

  * 'semilagrangian' : RK4 backtrace of departure points + bilinear gather
                       (the robust default),
  * 'weno5'          : Jiang-Shu WENO5 upwind reconstruction + SSP-RK3,
                       active only where phi <= w_cut,
  * 'central2'       : 2nd-order central + SSP-RK3, same banding,
  * dispatcher with the same scheme names.

Design:
  * The semi-Lagrangian backtrace depends only on (a, b), not on the advected
    field, so ``advect_semilagrangian_rk4_multi`` computes departure points
    ONCE and gathers a whole stack of fields — the reference re-runs the full
    RK4 backtrace per component (pyRMT/functions.py:194-227 called twice per
    step).
  * WENO5 is evaluated densely over the grid with static shifts and selected
    by masks — no per-cell branching; the near-boundary fallback picks are the
    reference's exact choices, applied via column/row masks.
  * The divergence guard: the reference raises FloatingPointError on
    non-finite velocity (pyRMT/functions.py:460-465) to avoid a segfault in
    compiled code. Under jit a gather cannot segfault (indices are clamped and
    non-finite coordinates yield NaN), so the guard becomes a diagnosable
    NaN-propagation path; drivers check ``jnp.isfinite`` on the state instead
    (see pyrmt_tpu.sim.diverged).
"""
from __future__ import annotations

import jax.numpy as jnp

from pyrmt_tpu.ops.fd import _shift_x, _shift_y
from pyrmt_tpu.ops.interp import gather_bilinear_multi


# ── Semi-Lagrangian RK4 ──────────────────────────────────────────────────────


def backtrace_rk4(a, b, X, Y, dt, dx, dy):
    """RK4 departure points for the velocity field (a, b).

    Stage values are bilinear samples of (a, b) at the intermediate points;
    the first stage samples at the grid nodes themselves, which is the
    identity for a node-centred field, so (a, b) are used directly.
    """
    ab = jnp.stack([a, b])

    k1x, k1y = a, b

    X2 = X - 0.5 * dt * k1x
    Y2 = Y - 0.5 * dt * k1y
    k2 = gather_bilinear_multi(ab, X2, Y2, dx, dy)
    k2x, k2y = k2[0], k2[1]

    X3 = X - 0.5 * dt * k2x
    Y3 = Y - 0.5 * dt * k2y
    k3 = gather_bilinear_multi(ab, X3, Y3, dx, dy)
    k3x, k3y = k3[0], k3[1]

    X4 = X - dt * k3x
    Y4 = Y - dt * k3y
    k4 = gather_bilinear_multi(ab, X4, Y4, dx, dy)
    k4x, k4y = k4[0], k4[1]

    X_back = X - (dt / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x)
    Y_back = Y - (dt / 6.0) * (k1y + 2 * k2y + 2 * k3y + k4y)
    return X_back, Y_back


def advect_semilagrangian_rk4_multi(qs, a, b, X, Y, dt, dx, dy,
                                    interp="bilinear", cubic_mask=None):
    """Advect a stack of fields (K, Ny, Nx) with ONE shared RK4 backtrace.

    ``interp`` selects the FINAL gather of the advected fields: 'bilinear'
    (the reference's active choice) or 'bicubic' (Catmull-Rom with overshoot
    clamp — present but inactive in the reference, pyRMT/functions.py:200).
    The RK4 stage velocity samples stay bilinear in both cases.
    ``cubic_mask`` is the bicubic band guard (see gather_bicubic_local).
    """
    X_back, Y_back = backtrace_rk4(a, b, X, Y, dt, dx, dy)
    if interp == "bilinear":
        return gather_bilinear_multi(qs, X_back, Y_back, dx, dy)
    if interp == "bicubic":
        from pyrmt_tpu.ops.interp import gather_bicubic_multi

        return gather_bicubic_multi(qs, X_back, Y_back, dx, dy,
                                    cubic_mask=cubic_mask)
    raise ValueError(
        "Unknown semi-Lagrangian interpolant %r (expected 'bilinear' or "
        "'bicubic')" % (interp,)
    )


def advect_semilagrangian_rk4_local(qs, a, b, dt, dx, dy, interp="bilinear",
                                    cubic_mask=None):
    """Gather-free semi-Lagrangian RK4 (the fast path).

    Valid whenever the CFL bound guarantees |displacement| < one cell — which
    ``compute_timestep`` enforces (dt <= CFL dx / max|u| with CFL < 1); every
    intermediate velocity sample is a convex combination of grid values, so
    the bound holds at all four RK4 stages. Uses local shift+select sampling
    (pyrmt_tpu.ops.interp.gather_bilinear_local / gather_bicubic_local) —
    pure elementwise work. ``interp`` selects the FINAL field sample
    ('bilinear' | 'bicubic'); stage velocity samples stay bilinear either way.
    """
    from pyrmt_tpu.ops.interp import gather_bicubic_local, gather_bilinear_local

    ab = jnp.stack([a, b])
    inv_dx = 1.0 / dx
    inv_dy = 1.0 / dy

    k1x, k1y = a, b
    k2 = gather_bilinear_local(ab, -0.5 * dt * k1x * inv_dx, -0.5 * dt * k1y * inv_dy)
    k2x, k2y = k2[0], k2[1]
    k3 = gather_bilinear_local(ab, -0.5 * dt * k2x * inv_dx, -0.5 * dt * k2y * inv_dy)
    k3x, k3y = k3[0], k3[1]
    k4 = gather_bilinear_local(ab, -dt * k3x * inv_dx, -dt * k3y * inv_dy)
    k4x, k4y = k4[0], k4[1]

    sx = -(dt / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x) * inv_dx
    sy = -(dt / 6.0) * (k1y + 2 * k2y + 2 * k3y + k4y) * inv_dy
    if interp == "bilinear":
        return gather_bilinear_local(qs, sx, sy)
    if interp == "bicubic":
        return gather_bicubic_local(qs, sx, sy, cubic_mask=cubic_mask)
    raise ValueError(
        "Unknown semi-Lagrangian interpolant %r (expected 'bilinear' or "
        "'bicubic')" % (interp,)
    )


def advect_semilagrangian_rk4(q, a, b, X, Y, dt, dx, dy):
    """Single-field parity wrapper (pyRMT/functions.py:194-227)."""
    return advect_semilagrangian_rk4_multi(q[None], a, b, X, Y, dt, dx, dy)[0]


# ── WENO5 reconstruction ─────────────────────────────────────────────────────


def _weno5_left(vm2, vm1, v0, vp1, vp2):
    """Left-biased WENO5 value at i+1/2 (parity: pyRMT/functions.py:232-262)."""
    eps = 1.0e-6
    r0 = (2.0 * vm2 - 7.0 * vm1 + 11.0 * v0) / 6.0
    r1 = (-vm1 + 5.0 * v0 + 2.0 * vp1) / 6.0
    r2 = (2.0 * v0 + 5.0 * vp1 - vp2) / 6.0
    b0 = (13.0 / 12.0) * (vm2 - 2.0 * vm1 + v0) ** 2 + 0.25 * (vm2 - 4.0 * vm1 + 3.0 * v0) ** 2
    b1 = (13.0 / 12.0) * (vm1 - 2.0 * v0 + vp1) ** 2 + 0.25 * (vm1 - vp1) ** 2
    b2 = (13.0 / 12.0) * (v0 - 2.0 * vp1 + vp2) ** 2 + 0.25 * (3.0 * v0 - 4.0 * vp1 + vp2) ** 2
    a0 = 0.1 / (eps + b0) ** 2
    a1 = 0.6 / (eps + b1) ** 2
    a2 = 0.3 / (eps + b2) ** 2
    s = a0 + a1 + a2
    return (a0 * r0 + a1 * r1 + a2 * r2) / s


def _weno5_right(vm1, v0, vp1, vp2, vp3):
    """Right-biased WENO5 value at i+1/2 (parity: pyRMT/functions.py:265-294)."""
    eps = 1.0e-6
    r0 = (2.0 * vp3 - 7.0 * vp2 + 11.0 * vp1) / 6.0
    r1 = (-vp2 + 5.0 * vp1 + 2.0 * v0) / 6.0
    r2 = (2.0 * vp1 + 5.0 * v0 - vm1) / 6.0
    b0 = (13.0 / 12.0) * (vp3 - 2.0 * vp2 + vp1) ** 2 + 0.25 * (3.0 * vp1 - 4.0 * vp2 + vp3) ** 2
    b1 = (13.0 / 12.0) * (vp2 - 2.0 * vp1 + v0) ** 2 + 0.25 * (vp2 - v0) ** 2
    b2 = (13.0 / 12.0) * (vp1 - 2.0 * v0 + vm1) ** 2 + 0.25 * (vp1 - 4.0 * v0 + 3.0 * vm1) ** 2
    a0 = 0.1 / (eps + b0) ** 2
    a1 = 0.6 / (eps + b1) ** 2
    a2 = 0.3 / (eps + b2) ** 2
    s = a0 + a1 + a2
    return (a0 * r0 + a1 * r1 + a2 * r2) / s


def _weno5_deriv_1d(q, vel, h, shift):
    """Upwind WENO5 d(q)/dxi along one axis given a shift function.

    Reproduces the reference's per-cell picks (pyRMT/functions.py:323-365)
    densely: face values at i±1/2 chosen by sign(vel), with the exact
    near-boundary fallbacks (the left-biased substitute at the last interior
    column and the clamped q[N-1] in the minus-face right-biased stencil).
    """
    qm3, qm2, qm1 = shift(q, -3), shift(q, -2), shift(q, -1)
    qp1, qp2, qp3 = shift(q, 1), shift(q, 2), shift(q, 3)

    n = q.shape[1] if shift is _shift_x else q.shape[0]
    idx = jnp.arange(n)
    idx = idx[None, :] if shift is _shift_x else idx[:, None]

    # plus face (i+1/2)
    plus_left = _weno5_left(qm2, qm1, q, qp1, qp2)
    plus_right = _weno5_right(qm1, q, qp1, qp2, qp3)
    # reference falls back to the left-biased stencil where i+3 >= N
    plus_right = jnp.where(idx + 3 >= n, plus_left, plus_right)
    q_plus = jnp.where(vel >= 0.0, plus_left, plus_right)

    # minus face (i-1/2)
    minus_left = _weno5_left(qm3, qm2, qm1, q, qp1)
    minus_left_fb = _weno5_left(qm2, qm1, q, qp1, qp2)  # used where i < 3
    minus_left = jnp.where(idx < 3, minus_left_fb, minus_left)
    # Right-biased minus face: the correct upwind stencil is {i-2 .. i+2}
    # (the plus-face stencil shifted by -1). NOTE: this deliberately fixes an
    # off-by-one in the reference, which passes the UNSHIFTED plus-face
    # stencil here (pyRMT/functions.py:340-341 / :362-363), making
    # d(q)/dx identically zero wherever the wind is negative.
    minus_right = _weno5_right(qm2, qm1, q, qp1, qp2)
    q_minus = jnp.where(vel >= 0.0, minus_left, minus_right)
    del qp3

    return (q_plus - q_minus) / h


def weno5_rhs(q, a, b, dx, dy, phi, w_cut):
    """RHS = -(u dq/dx + v dq/dy), evaluated only where phi <= w_cut and on
    the interior (2-cell margin), zero elsewhere
    (parity: pyRMT/functions.py:297-369)."""
    dqdx = _weno5_deriv_1d(q, a, dx, _shift_x)
    dqdy = _weno5_deriv_1d(q, b, dy, _shift_y)
    rhs = -(a * dqdx + b * dqdy)

    Ny, Nx = q.shape
    jj = jnp.arange(Ny)[:, None]
    ii = jnp.arange(Nx)[None, :]
    active = (phi <= w_cut) & (jj >= 2) & (jj <= Ny - 3) & (ii >= 2) & (ii <= Nx - 3)
    return jnp.where(active, rhs, 0.0)


def advect_weno5_rk3(q, a, b, dx, dy, dt, phi, w_cut=0.0):
    """WENO5 + SSP-RK3 (Shu-Osher) (parity: pyRMT/functions.py:372-391)."""
    q1 = q + dt * weno5_rhs(q, a, b, dx, dy, phi, w_cut)
    q2 = 0.75 * q + 0.25 * (q1 + dt * weno5_rhs(q1, a, b, dx, dy, phi, w_cut))
    return (1.0 / 3.0) * q + (2.0 / 3.0) * (
        q2 + dt * weno5_rhs(q2, a, b, dx, dy, phi, w_cut)
    )


# ── 2nd-order central + SSP-RK3 ──────────────────────────────────────────────


def central2_rhs(q, a, b, dx, dy, phi, w_cut):
    """RHS = -(u dq/dx + v dq/dy) with 2nd-order central stencils, active
    where phi <= w_cut on the 1-cell interior
    (parity: pyRMT/functions.py:396-416)."""
    dqdx = (_shift_x(q, 1) - _shift_x(q, -1)) * (0.5 / dx)
    dqdy = (_shift_y(q, 1) - _shift_y(q, -1)) * (0.5 / dy)
    rhs = -(a * dqdx + b * dqdy)

    Ny, Nx = q.shape
    jj = jnp.arange(Ny)[:, None]
    ii = jnp.arange(Nx)[None, :]
    active = (phi <= w_cut) & (jj >= 1) & (jj <= Ny - 2) & (ii >= 1) & (ii <= Nx - 2)
    return jnp.where(active, rhs, 0.0)


def advect_central2_rk3(q, a, b, dx, dy, dt, phi, w_cut=0.0):
    """Central-2 + SSP-RK3 (parity: pyRMT/functions.py:419-435)."""
    q1 = q + dt * central2_rhs(q, a, b, dx, dy, phi, w_cut)
    q2 = 0.75 * q + 0.25 * (q1 + dt * central2_rhs(q1, a, b, dx, dy, phi, w_cut))
    return (1.0 / 3.0) * q + (2.0 / 3.0) * (
        q2 + dt * central2_rhs(q2, a, b, dx, dy, phi, w_cut)
    )


# ── Dispatcher ───────────────────────────────────────────────────────────────


def advect_reference_map_multi(
    qs, a, b, X, Y, dt, dx, dy, phi, scheme="semilagrangian", w_cut=0.0,
    sl_interp="bilinear", sl_cubic_mask=None,
):
    """Advect a STACK of reference-map components with a selectable scheme
    (parity: pyRMT/functions.py:438-477, scheme is static/trace-time).
    ``sl_interp`` selects the semi-Lagrangian final gather
    ('bilinear' | 'bicubic'); other schemes ignore it. ``sl_cubic_mask`` is
    the bicubic band guard (see gather_bicubic_local)."""
    if scheme == "semilagrangian":
        return advect_semilagrangian_rk4_multi(qs, a, b, X, Y, dt, dx, dy,
                                               interp=sl_interp,
                                               cubic_mask=sl_cubic_mask)
    elif scheme == "central2":
        return jnp.stack(
            [advect_central2_rk3(q, a, b, dx, dy, dt, phi, w_cut) for q in qs]
        )
    elif scheme == "weno5":
        return jnp.stack(
            [advect_weno5_rk3(q, a, b, dx, dy, dt, phi, w_cut) for q in qs]
        )
    else:
        raise ValueError(
            "Unknown advection scheme %r (expected 'semilagrangian', "
            "'central2' or 'weno5')" % (scheme,)
        )


def advect_reference_map(q, a, b, X, Y, dt, dx, dy, phi, scheme="semilagrangian", w_cut=0.0):
    """Single-field parity wrapper."""
    return advect_reference_map_multi(
        q[None], a, b, X, Y, dt, dx, dy, phi, scheme, w_cut
    )[0]
