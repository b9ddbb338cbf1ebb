"""Neo-Hookean solid stress from the reference map + smoothed Heaviside.

Capability parity with ``solid_cauchy_stress`` (pyRMT/functions.py:480-579)
and ``smoothed_heaviside`` (pyRMT/functions.py:581-592):

  * per-cell G = grad(xi), F = G^{-1}, b = F F^T, J = det F = 1/det G,
    sigma = mu_s b + kappa (J-1) I,
  * LEGACY interior mode (w_cut <= 0): stress only where phi <= 0, with
    one-sided stencils when a neighbour is fluid (robust default),
  * BAND mode (w_cut > 0): central stencils over the whole blend band
    phi < w_cut (higher order; requires an extrapolated reference map),
  * localized detG clamp bounding J in [1/C, C] (off when detg_clamp <= 0),
  * near-singular cells (|detG| < 1e-10) keep sigma = 0, J = 1 — the
    vectorised equivalent of the reference's ``continue``.

Design: branchless whole-grid selects; every stencil is a static
shift, so the kernel fuses into one elementwise pass. Stack multiple solids
on a leading axis and ``jax.vmap`` this function (the reference hand-writes the
two-solid case instead).
"""
from __future__ import annotations

import jax.numpy as jnp

from pyrmt_tpu.ops.fd import _shift_x, _shift_y


def smoothed_heaviside(x, w_t):
    """H(phi) = 1/2 (1 + phi/w_t + sin(pi phi/w_t)/pi), clipped to {0,1}
    outside +/- w_t (parity: pyRMT/functions.py:581-592)."""
    inv_wt = 1.0 / w_t
    H = 0.5 * (1.0 + x * inv_wt + jnp.sin(jnp.pi * x * inv_wt) / jnp.pi)
    H = jnp.where(x > w_t, 1.0, H)
    H = jnp.where(x < -w_t, 0.0, H)
    return H


def solid_cauchy_stress(X1, X2, dx, dy, mu_s, kappa, phi, w_cut=0.0, detg_clamp=0.0):
    """Neo-Hookean Cauchy stress sigma = mu_s*b + kappa*(J-1)*I from the
    reference map. Returns (sxx, sxy, syy, J).

    ``w_cut`` and ``detg_clamp`` are static (Python float) switches — they
    select the compiled stencil variant at trace time.
    """
    inv_2dx = 1.0 / (2.0 * dx)
    inv_2dy = 1.0 / (2.0 * dy)

    X1_xp, X1_xm = _shift_x(X1, 1), _shift_x(X1, -1)
    X2_xp, X2_xm = _shift_x(X2, 1), _shift_x(X2, -1)
    X1_yp, X1_ym = _shift_y(X1, 1), _shift_y(X1, -1)
    X2_yp, X2_ym = _shift_y(X2, 1), _shift_y(X2, -1)

    if w_cut > 0.0:
        in_band = phi < w_cut
        g11 = (X1_xp - X1_xm) * inv_2dx
        g21 = (X2_xp - X2_xm) * inv_2dx
        g12 = (X1_yp - X1_ym) * inv_2dy
        g22 = (X2_yp - X2_ym) * inv_2dy
    else:
        in_band = phi <= 0.0
        phi_xp, phi_xm = _shift_x(phi, 1), _shift_x(phi, -1)
        phi_yp, phi_ym = _shift_y(phi, 1), _shift_y(phi, -1)
        left_fluid = phi_xm > 0.0
        right_fluid = phi_xp > 0.0
        central_x1 = (X1_xp - X1_xm) * inv_2dx
        central_x2 = (X2_xp - X2_xm) * inv_2dx
        g11 = jnp.where(
            left_fluid & ~right_fluid,
            (X1_xp - X1) / dx,
            jnp.where(right_fluid & ~left_fluid, (X1 - X1_xm) / dx, central_x1),
        )
        g21 = jnp.where(
            left_fluid & ~right_fluid,
            (X2_xp - X2) / dx,
            jnp.where(right_fluid & ~left_fluid, (X2 - X2_xm) / dx, central_x2),
        )
        bot_fluid = phi_ym > 0.0
        top_fluid = phi_yp > 0.0
        central_y1 = (X1_yp - X1_ym) * inv_2dy
        central_y2 = (X2_yp - X2_ym) * inv_2dy
        g12 = jnp.where(
            bot_fluid & ~top_fluid,
            (X1_yp - X1) / dy,
            jnp.where(top_fluid & ~bot_fluid, (X1 - X1_ym) / dy, central_y1),
        )
        g22 = jnp.where(
            bot_fluid & ~top_fluid,
            (X2_yp - X2) / dy,
            jnp.where(top_fluid & ~bot_fluid, (X2 - X2_ym) / dy, central_y2),
        )

    detG = g11 * g22 - g12 * g21
    nonsingular = jnp.abs(detG) >= 1e-10

    if detg_clamp > 0.0:
        detG = jnp.clip(detG, 1.0 / detg_clamp, detg_clamp)

    # interior only (boundary ring never computed in the reference loops)
    Ny, Nx = X1.shape
    jj = jnp.arange(Ny)[:, None]
    ii = jnp.arange(Nx)[None, :]
    interior = (jj > 0) & (jj < Ny - 1) & (ii > 0) & (ii < Nx - 1)
    active = in_band & nonsingular & interior

    safe_det = jnp.where(active, detG, 1.0)
    inv_det = 1.0 / safe_det
    f11, f12 = g22 * inv_det, -g12 * inv_det
    f21, f22 = -g21 * inv_det, g11 * inv_det

    b11 = f11 * f11 + f12 * f12
    b12 = f11 * f21 + f12 * f22
    b22 = f21 * f21 + f22 * f22

    j_val = inv_det
    vol_term = kappa * (j_val - 1.0)

    zero = jnp.zeros_like(X1)
    sxx = jnp.where(active, mu_s * b11 + vol_term, zero)
    sxy = jnp.where(active, mu_s * b12, zero)
    syy = jnp.where(active, mu_s * b22 + vol_term, zero)
    J = jnp.where(active, j_val, jnp.ones_like(X1))
    return sxx, sxy, syy, J
