"""Pressure projection — the solver hub.

Capability parity with ``pressure_projection_amg``
(pyRMT/functions.py:1176-1285), re-designed for XLA: the reference's three
runtime-branchy paths become STATIC (trace-time) dispatch on
(bc_type, variable_rho), so each configuration compiles to a single fused
program:

  * bc_type='periodic'           -> direct FFT solve, mean-rho operator,
                                    local-rho velocity correction,
  * bc_type='neumann' + const rho -> DCT-I direct solve,
  * bc_type='neumann' + var rho   -> matrix-free CG preconditioned by the DCT
                                    direct solve (replaces pyamg).

Incremental projection: when ``p_prev`` is provided the divergence uses
Rhie-Chow face velocities, the velocity is corrected with the gradient of the
CORRECTION only, and pressure accumulates p = p_prev + dp, de-meaned.
"""
from __future__ import annotations

import jax.numpy as jnp

from pyrmt_tpu.ops.poisson import (
    compute_divergence,
    compute_divergence_periodic,
    compute_divergence_rc,
    compute_pressure_gradient,
    compute_pressure_gradient_periodic,
    solve_poisson_dct,
    solve_poisson_fft,
    solve_variable_poisson_cg,
)


def pressure_projection(
    a_star,
    b_star,
    dx,
    dy,
    dt,
    rho,
    velocity_bc,
    p_prev=None,
    eigenvalues=None,
    bc_type="neumann",
    variable_rho=False,
    cg_tol=1e-6,
    cg_maxiter=200,
    dct_mats=None,
    dct_precision=None,
    cg_info=False,
    st_faces=None,
):
    """Project (a*, b*) onto a (discretely) divergence-free field.

    Parameters mirror the reference; ``variable_rho`` is the static
    replacement for the runtime ``np.ptp(rho) > 1e-10`` probe. ``rho`` may be
    a scalar or an (Ny, Nx) array in either mode. ``dct_mats`` (optional)
    routes the Neumann DCT solves through dense matmuls instead of the FFT
    lowering. ``dct_precision`` (None/'highest'/'high'/'default') sets the
    matmul precision of the DCT transforms when ``dct_mats`` is given —
    see ops/poisson.py. Returns (a, b, p), or
    (a, b, p, (cg_iters, cg_relres)) when ``cg_info=True`` with
    ``variable_rho=True`` (the counted while-loop PCG; same math as
    the jax.scipy path, pinned in tests/test_poisson.py).
    """
    if cg_info and not variable_rho:
        raise ValueError("cg_info=True requires variable_rho=True")
    if st_faces is not None and (bc_type != "neumann" or p_prev is None):
        raise ValueError(
            "balanced-force st_faces requires the incremental Neumann "
            "(Rhie-Chow) projection")
    rho = jnp.asarray(rho, dtype=a_star.dtype)

    if bc_type == "periodic":
        if eigenvalues is None:
            raise ValueError("periodic projection needs precomputed eigenvalues")
        divU = compute_divergence_periodic(a_star, b_star, dx, dy)
        rho_bar = jnp.mean(rho)
        rhs_2d = rho_bar * divU / dt
        p_correction = solve_poisson_fft(rhs_2d, eigenvalues)
        dpdx, dpdy = compute_pressure_gradient_periodic(p_correction, dx, dy)
        a = a_star - (dt / rho) * dpdx
        b = b_star - (dt / rho) * dpdy
        a, b = velocity_bc(a, b)
        p = (p_prev + p_correction) if p_prev is not None else p_correction
        return a, b, p - jnp.mean(p)

    if bc_type != "neumann":
        raise ValueError(f"unknown bc_type {bc_type!r}")
    if eigenvalues is None:
        raise ValueError("neumann projection needs precomputed DCT eigenvalues")

    if p_prev is not None:
        divU = compute_divergence_rc(
            a_star, b_star, p_prev, dt, rho, dx, dy, variable_rho,
            st_faces=st_faces,
        )
    else:
        divU = compute_divergence(a_star, b_star, dx, dy)

    cg_stats = None
    if variable_rho:
        rhs = divU / dt
        inv_rho = 1.0 / rho
        if cg_info:
            from pyrmt_tpu.ops.poisson import solve_variable_poisson_cg_counted

            p_correction, cg_iters, cg_relres = solve_variable_poisson_cg_counted(
                rhs, inv_rho, eigenvalues, dx, dy, tol=cg_tol,
                maxiter=cg_maxiter, dct_mats=dct_mats, precision=dct_precision,
            )
            cg_stats = (cg_iters, cg_relres)
        else:
            p_correction = solve_variable_poisson_cg(
                rhs, inv_rho, eigenvalues, dx, dy, tol=cg_tol,
                maxiter=cg_maxiter, dct_mats=dct_mats, precision=dct_precision,
            )
    else:
        rhs_2d = rho * divU / dt
        p_correction = solve_poisson_dct(rhs_2d, eigenvalues,
                                         dct_mats=dct_mats,
                                         precision=dct_precision)

    dpdx, dpdy = compute_pressure_gradient(p_correction, dx, dy)
    a = a_star - (dt / rho) * dpdx
    b = b_star - (dt / rho) * dpdy
    a, b = velocity_bc(a, b)

    p = (p_prev + p_correction) if p_prev is not None else p_correction
    p = p - jnp.mean(p)
    if cg_stats is not None:
        return a, b, p, cg_stats
    return a, b, p
