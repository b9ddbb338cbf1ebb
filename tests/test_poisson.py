"""Poisson solvers and pressure projection: Neumann (DCT) and periodic (FFT).

Same contracts and tolerances as the reference's tests/test_poisson.py,
plus DCT-vs-scipy transform identity and the variable-density CG path.
"""

import pytest

pytestmark = pytest.mark.slow  # full local tier only; fast tier = -m 'not slow'
import numpy as np

from pyrmt_tpu.grid import create_grid
from pyrmt_tpu.ops.poisson import (
    apply_variable_poisson,
    compute_divergence,
    compute_divergence_periodic,
    compute_pressure_gradient_periodic,
    dct1_2d,
    idct1_2d,
    precompute_poisson_eigenvalues,
    precompute_poisson_eigenvalues_periodic,
    solve_poisson_dct,
    solve_variable_poisson_cg,
)
from pyrmt_tpu.ops.projection import pressure_projection


def _mk(N):
    X, Y, dx, dy = create_grid(N, N, 1.0, 1.0, dtype=np.float64)
    return np.asarray(X), np.asarray(Y), dx, dy


def test_dct1_matches_scipy():
    from scipy.fft import dctn, idctn

    rng = np.random.default_rng(0)
    x = rng.standard_normal((17, 33))
    assert np.allclose(np.asarray(dct1_2d(x)), dctn(x, type=1), atol=1e-10)
    assert np.allclose(np.asarray(idct1_2d(x)), idctn(x, type=1), atol=1e-12)


def test_dct_recovers_manufactured_neumann():
    """DCT solve of lap(p)=rhs recovers p (up to a constant) for a field with
    zero normal derivative on the walls."""
    N = 65
    X, Y, dx, dy = _mk(N)
    p_true = np.cos(np.pi * X) * np.cos(np.pi * Y)
    lap = -2.0 * np.pi**2 * p_true
    eig = precompute_poisson_eigenvalues(N, N, dx, dy)
    p = np.asarray(solve_poisson_dct(lap, eig))
    p = p - p.mean()
    pt = p_true - p_true.mean()
    assert np.max(np.abs(p - pt)) < 5e-3


def test_fft_periodic_roundtrip_machine_precision():
    """solve(div(grad(p))) == p for the periodic operators (exact)."""
    N = 65
    X, Y, dx, dy = _mk(N)
    from pyrmt_tpu.ops.poisson import solve_poisson_fft

    k = 2 * np.pi
    p_true = np.cos(k * X) * np.sin(k * Y) + 0.5 * np.sin(2 * k * X)
    gx, gy = compute_pressure_gradient_periodic(p_true, dx, dy)
    lap = compute_divergence_periodic(np.asarray(gx), np.asarray(gy), dx, dy)
    eig = precompute_poisson_eigenvalues_periodic(N, N, dx, dy)
    p = np.asarray(solve_poisson_fft(np.asarray(lap), eig))
    pt = p_true - p_true.mean()
    assert np.max(np.abs((p - pt)[:-1, :-1])) < 1e-10


def _wall_bc(u, v):
    u = u.at[:, 0].set(0.0).at[:, -1].set(0.0).at[0, :].set(0.0).at[-1, :].set(0.0)
    v = v.at[:, 0].set(0.0).at[:, -1].set(0.0).at[0, :].set(0.0).at[-1, :].set(0.0)
    return u, v


def test_neumann_projection_reduces_divergence():
    import jax.numpy as jnp

    N = 65
    X, Y, dx, dy = _mk(N)
    a = jnp.asarray(np.sin(np.pi * X) * np.cos(np.pi * Y))
    b = jnp.asarray(0.5 * np.cos(np.pi * X) * np.sin(np.pi * Y))
    a, b = _wall_bc(a, b)
    eig = precompute_poisson_eigenvalues(N, N, dx, dy)
    d0 = np.abs(np.asarray(compute_divergence(a, b, dx, dy))[2:-2, 2:-2]).max()
    an, bn, p = pressure_projection(
        a, b, dx, dy, 1e-2, 1.0, _wall_bc, p_prev=None, eigenvalues=eig,
        bc_type="neumann")
    d1 = np.abs(np.asarray(compute_divergence(an, bn, dx, dy))[2:-2, 2:-2]).max()
    assert d1 < d0 / 50.0


def _periodic_bc(u, v):
    u = u.at[:, -1].set(u[:, 0]).at[-1, :].set(u[0, :])
    v = v.at[:, -1].set(v[:, 0]).at[-1, :].set(v[0, :])
    return u, v


def test_periodic_projection_makes_divergence_free():
    import jax.numpy as jnp

    N = 65
    X, Y, dx, dy = _mk(N)
    k = 2 * np.pi
    a = jnp.asarray(np.sin(k * X) * np.cos(k * Y) + 0.3 * np.cos(k * X))
    b = jnp.asarray(-np.cos(k * X) * np.sin(k * Y) + 0.2 * np.sin(k * Y))
    a, b = _periodic_bc(a, b)
    eig = precompute_poisson_eigenvalues_periodic(N, N, dx, dy)
    an, bn, p = pressure_projection(
        a, b, dx, dy, 1e-2, 1.0, _periodic_bc, p_prev=None, eigenvalues=eig,
        bc_type="periodic")
    d1 = np.abs(
        np.asarray(compute_divergence_periodic(an, bn, dx, dy))[:-1, :-1]
    ).max()
    assert d1 < 1e-9


def test_variable_poisson_operator_consistent_with_constant():
    """With rho == 1 the variable operator must equal the ghost-mirror
    Laplacian the DCT eigenvalues diagonalise."""
    N = 33
    X, Y, dx, dy = _mk(N)
    rng = np.random.default_rng(1)
    p = rng.standard_normal((N, N))
    inv_rho = np.ones((N, N))
    Ap = np.asarray(apply_variable_poisson(p, inv_rho, dx, dy))
    eig = precompute_poisson_eigenvalues(N, N, dx, dy)
    # DCT of Ap must equal eig * DCT(p) except at the pinned (0,0) mode
    lhs = np.asarray(dct1_2d(Ap))
    rhs = np.asarray(eig) * np.asarray(dct1_2d(p))
    assert np.allclose(lhs.ravel()[1:], rhs.ravel()[1:], atol=1e-8)


def test_variable_density_cg_solves_manufactured():
    """CG with DCT preconditioner solves grad.((1/rho) grad p) = f for a
    smooth variable rho to the requested tolerance."""
    N = 65
    X, Y, dx, dy = _mk(N)
    rho = 1.0 + 0.8 * np.exp(-((X - 0.5) ** 2 + (Y - 0.5) ** 2) / 0.05)
    inv_rho = 1.0 / rho
    p_true = np.cos(np.pi * X) * np.cos(np.pi * Y)
    p_true -= p_true.mean()
    rhs = np.asarray(apply_variable_poisson(p_true, inv_rho, dx, dy))
    eig = precompute_poisson_eigenvalues(N, N, dx, dy)
    p = np.asarray(
        solve_variable_poisson_cg(rhs, inv_rho, eig, dx, dy, tol=1e-10, maxiter=400)
    )
    p = p - p.mean()
    assert np.max(np.abs(p - p_true)) < 1e-6


def test_variable_density_projection_reduces_divergence():
    import jax.numpy as jnp

    N = 65
    X, Y, dx, dy = _mk(N)
    a = jnp.asarray(np.sin(np.pi * X) * np.cos(np.pi * Y))
    b = jnp.asarray(0.5 * np.cos(np.pi * X) * np.sin(np.pi * Y))
    a, b = _wall_bc(a, b)
    rho = jnp.asarray(1.0 + 0.5 * np.exp(-((X - 0.5) ** 2 + (Y - 0.5) ** 2) / 0.02))
    eig = precompute_poisson_eigenvalues(N, N, dx, dy)
    d0 = np.abs(np.asarray(compute_divergence(a, b, dx, dy))[2:-2, 2:-2]).max()
    an, bn, p = pressure_projection(
        a, b, dx, dy, 1e-2, rho, _wall_bc, p_prev=None, eigenvalues=eig,
        bc_type="neumann", variable_rho=True)
    d1 = np.abs(np.asarray(compute_divergence(an, bn, dx, dy))[2:-2, 2:-2]).max()
    assert d1 < d0 / 50.0


def test_dct_eigenvalues_diagonalize_explicit_matrix():
    """The DCT-I eigenvalues must diagonalise EXACTLY the explicit
    ghost-mirror matrix from build_poisson_matrix (the property that makes
    the Neumann projection a direct solve)."""
    from pyrmt_tpu.ops.poisson import build_poisson_matrix

    N = 17
    dx = 1.0 / (N - 1)
    A = build_poisson_matrix(N, N, dx, dx)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((N, N))
    Ap = (A @ p.ravel()).reshape(N, N)
    eig = np.asarray(precompute_poisson_eigenvalues(N, N, dx, dx))
    lhs = np.asarray(dct1_2d(Ap))
    rhs = eig * np.asarray(dct1_2d(p))
    # skip the pinned (0,0) mode
    assert np.allclose(lhs.ravel()[1:], rhs.ravel()[1:], atol=1e-7)


def test_dct_matmul_path_matches_fft_path():
    """The matmul DCT-I lowering is the SAME transform as the rFFT one:
    transforms match to roundoff and the Neumann solve is identical."""
    from pyrmt_tpu.ops.poisson import (
        dct1_2d_matmul,
        idct1_2d_matmul,
        precompute_dct_matrices,
    )

    rng = np.random.default_rng(7)
    Ny, Nx = 33, 49
    x = rng.standard_normal((Ny, Nx))
    mats = precompute_dct_matrices(Nx, Ny, dtype=np.float64)
    assert np.allclose(np.asarray(dct1_2d_matmul(x, mats)),
                       np.asarray(dct1_2d(x)), atol=1e-9)
    assert np.allclose(np.asarray(idct1_2d_matmul(x, mats)),
                       np.asarray(idct1_2d(x)), atol=1e-12)

    dx = 1.0 / (Nx - 1)
    dy = 1.0 / (Ny - 1)
    eig = precompute_poisson_eigenvalues(Nx, Ny, dx, dy)
    rhs = rng.standard_normal((Ny, Nx))
    p_fft = np.asarray(solve_poisson_dct(rhs, eig))
    p_mm = np.asarray(solve_poisson_dct(rhs, eig, dct_mats=mats))
    assert np.allclose(p_mm, p_fft, atol=1e-9)


def test_sim_step_dct_method_matmul_matches_fft():
    """One full FSI step with dct_method='matmul' equals 'fft' to roundoff."""
    import dataclasses

    import jax.numpy as jnp

    from pyrmt_tpu.bcs import make_lid_bc
    from pyrmt_tpu.grid import Grid
    from pyrmt_tpu.sim import RMTConfig, make_init_state, make_step

    g = Grid(Nx=17, Ny=17, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                    num_layers=3, CFL=0.2, dt_min_cap=1e-3, dct_method="fft")
    phi_inits = (lambda X, Y: jnp.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.25,)
    bc = make_lid_bc(1.0)
    state = make_init_state(cfg, phi_inits, dtype=jnp.float64)
    t_end = jnp.asarray(1.0, jnp.float64)

    s_fft = state
    step_fft = make_step(cfg, bc, phi_inits, dtype=jnp.float64)
    step_mm = make_step(dataclasses.replace(cfg, dct_method="matmul"),
                        bc, phi_inits, dtype=jnp.float64)
    s_mm = state
    for _ in range(3):
        s_fft, _ = step_fft(s_fft, t_end)
        s_mm, _ = step_mm(s_mm, t_end)
    assert np.allclose(np.asarray(s_mm.u), np.asarray(s_fft.u), atol=1e-11)
    assert np.allclose(np.asarray(s_mm.p), np.asarray(s_fft.p), atol=1e-10)


def test_dct_recursive_fold_matches_fft_path():
    """The recursive even/odd fold (dct_method='matmul_rec', 2^k+1 grids) is
    the SAME transform in recursive fold order: un-permuted forward matches
    dct1_2d, the roundtrip is exact, and the Neumann solve matches the FFT
    path to roundoff — including non-square grids and deep recursion."""
    from pyrmt_tpu.ops.poisson import (
        dct1_2d_rec,
        idct1_2d_rec,
        precompute_dct_plan,
    )

    rng = np.random.default_rng(11)
    Ny, Nx = 33, 65  # 2^5+1, 2^6+1
    x = rng.standard_normal((Ny, Nx))
    plan = precompute_dct_plan(Nx, Ny, dtype=np.float64, min_leaf=8)
    y_fold = np.asarray(dct1_2d_rec(x, plan))
    y_nat = np.empty_like(y_fold)
    y_nat[np.ix_(plan["perm_y"], plan["perm_x"])] = y_fold
    assert np.allclose(y_nat, np.asarray(dct1_2d(x)), atol=1e-9)
    assert np.allclose(np.asarray(idct1_2d_rec(dct1_2d_rec(x, plan), plan)),
                       x, atol=1e-12)

    dx = 1.0 / (Nx - 1)
    dy = 1.0 / (Ny - 1)
    eig = precompute_poisson_eigenvalues(Nx, Ny, dx, dy)
    rhs = rng.standard_normal((Ny, Nx))
    p_fft = np.asarray(solve_poisson_dct(rhs, eig))
    p_rec = np.asarray(solve_poisson_dct(rhs, eig, dct_mats=plan))
    assert np.allclose(p_rec, p_fft, atol=1e-9)

    import pytest

    with pytest.raises(ValueError):
        precompute_dct_plan(64, 65)  # even sizes cannot recurse


def test_sim_step_dct_method_matmul_rec_matches_fft():
    """One full FSI step with dct_method='matmul_rec' equals 'fft' to
    roundoff (N=65 exercises one fold level at the default min_leaf)."""
    import dataclasses

    import jax.numpy as jnp

    from pyrmt_tpu.bcs import make_lid_bc
    from pyrmt_tpu.grid import Grid
    from pyrmt_tpu.sim import RMTConfig, make_init_state, make_step

    g = Grid(Nx=65, Ny=65, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                    num_layers=3, CFL=0.2, dt_min_cap=1e-3, dct_method="fft")
    phi_inits = (lambda X, Y: jnp.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.25,)
    bc = make_lid_bc(1.0)
    state = make_init_state(cfg, phi_inits, dtype=jnp.float64)
    t_end = jnp.asarray(1.0, jnp.float64)

    s_fft = state
    step_fft = make_step(cfg, bc, phi_inits, dtype=jnp.float64)
    step_rec = make_step(dataclasses.replace(cfg, dct_method="matmul_rec"),
                         bc, phi_inits, dtype=jnp.float64)
    s_rec = state
    for _ in range(3):
        s_fft, _ = step_fft(s_fft, t_end)
        s_rec, _ = step_rec(s_rec, t_end)
    assert np.allclose(np.asarray(s_rec.u), np.asarray(s_fft.u), atol=1e-11)
    assert np.allclose(np.asarray(s_rec.p), np.asarray(s_fft.p), atol=1e-10)


def test_trapezoid_weights_symmetrize_variable_operator():
    """The trapezoidal boundary weights D make D A exactly symmetric (the
    property the variable-rho PCG relies on; the raw ghost-mirror operator
    is nonsymmetric at boundary rows)."""
    from pyrmt_tpu.ops.poisson import _trapezoid_weights

    N = 12
    X, Y, dx, dy = _mk(N)
    rho = np.where(np.sqrt((X - 0.5) ** 2 + (Y - 0.6) ** 2) - 0.3 <= 0, 10.0, 1.0)
    inv_rho = 1.0 / rho
    n = N * N
    A = np.zeros((n, n))
    for k in range(n):
        e = np.zeros(n)
        e[k] = 1.0
        A[:, k] = np.asarray(
            apply_variable_poisson(e.reshape(N, N), inv_rho, dx, dy)
        ).ravel()
    assert np.max(np.abs(A - A.T)) > 1.0  # raw operator really is asymmetric
    w = np.asarray(_trapezoid_weights((N, N), np.float64)).ravel()
    S = w[:, None] * A
    assert np.max(np.abs(S - S.T)) < 1e-12
    # negative semidefinite with a single (constant) null mode
    ev = np.linalg.eigvalsh(S)
    assert ev[-1] < 1e-10 and ev[-2] < -1e-6


def test_variable_density_cg_counted_converges_sharp_contrast():
    """The symmetrized PCG converges to tol in tens of iterations on a SHARP
    10:1 density contrast — the configuration on which CG on the raw
    (nonsymmetric) operator, as the reference runs it, stagnates at ~1e-3
    after 200 iterations (measured; docs/DESIGN.md deviation)."""
    from pyrmt_tpu.ops.poisson import (
        _trapezoid_weights,
        solve_variable_poisson_cg_counted,
    )

    N = 65
    X, Y, dx, dy = _mk(N)
    rho = np.where(np.sqrt((X - 0.5) ** 2 + (Y - 0.7) ** 2) - 0.15 <= 0, 10.0, 1.0)
    inv_rho = 1.0 / rho
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal((N, N))
    p, it, rr = solve_variable_poisson_cg_counted(
        rhs, inv_rho, eigenvalues=precompute_poisson_eigenvalues(N, N, dx, dy),
        dx=dx, dy=dy, tol=1e-8, maxiter=200)
    assert int(it) < 50
    assert float(rr) <= 1e-8
    # reported relres == true weighted-system residual
    w = np.asarray(_trapezoid_weights((N, N), np.float64))
    b = w * rhs
    b = b - b.mean()
    r = w * np.asarray(apply_variable_poisson(p, inv_rho, dx, dy)) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 1.1e-8


def test_variable_density_cg_counted_matches_uncounted():
    from pyrmt_tpu.ops.poisson import solve_variable_poisson_cg_counted

    N = 33
    X, Y, dx, dy = _mk(N)
    rho = 1.0 + 9.0 * (np.sqrt((X - 0.4) ** 2 + (Y - 0.5) ** 2) < 0.2)
    inv_rho = 1.0 / rho
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((N, N))
    eig = precompute_poisson_eigenvalues(N, N, dx, dy)
    p1 = np.asarray(solve_variable_poisson_cg(rhs, inv_rho, eig, dx, dy))
    p2, _, _ = solve_variable_poisson_cg_counted(rhs, inv_rho, eig, dx, dy)
    assert np.max(np.abs(p1 - np.asarray(p2))) < 1e-13


def test_projection_cg_info_contract():
    """pressure_projection(cg_info=True) returns (a, b, p, (iters, relres))
    on the variable-rho path and raises on the constant-rho one."""
    import jax.numpy as jnp
    import pytest

    N = 33
    X, Y, dx, dy = _mk(N)
    a = jnp.asarray(np.sin(np.pi * X) * np.cos(np.pi * Y))
    b = jnp.asarray(0.5 * np.cos(np.pi * X) * np.sin(np.pi * Y))
    a, b = _wall_bc(a, b)
    rho = jnp.asarray(1.0 + 9.0 * (np.sqrt((X - 0.5) ** 2 + (Y - 0.6) ** 2) < 0.2))
    eig = precompute_poisson_eigenvalues(N, N, dx, dy)
    an, bn, p, (it, rr) = pressure_projection(
        a, b, dx, dy, 1e-2, rho, _wall_bc, p_prev=None, eigenvalues=eig,
        bc_type="neumann", variable_rho=True, cg_info=True)
    assert 0 < int(it) <= 200 and float(rr) <= 1e-6
    with pytest.raises(ValueError):
        pressure_projection(
            a, b, dx, dy, 1e-2, 1.0, _wall_bc, p_prev=None, eigenvalues=eig,
            bc_type="neumann", variable_rho=False, cg_info=True)
