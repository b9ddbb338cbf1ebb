"""Multi-chip domain decomposition: sharded step == single-device step.

Runs on the 8-device virtual CPU mesh from conftest (the same mechanism the
driver's dryrun uses), exercising real XLA collectives (halo exchange for
stencils/convs, FFT all-to-alls, psum reductions).
"""

import pytest

pytestmark = pytest.mark.slow  # full local tier only; fast tier = -m 'not slow'
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pyrmt_tpu.bcs import free_slip_box_bc
from pyrmt_tpu.grid import Grid
from pyrmt_tpu.parallel import make_mesh, make_sharded_step
from pyrmt_tpu.sim import RMTConfig, make_init_state, make_step


def _disc_phi(x0, y0, R):
    def phi_init(Xq, Yq):
        return jnp.sqrt((Xq - x0) ** 2 + (Yq - y0) ** 2) - R

    return phi_init


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_fsi_step_matches_single_device():
    g = Grid(Nx=64, Ny=64, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, eta_s=0.01, mu_f=0.01, rho_f=1.0,
                    rho_s=1.0, CFL=0.2, dt_min_cap=1e-3)
    phi_init = _disc_phi(0.5, 0.5, 0.2)

    step1 = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    ref, _ = step1(state, jnp.asarray(1.0))

    mesh = make_mesh(jax.devices()[:8])
    stepN, shard = make_sharded_step(cfg, free_slip_box_bc, (phi_init,), mesh,
                                     dtype=jnp.float64)
    out, _ = stepN(shard(state), jnp.asarray(1.0))

    assert np.allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-8)
    assert np.allclose(np.asarray(out.p), np.asarray(ref.p), atol=1e-8)
    assert np.allclose(np.asarray(out.X1), np.asarray(ref.X1), atol=1e-8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_mesh_factorization():
    mesh = make_mesh(jax.devices()[:8])
    assert mesh.devices.shape in ((2, 4), (4, 2))
    mesh6 = make_mesh(jax.devices()[:6])
    assert mesh6.devices.shape[0] * mesh6.devices.shape[1] == 6


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_driver_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_sharded_2d_mesh_matches_single_device(mesh_shape):
    """2D (row x column) GSPMD decomposition: every device owns a
    rectangular block, halo exchanges run on BOTH mesh axes."""
    from jax.sharding import Mesh

    g = Grid(Nx=64, Ny=64, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, eta_s=0.01, mu_f=0.01, rho_f=1.0,
                    rho_s=1.0, num_layers=3, CFL=0.2, dt_min_cap=1e-3)
    # off-centre disc: the solid straddles shard boundaries unevenly
    phi_init = _disc_phi(0.35, 0.6, 0.2)

    step1 = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)

    ny, nx = mesh_shape
    mesh = Mesh(np.array(jax.devices()[: ny * nx]).reshape(ny, nx),
                ("gy", "gx"))
    stepN, shard = make_sharded_step(
        cfg, free_slip_box_bc, (phi_init,), mesh, dtype=jnp.float64)

    ref, sh_state = state, shard(state)
    t_end = jnp.asarray(1.0)
    for _ in range(2):
        ref, _ = step1(ref, t_end)
        sh_state, _ = stepN(sh_state, t_end)

    assert np.allclose(np.asarray(sh_state.u), np.asarray(ref.u), atol=1e-10)
    assert np.allclose(np.asarray(sh_state.p), np.asarray(ref.p), atol=1e-10)
    assert np.allclose(np.asarray(sh_state.X1), np.asarray(ref.X1), atol=1e-11)
    assert np.allclose(np.asarray(sh_state.X2), np.asarray(ref.X2), atol=1e-11)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_bicubic_step_matches_single_device():
    """sl_interp='bicubic' (local shift+select Catmull-Rom) under GSPMD: the
    edge-replicating pad stencils must partition cleanly — sharded step ==
    single-device on the 8-device mesh."""
    import dataclasses

    g = Grid(Nx=64, Ny=64, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, eta_s=0.01, mu_f=0.01, rho_f=1.0,
                    rho_s=1.0, CFL=0.2, dt_min_cap=1e-3, sl_interp="bicubic")
    phi_init = _disc_phi(0.5, 0.5, 0.2)

    step1 = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    ref = state
    for _ in range(2):
        ref, _ = step1(ref, jnp.asarray(1.0))

    mesh = make_mesh(jax.devices()[:8])
    stepN, shard = make_sharded_step(cfg, free_slip_box_bc, (phi_init,), mesh,
                                     dtype=jnp.float64)
    out = shard(state)
    for _ in range(2):
        out, _ = stepN(out, jnp.asarray(1.0))

    assert np.allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-8)
    assert np.allclose(np.asarray(out.X1), np.asarray(ref.X1), atol=1e-8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_two_solid_contact_matches_single_device():
    """S=2 + pairwise contact on a (2,4) mesh: the n-solid mixture blend
    and the contact force stencils must partition correctly."""
    from jax.sharding import Mesh

    g = Grid(Nx=64, Ny=64, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=1.0, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                    k_rep=2.0, w_c_cells=3.0, num_layers=3, CFL=0.2,
                    dt_min_cap=1e-3)
    # overlapping contact bands across shard boundaries
    phi_inits = (_disc_phi(0.38, 0.5, 0.14), _disc_phi(0.66, 0.5, 0.14))

    step1 = make_step(cfg, free_slip_box_bc, phi_inits, dtype=jnp.float64)
    state = make_init_state(cfg, phi_inits, dtype=jnp.float64)
    # give the discs approach velocities so the contact force is nonzero
    X, Y = g.coords(dtype=jnp.float64)
    u0 = 0.3 * jnp.tanh((0.52 - X) * 8.0)
    state = state.__class__(u=u0, v=state.v, p=state.p, X1=state.X1,
                            X2=state.X2, t=state.t, step=state.step)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("gy", "gx"))
    stepX, shard = make_sharded_step(cfg, free_slip_box_bc, phi_inits, mesh,
                                     dtype=jnp.float64)

    ref, shx = state, shard(state)
    t_end = jnp.asarray(1.0)
    for _ in range(2):
        ref, aux_ref = step1(ref, t_end)
        shx, _ = stepX(shx, t_end)

    assert np.allclose(np.asarray(shx.u), np.asarray(ref.u), atol=1e-10)
    assert np.allclose(np.asarray(shx.p), np.asarray(ref.p), atol=1e-10)
    assert np.allclose(np.asarray(shx.X1), np.asarray(ref.X1), atol=1e-11)
    # the contact force must actually be active in this configuration
    phis = np.asarray(aux_ref["phis"])
    assert (np.abs(phis[0] - phis[1]) * 0.5 < 3 * g.dx)[
        (phis[0] <= 0) | (phis[1] <= 0)].any()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_variable_rho_matches_single_device():
    """variable_rho=True (symmetrized while-loop PCG + buoyancy body force)
    under GSPMD: sharded == single to roundoff over 3 steps."""
    g = Grid(Nx=64, Ny=64, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=1.0, rho_s=5.0, mu_f=1e-3, rho_f=1.0,
                    g_y=-1.0, variable_rho=True, cg_tol=1e-10, CFL=0.2,
                    dt_min_cap=1e-3)
    phi_init = _disc_phi(0.5, 0.55, 0.18)

    step1 = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)

    mesh = make_mesh(jax.devices()[:8])
    stepN, shard = make_sharded_step(cfg, free_slip_box_bc, (phi_init,), mesh,
                                     dtype=jnp.float64)
    ref, out = state, shard(state)
    t_end = jnp.asarray(1.0)
    for _ in range(3):
        ref, aux1 = step1(ref, t_end)
        out, auxN = stepN(out, t_end)

    assert np.allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-8)
    assert np.allclose(np.asarray(out.v), np.asarray(ref.v), atol=1e-8)
    assert np.allclose(np.asarray(out.p), np.asarray(ref.p), atol=1e-8)
    # CG observability must agree across the partitioning (same iterates)
    assert int(auxN["cg_iters"]) == int(aux1["cg_iters"])


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_long_horizon_matches_single_device():
    """12-step horizon on the (2,4) mesh: surfaces slow halo-drift /
    collective-placement bugs the 2-step pins cannot."""
    from jax.sharding import Mesh

    g = Grid(Nx=64, Ny=64, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, eta_s=0.01, mu_f=0.01, rho_f=1.0,
                    rho_s=1.0, num_layers=3, CFL=0.2, dt_min_cap=1e-3)
    phi_init = _disc_phi(0.42, 0.58, 0.2)

    step1 = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("gy", "gx"))
    stepN, shard = make_sharded_step(
        cfg, free_slip_box_bc, (phi_init,), mesh, dtype=jnp.float64)

    ref, out = state, shard(state)
    t_end = jnp.asarray(1.0)
    for _ in range(12):
        ref, _ = step1(ref, t_end)
        out, _ = stepN(out, t_end)

    assert np.allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-9)
    assert np.allclose(np.asarray(out.p), np.asarray(ref.p), atol=1e-9)
    assert np.allclose(np.asarray(out.X1), np.asarray(ref.X1), atol=1e-10)
    assert np.allclose(np.asarray(out.X2), np.asarray(ref.X2), atol=1e-10)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_periodic_step_matches_single_device():
    """The doubly-periodic step under GSPMD — the FFT solve's
    all-to-alls, the periodic wrap stencils' halo exchanges, and the
    overlap-row/col BC all partition correctly (nothing periodic was ever
    sharded before this test). Multi-step so the incremental pressure
    feedback path is exercised too."""
    from pyrmt_tpu.bcs import periodic_bc
    from pyrmt_tpu.parallel import make_mesh, make_sharded_step

    g = Grid(Nx=64, Ny=64, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_f=0.01, rho_f=1.0, bc_type="periodic",
                    CFL=0.3, dt_min_cap=1e-3)
    X, Y = g.coords(dtype=jnp.float64)
    u0 = 0.5 * jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Y)
    v0 = -0.5 * jnp.cos(2 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)

    step1 = make_step(cfg, periodic_bc, (), dtype=jnp.float64)
    ref = make_init_state(cfg, (), u0=u0, v0=v0, dtype=jnp.float64)

    mesh = make_mesh(jax.devices()[:8])
    stepN, shard = make_sharded_step(cfg, periodic_bc, (), mesh,
                                     dtype=jnp.float64)
    out = shard(ref)
    for _ in range(3):
        ref, _ = step1(ref, jnp.asarray(1.0))
        out, _ = stepN(out, jnp.asarray(1.0))
    assert np.allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-10)
    assert np.allclose(np.asarray(out.v), np.asarray(ref.v), atol=1e-10)
    assert np.allclose(np.asarray(out.p), np.asarray(ref.p), atol=1e-9)
