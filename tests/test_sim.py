"""End-to-end sim tests: pure-fluid + FSI step, checkpoint/resume, divergence
predicate, narrow-band check."""

import pytest

pytestmark = pytest.mark.slow  # full local tier only; fast tier = -m 'not slow'
import numpy as np
import pytest

import jax.numpy as jnp

from pyrmt_tpu.bcs import free_slip_box_bc, make_lid_bc
from pyrmt_tpu.grid import Grid
from pyrmt_tpu.sim import (
    RMTConfig,
    check_narrow_band,
    diverged,
    make_init_state,
    make_step,
)


def _disc_phi(x0, y0, R):
    def phi_init(Xq, Yq):
        return jnp.sqrt((Xq - x0) ** 2 + (Yq - y0) ** 2) - R

    return phi_init


def test_pure_fluid_step_advances_time_and_stays_finite():
    g = Grid(Nx=33, Ny=33, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_f=0.01, rho_f=1.0, CFL=0.2, dt_min_cap=1e-2)
    bc = make_lid_bc(1.0)
    step = make_step(cfg, bc, (), dtype=jnp.float64)
    state = make_init_state(cfg, (), dtype=jnp.float64)
    s2, aux = step(state, jnp.asarray(10.0))
    assert float(s2.t) > 0
    assert int(s2.step) == 1
    assert not bool(diverged(s2))
    # lid BC active after the step
    assert np.allclose(np.asarray(s2.u)[-1, 1:-1], 1.0)


def test_fsi_step_mass_and_reference_map_sane():
    g = Grid(Nx=49, Ny=49, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, eta_s=0.01, mu_f=0.01, rho_f=1.0,
                    rho_s=1.0, CFL=0.2, dt_min_cap=1e-3)
    phi_init = _disc_phi(0.5, 0.5, 0.2)
    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    area0 = float(jnp.sum(phi_init(state.X1[0], state.X2[0]) <= 0))
    for _ in range(5):
        state, aux = step(state, jnp.asarray(10.0))
    assert not bool(diverged(state))
    area1 = float(jnp.sum(aux["phis"][0] <= 0))
    # solid area approximately conserved over a few steps at rest
    assert abs(area1 - area0) / area0 < 0.05
    # J stays ~1 for a solid at rest
    assert abs(float(aux["J"].min()) - 1.0) < 0.05


def test_dt_clips_to_t_end():
    g = Grid(Nx=33, Ny=33, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_f=0.01, rho_f=1.0, CFL=0.2, dt_min_cap=1e-2)
    step = make_step(cfg, make_lid_bc(1.0), (), dtype=jnp.float64)
    state = make_init_state(cfg, (), dtype=jnp.float64)
    t_end = jnp.asarray(1e-5)
    s2, aux = step(state, t_end)
    assert float(s2.t) <= 1e-5 + 1e-12
    s3, aux = step(s2, t_end)
    assert abs(float(s3.t) - 1e-5) < 1e-12  # dt clamps to 0 at t_end


def test_diverged_predicate():
    g = Grid(Nx=17, Ny=17, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_f=0.01, rho_f=1.0)
    state = make_init_state(cfg, (), dtype=jnp.float64)
    assert not bool(diverged(state))
    bad = type(state)(u=state.u.at[3, 3].set(jnp.nan), v=state.v, p=state.p,
                      X1=state.X1, X2=state.X2, t=state.t, step=state.step)
    assert bool(diverged(bad))
    big = type(state)(u=state.u.at[3, 3].set(1e4), v=state.v, p=state.p,
                      X1=state.X1, X2=state.X2, t=state.t, step=state.step)
    assert bool(diverged(big))


def test_narrow_band_check_raises():
    with pytest.raises(ValueError):
        check_narrow_band(w_t=4 * 0.01, dx=0.01, num_layers=3)
    assert check_narrow_band(w_t=2 * 0.01, dx=0.01, num_layers=3) == 3


def test_checkpoint_roundtrip(tmp_path):
    from pyrmt_tpu.io import load_checkpoint, save_checkpoint

    g = Grid(Nx=33, Ny=33, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, mu_f=0.01)
    phi_init = _disc_phi(0.5, 0.5, 0.2)
    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    state, _ = step(state, jnp.asarray(10.0))

    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state)
    restored = load_checkpoint(path)
    for k in ("u", "v", "p", "X1", "X2"):
        assert np.array_equal(np.asarray(getattr(state, k)),
                              np.asarray(getattr(restored, k))), k

    # resume: stepping the restored state matches stepping the original
    s_a, _ = step(state, jnp.asarray(10.0))
    s_b, _ = step(restored, jnp.asarray(10.0))
    assert np.allclose(np.asarray(s_a.u), np.asarray(s_b.u), atol=0)


def test_snapshot_roundtrip(tmp_path):
    from pyrmt_tpu.io import load_snapshot, save_snapshot

    f = {"a": np.arange(6.0).reshape(2, 3), "b": np.ones((4,))}
    path = save_snapshot(str(tmp_path / "snap.h5"), f, attrs={"time": 1.5})
    fields, attrs = load_snapshot(path)
    assert np.array_equal(fields["a"], f["a"])
    assert abs(attrs["time"] - 1.5) < 1e-15


def test_variable_density_fsi_step():
    """rho_s != rho_f exercises the matrix-free CG projection inside the
    full FSI step (static variable_rho dispatch)."""
    g = Grid(Nx=49, Ny=49, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, mu_f=0.01, rho_f=1.0, rho_s=2.0,
                    variable_rho=True, CFL=0.2, dt_min_cap=1e-3,
                    cg_tol=1e-8, cg_maxiter=100)
    phi_init = _disc_phi(0.5, 0.5, 0.2)
    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    for _ in range(3):
        state, aux = step(state, jnp.asarray(10.0))
    assert not bool(diverged(state))
    # mixture density spans [rho_f, rho_s]
    rho = np.asarray(aux["rho_local"])
    assert rho.min() > 0.99 and rho.max() > 1.5


def test_weno5_fsi_step_runs():
    """The Eulerian WENO5 advection path works inside the full step."""
    g = Grid(Nx=49, Ny=49, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, mu_f=0.01, scheme="weno5", w_cut=0.0,
                    CFL=0.2, dt_min_cap=1e-3)
    phi_init = _disc_phi(0.5, 0.5, 0.2)
    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    for _ in range(3):
        state, aux = step(state, jnp.asarray(10.0))
    assert not bool(diverged(state))


def test_periodic_fsi_step_runs():
    """bc_type='periodic' uses the FFT projection inside the full step."""
    from pyrmt_tpu.bcs import periodic_bc

    g = Grid(Nx=48, Ny=48, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, mu_f=0.01, bc_type="periodic",
                    CFL=0.2, dt_min_cap=1e-3)
    phi_init = _disc_phi(0.5, 0.5, 0.15)
    step = make_step(cfg, periodic_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    for _ in range(3):
        state, aux = step(state, jnp.asarray(10.0))
    assert not bool(diverged(state))


def test_steps_past_t_end_are_noops_not_nans():
    """Scanned chunks may overrun t_end; overrun steps must freeze the state
    (found live: the projection divided by the clamped dt=0 -> NaN)."""
    g = Grid(Nx=33, Ny=33, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, mu_f=0.01, CFL=0.2, dt_min_cap=1e-3)
    phi_init = _disc_phi(0.5, 0.5, 0.2)
    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    t_end = jnp.asarray(2.5e-3)
    for _ in range(6):  # overruns t_end after 3 steps
        state, aux = step(state, t_end)
    assert not bool(diverged(state))
    assert abs(float(state.t) - 2.5e-3) < 1e-15
    assert int(state.step) == 3
    assert float(aux["dt"]) == 0.0
    assert np.all(np.isfinite(np.asarray(aux["phis"])))
    assert np.all(np.isfinite(np.asarray(aux["J"])))


def test_unknown_method_configs_raise():
    """Bogus dct/extrap method strings fail loudly at trace time
    (same contract as the reference's unknown-scheme ValueError)."""
    import dataclasses

    import pytest

    from pyrmt_tpu.bcs import make_lid_bc
    from pyrmt_tpu.grid import Grid
    from pyrmt_tpu.sim import RMTConfig, make_step

    g = Grid(Nx=17, Ny=17, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_f=0.01, rho_f=1.0)
    bc = make_lid_bc(1.0)
    for field in ("dct_method", "extrap_method"):
        bad = dataclasses.replace(cfg, **{field: "bogus"})
        with pytest.raises(ValueError):
            make_step(bad, bc, ())


def test_fixed_dt_overrides_adaptive_constraints():
    """``fixed_dt`` must step with EXACTLY the requested dt even when an
    adaptive constraint would bind below it (found live: at N=1024 the
    viscous constraint CFL*dx^2/(4 mu_f) silently bound below a convergence
    study's intended fixed dt=1e-4 and the finest leg stopped at t=0.119
    instead of t_end=0.25)."""
    g = Grid(Nx=33, Ny=33, Lx=1.0, Ly=1.0)
    # mu_f large enough that dt_visc = CFL*rho*dx^2/(4 mu_f) ~ 1.2e-5 << dt
    base = dict(grid=g, mu_s=0.1, mu_f=4.0, rho_f=1.0, CFL=0.2,
                dt_min_cap=1e-3)
    phi_init = _disc_phi(0.5, 0.5, 0.2)
    t_end = jnp.asarray(10.0)

    cfg_adapt = RMTConfig(**base)
    step = make_step(cfg_adapt, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg_adapt, (phi_init,), dtype=jnp.float64)
    state, aux = step(state, t_end)
    assert float(aux["dt"]) < 5e-5  # the viscous constraint binds...

    cfg_fixed = RMTConfig(**base, fixed_dt=1e-4)
    step = make_step(cfg_fixed, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg_fixed, (phi_init,), dtype=jnp.float64)
    for _ in range(3):
        state, aux = step(state, t_end)
    assert float(aux["dt"]) == 1e-4  # ...and fixed_dt overrides it
    assert abs(float(state.t) - 3e-4) < 1e-15


def test_stress_band_underlayered_warns():
    """Band mode below the measured stability bound num_layers >=
    ceil(w_t/dx)+2 must warn (benchmarks/README.md: num_layers=3 blows up
    on soft-disc-in-lid; 4+ is stable)."""
    import warnings

    g = Grid(Nx=32, Ny=32, Lx=1.0, Ly=1.0)
    phi_init = _disc_phi(0.5, 0.5, 0.2)
    base = dict(grid=g, mu_s=0.1, mu_f=0.01, rho_f=1.0, w_t_cells=2.0,
                stress_band=True)

    with pytest.warns(UserWarning, match="outermost extrapolation ring"):
        make_step(RMTConfig(**base, num_layers=3), free_slip_box_bc,
                  (phi_init,), dtype=jnp.float64)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_step(RMTConfig(**base, num_layers=4), free_slip_box_bc,
                  (phi_init,), dtype=jnp.float64)


def test_gravity_pure_fluid_stays_at_rest():
    """With the buoyancy formulation (rho_local - rho_f) * g, a pure fluid
    under gravity is exactly force-free: the state must not move."""
    g = Grid(Nx=33, Ny=33, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_f=0.01, rho_f=1.0, g_y=-1.0, CFL=0.2,
                    dt_min_cap=1e-3)
    step = make_step(cfg, free_slip_box_bc, (), dtype=jnp.float64)
    state = make_init_state(cfg, (), dtype=jnp.float64)
    for _ in range(3):
        state, _ = step(state, jnp.asarray(10.0))
    assert float(jnp.max(jnp.abs(state.u))) == 0.0
    assert float(jnp.max(jnp.abs(state.v))) == 0.0


@pytest.mark.parametrize("rho_s,sign", [(5.0, -1.0), (0.2, +1.0)])
def test_gravity_buoyancy_direction(rho_s, sign):
    """A heavy disc sinks, a light disc rises — solid-averaged vertical
    velocity takes the buoyancy sign within a few steps (variable-rho CG
    projection end-to-end)."""
    g = Grid(Nx=48, Ny=48, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=1.0, rho_s=rho_s, mu_f=1e-3, rho_f=1.0,
                    g_y=-1.0, variable_rho=True, CFL=0.2, dt_min_cap=1e-3,
                    cg_tol=1e-8)
    phi_init = _disc_phi(0.5, 0.5, 0.15)
    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    aux = None
    for _ in range(5):
        state, aux = step(state, jnp.asarray(10.0))
    assert not bool(diverged(state))
    w = (aux["phis"][0] <= 0.0).astype(jnp.float64)
    vbar = float(jnp.sum(w * state.v) / jnp.sum(w))
    assert sign * vbar > 1e-5
    # the counted CG ran and converged (aux observability contract)
    assert 0 < int(aux["cg_iters"]) < 100
    assert float(aux["cg_relres"]) <= cfg.cg_tol


def test_balanced_csf_composes_with_variable_rho():
    """Rising light drop WITH surface tension: st_method='balanced' and
    variable_rho=True together (the face capillary forces enter the
    Rhie-Chow corrector whose face coefficients are the variable dt/rho) —
    the two-phase composition the classic rising-bubble benchmarks use."""
    g = Grid(Nx=48, Ny=48, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=1e-3, rho_s=0.2, mu_f=5e-3, rho_f=1.0,
                    g_y=-1.0, gamma=0.05, st_method="balanced",
                    st_kappa_interface=True, variable_rho=True, CFL=0.2,
                    dt_min_cap=1e-3, cg_tol=1e-8)
    phi_init = _disc_phi(0.5, 0.4, 0.15)
    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    aux = None
    for _ in range(5):
        state, aux = step(state, jnp.asarray(10.0))
    assert not bool(diverged(state))
    w = (aux["phis"][0] <= 0.0).astype(jnp.float64)
    vbar = float(jnp.sum(w * state.v) / jnp.sum(w))
    assert vbar > 1e-6                      # light drop rises
    assert 0 < int(aux["cg_iters"]) < 100   # PCG healthy with st_faces on
    assert float(aux["cg_relres"]) <= cfg.cg_tol
