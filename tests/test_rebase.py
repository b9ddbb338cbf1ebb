"""Reference-map rebasing (RMTConfig.map_rebase_minj).

Beyond reference: the Kamrin/Nave-style periodic remapping for fluid-like
solids. The rebuild identity under rebasing, phi = phi0(xi(x)), generalizes
the reference's analytic rebuild (pyRMT/functions.py:1287-1288) to a
non-analytic, carried phi0 (SimState.phis0); the min-J trigger resets the
map to the identity against a fast-sweeping-redistanced base.
"""

import pytest

pytestmark = pytest.mark.slow  # full local tier only; fast tier = -m 'not slow'
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pyrmt_tpu.bcs import free_slip_box_bc, make_lid_bc
from pyrmt_tpu.grid import Grid
from pyrmt_tpu.sim import RMTConfig, make_init_state, make_step


def _disc_phi(x0, y0, R):
    def phi_init(Xq, Yq):
        return jnp.sqrt((Xq - x0) ** 2 + (Yq - y0) ** 2) - R

    return phi_init


def _halfplane_phi(y0):
    # LINEAR level set (solid = upper half, so un-extrapolated far-field
    # cells with map 0 rebuild to the FLUID sign phi_init(0,0) = y0 > 0):
    # bilinear sampling of the gridded phi0 reproduces the analytic
    # evaluation exactly, so a never-triggering rebasing run must match the
    # analytic-rebuild run to roundoff
    def phi_init(Xq, Yq):
        return y0 - Yq

    return phi_init


def _tg_velocity(g, dtype):
    X, Y = g.coords(dtype=dtype)
    u0 = jnp.sin(np.pi * X) * jnp.cos(np.pi * Y)
    v0 = -jnp.cos(np.pi * X) * jnp.sin(np.pi * Y)
    return 0.3 * u0, 0.3 * v0


def test_rebasing_enabled_steps_without_error():
    """The round-3 regression: enabling map_rebase_minj raised TypeError at
    trace time (rebuild_phis arity). Now it must build, step, and carry a
    seeded phis0."""
    g = Grid(Nx=48, Ny=48, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, mu_f=0.01, rho_s=1.0, rho_f=1.0,
                    CFL=0.3, map_rebase_minj=0.5)
    phi_init = _disc_phi(0.6, 0.5, 0.2)
    bc = make_lid_bc(1.0)
    step = make_step(cfg, bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    assert state.phis0.shape == (1, 48, 48)
    for _ in range(3):
        state, aux = step(state, jnp.asarray(10.0))
    assert "rebased" in aux and aux["rebased"].shape == (1,)
    assert bool(jnp.all(jnp.isfinite(state.u)))
    assert bool(jnp.all(jnp.isfinite(state.phis0)))


def test_rebasing_untriggered_matches_analytic_rebuild():
    """With a LINEAR phi_init (bilinear-exact) and a threshold that never
    fires, the rebasing step is numerically identical to the analytic
    rebuild it replaces."""
    g = Grid(Nx=48, Ny=48, Lx=1.0, Ly=1.0)
    base = RMTConfig(grid=g, mu_s=0.05, mu_f=0.01, rho_s=1.0, rho_f=1.0,
                     CFL=0.3)
    phi_init = _halfplane_phi(0.55)
    u0, v0 = _tg_velocity(g, jnp.float64)

    step_a = make_step(base, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    cfg_r = dataclasses.replace(base, map_rebase_minj=1e-9)
    step_r = make_step(cfg_r, free_slip_box_bc, (phi_init,), dtype=jnp.float64)

    sa = make_init_state(base, (phi_init,), u0=u0, v0=v0, dtype=jnp.float64)
    sr = make_init_state(cfg_r, (phi_init,), u0=u0, v0=v0, dtype=jnp.float64)
    for _ in range(8):
        sa, _ = step_a(sa, jnp.asarray(10.0))
        sr, aux = step_r(sr, jnp.asarray(10.0))
        assert not bool(jnp.any(aux["rebased"]))
    np.testing.assert_allclose(np.asarray(sr.u), np.asarray(sa.u), atol=1e-12)
    np.testing.assert_allclose(np.asarray(sr.X1), np.asarray(sa.X1),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(sr.p), np.asarray(sa.p), atol=1e-11)


def test_rebase_trigger_resets_map_and_preserves_interface():
    """Force a trigger (threshold above the resting J ~= 1): the stored maps
    reset to the extrapolated identity, phis0 becomes the redistanced current
    level set (|grad phi0| ~= 1 near the front), and the zero set moves by
    less than a cell."""
    g = Grid(Nx=64, Ny=64, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.05, mu_f=0.01, rho_s=1.0, rho_f=1.0,
                    CFL=0.3, map_rebase_minj=10.0)  # always fires
    phi_init = _disc_phi(0.5, 0.5, 0.22)
    u0, v0 = _tg_velocity(g, jnp.float64)
    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    state = make_init_state(cfg, (phi_init,), u0=u0, v0=v0,
                            dtype=jnp.float64)

    X, Y = g.coords(dtype=jnp.float64)
    prev_phis = None
    for _ in range(4):
        prev_state = state
        state, aux = step(state, jnp.asarray(10.0))
        assert bool(jnp.all(aux["rebased"]))
        phi0 = np.asarray(state.phis0[0])
        # identity reset inside the new solid (off the boundary ring the
        # extrapolation treats as unknown-capable)
        inside = (phi0 <= 0.0)
        inside[:1] = inside[-1:] = False
        inside[:, :1] = inside[:, -1:] = False
        np.testing.assert_allclose(np.asarray(state.X1[0])[inside],
                                   np.asarray(X)[inside], atol=1e-12)
        np.testing.assert_allclose(np.asarray(state.X2[0])[inside],
                                   np.asarray(Y)[inside], atol=1e-12)
        # redistanced base: |grad phi0| ~ 1 in a band near the front (the
        # frozen frontier ring |phi0| < dx keeps first-order interpolated
        # distances with a kink across the interface — exclude it)
        gx, gy_ = np.gradient(phi0, g.dy, g.dx)
        band = (np.abs(phi0) < 4 * g.dx) & (np.abs(phi0) > g.dx)
        band[:2] = band[-2:] = False
        band[:, :2] = band[:, -2:] = False
        gm = np.hypot(gx, gy_)[band]
        assert np.all(np.abs(gm - 1.0) < 0.1)
        # the rebase must not move the interface: the redistanced phi0 and
        # the step's own rebuilt phi share a zero set to sub-cell accuracy
        phis = np.asarray(aux["phis"][0])
        sign_flip = (phi0 <= 0) != (phis <= 0)
        assert np.all(np.abs(phis[sign_flip]) < g.dx)
        if prev_phis is not None:
            # and the interface advances continuously across rebases
            flip2 = (phis <= 0) != (prev_phis <= 0)
            assert np.all(np.abs(prev_phis[flip2]) < 2 * g.dx)
        prev_phis = phis
        del prev_state


def test_rebase_checkpoint_roundtrip(tmp_path):
    from pyrmt_tpu.io import load_checkpoint, save_checkpoint

    g = Grid(Nx=32, Ny=32, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, mu_f=0.01, CFL=0.3,
                    map_rebase_minj=0.5)
    phi_init = _disc_phi(0.5, 0.5, 0.2)
    state = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state)
    state2 = load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(state2.phis0),
                                  np.asarray(state.phis0))
    # and a step from the restored state works
    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    out, _ = step(state2, jnp.asarray(10.0))
    assert bool(jnp.all(jnp.isfinite(out.u)))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_rebasing_matches_single_device():
    """Rebasing under GSPMD: the min-J reduction, lax.cond, fast-sweeping
    redistance, and identity re-extrapolation all partition correctly. The
    always-fire threshold exercises the TRUE branch on every step."""
    from pyrmt_tpu.parallel import make_mesh, make_sharded_step

    g = Grid(Nx=64, Ny=64, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.05, mu_f=0.01, rho_s=1.0, rho_f=1.0,
                    CFL=0.3, map_rebase_minj=10.0)
    phi_init = _disc_phi(0.5, 0.5, 0.22)
    u0, v0 = _tg_velocity(g, jnp.float64)

    step1 = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    ref = make_init_state(cfg, (phi_init,), u0=u0, v0=v0, dtype=jnp.float64)

    mesh = make_mesh(jax.devices()[:8])
    stepN, shard = make_sharded_step(cfg, free_slip_box_bc, (phi_init,),
                                     mesh, dtype=jnp.float64)
    out = shard(ref)
    for _ in range(3):
        ref, _ = step1(ref, jnp.asarray(10.0))
        out, auxN = stepN(out, jnp.asarray(10.0))
        assert bool(jnp.all(auxN["rebased"]))
    assert np.allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-8)
    assert np.allclose(np.asarray(out.X1), np.asarray(ref.X1), atol=1e-8)
    assert np.allclose(np.asarray(out.phis0), np.asarray(ref.phis0),
                       atol=1e-8)


def test_rebuild_modes_match_cond_dispatch():
    """Round 5: the explicit rebuild modes ('analytic'/'sampled',
    RMTConfig.map_rebase_rebuild — the two executables of
    make_rebase_runner) are each BITWISE the in-graph 'cond' dispatch in
    their own phase: 'analytic' while no rebase has fired, 'sampled' once
    every solid has rebased."""
    g = Grid(Nx=48, Ny=48, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.05, mu_f=0.01, rho_s=1.0, rho_f=1.0,
                    CFL=0.3, map_rebase_minj=0.5)
    phi_init = _disc_phi(0.5, 0.5, 0.22)
    u0, v0 = _tg_velocity(g, jnp.float64)
    t_end = jnp.asarray(10.0)

    def steps(cfg_m, state, n):
        step = make_step(cfg_m, free_slip_box_bc, (phi_init,),
                         dtype=jnp.float64)
        for _ in range(n):
            state, aux = step(state, t_end)
        return state, aux

    # pre-rebase phase: 'analytic' == 'cond' bitwise (trigger never fires)
    s0 = make_init_state(cfg, (phi_init,), u0=u0, v0=v0, dtype=jnp.float64)
    sc, auxc = steps(cfg, s0, 3)
    sa, auxa = steps(dataclasses.replace(cfg, map_rebase_rebuild="analytic"),
                     s0, 3)
    assert not bool(jnp.any(auxc["rebased"]))
    for name in ("u", "v", "p", "X1", "X2", "phis0"):
        np.testing.assert_array_equal(np.asarray(getattr(sc, name)),
                                      np.asarray(getattr(sa, name)),
                                      err_msg=f"analytic {name}")

    # force a rebase (always-fire threshold, one step), then the post
    # phase: 'sampled' == 'cond' bitwise
    fire = dataclasses.replace(cfg, map_rebase_minj=10.0)
    s1, aux1 = steps(fire, s0, 1)
    assert bool(jnp.all(aux1["rebased"]))
    sc2, _ = steps(cfg, s1, 3)
    ss2, _ = steps(dataclasses.replace(cfg, map_rebase_rebuild="sampled"),
                   s1, 3)
    for name in ("u", "v", "p", "X1", "X2", "phis0"):
        np.testing.assert_array_equal(np.asarray(getattr(sc2, name)),
                                      np.asarray(getattr(ss2, name)),
                                      err_msg=f"sampled {name}")

    with pytest.raises(ValueError, match="map_rebase_rebuild"):
        steps(dataclasses.replace(cfg, map_rebase_rebuild="bogus"), s0, 1)


def test_rebase_runner_matches_cond_path_at_step_chunks():
    """make_rebase_runner with 1-step chunks matches the in-graph 'cond'
    path across a firing trigger to roundoff (different executables, so
    fusion order may differ by 1 ulp): the rebuild-source switch happens at
    the same step boundary the cond would take it (the rebase lands AFTER
    the firing step's physics, so the pre executable covers that step
    exactly and the post executable takes over from the next)."""
    from pyrmt_tpu.sim import make_rebase_runner

    g = Grid(Nx=48, Ny=48, Lx=1.0, Ly=1.0)
    # always-fire threshold => the first step rebases; steps 2.. sample
    cfg = RMTConfig(grid=g, mu_s=0.05, mu_f=0.01, rho_s=1.0, rho_f=1.0,
                    CFL=0.3, map_rebase_minj=10.0)
    phi_init = _disc_phi(0.5, 0.5, 0.22)
    u0, v0 = _tg_velocity(g, jnp.float64)
    t_end = jnp.asarray(10.0)

    s_cond = make_init_state(cfg, (phi_init,), u0=u0, v0=v0,
                             dtype=jnp.float64)
    s_run = s_cond
    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    run = make_rebase_runner(cfg, free_slip_box_bc, (phi_init,), 1,
                             dtype=jnp.float64)
    for k in range(4):
        s_cond, _ = step(s_cond, t_end)
        s_run, _ = run(s_run, t_end)
    for name in ("u", "v", "p", "X1", "X2", "phis0", "t"):
        np.testing.assert_allclose(np.asarray(getattr(s_cond, name)),
                                   np.asarray(getattr(s_run, name)),
                                   rtol=0, atol=1e-13, err_msg=name)

    with pytest.raises(ValueError, match="map_rebase_minj"):
        make_rebase_runner(dataclasses.replace(cfg, map_rebase_minj=0.0),
                           free_slip_box_bc, (phi_init,), 1,
                           dtype=jnp.float64)
