"""Area-conserving level-set shift (ops/levelset.py:area_conserving_shift)
and the phi_area_fix config wiring.

Beyond-reference robustness feature: the long-horizon coupled capillary
probes pinned that case's eventual divergence to slow advection-error area
inflation (benchmarks/README.md) — the standard level-set remedy is a
global constant shift solved against the t=0 area (cf. Sussman-Fatemi's
volume constraint). These tests pin the Newton solve and the in-sim
invariant (smoothed area constant to roundoff over many steps).
"""
import numpy as np

import jax.numpy as jnp

from pyrmt_tpu.grid import create_grid
from pyrmt_tpu.ops.levelset import area_conserving_shift, smoothed_solid_area


def _grid(N):
    X, Y, dx, dy = create_grid(N, N, 1.0, 1.0, dtype=np.float64)
    return jnp.asarray(X), jnp.asarray(Y), dx, dy


def test_shift_restores_constant_inflation():
    """A constant inflation/deflation of phi is undone exactly (the shift is
    the inverse operation); 2 Newton steps reach ~1e-7 relative."""
    N = 96
    X, Y, dx, dy = _grid(N)
    w_t = 2.0 * dx
    for a, b in ((0.25, 0.25), (0.3, 0.18)):   # circle, ellipse
        phi = jnp.sqrt(((X - 0.5) / a) ** 2 + ((Y - 0.5) / b) ** 2) - 1.0
        phi = phi * min(a, b)                   # quasi-SDF scaling
        A0 = float(smoothed_solid_area(phi, dx, dy, w_t))
        for c_true in (0.7 * dx, -0.4 * dx):
            phi_d = phi + c_true
            fixed = area_conserving_shift(phi_d, dx, dy, w_t, A0)
            A = float(smoothed_solid_area(fixed, dx, dy, w_t))
            assert abs(A - A0) / A0 < 1e-6
            # the recovered shift is the constant we applied
            assert abs(float(jnp.mean(fixed - phi_d)) + c_true) < 1e-6


def test_shift_noop_without_interface():
    """With no zero set the smoothed delta integral vanishes and the guard
    must return phi unchanged instead of dividing by noise."""
    N = 48
    X, Y, dx, dy = _grid(N)
    phi = jnp.full((N, N), 0.5)
    fixed = area_conserving_shift(phi, dx, dy, 2.0 * dx, 0.05)
    assert np.array_equal(np.asarray(fixed), np.asarray(phi))


def test_step_pins_area_and_gates_fusion():
    """phi_area_fix=True: the aux level set's smoothed area equals the t=0
    target to f64 roundoff across steps of a coupled surface-tension run
    (the shift is reapplied after the post-advection rebuild)."""
    from pyrmt_tpu.bcs import free_slip_box_bc
    from pyrmt_tpu.grid import Grid
    from pyrmt_tpu.sim import RMTConfig, make_init_state, make_step

    g = Grid(Nx=48, Ny=48, Lx=1.0, Ly=1.0)

    def phi_init(X1, X2):
        return jnp.hypot((X1 - 0.5) / 1.15, (X2 - 0.5) * 1.15) - 0.2

    cfg = RMTConfig(grid=g, mu_s=1e-3, mu_f=1e-3, gamma=0.1,
                    w_t_cells=2.0, CFL=0.4, dt_min_cap=1e-3,
                    st_method="balanced", phi_area_fix=True)

    step = make_step(cfg, free_slip_box_bc, (phi_init,), dtype=jnp.float64)
    s = make_init_state(cfg, (phi_init,), dtype=jnp.float64)
    A0 = float(smoothed_solid_area(
        phi_init(*g.coords(jnp.float64)), g.dx, g.dy, cfg.w_t))
    for _ in range(25):
        s, aux = step(s, jnp.asarray(9.9))
    A = float(smoothed_solid_area(aux["phis"][0], g.dx, g.dy, cfg.w_t))
    assert abs(A - A0) / A0 < 1e-12
    assert bool(jnp.all(jnp.isfinite(s.u)) & jnp.all(jnp.isfinite(s.p)))
