"""Advection schemes: accuracy on smooth profiles + banding semantics."""
import numpy as np

from pyrmt_tpu.grid import create_grid
from pyrmt_tpu.ops.advect import (
    advect_central2_rk3,
    advect_reference_map,
    advect_reference_map_multi,
    advect_semilagrangian_rk4,
    advect_weno5_rk3,
    weno5_rhs,
)


def _setup(N):
    X, Y, dx, dy = create_grid(N, N, 1.0, 1.0, dtype=np.float64)
    return np.asarray(X), np.asarray(Y), dx, dy


def test_semilagrangian_translates_gaussian():
    """Constant velocity: the semi-Lagrangian solution is the translated
    initial condition (up to bilinear smoothing)."""
    N = 129
    X, Y, dx, dy = _setup(N)
    q = np.exp(-((X - 0.4) ** 2 + (Y - 0.5) ** 2) / 0.01)
    a = np.full_like(q, 0.5)
    b = np.zeros_like(q)
    dt = 0.02
    qn = np.asarray(advect_semilagrangian_rk4(q, a, b, X, Y, dt, dx, dy))
    exact = np.exp(-((X - 0.4 - 0.5 * dt) ** 2 + (Y - 0.5) ** 2) / 0.01)
    err = np.max(np.abs(qn - exact)[5:-5, 5:-5])
    assert err < 2e-3


def test_weno5_rhs_exact_on_linear():
    """WENO5 recovers -(u*qx + v*qy) exactly for a linear field."""
    N = 65
    X, Y, dx, dy = _setup(N)
    q = 2.0 * X - 0.7 * Y
    a = 0.3 * np.ones_like(q)
    b = -0.4 * np.ones_like(q)
    phi = -np.ones_like(q)  # everywhere active
    rhs = np.asarray(weno5_rhs(q, a, b, dx, dy, phi, 0.0))
    expected = -(0.3 * 2.0 + (-0.4) * (-0.7))
    assert np.allclose(rhs[3:-3, 3:-3], expected, atol=1e-10)


def test_weno5_banding_leaves_outside_zero():
    N = 65
    X, Y, dx, dy = _setup(N)
    q = np.sin(2 * np.pi * X)
    a = np.ones_like(q)
    b = np.ones_like(q)
    phi = np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2) - 0.2
    rhs = np.asarray(weno5_rhs(q, a, b, dx, dy, phi, 0.0))
    assert np.allclose(rhs[phi > 0], 0.0)
    assert np.max(np.abs(rhs[phi <= 0])) > 0.0


def test_central2_translates_smooth_profile():
    """Many small SSP-RK3 steps of central2 track a translating Gaussian."""
    N = 129
    X, Y, dx, dy = _setup(N)
    q = np.exp(-((X - 0.4) ** 2 + (Y - 0.5) ** 2) / 0.02)
    a = np.full_like(q, 1.0)
    b = np.zeros_like(q)
    phi = -np.ones_like(q)
    dt = 0.2 * dx
    qn = q
    steps = 16
    for _ in range(steps):
        qn = advect_central2_rk3(qn, a, b, dx, dy, dt, phi, 0.0)
    qn = np.asarray(qn)
    shift = steps * dt
    exact = np.exp(-((X - 0.4 - shift) ** 2 + (Y - 0.5) ** 2) / 0.02)
    err = np.max(np.abs(qn - exact)[5:-5, 5:-5])
    assert err < 5e-3


def test_weno5_translates_smooth_profile_accurately():
    N = 129
    X, Y, dx, dy = _setup(N)
    q = np.exp(-((X - 0.4) ** 2 + (Y - 0.5) ** 2) / 0.02)
    a = np.full_like(q, 1.0)
    b = np.zeros_like(q)
    phi = -np.ones_like(q)
    dt = 0.2 * dx
    qn = q
    steps = 16
    for _ in range(steps):
        qn = advect_weno5_rk3(qn, a, b, dx, dy, dt, phi, 0.0)
    qn = np.asarray(qn)
    shift = steps * dt
    exact = np.exp(-((X - 0.4 - shift) ** 2 + (Y - 0.5) ** 2) / 0.02)
    err = np.max(np.abs(qn - exact)[5:-5, 5:-5])
    assert err < 1e-3


def test_dispatcher_multi_matches_single():
    N = 65
    X, Y, dx, dy = _setup(N)
    q1 = np.sin(2 * np.pi * X) * Y
    q2 = np.cos(np.pi * Y) * X
    a = 0.2 + 0.1 * np.sin(2 * np.pi * Y)
    b = -0.3 * np.cos(np.pi * X)
    phi = -np.ones_like(q1)
    dt = 0.3 * dx
    for scheme in ("semilagrangian", "central2", "weno5"):
        multi = np.asarray(
            advect_reference_map_multi(
                np.stack([q1, q2]), a, b, X, Y, dt, dx, dy, phi, scheme, 0.0
            )
        )
        s1 = np.asarray(
            advect_reference_map(q1, a, b, X, Y, dt, dx, dy, phi, scheme, 0.0)
        )
        s2 = np.asarray(
            advect_reference_map(q2, a, b, X, Y, dt, dx, dy, phi, scheme, 0.0)
        )
        assert np.allclose(multi[0], s1, atol=1e-13), scheme
        assert np.allclose(multi[1], s2, atol=1e-13), scheme


def test_dispatcher_unknown_scheme_raises():
    import pytest

    N = 17
    X, Y, dx, dy = _setup(N)
    q = np.zeros((N, N))
    with pytest.raises(ValueError):
        advect_reference_map(q, q, q, X, Y, 0.1, dx, dy, q, "bogus", 0.0)


def test_local_semilagrangian_matches_gather_path():
    """The gather-free local bilinear path must match the general gather
    path bit-for-tolerance when the displacement is sub-cell."""
    import jax.numpy as jnp

    from pyrmt_tpu.ops.advect import (
        advect_semilagrangian_rk4_local,
        advect_semilagrangian_rk4_multi,
    )

    N = 65
    X, Y, dx, dy = _setup(N)
    rng = np.random.default_rng(7)
    q1 = np.sin(2 * np.pi * X) * Y
    q2 = np.cos(np.pi * Y) * X**2
    a = 0.3 * np.sin(2 * np.pi * Y) + 0.1
    b = -0.25 * np.cos(np.pi * X)
    dt = 0.5 * dx  # |u| < 0.4 => displacement < 0.2 cells
    qs = jnp.stack([jnp.asarray(q1), jnp.asarray(q2)])
    ref = np.asarray(advect_semilagrangian_rk4_multi(
        qs, jnp.asarray(a), jnp.asarray(b), jnp.asarray(X), jnp.asarray(Y),
        dt, dx, dy))
    loc = np.asarray(advect_semilagrangian_rk4_local(
        qs, jnp.asarray(a), jnp.asarray(b), dt, dx, dy))
    assert np.allclose(loc, ref, atol=1e-11)


def test_local_bilinear_matches_gather_bilinear():
    """gather_bilinear_local == gather_bilinear_multi for sub-cell
    displacements, including at the domain boundary."""
    import jax.numpy as jnp

    from pyrmt_tpu.ops.interp import gather_bilinear_local, gather_bilinear_multi

    N = 33
    X, Y, dx, dy = _setup(N)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((N, N))
    sx = rng.uniform(-0.95, 0.95, (N, N))
    sy = rng.uniform(-0.95, 0.95, (N, N))
    xq = X + sx * dx
    yq = Y + sy * dy
    ref = np.asarray(gather_bilinear_multi(
        jnp.asarray(u)[None], jnp.asarray(xq), jnp.asarray(yq), dx, dy))[0]
    loc = np.asarray(gather_bilinear_local(
        jnp.asarray(u)[None], jnp.asarray(sx), jnp.asarray(sy)))[0]
    assert np.allclose(loc, ref, atol=1e-12)


def test_bicubic_gather_multi_matches_single_and_is_linear_exact():
    """gather_bicubic_multi == per-field bicubic_interpolate, and both are
    exact on linear fields (interior queries)."""
    import jax.numpy as jnp

    from pyrmt_tpu.ops.interp import bicubic_interpolate, gather_bicubic_multi

    N = 33
    X, Y, dx, dy = _setup(N)
    rng = np.random.default_rng(3)
    u0 = rng.standard_normal((N, N))
    u1 = 1.5 * X - 0.25 * Y + 0.7
    xq = np.clip(X + rng.uniform(-1.4, 1.4, (N, N)) * dx, 0.0, 1.0)
    yq = np.clip(Y + rng.uniform(-1.4, 1.4, (N, N)) * dy, 0.0, 1.0)
    us = jnp.stack([jnp.asarray(u0), jnp.asarray(u1)])
    out = np.asarray(gather_bicubic_multi(us, jnp.asarray(xq),
                                          jnp.asarray(yq), dx, dy))
    for k, u in enumerate((u0, u1)):
        single = np.asarray(bicubic_interpolate(
            jnp.asarray(u), jnp.asarray(xq), jnp.asarray(yq), dx, dy))
        assert np.allclose(out[k], single, atol=1e-13)
    # Linear exactness holds only where the full (unclamped) 4x4 stencil is
    # interior — index clamping at the edges duplicates stencil rows, exactly
    # as the reference's clamped global indices do.
    inner = (slice(3, -3), slice(3, -3))
    exact = 1.5 * xq - 0.25 * yq + 0.7
    assert np.allclose(out[1][inner], exact[inner], atol=1e-12)


def test_semilagrangian_bicubic_beats_bilinear_on_smooth_field():
    """The 'bicubic' final gather (the reference's inactive variant,
    pyRMT/functions.py:200) is more accurate than bilinear on a smooth
    profile and exact on linear fields."""
    import jax.numpy as jnp

    from pyrmt_tpu.ops.advect import advect_semilagrangian_rk4_multi

    N = 65
    X, Y, dx, dy = _setup(N)
    q = np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    a = np.full_like(q, 0.37)
    b = np.full_like(q, -0.21)
    dt = 0.4 * dx
    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(X), jnp.asarray(Y),
            dt, dx, dy)
    exact = np.sin(2 * np.pi * (X - a * dt)) * np.cos(2 * np.pi * (Y - b * dt))
    qs = jnp.asarray(q)[None]
    inner = (slice(3, -3), slice(3, -3))
    e_bil = np.max(np.abs(np.asarray(
        advect_semilagrangian_rk4_multi(qs, *args))[0] - exact)[inner])
    e_bic = np.max(np.abs(np.asarray(
        advect_semilagrangian_rk4_multi(qs, *args, interp="bicubic"))[0]
        - exact)[inner])
    assert e_bic < 0.25 * e_bil

    lin = (2.0 * jnp.asarray(X) - 0.3 * jnp.asarray(Y))[None]
    exact_lin = 2.0 * (X - a * dt) - 0.3 * (Y - b * dt)
    out_lin = np.asarray(advect_semilagrangian_rk4_multi(
        lin, *args, interp="bicubic"))[0]
    assert np.allclose(out_lin[inner], exact_lin[inner], atol=1e-11)

    import pytest

    with pytest.raises(ValueError):
        advect_semilagrangian_rk4_multi(qs, *args, interp="bogus")


def test_sim_step_sl_interp_bicubic_runs_and_differs():
    """A full FSI step with cfg.sl_interp='bicubic' compiles, stays finite,
    and actually changes the advected maps relative to bilinear."""
    import jax.numpy as jnp

    from pyrmt_tpu.bcs import make_lid_bc
    from pyrmt_tpu.grid import Grid
    from pyrmt_tpu.sim import RMTConfig, make_init_state, make_step
    import dataclasses

    g = Grid(Nx=48, Ny=48, Lx=1.0, Ly=1.0)
    cfg = RMTConfig(grid=g, mu_s=0.1, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                    num_layers=3, CFL=0.2, dt_min_cap=1e-3)
    cfg_bic = dataclasses.replace(cfg, sl_interp="bicubic")
    phi_inits = (lambda X, Y: jnp.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.25,)
    bc = make_lid_bc(1.0)
    # seed a Taylor-Green velocity so the solid actually advects within a few
    # steps (a from-rest lid flow doesn't reach the disc, and the two
    # interpolants would agree to roundoff)
    X, Y, _, _ = _setup(48)
    u0 = np.sin(np.pi * X) * np.cos(np.pi * Y)
    v0 = -np.cos(np.pi * X) * np.sin(np.pi * Y)
    state = make_init_state(cfg, phi_inits, u0=u0, v0=v0, dtype=jnp.float64)
    t_end = jnp.asarray(1.0, jnp.float64)
    s_bil, s_bic = state, state
    step_bil = make_step(cfg, bc, phi_inits, dtype=jnp.float64)
    step_bic = make_step(cfg_bic, bc, phi_inits, dtype=jnp.float64)
    for _ in range(3):
        s_bil, _ = step_bil(s_bil, t_end)
        s_bic, _ = step_bic(s_bic, t_end)
    assert np.all(np.isfinite(np.asarray(s_bic.u)))
    assert np.all(np.isfinite(np.asarray(s_bic.X1)))
    # the interpolants genuinely diverge (measured ~1.7e-6 after 3 steps)
    assert np.max(np.abs(np.asarray(s_bic.X1) - np.asarray(s_bil.X1))) > 1e-8


def test_local_bicubic_matches_gather_bicubic():
    """gather_bicubic_local == gather_bicubic_multi for sub-cell
    displacements, including at the domain boundary (where both clamp the
    4x4 stencil by edge replication)."""
    import jax.numpy as jnp

    from pyrmt_tpu.ops.interp import gather_bicubic_local, gather_bicubic_multi

    N = 33
    X, Y, dx, dy = _setup(N)
    rng = np.random.default_rng(5)
    u = rng.standard_normal((N, N))
    w = np.sin(3 * X) * np.cos(2 * Y)
    sx = rng.uniform(-0.95, 0.95, (N, N))
    sy = rng.uniform(-0.95, 0.95, (N, N))
    xq = X + sx * dx
    yq = Y + sy * dy
    us = jnp.stack([jnp.asarray(u), jnp.asarray(w)])
    ref = np.asarray(gather_bicubic_multi(
        us, jnp.asarray(xq), jnp.asarray(yq), dx, dy))
    loc = np.asarray(gather_bicubic_local(
        us, jnp.asarray(sx), jnp.asarray(sy)))
    assert np.allclose(loc, ref, atol=1e-12, rtol=0.0)


def test_local_semilagrangian_bicubic_matches_gather_path():
    """The local (shift+select) bicubic SL path == the gather bicubic path
    for sub-cell displacements."""
    import jax.numpy as jnp

    from pyrmt_tpu.ops.advect import (
        advect_semilagrangian_rk4_local,
        advect_semilagrangian_rk4_multi,
    )

    N = 65
    X, Y, dx, dy = _setup(N)
    q1 = np.sin(2 * np.pi * X) * Y
    q2 = np.cos(np.pi * Y) * X**2
    a = 0.3 * np.sin(2 * np.pi * Y) + 0.1
    b = -0.25 * np.cos(np.pi * X)
    dt = 0.5 * dx
    qs = jnp.stack([jnp.asarray(q1), jnp.asarray(q2)])
    ref = np.asarray(advect_semilagrangian_rk4_multi(
        qs, jnp.asarray(a), jnp.asarray(b), jnp.asarray(X), jnp.asarray(Y),
        dt, dx, dy, interp="bicubic"))
    loc = np.asarray(advect_semilagrangian_rk4_local(
        qs, jnp.asarray(a), jnp.asarray(b), dt, dx, dy, interp="bicubic"))
    assert np.allclose(loc, ref, atol=1e-12, rtol=0.0)


def test_bicubic_band_guard_blends_bilinear():
    """cubic_mask=False cells take the bilinear sample, True cells the
    bicubic one — on both the local (shift+select) and gather paths."""
    import jax.numpy as jnp

    from pyrmt_tpu.ops.interp import (
        gather_bicubic_local,
        gather_bicubic_multi,
        gather_bilinear_local,
        gather_bilinear_multi,
    )

    N = 32
    X, Y, dx, dy = _setup(N)
    rng = np.random.default_rng(11)
    us = jnp.asarray(rng.standard_normal((3, N, N)))
    sx = jnp.asarray(rng.uniform(-0.9, 0.9, (N, N)))
    sy = jnp.asarray(rng.uniform(-0.9, 0.9, (N, N)))
    mask = jnp.asarray(rng.uniform(size=(3, N, N)) > 0.5)

    bic = gather_bicubic_local(us, sx, sy)
    bil = gather_bilinear_local(us, sx, sy)
    hyb = gather_bicubic_local(us, sx, sy, cubic_mask=mask)
    assert np.array_equal(np.asarray(hyb),
                          np.asarray(jnp.where(mask, bic, bil)))

    xq = jnp.asarray(X) + sx * dx
    yq = jnp.asarray(Y) + sy * dy
    bic_g = gather_bicubic_multi(us, xq, yq, dx, dy)
    bil_g = gather_bilinear_multi(us, xq, yq, dx, dy)
    hyb_g = gather_bicubic_multi(us, xq, yq, dx, dy, cubic_mask=mask)
    assert np.array_equal(np.asarray(hyb_g),
                          np.asarray(jnp.where(mask, bic_g, bil_g)))


def test_sim_step_band_guard_limits():
    """The sl_band_guard limits behave as specified on a full FSI step:
    a guard wider than the domain makes the bicubic step's reference maps
    EQUAL the bilinear step's (every cell falls back), while the default
    guard differs from raw bicubic (sl_band_guard=0) only in the band."""
    import dataclasses

    import jax.numpy as jnp

    from pyrmt_tpu.bcs import make_lid_bc
    from pyrmt_tpu.grid import Grid
    from pyrmt_tpu.sim import RMTConfig, make_init_state, make_step

    N = 48
    g = Grid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
    base = RMTConfig(grid=g, mu_s=0.1, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                     num_layers=3, CFL=0.2, dt_min_cap=1e-3)
    phi_inits = (lambda X, Y: jnp.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.25,)
    bc = make_lid_bc(1.0)
    X, Y, _, _ = _setup(N)
    u0 = np.sin(np.pi * X) * np.cos(np.pi * Y)
    v0 = -np.cos(np.pi * X) * np.sin(np.pi * Y)
    t_end = jnp.asarray(1.0, jnp.float64)

    def run3(cfg):
        s = make_init_state(cfg, phi_inits, u0=u0, v0=v0, dtype=jnp.float64)
        step = make_step(cfg, bc, phi_inits, dtype=jnp.float64)
        for _ in range(3):
            s, _ = step(s, t_end)
        return s

    s_bil = run3(base)
    s_all_bil = run3(dataclasses.replace(base, sl_interp="bicubic",
                                         sl_band_guard=1e9))
    assert np.array_equal(np.asarray(s_all_bil.X1), np.asarray(s_bil.X1))
    assert np.array_equal(np.asarray(s_all_bil.X2), np.asarray(s_bil.X2))

    s_guard = run3(dataclasses.replace(base, sl_interp="bicubic"))
    s_raw = run3(dataclasses.replace(base, sl_interp="bicubic",
                                     sl_band_guard=0.0))
    d_raw = np.max(np.abs(np.asarray(s_guard.X1) - np.asarray(s_raw.X1)))
    d_bil = np.max(np.abs(np.asarray(s_guard.X1) - np.asarray(s_bil.X1)))
    assert d_raw > 0.0 and d_bil > 0.0  # guarded sits strictly between
    assert np.all(np.isfinite(np.asarray(s_guard.X1)))


def test_band_guard_local_matches_gather_path_in_step():
    """A guarded-bicubic FSI step gives the same advected maps through the
    local (shift+select) path and the general gather path (sl_local=False) —
    the guard mask is applied identically in both."""
    import dataclasses

    import jax.numpy as jnp

    from pyrmt_tpu.bcs import make_lid_bc
    from pyrmt_tpu.grid import Grid
    from pyrmt_tpu.sim import RMTConfig, make_init_state, make_step

    N = 48
    g = Grid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
    base = RMTConfig(grid=g, mu_s=0.1, rho_s=1.0, mu_f=0.01, rho_f=1.0,
                     num_layers=3, CFL=0.2, dt_min_cap=1e-3,
                     sl_interp="bicubic")
    phi_inits = (lambda X, Y: jnp.sqrt((X - 0.6) ** 2 + (Y - 0.5) ** 2) - 0.25,)
    bc = make_lid_bc(1.0)
    X, Y, _, _ = _setup(N)
    u0 = np.sin(np.pi * X) * np.cos(np.pi * Y)
    v0 = -np.cos(np.pi * X) * np.sin(np.pi * Y)
    t_end = jnp.asarray(1.0, jnp.float64)

    def run2(cfg):
        s = make_init_state(cfg, phi_inits, u0=u0, v0=v0, dtype=jnp.float64)
        step = make_step(cfg, bc, phi_inits, dtype=jnp.float64)
        for _ in range(2):
            s, _ = step(s, t_end)
        return s

    s_loc = run2(base)
    s_gat = run2(dataclasses.replace(base, sl_local=False))
    assert np.allclose(np.asarray(s_loc.X1), np.asarray(s_gat.X1),
                       atol=1e-12, rtol=0.0)
    assert np.allclose(np.asarray(s_loc.u), np.asarray(s_gat.u),
                       atol=1e-11, rtol=0.0)
