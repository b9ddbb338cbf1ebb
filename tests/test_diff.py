"""Differentiability & batching of the FSI step (BEYOND REFERENCE).

The upstream NumPy/Numba stack (pyRMT/functions.py) has no gradient or
batching story; here the whole jitted step composes with jax.grad and
jax.vmap on the XLA compute paths. These tests pin:

  * reverse-mode gradients through a multi-step rollout match central
    finite differences — w.r.t. a PHYSICS scalar (mu_s, threaded through
    dataclasses.replace into a re-traced make_step) and w.r.t. the initial
    condition (velocity amplitude),
  * make_rollout's remat wrapper is forward-bitwise vs make_run_chunk and
    gradient-identical to the non-remat rollout,
  * jax.vmap over a batch of SimStates reproduces sequential runs
    (ensemble parameter sweeps in ONE compiled program).

All on the CPU/f64 backend (conftest). make_diff_step (custom VJP with
input-only residuals) is pinned below against make_rollout's gradients.
"""

import pytest

pytestmark = pytest.mark.slow  # full local tier only; fast tier = -m 'not slow'
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyrmt_tpu import (
    Grid,
    RMTConfig,
    free_slip_box_bc,
    make_diff_rollout,
    make_diff_step,
    make_init_state,
    make_rollout,
    make_run_chunk,
    make_step,
)

N = 32
G = Grid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
N_STEPS = 6
T_END = 1.0  # far beyond n_steps * dt: dt stays == fixed_dt throughout


def phi_disc(X1, X2):
    return jnp.sqrt((X1 - 0.5) ** 2 + (X2 - 0.5) ** 2) - 0.2


def base_cfg(**over):
    kw = dict(
        grid=G, mu_s=0.3, kappa=0.0, eta_s=0.0, rho_s=1.0, mu_f=0.02,
        rho_f=1.0, fixed_dt=2.0e-3,
        extrap_method="xla", dct_method="fft",
    )
    kw.update(over)
    return RMTConfig(**kw)


def tg_velocity(amp):
    X, Y = G.coords(jnp.float64)
    u = amp * jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Y)
    v = -amp * jnp.cos(2 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)
    return u, v


def final_energy(state):
    return jnp.sum(state.u**2 + state.v**2) + jnp.sum(state.p**2)


def test_grad_wrt_mu_s_matches_finite_difference():
    """d(loss)/d(mu_s) through 6 full FSI steps vs central differences.

    mu_s is a static RMTConfig field; differentiating it works by
    rebuilding the step INSIDE the traced function via dataclasses.replace
    — the scalar enters the graph multiplicatively (ops/stress.py:118-120,
    compute_timestep bypassed by fixed_dt), so a tracer works wherever a
    Python float does.
    """
    cfg0 = base_cfg()
    bc = free_slip_box_bc
    u0, v0 = tg_velocity(0.5)
    state0 = make_init_state(cfg0, (phi_disc,), u0=u0, v0=v0,
                             dtype=jnp.float64)

    def loss(mu_s):
        cfg = dataclasses.replace(cfg0, mu_s=mu_s)
        step = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64)
        roll = make_rollout(step, N_STEPS, remat=True)
        return final_energy(roll(state0, T_END))

    loss_j = jax.jit(loss)  # ONE compile; FD evals reuse it
    mu = 0.3
    g = float(jax.grad(loss)(mu))
    h = 1e-4
    fd = (float(loss_j(mu + h)) - float(loss_j(mu - h))) / (2 * h)
    assert np.isfinite(g) and abs(fd) > 0.0
    assert abs(g - fd) <= 1e-5 * max(1.0, abs(fd)), (g, fd)


def test_grad_wrt_initial_velocity_matches_finite_difference():
    cfg = base_cfg()
    bc = free_slip_box_bc
    step = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64)
    roll = make_rollout(step, N_STEPS, remat=True)

    def loss(amp):
        u0, v0 = tg_velocity(amp)
        state0 = make_init_state(cfg, (phi_disc,), u0=u0, v0=v0,
                                 dtype=jnp.float64)
        return final_energy(roll(state0, T_END))

    loss_j = jax.jit(loss)
    amp = 0.5
    g = float(jax.grad(loss)(amp))
    h = 1e-5
    fd = (float(loss_j(amp + h)) - float(loss_j(amp - h))) / (2 * h)
    assert abs(g - fd) <= 1e-6 * max(1.0, abs(fd)), (g, fd)


def test_rollout_forward_matches_run_chunk_and_remat_grads_agree():
    cfg = base_cfg()
    bc = free_slip_box_bc
    u0, v0 = tg_velocity(0.5)
    state0 = make_init_state(cfg, (phi_disc,), u0=u0, v0=v0,
                             dtype=jnp.float64)
    step = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64)

    # forward parity: remat changes only what the backward pass saves
    chunk = make_run_chunk(step, N_STEPS)
    ref_state, _ = chunk(state0, T_END)
    out = make_rollout(step, N_STEPS, remat=True)(state0, T_END)
    for name in ("u", "v", "p", "X1", "X2", "t"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out, name)),
            np.asarray(getattr(ref_state, name)), err_msg=name)

    # gradient parity: remat vs plain reverse-mode
    def make_loss(remat):
        roll = make_rollout(step, N_STEPS, remat=remat)

        def loss(amp):
            s0 = dataclasses.replace(state0, u=state0.u * amp,
                                     v=state0.v * amp)
            return final_energy(roll(s0, T_END))

        return loss

    g_remat = float(jax.grad(make_loss(True))(1.0))
    g_plain = float(jax.grad(make_loss(False))(1.0))
    assert abs(g_remat - g_plain) <= 1e-10 * max(1.0, abs(g_plain))


def test_vmap_ensemble_matches_sequential():
    """An ensemble of initial conditions runs as ONE batched program."""
    cfg = base_cfg()
    bc = free_slip_box_bc
    step = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64)
    roll = make_rollout(step, N_STEPS, remat=False)

    amps = [0.3, 0.5, 0.7]
    states = []
    for a in amps:
        u0, v0 = tg_velocity(a)
        states.append(make_init_state(cfg, (phi_disc,), u0=u0, v0=v0,
                                      dtype=jnp.float64))
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)

    out_b = jax.vmap(roll, in_axes=(0, None))(batched, T_END)
    for i, s0 in enumerate(states):
        out_i = roll(s0, T_END)
        for name in ("u", "v", "p", "X1", "X2"):
            np.testing.assert_allclose(
                np.asarray(jax.tree_util.tree_map(lambda x: x[i], out_b.__dict__[name])),
                np.asarray(getattr(out_i, name)),
                rtol=0, atol=1e-12, err_msg=f"amp={amps[i]} field={name}")


# ---------------------------------------------------------------------------
# make_diff_step: custom VJP with input-only residuals (diff.py)
# ---------------------------------------------------------------------------

def test_diff_step_forward_matches_step_and_grad_matches_rollout():
    """dstep's forward IS the step (bitwise); its reverse-mode gradient
    through a rollout matches make_rollout's gradient and central finite
    differences."""
    n_steps = 4
    cfg = base_cfg()
    bc = free_slip_box_bc
    u0, v0 = tg_velocity(0.5)
    state0 = make_init_state(cfg, (phi_disc,), u0=u0, v0=v0,
                             dtype=jnp.float64)

    dstep = make_diff_step(cfg, bc, (phi_disc,), dtype=jnp.float64)
    step = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64)

    out_d = dstep(state0, T_END)
    out_s, _ = step(state0, T_END)
    for name in ("u", "v", "p", "X1", "X2", "t"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out_d, name)),
            np.asarray(getattr(out_s, name)), err_msg=name)

    droll = make_diff_rollout(dstep, n_steps)

    def diff_loss(amp):
        s0 = dataclasses.replace(state0, u=state0.u * amp,
                                 v=state0.v * amp)
        return final_energy(droll(s0, T_END))

    roll = make_rollout(step, n_steps, remat=True)

    def roll_loss(amp):
        s0 = dataclasses.replace(state0, u=state0.u * amp,
                                 v=state0.v * amp)
        return final_energy(roll(s0, T_END))

    g_diff = float(jax.grad(diff_loss)(1.0))
    g_roll = float(jax.grad(roll_loss)(1.0))
    assert abs(g_diff - g_roll) <= 1e-8 * max(1.0, abs(g_roll)), (g_diff,
                                                                  g_roll)

    loss_j = jax.jit(diff_loss)
    h = 1e-5
    fd = (float(loss_j(1.0 + h)) - float(loss_j(1.0 - h))) / (2 * h)
    assert abs(g_diff - fd) <= 1e-6 * max(1.0, abs(fd)), (g_diff, fd)


# ---------------------------------------------------------------------------
# Variable-density differentiability: implicit-adjoint custom_vjp on the
# symmetrized PCG (ops/poisson.py) — one extra solve instead of unrolling
# the lax.while_loop (which has no reverse-mode rule at all).
# ---------------------------------------------------------------------------

def test_cg_adjoint_matches_finite_difference():
    """grad of sum(w*p) through the variable-rho PCG solve vs central FD,
    w.r.t. BOTH the rhs and the inverse-density field (the ∂θ term goes
    through jax.vjp of the matrix-free operator)."""
    from pyrmt_tpu.ops.poisson import (
        precompute_poisson_eigenvalues,
        solve_variable_poisson_cg,
    )

    n = 24
    dx = dy = 1.0 / (n - 1)
    yy, xx = np.mgrid[0:n, 0:n] * dx
    rhs0 = jnp.asarray(np.sin(2 * np.pi * xx) * np.cos(np.pi * yy))
    rho = 1.0 + 4.0 / (1.0 + np.exp(
        -(((xx - 0.5) ** 2 + (yy - 0.5) ** 2) - 0.09) / 0.01))
    ir0 = jnp.asarray(1.0 / rho)
    eig = precompute_poisson_eigenvalues(n, n, dx, dy, dtype=jnp.float64)
    wt = jnp.asarray(np.random.RandomState(0).randn(n, n))

    def loss(rhs, ir):
        p = solve_variable_poisson_cg(rhs, ir, eig, dx, dy, tol=1e-13,
                                      maxiter=500)
        return jnp.sum(p * wt)

    g_rhs, g_ir = jax.grad(loss, argnums=(0, 1))(rhs0, ir0)
    h = 1e-6
    for (i, j) in [(3, 4), (11, 17), (0, 0), (23, 12), (7, 0)]:
        e = jnp.zeros((n, n)).at[i, j].set(1.0)
        for which, grad in ((0, g_rhs), (1, g_ir)):
            args_p = (rhs0 + h * e, ir0) if which == 0 else (rhs0, ir0 + h * e)
            args_m = (rhs0 - h * e, ir0) if which == 0 else (rhs0, ir0 - h * e)
            fd = (float(loss(*args_p)) - float(loss(*args_m))) / (2 * h)
            an = float(grad[i, j])
            # 1e-5: central-FD truncation dominates on small-magnitude
            # entries; the adjoint itself is exact to the 1e-13 CG tol
            assert abs(an - fd) <= 1e-5 * max(1.0, abs(fd)), (which, i, j,
                                                              an, fd)


def test_grad_through_variable_rho_rollout():
    """End-to-end reverse-mode through a variable-density rollout (the CG
    while-loop hidden behind the implicit adjoint) vs central FD w.r.t. the
    initial velocity amplitude. Both make_rollout on the plain step and
    make_diff_rollout on make_diff_step (which now ACCEPTS variable_rho)."""
    n_steps = 3
    cfg = base_cfg(rho_s=2.0, variable_rho=True, cg_tol=1e-12,
                   cg_maxiter=400)
    bc = free_slip_box_bc
    u0, v0 = tg_velocity(1.0)
    state0 = make_init_state(cfg, (phi_disc,), u0=u0, v0=v0,
                             dtype=jnp.float64)

    step = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64)
    roll = make_rollout(step, n_steps, remat=True)

    def loss(amp):
        s0 = dataclasses.replace(state0, u=state0.u * amp, v=state0.v * amp)
        return final_energy(roll(s0, T_END))

    loss_j = jax.jit(loss)
    g = float(jax.grad(loss)(1.0))
    h = 1e-5
    fd = (float(loss_j(1.0 + h)) - float(loss_j(1.0 - h))) / (2 * h)
    assert np.isfinite(g) and abs(fd) > 0.0
    assert abs(g - fd) <= 1e-6 * max(1.0, abs(fd)), (g, fd)

    dstep = make_diff_step(cfg, bc, (phi_disc,), dtype=jnp.float64)
    droll = make_diff_rollout(dstep, n_steps)

    def dloss(amp):
        s0 = dataclasses.replace(state0, u=state0.u * amp, v=state0.v * amp)
        return final_energy(droll(s0, T_END))

    g_d = float(jax.grad(dloss)(1.0))
    assert abs(g_d - g) <= 1e-9 * max(1.0, abs(g)), (g_d, g)


# ---------------------------------------------------------------------------
# Traced physics-scalar params: make_step(traced_params=...) /
# make_diff_step(param_names=...) take mu_s/kappa/gamma/rho_s/rho_f as a
# RUNTIME dict — one compiled program across parameter values.
# ---------------------------------------------------------------------------


def _cfg_params():
    return {k: jnp.asarray(v, jnp.float64) for k, v in
            dict(mu_s=0.3, kappa=0.0, gamma=0.0, rho_s=1.0, rho_f=1.0
                 ).items()}


def test_traced_params_step_matches_default_build():
    """With params == cfg's own values the traced-params step reproduces
    the default build to roundoff (the math is identical; only constant
    folding differs), on the ADAPTIVE-dt path so compute_timestep's
    traced-scalar branch is covered too."""
    cfg = base_cfg(fixed_dt=None, CFL=0.3, dt_min_cap=2e-3)
    bc = free_slip_box_bc
    u0, v0 = tg_velocity(0.5)
    state0 = make_init_state(cfg, (phi_disc,), u0=u0, v0=v0,
                             dtype=jnp.float64)
    step0 = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64)
    stepP = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64,
                      traced_params=tuple(_cfg_params()))
    s0, s1 = state0, state0
    for _ in range(3):
        s0, _a = step0(s0, T_END)
        s1, _a = stepP(s1, T_END, _cfg_params())
    np.testing.assert_allclose(np.asarray(s0.u), np.asarray(s1.u),
                               atol=1e-14)
    np.testing.assert_allclose(np.asarray(s0.t), np.asarray(s1.t),
                               atol=1e-15)
    np.testing.assert_allclose(np.asarray(s0.X1), np.asarray(s1.X1),
                               atol=1e-14)

    with pytest.raises(ValueError, match="not traceable"):
        make_step(cfg, bc, (phi_disc,), dtype=jnp.float64,
                  traced_params=("eta_s",))


def test_grad_mu_s_via_traced_params_adaptive_dt():
    """d(loss)/d(mu_s) through the traced-params rollout — ONE compiled
    program evaluated at every FD point (no per-value retrace, unlike the
    dataclasses.replace pattern) — matches central differences INCLUDING
    the d(dt)/d(mu_s) term from the adaptive solid-CFL constraint."""
    cfg = base_cfg(fixed_dt=None, CFL=0.3, dt_min_cap=2e-3)
    bc = free_slip_box_bc
    u0, v0 = tg_velocity(0.5)
    state0 = make_init_state(cfg, (phi_disc,), u0=u0, v0=v0,
                             dtype=jnp.float64)
    stepP = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64,
                      traced_params=("mu_s",))

    @jax.jit
    def loss(mu):
        s = state0
        def body(s, _):
            s2, _a = stepP(s, T_END, {"mu_s": mu})
            return s2, None
        s, _ = jax.lax.scan(body, s, None, length=N_STEPS)
        return final_energy(s)

    mu = 0.3
    g = float(jax.grad(loss)(jnp.asarray(mu, jnp.float64)))
    h = 1e-5
    fd = (float(loss(jnp.asarray(mu + h, jnp.float64)))
          - float(loss(jnp.asarray(mu - h, jnp.float64)))) / (2 * h)
    assert np.isfinite(g) and abs(fd) > 0.0
    assert abs(g - fd) <= 1e-5 * max(1.0, abs(fd)), (g, fd)


def test_diff_step_param_names_mu_s_grad():
    """make_diff_step(param_names=('mu_s',)): forward values equal the
    traced-params step's, and the mu_s gradient through the rollout equals
    the plain traced-params scan's gradient and finite differences."""
    n_steps = 4
    cfg = base_cfg()
    bc = free_slip_box_bc
    u0, v0 = tg_velocity(0.5)
    state0 = make_init_state(cfg, (phi_disc,), u0=u0, v0=v0,
                             dtype=jnp.float64)

    dstep = make_diff_step(cfg, bc, (phi_disc,), dtype=jnp.float64,
                           param_names=("mu_s",))
    stepP = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64,
                      traced_params=("mu_s",))

    params = {"mu_s": jnp.asarray(0.3, jnp.float64)}
    out_d = dstep(state0, T_END, params)
    out_s, _ = stepP(state0, T_END, params)
    for name in ("u", "v", "p", "X1", "X2", "t"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out_d, name)),
            np.asarray(getattr(out_s, name)), err_msg=name)

    droll = make_diff_rollout(dstep, n_steps, with_params=True)

    def diff_loss(mu):
        return final_energy(droll(state0, T_END, {"mu_s": mu}))

    @jax.jit
    def scan_loss(mu):
        def body(s, _):
            s2, _a = stepP(s, T_END, {"mu_s": mu})
            return s2, None
        s, _ = jax.lax.scan(body, state0, None, length=n_steps)
        return final_energy(s)

    mu = jnp.asarray(0.3, jnp.float64)
    g_diff = float(jax.grad(diff_loss)(mu))
    g_scan = float(jax.grad(scan_loss)(mu))
    assert abs(g_diff - g_scan) <= 1e-8 * max(1.0, abs(g_scan)), (g_diff,
                                                                  g_scan)

    loss_j = jax.jit(diff_loss)
    h = 1e-5
    fd = (float(loss_j(mu + h)) - float(loss_j(mu - h))) / (2 * h)
    assert abs(g_diff - fd) <= 1e-5 * max(1.0, abs(fd)), (g_diff, fd)


def test_grad_gamma_via_traced_params():
    """d(loss)/d(gamma) on a surface-tension config via traced params
    (st_enabled decoupled from gamma's VALUE; the Brackbill capillary dt
    constraint differentiates through compute_timestep's traced branch)."""
    cfg = base_cfg(gamma=0.05, fixed_dt=None, CFL=0.3, dt_min_cap=2e-3,
                   st_kappa_interface=True)
    bc = free_slip_box_bc
    u0, v0 = tg_velocity(0.3)
    state0 = make_init_state(cfg, (phi_disc,), u0=u0, v0=v0,
                             dtype=jnp.float64)
    stepP = make_step(cfg, bc, (phi_disc,), dtype=jnp.float64,
                      traced_params=("gamma",))

    @jax.jit
    def loss(gam):
        def body(s, _):
            s2, _a = stepP(s, T_END, {"gamma": gam})
            return s2, None
        s, _ = jax.lax.scan(body, state0, None, length=N_STEPS)
        return final_energy(s)

    gam = jnp.asarray(0.05, jnp.float64)
    g = float(jax.grad(loss)(gam))
    h = 1e-6
    fd = (float(loss(gam + h)) - float(loss(gam - h))) / (2 * h)
    assert np.isfinite(g) and abs(fd) > 0.0
    assert abs(g - fd) <= 1e-5 * max(1.0, abs(fd)), (g, fd)


def test_grad_contact_adaptive_dt_finite_and_matches_fd():
    """Round 5 AD-safety regression: a 2-solid CONTACT config under the
    ADAPTIVE timestep. Two 0*inf NaN sources used to poison every such
    gradient: sqrt'(0) at the flat mid-surface normal in
    ops/contact.compute_contact_force, and sqrt'(0) at exact-zero velocity
    cells inside compute_timestep's max|u| (both now double-where guarded,
    forward bitwise-unchanged). Pins finiteness AND the FD match."""
    two = base_cfg(fixed_dt=None, CFL=0.2, dt_min_cap=1e-3, k_rep=2.0,
                   mu_s=1.0)
    bc = free_slip_box_bc

    def phi_a(X1, X2):
        return jnp.sqrt((X1 - 0.35) ** 2 + (X2 - 0.5) ** 2) - 0.15

    def phi_b(X1, X2):
        return jnp.sqrt((X1 - 0.65) ** 2 + (X2 - 0.5) ** 2) - 0.15

    u0, v0 = tg_velocity(0.5)
    state0 = make_init_state(two, (phi_a, phi_b), u0=u0, v0=v0,
                             dtype=jnp.float64)
    step = make_step(two, bc, (phi_a, phi_b), dtype=jnp.float64)

    @jax.jit
    def loss(amp):
        s = dataclasses.replace(state0, u=state0.u * amp, v=state0.v * amp)
        for _ in range(2):
            s, _a = step(s, T_END)
        return final_energy(s)

    g = float(jax.grad(loss)(jnp.asarray(1.0, jnp.float64)))
    assert np.isfinite(g), g
    h = 1e-6
    fd = (float(loss(jnp.asarray(1.0 + h, jnp.float64)))
          - float(loss(jnp.asarray(1.0 - h, jnp.float64)))) / (2 * h)
    assert abs(g - fd) <= 1e-5 * max(1.0, abs(fd)), (g, fd)
