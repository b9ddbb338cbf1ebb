"""Differentiable step with per-step recompute (BEYOND REFERENCE).

:func:`sim.make_rollout` documents the baseline gradient story: reverse-mode
AD flows through the whole trajectory, with ``jax.checkpoint`` per step to
bound memory. :func:`make_diff_step` gets the same memory bound without a
remat wrapper, through ``jax.custom_vjp``:

* **forward** = the config's own step;
* **backward** = the VJP of that same step, recomputed from the step's
  inputs.

The residuals saved by the custom VJP are just the step's *inputs* (one
SimState per step), so a ``lax.scan`` rollout over ``dstep`` gets
checkpoint-level memory for free — no ``jax.checkpoint`` wrapper needed.

Scope: differentiable w.r.t. ``state`` and ``t_end`` — and, with
``param_names``, w.r.t. the named PHYSICS scalars
(mu_s/kappa/gamma/rho_s/rho_f): ``dstep(state, t_end, params)`` takes them
as a runtime dict, so one compiled program serves every parameter value
(the inverse-problem use case, examples/differentiable_fsi.py, mu_s
recovery).

The upstream stack (pyRMT/functions.py) has no gradient story; this module
is pure JAX-architecture upside.
"""
from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from pyrmt_tpu.sim import SimState, make_step

__all__ = ["make_diff_step", "make_diff_rollout"]


def make_diff_step(
    cfg,
    velocity_bc: Callable,
    phi_inits: Sequence[Callable] = (),
    dtype=jnp.float32,
    param_names: tuple[str, ...] | None = None,
):
    """Build ``dstep(state, t_end) -> SimState`` with an input-only-residual
    VJP (the backward pass recomputes the step).

    With ``param_names`` the signature becomes
    ``dstep(state, t_end, params) -> SimState`` where ``params`` is a dict
    of the named physics scalars (sim._TRACEABLE_PARAMS) — differentiable
    w.r.t. every entry.

    The aux diagnostics dict is dropped: only the state participates in
    the differentiable contract.

    ``variable_rho=True`` works too: the CG projection's ``lax.while_loop``
    is hidden behind an implicit-adjoint ``jax.custom_vjp``
    (ops/poisson.solve_variable_poisson_cg_counted), so the backward pass
    runs one extra PCG solve per step instead of unrolling iterations.
    """
    step = make_step(cfg, velocity_bc, phi_inits, dtype=dtype,
                     traced_params=param_names)

    if param_names is None:
        @jax.custom_vjp
        def dstep(state: SimState, t_end):
            return step(state, t_end)[0]

        def dstep_fwd(state, t_end):
            return step(state, t_end)[0], (state, t_end)

        def dstep_bwd(residuals, ct):
            state, t_end = residuals
            _, vjp = jax.vjp(lambda s, t: step(s, t)[0], state, t_end)
            return vjp(ct)

        dstep.defvjp(dstep_fwd, dstep_bwd)
        return dstep

    @jax.custom_vjp
    def dstep(state: SimState, t_end, params):
        return step(state, t_end, params)[0]

    def dstep_fwd(state, t_end, params):
        return step(state, t_end, params)[0], (state, t_end, params)

    def dstep_bwd(residuals, ct):
        state, t_end, params = residuals
        _, vjp = jax.vjp(lambda s, t, p: step(s, t, p)[0],
                         state, t_end, params)
        return vjp(ct)

    dstep.defvjp(dstep_fwd, dstep_bwd)
    return dstep


def make_diff_rollout(dstep, n_steps: int, with_params: bool = False):
    """``n_steps``-step differentiable rollout over a :func:`make_diff_step`
    step — one jitted ``lax.scan`` program, O(n_steps * state) backward
    memory from the custom VJP's input-only residuals (no remat wrapper).

    ``with_params=True`` matches a ``param_names``
    step: ``rollout(state, t_end, params)``.
    """

    if with_params:
        @jax.jit
        def rollout(state: SimState, t_end, params):
            def body(s, _):
                return dstep(s, t_end, params), None

            out, _ = jax.lax.scan(body, state, None, length=n_steps)
            return out

        return rollout

    @jax.jit
    def rollout(state: SimState, t_end):
        def body(s, _):
            return dstep(s, t_end), None

        out, _ = jax.lax.scan(body, state, None, length=n_steps)
        return out

    return rollout
