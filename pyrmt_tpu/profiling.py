"""Profiling / tracing harness.

The reference has no in-code profiling — its per-stage breakdown is a
manually-produced table (upstream docs/PERFORMANCE.md:3-12). Here both are
first-class:

  * ``trace(path)``: context manager around ``jax.profiler`` — produces an
    XLA/TensorBoard trace of the fused step for kernel-level analysis,
  * ``stage_breakdown(...)``: compiles each pipeline stage separately and
    times it on-device, reproducing the reference's table (momentum,
    projection, advection, extrapolation) for any grid size.
"""
from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir="/tmp/pyrmt_tpu_trace"):
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def _time_fn(fn, args, iters=20):
    import jax

    out = fn(*args)  # compile
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3  # ms


def _time_scan(fn, carry, iters=50, repeats=3):
    """Time ``fn: carry -> carry`` by compiling ``iters`` chained applications
    into ONE scanned XLA program (min over ``repeats``). Chaining through
    the carry defeats both per-dispatch overhead and dead-code elimination.
    """
    import jax

    @jax.jit
    def chunk(c):
        return jax.lax.scan(lambda c2, _: (fn(c2), None), c, None,
                            length=iters)[0]

    out = chunk(carry)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = chunk(out)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best  # ms


def stage_breakdown(N=128, dtype=None, iters=20, verbose=True):
    """Per-stage ms timings for the soft-disc FSI pipeline at grid size N.

    Returns a dict {stage: ms}. Mirrors the reference's published profile
    (31 ms/step at N=128 = momentum 16.7 + projection 8.3 + advection 6.4 +
    extrapolation 3.5, upstream docs/PERFORMANCE.md:3-12).
    """
    import jax
    import jax.numpy as jnp

    from pyrmt_tpu.bcs import make_lid_bc
    from pyrmt_tpu.grid import Grid
    from pyrmt_tpu.ops.advect import advect_semilagrangian_rk4_multi
    from pyrmt_tpu.ops.extrapolate import extrapolate_reference_map
    from pyrmt_tpu.ops.poisson import precompute_poisson_eigenvalues
    from pyrmt_tpu.ops.projection import pressure_projection
    from pyrmt_tpu.physics import momentum_step_rk4
    from pyrmt_tpu.sim import RMTConfig, make_init_state, make_step

    dtype = dtype or jnp.float32
    g = Grid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
    dx, dy = g.dx, g.dy
    X, Y = g.coords(dtype=dtype)

    def phi_init(Xq, Yq):
        return jnp.sqrt((Xq - 0.6) ** 2 + (Xq * 0 + Yq - 0.5) ** 2) - 0.2

    cfg = RMTConfig(grid=g, mu_s=0.1, eta_s=0.01, mu_f=0.01, rho_f=1.0,
                    rho_s=1.0, CFL=0.2, dt_min_cap=1e-3)
    bc = make_lid_bc(1.0)
    state = make_init_state(cfg, (phi_init,), dtype=dtype)
    phi = phi_init(X, Y).astype(dtype)
    eig = precompute_poisson_eigenvalues(N, N, dx, dy, dtype=dtype)
    dt = jnp.asarray(1e-3, dtype)
    w_t = cfg.w_t

    results = {}

    X1_0, X2_0 = state.X1[0], state.X2[0]

    def mom_body(c):
        u, v = c
        out = momentum_step_rk4(
            u, v, state.p, X1_0, X2_0, bc, cfg.mu_s, cfg.kappa, cfg.eta_s,
            dx, dy, dt, cfg.rho_s, cfg.rho_f, phi, cfg.mu_f, w_t)
        return out[0], out[1]

    results["momentum_rk4"] = _time_scan(mom_body, (state.u, state.v), iters)

    def proj_body(c):
        u, v, p = c
        return pressure_projection(
            u, v, dx, dy, dt, 1.0, bc, p_prev=p, eigenvalues=eig,
            bc_type="neumann")

    results["projection"] = _time_scan(
        proj_body, (state.u, state.v, state.p), iters)

    qs = jnp.concatenate([state.X1, state.X2], axis=0)
    results["advection_gather"] = _time_scan(
        lambda q: advect_semilagrangian_rk4_multi(
            q, state.u, state.v, X, Y, dt, dx, dy),
        qs, max(iters // 10, 2))

    from pyrmt_tpu.ops.advect import advect_semilagrangian_rk4_local

    results["advection_local"] = _time_scan(
        lambda q: advect_semilagrangian_rk4_local(
            q, state.u, state.v, dt, dx, dy),
        qs, iters)

    results["extrapolation_xla"] = _time_scan(
        lambda c: extrapolate_reference_map(
            c[0], c[1], phi, dx, dy, cfg.num_layers),
        (X1_0, X2_0), iters)

    step = make_step(cfg, bc, (phi_init,), dtype=dtype)
    t_end = jnp.asarray(1e9, dtype)
    results["full_step"] = _time_scan(
        lambda s: step(s, t_end)[0], state, iters)

    if verbose:
        print(f"[stage_breakdown] N={N} dtype={jnp.dtype(dtype).name}")
        for k, v in results.items():
            print(f"  {k:16s} {v:8.3f} ms")
    return results


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import pyrmt_tpu.runtime as rt

    rt.setup()
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    stage_breakdown(N=N)
