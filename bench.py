"""Headline benchmark: FSI steps/sec, soft disc in lid-driven cavity.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "platform": ..., "device_kind": ..., "device_count": N}

Runs on a GPU only: it exits with an error when JAX's default device is not
one (no CPU fallback).

Baseline: the reference (Numba, 8 CPU threads) does ~31 ms/step at N=128
(upstream docs/PERFORMANCE.md:3-5). Its kernels are O(N^2) and the DCT is
O(N^2 log N), so at the target N=1024 the projected reference step is
31 ms * 64 = ~1.98 s (kernel-dominated; log-factor ignored — conservative in
the reference's favour). vs_baseline = projected_ref_step_time / our_step_time.

Usage: python bench.py [N] [steps] [--bicubic] [--rebase] [--areafix]
       [--reinit=pde|fmm] [--periodic] [--donate]

Best of 3 timed chunks of ``steps`` scanned steps after one warmup chunk.
"""
from __future__ import annotations

import json
import sys
import time


def main(N=1024, n_steps=2000, sl_bicubic=False, rebase=False,
         areafix=False, reinit=None, periodic=False, donate=False):
    import pyrmt_tpu.runtime as rt

    rt.setup()

    import dataclasses

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's default device is "
                         f"{dev.platform} ({dev.device_kind})")

    from pyrmt_tpu.sim import make_init_state, make_run_chunk, make_step
    from __graft_entry__ import _flagship

    cfg, bc, phi_inits = _flagship(N, jnp.float32)
    if sl_bicubic:
        # Catmull-Rom final gather (band-guarded)
        cfg = dataclasses.replace(cfg, sl_interp="bicubic")
    # robustness-config rows
    if rebase:
        cfg = dataclasses.replace(cfg, map_rebase_minj=0.5)
    if areafix:
        cfg = dataclasses.replace(cfg, phi_area_fix=True)
    if reinit:
        cfg = dataclasses.replace(cfg, reinit_method=reinit)
    u0 = v0 = None
    if periodic:
        # the doubly-periodic stack's row — same solid, periodic wrap BCs
        # (FFT projection + wrap momentum stencils, seam-clear solid),
        # seeded with a decaying TG vortex so the flow/dt are nontrivial
        from pyrmt_tpu.bcs import periodic_bc

        cfg = dataclasses.replace(cfg, bc_type="periodic")
        bc = periodic_bc
        X, Y = cfg.grid.coords(jnp.float32)
        u0 = 0.5 * jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Y)
        v0 = -0.5 * jnp.cos(2 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)
    step = make_step(cfg, bc, phi_inits, dtype=jnp.float32)
    state = make_init_state(cfg, phi_inits, u0=u0, v0=v0, dtype=jnp.float32)
    t_end = jnp.asarray(1e9, jnp.float32)

    if rebase:
        # two-executable chunked runner ('analytic' rebuild until a rebase
        # fires, then 'sampled'; sim.make_rebase_runner docstring)
        from pyrmt_tpu.sim import make_rebase_runner

        chunk = make_rebase_runner(cfg, bc, phi_inits, n_steps,
                                   dtype=jnp.float32, donate=donate)
    else:
        chunk = make_run_chunk(step, n_steps, donate=donate)

    # warmup / compile
    state_w, _ = chunk(state, t_end)
    jax.block_until_ready(state_w.u)

    wall = 1e18
    if donate:
        # donated input buffers are consumed — CHAIN the state through the
        # timed chunks instead of re-running from state_w (same adaptive-dt
        # steady regime)
        s = state_w
        for _ in range(3):
            t0 = time.perf_counter()
            s, _ = chunk(s, t_end)
            jax.block_until_ready(s.u)
            wall = min(wall, time.perf_counter() - t0)
    else:
        for _ in range(3):
            t0 = time.perf_counter()
            state2, ts = chunk(state_w, t_end)
            jax.block_until_ready(state2.u)
            wall = min(wall, time.perf_counter() - t0)

    step_ms = wall / n_steps * 1e3
    steps_per_sec = n_steps / wall

    ref_step_ms_at_128 = 31.0  # upstream docs/PERFORMANCE.md:3-5
    ref_step_ms = ref_step_ms_at_128 * (N / 128.0) ** 2
    vs_baseline = ref_step_ms / step_ms

    variant = ""
    if rebase:
        variant += "_rebase"
    if areafix:
        variant += "_areafix"
    if reinit:
        variant += f"_reinit_{reinit}"
    if sl_bicubic:
        variant += "_bicubic"
    if periodic:
        variant += "_periodic"
    print(json.dumps({
        "metric": f"fsi_steps_per_sec_N{N}" + variant,
        "value": round(steps_per_sec, 3),
        "unit": "steps/s",
        "vs_baseline": round(vs_baseline, 2),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    sl_bicubic = "--bicubic" in sys.argv
    rebase = "--rebase" in sys.argv
    areafix = "--areafix" in sys.argv
    periodic = "--periodic" in sys.argv
    donate = "--donate" in sys.argv
    reinit = None
    for a in sys.argv[1:]:
        if a.startswith("--reinit="):
            reinit = a.split("=", 1)[1]
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    N = int(args[0]) if len(args) > 0 else 1024
    n_steps = int(args[1]) if len(args) > 1 else 2000
    main(N=N, n_steps=n_steps, sl_bicubic=sl_bicubic, rebase=rebase,
         areafix=areafix, reinit=reinit, periodic=periodic, donate=donate)
