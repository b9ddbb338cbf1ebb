"""Smoke check of the FSI step on one GPU, through the normal entry points.

    python chip_smoke.py                 # phases (a)-(f) on one GPU
    python chip_smoke.py --multichip 4   # only the 4-GPU sharded phase
    python chip_smoke.py --calibrate     # CPU only: phase (b)'s f32 errors

Phases, all in this one process (a second JAX process would find the
card's memory taken):

  (a) flagship — soft disc in the lid-driven cavity at N=1024, f32
      (``__graft_entry__._flagship`` -> ``make_step`` -> ``make_run_chunk``):
      compile time, ``memory_analysis()``, 3 timed 500-step chunks after a
      warm-up chunk, finite fields and 0.5 < J < 1.5 inside the solid;
  (b) the same configuration for 20 fixed-dt steps, f32 on the GPU against
      f64 on the CPU backend (a ``JAX_PLATFORMS=cpu`` child process that
      never opens the card, run while phases (c)-(f) use the card);
  (c) pure fluid: Ghia Re=100 at N=129, f32 (benchmarks/lid_driven_cavity);
  (d) variable-density many-body path: 2-solid contact + PCG at N=256;
  (e) periodic stack: Taylor-Green decay at N=129, f32;
  (f) one profiler trace of a 50-step flagship chunk at N=1024, compiled
      without command buffers: the 10 largest device ops per step and the
      device time of each stage of the step.

Every phase runs; a failed phase prints its traceback and makes the script
exit 1 without the result line. The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Step rates printed here are informational, not benchmark results.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

N_FLAGSHIP = 1024
CHUNK = 500
# Phase (b): 4e-6 sits just under the flagship's own adaptive dt at N=1024,
# which the viscous limit CFL * dx^2 / (4 mu_f) = 4.78e-6 sets; a larger
# fixed dt would be outside the explicit momentum step's stability range.
B_FIXED_DT = 4e-6
B_STEPS = 20
B_FIELDS = ("u", "v", "p", "X1", "X2")
# Relative L2 error of CPU f32 against CPU f64 over the same 20 steps at
# N=1024, both on JAX's CPU backend (``python chip_smoke.py --calibrate``);
# the GPU f32 run must stay within B_FACTOR times each. The Neumann solve
# goes through the FFT lowering (dct_method 'auto' -> 'fft', cuFFT on the
# GPU), so no matmul and no TF32 is involved; a matmul DCT would run at
# precision 'highest' (dct_precision 'auto').
B_CPU_F32_ERR = {"u": 1.012e-7, "v": 1.731e-6, "p": 4.925e-6,
                 "X1": 3.375e-7, "X2": 3.141e-7}
B_FACTOR = 10.0
# Phase (c): CPU f64 gives 1.80e-3 at N=129 (the reference code 1.7e-3).
GHIA_GATE = 2.5e-3
# Phase (e): the f64 CI gate (tests/test_validation_gates.py, N=65) holds
# rate 1e-2, profile 5e-3, max|div| 1e-6. CPU f32 at N=129 measures rate
# 7.8e-4, profile 3.1e-4, max|div| 2.4e-6: the first two keep the f64
# gates; max|div| sits at f32 roundoff of the FFT solve, gated at ~10x it.
TG_GATES = {"rate_rel_err": 1e-2, "profile_rel_err": 5e-3, "maxdiv": 2.5e-5}


def require_gpu(count: int = 1):
    """JAX's devices, if the default backend is a GPU with at least
    ``count`` devices; raises RuntimeError otherwise (no CPU fallback)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        raise RuntimeError(
            f"chip_smoke needs {count} GPU(s); JAX's default backend is "
            f"{devices[0].platform} with {len(devices)} device(s)")
    return devices


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _solid_J_range(cfg, phi_inits, state):
    """(min, max) of J = det(F) over the cells inside each solid."""
    from pyrmt_tpu.ops.stress import solid_cauchy_stress

    lo, hi = np.inf, -np.inf
    for i, pi in enumerate(phi_inits):
        phi = pi(state.X1[i], state.X2[i])
        _, _, _, J = solid_cauchy_stress(
            state.X1[i], state.X2[i], cfg.grid.dx, cfg.grid.dy, cfg.mu_s,
            cfg.kappa, phi)
        inside = np.asarray(phi <= 0.0)
        Jn = np.asarray(J)[inside]
        lo, hi = min(lo, float(Jn.min())), max(hi, float(Jn.max()))
    return lo, hi


def _finite(state) -> bool:
    return all(bool(np.all(np.isfinite(np.asarray(getattr(state, f)))))
               for f in B_FIELDS)


def phase_a_flagship(card):
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship
    from pyrmt_tpu.sim import make_init_state, make_run_chunk, make_step

    cfg, bc, phi_inits = _flagship(N_FLAGSHIP, jnp.float32)
    step = make_step(cfg, bc, phi_inits, dtype=jnp.float32)
    chunk = make_run_chunk(step, CHUNK)
    state = make_init_state(cfg, phi_inits, dtype=jnp.float32)
    t_end = jnp.asarray(1e9, jnp.float32)

    t0 = time.perf_counter()
    compiled = chunk.lower(state, t_end).compile()
    print(f"[a] compile {time.perf_counter() - t0:.1f} s "
          f"({CHUNK}-step scanned chunk, N={N_FLAGSHIP}, f32)")
    print(f"[a] memory_analysis: {compiled.memory_analysis()}")

    state, _ = compiled(state, t_end)             # warm-up chunk
    jax.block_until_ready(state.u)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, _ = compiled(state, t_end)
        jax.block_until_ready(state.u)
        walls.append(time.perf_counter() - t0)
    rates = [CHUNK / w for w in walls]
    assert _finite(state), "non-finite fields after the flagship chunks"
    lo, hi = _solid_J_range(cfg, phi_inits, state)
    print(f"[a] after {4 * CHUNK} steps: t={float(state.t):.6g}, J inside "
          f"the solid in [{lo:.4f}, {hi:.4f}]")
    assert 0.5 < lo and hi < 1.5, f"folded map: J in [{lo}, {hi}]"
    print(f"[a] steps/s per chunk {[round(r, 1) for r in rates]}, median "
          f"{float(np.median(rates)):.1f} on {card} (informational)")


def _b_config(dtype_name, n):
    import dataclasses

    import jax.numpy as jnp

    from __graft_entry__ import _flagship

    dtype = jnp.dtype(dtype_name)
    cfg, bc, phi_inits = _flagship(n, dtype)
    return dataclasses.replace(cfg, fixed_dt=B_FIXED_DT), bc, phi_inits, dtype


def run_b_steps(dtype_name, n):
    """The phase-(b) run on JAX's default device: ``B_STEPS`` fixed-dt
    flagship steps at grid size ``n`` from the initial state; returns the
    final fields."""
    import jax.numpy as jnp

    from pyrmt_tpu.sim import make_init_state, make_run_chunk, make_step

    cfg, bc, phi_inits, dtype = _b_config(dtype_name, n)
    chunk = make_run_chunk(make_step(cfg, bc, phi_inits, dtype=dtype),
                           B_STEPS)
    state, _ = chunk(make_init_state(cfg, phi_inits, dtype=dtype),
                     jnp.asarray(1e9, dtype))
    return {f: np.asarray(getattr(state, f)) for f in B_FIELDS}


def cpu_reference(path, n):
    """Child-process entry of phase (b): the f64 run on the CPU backend,
    saved to ``path``. Needs ``JAX_PLATFORMS=cpu`` in the environment."""
    import jax

    jax.config.update("jax_enable_x64", True)
    assert jax.devices()[0].platform == "cpu"
    np.savez(path, **run_b_steps("float64", n))


def _start_cpu_run(path, dtype_name="float64"):
    """A ``JAX_PLATFORMS=cpu`` child that saves the phase-(b) fields of a
    ``dtype_name`` run at N_FLAGSHIP to ``path``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if dtype_name == "float64":
        code = (f"import chip_smoke; "
                f"chip_smoke.cpu_reference({path!r}, {N_FLAGSHIP})")
    else:
        code = (f"import chip_smoke, numpy; numpy.savez({path!r}, "
                f"**chip_smoke.run_b_steps({dtype_name!r}, {N_FLAGSHIP}))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env)


def calibrate():
    """Measures B_CPU_F32_ERR: CPU f32 against CPU f64 for the phase-(b)
    steps, each in a CPU-only child. Opens no GPU."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        paths = {d: os.path.join(tmp, f"{d}.npz")
                 for d in ("float32", "float64")}
        children = [_start_cpu_run(p, d) for d, p in paths.items()]
        assert all(c.wait() == 0 for c in children), "a CPU child failed"
        a, b = (np.load(paths[d]) for d in ("float32", "float64"))
        errs = {f: _rel_l2(a[f], b[f]) for f in B_FIELDS}
    print(f"CPU f32 vs CPU f64, {B_STEPS} steps at dt {B_FIXED_DT:g}, "
          f"N={N_FLAGSHIP}: " + ", ".join(f"{f}={e:.3e}"
                                         for f, e in errs.items()))


def phase_b_gpu():
    t0 = time.perf_counter()
    out = run_b_steps("float32", N_FLAGSHIP)
    print(f"[b] GPU f32: {B_STEPS} steps at fixed dt {B_FIXED_DT:g} "
          f"({time.perf_counter() - t0:.1f} s incl. compile)")
    return out


def phase_b_compare(gpu, child, path):
    rc = child.wait(timeout=900)
    assert rc == 0, f"CPU f64 reference child exited {rc}"
    ref = np.load(path)
    bad = []
    for f in B_FIELDS:
        err = _rel_l2(gpu[f], ref[f])
        tol = B_FACTOR * B_CPU_F32_ERR[f]
        print(f"[b] rel L2 {f:2s} GPU f32 vs CPU f64: {err:.3e} "
              f"(tol {tol:.1e} = {B_FACTOR:g} x CPU f32 "
              f"{B_CPU_F32_ERR[f]:.1e})")
        if not err <= tol:
            bad.append(f)
    assert not bad, f"fields over tolerance: {bad}"


def phase_c_ghia():
    from benchmarks.lid_driven_cavity import run

    t0 = time.perf_counter()
    err = run(Re=100.0, N=129, dtype="float32", verbose=False,
              out_root=OUT_DIR)
    print(f"[c] Ghia Re=100 N=129 f32: RMS {err:.4e} (gate {GHIA_GATE:g}; "
          f"{time.perf_counter() - t0:.1f} s)")
    assert err < GHIA_GATE


def phase_d_many_body():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship
    from pyrmt_tpu.sim import make_init_state, make_step

    cfg, bc, phi_inits = _flagship(256, jnp.float32, n_solids=2)
    cfg = dataclasses.replace(cfg, rho_s=5.0, variable_rho=True, g_y=-1.0,
                              cg_tol=1e-5)
    step = make_step(cfg, bc, phi_inits, dtype=jnp.float32)
    t_end = jnp.asarray(1e9, jnp.float32)

    @jax.jit
    def run(state):
        def body(carry, _):
            s, it_max, both = carry
            s2, aux = step(s, t_end)
            ph = aux["phis"]
            n_both = jnp.sum((ph[0] <= 0.0) & (ph[1] <= 0.0))
            return (s2, jnp.maximum(it_max, aux["cg_iters"]),
                    jnp.maximum(both, n_both)), None

        init = (state, jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
        return jax.lax.scan(body, init, None, length=200)[0]

    t0 = time.perf_counter()
    state, it_max, both = run(make_init_state(cfg, phi_inits,
                                              dtype=jnp.float32))
    jax.block_until_ready(state.u)
    print(f"[d] 2-solid contact + PCG, N=256, 200 steps: max cg_iters "
          f"{int(it_max)} (cg_maxiter {cfg.cg_maxiter}), cells inside both "
          f"solids {int(both)}, t={float(state.t):.4g} "
          f"({time.perf_counter() - t0:.1f} s incl. compile)")
    assert _finite(state), "non-finite fields"
    assert int(both) == 0, "pass-through: a cell lies inside both solids"
    assert int(it_max) < cfg.cg_maxiter, "PCG hit cg_maxiter"


def phase_e_periodic():
    from benchmarks.periodic_taylor_green import run

    _, s = run(N=129, dtype="float32", t_end=0.5, verbose=False,
               out_root=OUT_DIR)
    print(f"[e] periodic TG N=129 f32: stable={s['stable']} rate rel err "
          f"{s['rate_rel_err']:.3e}, profile rel err "
          f"{s['profile_rel_err']:.3e}, max|div| {s['maxdiv']:.3e} "
          f"(gates {TG_GATES}; {s['steps']} steps)")
    assert s["stable"]
    for k, gate in TG_GATES.items():
        assert s[k] < gate, (k, s[k], gate)


def _repo_path(path):
    """``path`` as a file of this checkout (relative to ROOT), or None: the
    longest tail of ``path`` that names a file here. Not matched by ROOT's
    prefix: an executable loaded from the compile cache keeps the file
    names of the checkout that compiled it."""
    parts = path.split("/")
    for i in range(1, len(parts)):
        rel = "/".join(parts[i:])
        if os.path.isfile(os.path.join(ROOT, rel)):
            return rel
    return None


def _hlo_sources(hlo_text):
    """HLO instruction name -> its JAX call chain inside this repository,
    innermost first (a list of 'file:line function'), from the stack-frame
    tables of the compiled module's text."""
    import re

    def table(name):
        m = re.search(name + r"\n(.*?)\n\n", hlo_text, re.S)
        return m.group(1).splitlines() if m else []

    files = {k: _repo_path(v) for k, v in re.findall(
        r'(\d+) "(.*)"', "\n".join(table("FileNames")))}
    funcs = dict(re.findall(r'(\d+) "(.*)"',
                            "\n".join(table("FunctionNames"))))
    locs = {m[0]: (files.get(m[1]), funcs.get(m[2], "?"), m[3])
            for m in re.findall(
                r"(\d+) \{file_name_id=(\d+) function_name_id=(\d+) "
                r"line=(\d+)", "\n".join(table("FileLocations")))}
    # the printed parent id is the parent frame's id + 1 (1 = no parent)
    frames = {m[0]: (m[1], str(int(m[2]) - 1)) for m in re.findall(
        r"(\d+) \{file_location_id=(\d+) parent_frame_id=(\d+)\}",
        "\n".join(table("StackFrames")))}

    def chain(fid):
        out = []
        while fid in frames:
            loc, fid = frames[fid]
            f, fn, line = locs.get(loc, (None, "?", "?"))
            if f:
                out.append(f"{f}:{line} {fn}")
        return out

    inst = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+) = .*"
                      r"metadata=\{[^}]*stack_frame_id=(\d+)")
    return {m.group(1): chain(m.group(2))
            for m in map(inst.match, hlo_text.splitlines()) if m}


def _device_events(trace_dir):
    """(name, start_ns, duration_ns) of the ops on the first GPU's plane of
    the newest trace under ``trace_dir``; prints the plane's line names."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    prof = ProfileData.from_file(paths[-1])
    planes = [p for p in prof.planes if p.name.startswith("/device:GPU:0")]
    plane = planes[0]
    lines = {ln.name: ln for ln in plane.lines}
    print(f"[f] trace plane {plane.name}: lines {sorted(lines)}")
    if "XLA Ops" in lines:
        chosen = [lines["XLA Ops"]]
    else:
        chosen = [ln for name, ln in lines.items()
                  if name.startswith("Stream")]
    events = []
    for ln in chosen:
        for ev in ln.events:
            stats = dict(ev.stats)
            name = stats.get("hlo_op") or ev.name
            events.append((str(name), ev.start_ns, ev.duration_ns))
    return events


def _stage(chain):
    """The step stage an op belongs to: the line of ``make_step``'s
    ``_step`` body it comes from and the function called there. An op of
    an inner jitted function keeps the frames of the call that first
    traced it; it goes to its outermost frame in the library."""
    for i, frame in enumerate(chain):
        if frame.endswith("._step"):
            callee = chain[i - 1].split(" ", 1)[1] if i else "(inline)"
            return f"{frame.split(' ', 1)[0]} {callee}"
    lib = [f for f in chain if f.startswith("pyrmt_tpu/")
           and not f.startswith("pyrmt_tpu/sim.py")]
    return f"{lib[-1]} (inner jit)" if lib else "?"


def phase_f_trace():
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship
    from pyrmt_tpu.sim import make_init_state, make_run_chunk, make_step

    n = 50
    cfg, bc, phi_inits = _flagship(N_FLAGSHIP, jnp.float32)
    chunk = make_run_chunk(make_step(cfg, bc, phi_inits, dtype=jnp.float32),
                           n)
    state = make_init_state(cfg, phi_inits, dtype=jnp.float32)
    t_end = jnp.asarray(1e9, jnp.float32)
    # XLA:GPU replays the step's kernels as CUDA graphs ("command buffers"),
    # which the trace shows as one opaque event; this executable is
    # compiled without them so every fusion is its own event
    compiled = chunk.lower(state, t_end).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    sources = _hlo_sources(compiled.as_text())
    state, _ = compiled(state, t_end)
    jax.block_until_ready(state.u)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, _ = compiled(state, t_end)
        jax.block_until_ready(state.u)
        walls.append(time.perf_counter() - t0)
    print(f"[f] without command buffers, untraced: "
          f"{n / float(np.median(walls)):.1f} steps/s (median of 3 "
          f"{n}-step chunks)")

    trace_dir = os.path.join(OUT_DIR, "trace")
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        state, _ = compiled(state, t_end)
        jax.block_until_ready(state.u)
    wall = time.perf_counter() - t0

    events = _device_events(trace_dir)
    assert events, "the trace holds no device op"
    assert not any(name.startswith("command_buffer") for name, _, _ in
                   events), "command buffers hide the per-op breakdown"
    per_op = {}
    for name, _, dur in events:
        per_op[name] = per_op.get(name, 0) + dur
    busy = 0
    end = None
    for _, s, d in sorted((e for e in events), key=lambda e: e[1]):
        if end is None or s >= end:
            busy += d
            end = s + d
        elif s + d > end:
            busy += s + d - end
            end = s + d
    span = max(s + d for _, s, d in events) - min(s for _, s, _ in events)
    step_us = busy / n / 1e3
    print(f"[f] {n}-step chunk: {len(events) / n:.0f} device ops/step, "
          f"device busy {step_us:.1f} us/step, idle share "
          f"{1 - busy / span:.3f} of the {span / 1e6:.2f} ms device span "
          f"(host wall {wall * 1e3:.1f} ms, traced)")
    print("[f] top 10 ops: us/step, share of busy time, MB that time "
          "could move at 3.35 TB/s, source (innermost first)")
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    for name, tot in top:
        us = tot / n / 1e3
        src = " < ".join(sources.get(name, [])[:3]) or "?"
        print(f"[f]   {name:40s} {us:9.2f} {us / step_us:7.3f} "
              f"{us * 3.35:9.1f} MB  {src}")
    per_stage = {}
    for name, tot in per_op.items():
        key = _stage(sources.get(name, []))
        per_stage[key] = per_stage.get(key, 0) + tot
    print("[f] device time by stage of the step: us/step, share of busy "
          "time, MB at 3.35 TB/s")
    for key, tot in sorted(per_stage.items(), key=lambda kv: -kv[1])[:12]:
        us = tot / n / 1e3
        print(f"[f]   {key:60s} {us:9.2f} {us / step_us:7.3f} "
              f"{us * 3.35:9.1f} MB")


def multichip(n_dev):
    """GSPMD ``make_sharded_step`` flagship at N=1024 on a (2, 2) mesh vs
    the same 20 fixed-dt steps on one device."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from pyrmt_tpu.parallel import make_mesh, make_sharded_step
    from pyrmt_tpu.sim import make_init_state, make_step

    devices = require_gpu(n_dev)[:n_dev]
    cfg, bc, phi_inits, dtype = _b_config("float32", N_FLAGSHIP)
    # the sharded step uses the dense extrapolation; so does the reference
    cfg = dataclasses.replace(cfg, extrap_method="xla")
    mesh = make_mesh(devices)
    print(f"[multichip] mesh {mesh.devices.shape} over "
          f"{[d.device_kind for d in devices]}")
    t_end = jnp.asarray(1e9, dtype)

    step1 = make_step(cfg, bc, phi_inits, dtype=dtype)
    ref = jax.device_put(make_init_state(cfg, phi_inits, dtype=dtype),
                         devices[0])
    stepN, shard = make_sharded_step(cfg, bc, phi_inits, mesh, dtype=dtype)
    out = shard(make_init_state(cfg, phi_inits, dtype=dtype))
    for _ in range(B_STEPS):
        ref, _ = step1(ref, t_end)
        out, _ = stepN(out, t_end)
    jax.block_until_ready(out.u)
    # only the reduction order differs between the two runs: on 4 virtual
    # CPU devices at N=64 the f32 difference measures <= 6e-7
    bad = []
    for f in B_FIELDS:
        err = _rel_l2(getattr(out, f), getattr(ref, f))
        print(f"[multichip] rel L2 {f:2s} sharded vs one device: {err:.3e} "
              f"(tol 1e-4)")
        if not err <= 1e-4:
            bad.append(f)
    print(f"[multichip] u sharding: {out.u.sharding}")
    assert not bad, f"fields over tolerance: {bad}"


def main(argv):
    if "--calibrate" in argv:
        calibrate()
        return
    devices = require_gpu()
    import jax

    import pyrmt_tpu.runtime as rt

    card = _nvidia_smi()
    print(f"card: {card}")
    print(f"jax {jax.__version__}, devices {len(devices)} x "
          f"{devices[0].device_kind}")
    print(f"compile cache: {rt.setup()}")
    os.makedirs(OUT_DIR, exist_ok=True)

    failed = []

    def run(name, fn, *args):
        print(f"--- phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:
            traceback.print_exc()
            print(f"--- phase {name}: FAILED", flush=True)
            failed.append(name)
            return None
        print(f"--- phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        return out

    count = len(jax.devices())
    if "--multichip" in argv:
        count = int(argv[argv.index("--multichip") + 1])
        run("multichip", multichip, count)
    else:
        import tempfile

        run("a flagship", phase_a_flagship, card)
        with tempfile.TemporaryDirectory() as tmp:
            ref_path = os.path.join(tmp, "cpu_f64.npz")
            child = _start_cpu_run(ref_path)
            try:
                gpu_b = run("b GPU f32 run", phase_b_gpu)
                run("c Ghia", phase_c_ghia)
                run("d many-body", phase_d_many_body)
                run("e periodic", phase_e_periodic)
                run("f trace", phase_f_trace)
                if gpu_b is None:
                    failed.append("b compare")
                else:
                    run("b compare", phase_b_compare, gpu_b, child, ref_path)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
    print(card)  # name, power limit: nvidia-smi's own line(s)
    if failed:
        print(f"FAILED phases: {failed}")
        sys.exit(1)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main(sys.argv[1:])
