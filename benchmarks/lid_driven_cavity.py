"""Lid-driven cavity — pure-fluid solver validation against Ghia et al. (1982).

Capability parity with the reference driver benchmarks/lid_driven_cavity.py:
runs the incompressible Navier-Stokes solver (S = 0 solids) to steady state
and reports the RMS error of the centerline u(y) profile against the Ghia
data in data/plot_u_y_Ghia{100,1000}.csv.

The whole time loop runs as scanned chunks of the single jitted
step; the steady-state residual is checked between chunks (one scalar
transfer per chunk, not per step).

Usage:
    python benchmarks/lid_driven_cavity.py [Re] [N] [--f64]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run(Re=100.0, N=129, max_steps=60000, steady_tol=2e-5, chunk=200,
        dtype="float32", out_root="outputs", verbose=True, resume_from=None,
        cfg_overrides=None):
    import jax
    import jax.numpy as jnp

    from benchmarks.common import DATA_DIR, ensure_dir, load_xy_csv
    from pyrmt_tpu.bcs import make_lid_bc
    from pyrmt_tpu.diagnostics import extract_centerlines
    from pyrmt_tpu.grid import Grid
    from pyrmt_tpu.io import load_checkpoint, save_checkpoint
    from pyrmt_tpu.sim import RMTConfig, make_init_state, make_step

    dt_ = jnp.float64 if dtype == "float64" else jnp.float32

    g = Grid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
    U_lid = 1.0
    mu_f = 1.0 * U_lid * 1.0 / Re
    cfg = RMTConfig(
        grid=g, mu_f=mu_f, rho_f=1.0, CFL=0.2, dt_min_cap=1e-2,
        bc_type="neumann",
    )
    if cfg_overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **cfg_overrides)
    bc = make_lid_bc(U_lid)
    step = make_step(cfg, bc, phi_inits=(), dtype=dt_)
    if resume_from:
        # polish mode: continue from an earlier run's steady state (e.g. a
        # fast f32 solve on the GPU refined on CPU in f64 with a tighter
        # tolerance)
        state = load_checkpoint(resume_from, dtype=dt_)
    else:
        state = make_init_state(cfg, phi_inits=(), dtype=dt_)
    u0, v0 = bc(state.u, state.v)
    state = type(state)(u=u0, v=v0, p=state.p, X1=state.X1, X2=state.X2,
                        t=state.t, step=state.step)

    t_end = jnp.asarray(1e9, dt_)  # steady-state run: never clip dt

    @jax.jit
    def run_chunk(s):
        def body(carry, _):
            s, _ = carry
            s2, aux = step(s, t_end)
            return (s2, aux["dt"]), None

        u_prev = s.u
        (s2, last_dt), _ = jax.lax.scan(body, (s, jnp.asarray(0.0, dt_)), None,
                                        length=chunk)
        # steady-state residual + diagnostics in ONE stacked transfer
        res = jnp.max(jnp.abs(s2.u - u_prev)) / (last_dt * chunk)
        umax = jnp.max(jnp.hypot(s2.u, s2.v))
        return s2, jnp.stack([res, umax, s2.t.astype(res.dtype)])

    if verbose:
        print(f"[lid-driven] Re={Re:.0f} N={N} mu_f={mu_f:.3e} dtype={dtype}")
    t_wall = time.perf_counter()
    n = 0
    while n < max_steps:
        state, stats = run_chunk(state)
        n += chunk
        res, umax, t_now = map(float, np.asarray(stats))
        if verbose:
            print(f"  step {n:6d} t={t_now:7.3f} max|v|={umax:.4f} "
                  f"resid={res:.2e}")
        if res < steady_tol:
            if verbose:
                print(f"  -> steady state reached at step {n}")
            break
    wall = time.perf_counter() - t_wall

    X, Y = g.coords(dtype=dt_)
    y, u_line, x, v_line = extract_centerlines(state.u, state.v, X, Y)
    y, u_line = np.asarray(y), np.asarray(u_line)

    ghia_path = os.path.join(DATA_DIR, f"plot_u_y_Ghia{int(Re)}.csv")
    err = None
    if os.path.isfile(ghia_path):
        yg, ug = load_xy_csv(ghia_path, has_header=True)
        u_interp = np.interp(yg, y, u_line)
        err = float(np.sqrt(np.mean((u_interp - ug) ** 2)))
        if verbose:
            print(f"[lid-driven] Re={Re:.0f} RMS error vs Ghia (u at x=0.5): "
                  f"{err:.4e}  ({n} steps, {wall:.1f}s, "
                  f"{n / wall:.1f} steps/s)")
    out_dir = ensure_dir(os.path.join(out_root, f"lid_driven_Re{int(Re)}"))
    np.savetxt(os.path.join(out_dir, "centerline_u_vs_y.csv"),
               np.column_stack([y, u_line]), delimiter=",", header="y,u",
               comments="")
    save_checkpoint(os.path.join(out_dir, "steady_state.npz"), state)
    return err


if __name__ == "__main__":
    from benchmarks.common import apply_cli_platform, cli_out_root

    apply_cli_platform()
    out_root = cli_out_root()
    argv = sys.argv[1:]
    dtype = "float64" if "--f64" in argv else "float32"
    kw = {"out_root": out_root}
    if "--tol" in argv:
        i = argv.index("--tol")
        kw["steady_tol"] = float(argv[i + 1])
        del argv[i : i + 2]
    if "--resume" in argv:
        # f64 polish workflow: run f32 on the GPU first, then
        #   --cpu --f64 --resume outputs/lid_driven_Re<Re>/steady_state.npz
        i = argv.index("--resume")
        kw["resume_from"] = argv[i + 1]
        del argv[i : i + 2]
    argv = [a for a in argv if not a.startswith("--")]
    Re = float(argv[0]) if len(argv) > 0 else 100.0
    N = int(argv[1]) if len(argv) > 1 else 129
    run(Re=Re, N=N, dtype=dtype, **kw)
