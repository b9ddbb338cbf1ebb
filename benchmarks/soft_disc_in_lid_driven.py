"""Soft disc in a lid-driven cavity (Jain et al. 2019 Sec. 4.5; Sugiyama 2011).

THE primary FSI validation case — parity with the reference driver
benchmarks/soft_disc_in_lid_driven.py: a neo-Hookean disc (R=0.2 at
(0.6, 0.5)) carried by the cavity flow; the centroid trajectory is compared
against Sugiyama et al. (2011) 1024^2 and Kolahduz (2023)
(data/Sugiyama_1024x1024.csv, data/Kolahduz_2023.csv).

Physics (Jain Sec. 4.5): mu_f=1e-2, eta_s=1e-2, mu_s(code)=0.1 (paper 0.05),
rho_s=rho_f=1, no-slip walls + moving lid, Neumann/DCT pressure.

Usage:
    python benchmarks/soft_disc_in_lid_driven.py [N] [scheme] [t_end] [--f64]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run(N=128, scheme="semilagrangian", t_end=8.0, reinit_method="none",
        out_root="outputs", stress_band=False, detg_clamp=3.0, dtype="float32",
        log_every=100, snapshot_times=None, verbose=True, cfg_overrides=None):
    import jax
    import jax.numpy as jnp

    from benchmarks.common import DATA_DIR, ensure_dir, load_xy_csv, make_disc_phi_init
    from pyrmt_tpu.bcs import make_lid_bc
    from pyrmt_tpu.diagnostics import compute_kinetic_energy, disc_centroid
    from pyrmt_tpu.grid import Grid
    from pyrmt_tpu.io import EnergyLogger, save_snapshot
    from pyrmt_tpu.sim import RMTConfig, diverged, make_init_state, make_step

    dt_ = jnp.float64 if dtype == "float64" else jnp.float32
    g = Grid(Nx=N, Ny=N, Lx=1.0, Ly=1.0)
    phi_init = make_disc_phi_init(0.6, 0.5, 0.2)

    cfg = RMTConfig(
        grid=g, mu_s=0.1, kappa=0.0, rho_s=1.0, eta_s=0.01,
        mu_f=0.01, rho_f=1.0, w_t_cells=2.0, scheme=scheme,
        bc_type="neumann", reinit_method=reinit_method,
        stress_band=stress_band, detg_clamp=detg_clamp,
        # band mode differentiates the outermost extrapolated ring: needs
        # ceil(w_t/dx)+2 = 4 layers for stability (benchmarks/README.md)
        num_layers=4 if stress_band else 3,
        CFL=0.2, dt_min_cap=1e-3,
    )
    if cfg_overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **cfg_overrides)
    bc = make_lid_bc(1.0)
    step = make_step(cfg, bc, (phi_init,), dtype=dt_)
    state = make_init_state(cfg, (phi_init,), dtype=dt_)
    X, Y = g.coords(dtype=dt_)
    t_end_j = jnp.asarray(t_end, dt_)

    snap_targets = sorted(snapshot_times) if snapshot_times else []
    snap_idx = 0
    out_dir = ensure_dir(os.path.join(out_root, f"soft_disc_lid_N{N}_{scheme}"))

    @jax.jit
    def chunk(s):
        def body(carry, _):
            s, _ = carry
            s2, aux = step(s, t_end_j)
            return (s2, aux), None

        s1, aux1 = step(s, t_end_j)
        (s2, aux), _ = jax.lax.scan(body, (s1, aux1), None, length=log_every - 1)
        cx, cy = disc_centroid(aux["phis"][0], X, Y)
        ke = compute_kinetic_energy(
            s2.u, s2.v, cfg.rho_f, cfg.rho_s, aux["phis"][0], cfg.w_t, g.dx, g.dy
        )
        # one stacked scalar bundle -> ONE host transfer per chunk
        stats = jnp.stack([cx, cy, ke, jnp.min(aux["J"]), jnp.max(aux["J"]),
                           s2.t.astype(ke.dtype)])
        return s2, aux, stats

    if verbose:
        print(f"[soft-disc-lid] N={N} scheme={scheme} dtype={dtype} t_end={t_end}")
    log = EnergyLogger()
    t_wall = time.perf_counter()
    nsteps = 0
    while float(state.t) < t_end:
        state, aux, stats = chunk(state)
        nsteps += log_every
        cx, cy, ke, minJ, maxJ, t = map(float, np.asarray(stats))
        log.log(t=t, cx=cx, cy=cy, ke=ke, minJ=minJ, maxJ=maxJ)
        if verbose:
            print(f"  step {nsteps:6d} t={t:6.3f} centroid=({cx:.4f},"
                  f"{cy:.4f}) KE={ke:.3e} minJ={minJ:.3f}")
        while snap_idx < len(snap_targets) and t >= snap_targets[snap_idx]:
            tt = snap_targets[snap_idx]
            save_snapshot(
                os.path.join(out_dir, f"snap_t{tt:05.2f}.h5"),
                {"phi": aux["phis"][0], "X1": state.X1[0], "X2": state.X2[0],
                 "a": state.u, "b": state.v, "p": state.p, "J": aux["J"][0],
                 "sigma_xx": aux["sxx"][0], "sigma_xy": aux["sxy"][0],
                 "sigma_yy": aux["syy"][0]},
                attrs={"t": t, "t_target": tt},
            )
            snap_idx += 1
        if bool(diverged(state)):
            print("  [diverged]")
            break
    wall = time.perf_counter() - t_wall
    if verbose:
        print(f"[soft-disc-lid] {nsteps} steps in {wall:.1f}s "
              f"({nsteps / wall:.1f} steps/s)")

    traj = log.array("t", "cx", "cy", "minJ", "maxJ")
    np.savetxt(os.path.join(out_dir, "centroid.csv"), traj, delimiter=",",
               header="t,cx,cy,minJ,maxJ", comments="")

    # orbit x-extent diagnostic vs Sugiyama (benchmarks/README.md:107-113:
    # grid-converged orbit x-extent ~0.70)
    x_extent = float(traj[:, 1].max() - traj[:, 1].min()) if len(traj) else float("nan")
    refs = {}
    for name, fn in (("Sugiyama2011", "Sugiyama_1024x1024.csv"),
                     ("Kolahduz2023", "Kolahduz_2023.csv")):
        path = os.path.join(DATA_DIR, fn)
        if os.path.isfile(path):
            refs[name] = load_xy_csv(path)
    devs = {}
    if len(traj):
        for name, (rx, ry) in refs.items():
            devs[name] = mean_track_deviation(traj[:, 1], traj[:, 2], rx, ry)
    if verbose and refs:
        for name, (rx, ry) in refs.items():
            line = f"  ref {name}: x-extent={rx.max() - rx.min():.3f}"
            if name in devs:
                line += f"  centroid mean deviation={devs[name]:.4f}"
            print(line)
        print(f"  ours: orbit x-extent={x_extent:.3f}")
    return traj, x_extent, devs


def mean_track_deviation(cx, cy, rx, ry):
    """Mean over OUR centroid samples of the distance to the published
    track's polyline (time-free geometric deviation: how far our orbit
    strays from the published one). The published CSVs carry no timestamps
    and may cover a different time span, so the reverse direction would
    penalise unvisited track segments rather than trajectory error."""
    ours = np.column_stack([cx, cy])
    A = np.column_stack([rx, ry])[:-1]
    B = np.column_stack([rx, ry])[1:]
    AB = B - A
    denom = (AB * AB).sum(-1).clip(1e-30)
    t = ((ours[:, None, :] - A[None, :, :]) * AB[None, :, :]).sum(-1) / denom[None, :]
    t = np.clip(t, 0.0, 1.0)
    proj = A[None, :, :] + t[:, :, None] * AB[None, :, :]
    d = np.sqrt(((ours[:, None, :] - proj) ** 2).sum(-1)).min(axis=1)
    return float(d.mean())


if __name__ == "__main__":
    from benchmarks.common import apply_cli_platform, cli_out_root

    apply_cli_platform()
    out_root = cli_out_root()
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    scheme = sys.argv[2] if len(sys.argv) > 2 else "semilagrangian"
    t_end = float(sys.argv[3]) if len(sys.argv) > 3 else 8.0
    dtype = "float64" if "--f64" in sys.argv else "float32"
    run(N=N, scheme=scheme, t_end=t_end, dtype=dtype, out_root=out_root)
