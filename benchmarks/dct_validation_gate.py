"""One-command gate for a reduced-precision matmul DCT (DESIGN #6).

The matmul DCT lowering (``dct_method='matmul'``) at a precision below
``'highest'`` (on a GPU: TF32 or bf16 passes) perturbs every Neumann
solve. This script re-runs the four metric-bearing drivers with the matmul
lowering under ``dct_precision='default'`` and ``'highest'`` (the
FFT-parity transform), prints the DESIGN #6 table, and exits nonzero if
any metric leaves its gate. Run it before making a reduced precision the
default on any device.

Gates (CPU f64 values in parentheses, benchmarks/README.md):
  * Ghia Re=1000 N=129 RMS < 2.8e-2       (2.77e-2)
  * Sugiyama mean dev N=128 t=8 < 0.008   (0.0053)
  * disc-in-TG N=128 |energy drift| < 5% (driver returns percent; -2.96%)
  * two-disc contact N=64: gap floor > 2R=0.30, 0.60 < minJ < 0.78 (0.689)

Runtime: ~8 driver runs, each paying its compile:

    nohup python benchmarks/dct_validation_gate.py > /tmp/dct_gate.log 2>&1 &
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_all(precisions=("default", "highest"), out_root="/tmp/dct_gate_outputs"):
    from benchmarks.disc_in_taylor_green import run as run_tg
    from benchmarks.lid_driven_cavity import run as run_lid
    from benchmarks.soft_disc_in_lid_driven import run as run_sd
    from benchmarks.two_disc_contact import run as run_contact

    rows = []
    failures = []
    for prec in precisions:
        ov = {"dct_method": "matmul", "dct_precision": prec}
        t0 = time.time()

        err1000 = float(run_lid(Re=1000.0, N=129, steady_tol=5e-6,
                                cfg_overrides=ov, verbose=False,
                                out_root=out_root))
        _, _, devs = run_sd(N=128, t_end=8.0, cfg_overrides=ov,
                            verbose=False, out_root=out_root)
        sug = float(devs.get("Sugiyama2011", np.nan))
        _, drift = run_tg(N=128, t_end=1.0, cfg_overrides=ov, verbose=False,
                          out_root=out_root)
        drift = float(drift)
        hist, gmin, settled = run_contact(N=64, t_end=1.5, V0=0.15,
                                          k_rep=2.0, cfg_overrides=ov,
                                          verbose=False, out_root=out_root)
        gmin = float(gmin)
        minJ = float(np.min(np.asarray(hist)[:, 4]))
        wall = time.time() - t0

        checks = [
            ("ghia_re1000_rms", err1000, err1000 < 2.8e-2),
            ("sugiyama_dev", sug, sug < 8e-3),
            ("tg_drift_pct", drift, abs(drift) < 5.0),  # driver returns %
            ("contact_gap", gmin, gmin > 0.30),
            ("contact_minJ", minJ, 0.60 < minJ < 0.78),
        ]
        rows.append((prec, checks, wall))
        failures += [f"{prec}:{name}={val:.4g}"
                     for name, val, ok in checks if not ok]

    print(f"\n{'metric':>18s} " + " ".join(f"{p:>12s}" for p, _, _ in rows))
    for i, (name, _, _) in enumerate(rows[0][1]):
        vals = " ".join(f"{r[1][i][1]:12.4e}" for r in rows)
        flags = all(r[1][i][2] for r in rows)
        print(f"{name:>18s} {vals}  {'ok' if flags else 'FAIL'}")
    for prec, _, wall in rows:
        print(f"[{prec}] wall {wall:.0f}s")
    if failures:
        print("GATE FAILURES:", ", ".join(failures))
        return 1
    print("ALL DCT-PRECISION GATES PASS")
    return 0


if __name__ == "__main__":
    from benchmarks.common import apply_cli_platform

    apply_cli_platform()
    precs = ("default",) if "--default-only" in sys.argv else (
        "default", "highest")
    sys.exit(run_all(precisions=precs))
