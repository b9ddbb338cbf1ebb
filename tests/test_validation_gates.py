"""Fast CI tier: the published validation numbers as HARD gates.

Round-2 verdict weak item #4/#7: the recorded validation metrics (Ghia RMS,
Laplace law, contact predicates — benchmarks/README.md) were asserted only by
hand-run drivers; nothing automated would catch a regression that spends the
margin. This file runs the same drivers at CI-affordable sizes with pinned
tolerances (each ~1.5-2x the measured value, far below the failure regime).

Measured anchors on this backend (CPU f64; benchmarks/README.md has the
full-size numbers):
  * Ghia Re=100 N=65  RMS 3.36e-3   (gate 5e-3)
  * Laplace N=48 gamma=.1 R=.25 rel err 0.76% csf (gate 1.5%); the
    balanced-force CSF must additionally not be worse
  * two-disc contact N=48 t=0.6: no pass-through, gap > 2R
  * density-contrast N=48 ratio 10: sinks, CG converged far below cap
"""

import pytest

pytestmark = pytest.mark.slow  # full local tier only; fast tier = -m 'not slow'
import numpy as np
import pytest


def test_gate_ghia_re100_N65():
    from benchmarks.lid_driven_cavity import run

    err = run(Re=100.0, N=65, dtype="float64", verbose=False,
              out_root="/tmp/gate_outputs")
    assert err < 5e-3, f"Ghia Re=100 N=65 RMS {err:.3e} exceeds gate 5e-3"


def test_gate_laplace_law_and_balanced_csf():
    from benchmarks.surface_tension_drop import run

    dp, target, err = run(N=48, gamma=0.1, R=0.25, n_steps=1200,
                          dtype="float64", verbose=False,
                          out_root="/tmp/gate_outputs")
    assert err < 1.5e-2, f"Laplace rel err {err:.3e} exceeds gate 1.5e-2"
    dp_b, _, err_b = run(N=48, gamma=0.1, R=0.25, n_steps=1200,
                         dtype="float64", verbose=False, st_method="balanced",
                         kappa_interface=True, out_root="/tmp/gate_outputs")
    # the balanced-force + interface-curvature upgrade must stay strictly
    # more accurate than the reference-parity CSF on its own validation case
    assert err_b < err, (err_b, err)


def test_gate_two_disc_contact_no_passthrough():
    from benchmarks.two_disc_contact import run

    hist, gmin, _ = run(N=48, t_end=0.6, dtype="float64", verbose=False,
                        out_root="/tmp/gate_outputs")
    assert gmin > 2 * 0.15, f"discs passed through: min gap {gmin:.3f}"
    minJ = float(np.min(np.asarray(hist)[:, 4]))   # columns: t,cxa,cxb,gap,minJ
    assert 0.5 < minJ < 1.0, f"min J {minJ:.3f} outside the physical range"


def test_gate_density_contrast_sinks_with_bounded_cg():
    from benchmarks.density_contrast_disc import run

    rows, s = run(N=48, rho_ratio=10.0, t_end=0.25, dtype="float64",
                  verbose=False, out_root="/tmp/gate_outputs")
    assert s["vc_final"] < 0, "heavy disc failed to sink"
    assert s["cg_iters_max"] < 100, s["cg_iters_max"]
    # collocated approximate projection: the controlled quantity is the RC
    # face divergence; the cell-centred residual stays O(h) near the
    # interface. Measured 0.06 of the umax/dx scale; the constant-rho DCT
    # path sits at ~0.26 on a comparable flow, so gate well under that.
    assert s["max_div_rel"] < 0.2, s["max_div_rel"]


def test_gate_sedimentation_pack_small():
    """n-solid machinery gate: a 3-disc pack settles without pass-through,
    with bounded CG and conserved areas (S*(S-1)/2 contact pairs + the
    variable-density projection in one config)."""
    from benchmarks.sedimentation_pack import run

    rows, s = run(N=48, S=3, R=0.1, t_end=0.25, dtype="float64",
                  verbose=False, out_root="/tmp/gate_outputs")
    assert s["stable"]
    assert s["no_passthrough"], (s["dmin"], s["gap_floor"])
    assert s["ybar_monotone"]
    assert s["cg_iters_max"] < 100
    assert s["area_drift"] < 0.05


def test_gate_periodic_taylor_green_decay():
    """Round-4 gate: the doubly-periodic stack must track the analytic
    Taylor-Green viscous decay (measured 0.30% rate error at N=65 f64,
    gate 1%) and hold the solver-level divergence. The upstream code blows
    up at t~0.1 on this exact protocol (its momentum stencils stay
    one-sided at the ring; benchmarks/upstream_rerun/run_periodic_tg.py),
    so this gate also pins the docs/DESIGN.md #10 deviation."""
    from benchmarks.periodic_taylor_green import run

    _, s = run(N=65, nu=0.01, t_end=0.5, dtype="float64", verbose=False,
               log_every=100, out_root="/tmp/gate_outputs")
    assert s["stable"]
    assert s["rate_rel_err"] < 1e-2, s
    assert s["profile_rel_err"] < 5e-3, s
    assert s["maxdiv"] < 1e-6, s
