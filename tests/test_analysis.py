"""Post-processing/analysis layer smoke tests (CPU only, no long sims).

The analysis scripts mirror the reference's notebook layer
(/root/reference/notebooks/plot_*.ipynb, helper/lid_driven_gif.py); these
tests pin their loaders and metrics on synthetic data and one tiny frame.
"""
import csv
import os

import numpy as np
import pytest


def _write_energy_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        for r in rows:
            w.writerow(r)


def test_energy_loader_normalises_driver_and_reference_columns(tmp_path):
    from benchmarks.analysis.common import load_energy_csv

    # driver (EnergyLogger) layout
    d1 = tmp_path / "run1"
    d1.mkdir()
    _write_energy_csv(d1 / "energy_history.csv", [
        {"t": 0.1, "ke": 1.0, "se": 0.5, "dissipation": 0.01},
        {"t": 0.2, "ke": 0.9, "se": 0.6, "dissipation": 0.02},
    ])
    cols = load_energy_csv(str(d1))
    assert np.allclose(cols["time"], [0.1, 0.2])
    assert np.allclose(cols["kinetic_energy"], [1.0, 0.9])
    assert np.allclose(cols["dissipation_rate"], [0.01, 0.02])

    # reference (output_simulation_data) layout passes through
    d2 = tmp_path / "run2"
    d2.mkdir()
    _write_energy_csv(d2 / "energy_history.csv", [
        {"time": 0.1, "kinetic_energy": 2.0, "strain_energy": 0.1,
         "total_energy": 2.1},
    ])
    cols = load_energy_csv(str(d2))
    assert cols["total_energy"][0] == 2.1


def test_centroid_and_area_from_frames(tmp_path):
    from benchmarks.analysis.common import (
        frame_grid, get_area, get_centroid, list_frames)
    from pyrmt_tpu.io import save_snapshot

    N = 32
    x = np.linspace(0, 1, N)
    X, Y = np.meshgrid(x, x)
    phi = np.hypot(X - 0.4, Y - 0.6) - 0.2
    save_snapshot(str(tmp_path / "data_000100.h5"),
                  {"phi": phi, "X1": X, "X2": Y, "a": X * 0, "b": Y * 0,
                   "p": X * 0}, attrs={"time": 0.5})
    frames = list_frames(str(tmp_path))
    assert [s for s, _ in frames] == [100]
    Xg, Yg, dx, dy = frame_grid(phi)
    cx, cy = get_centroid(phi, Xg, Yg)
    assert abs(cx - 0.4) < 2 * dx and abs(cy - 0.6) < 2 * dy
    assert abs(get_area(phi, dx, dy) - np.pi * 0.2**2) < 0.02


def test_mean_track_deviation_polyline():
    from benchmarks.soft_disc_in_lid_driven import mean_track_deviation

    # reference track: unit segment y=0; our samples sit 0.01 above it,
    # including BETWEEN the track's sparse points
    rx = np.array([0.0, 1.0])
    ry = np.array([0.0, 0.0])
    cx = np.array([0.1, 0.5, 0.9])
    cy = np.array([0.01, 0.01, 0.01])
    assert abs(mean_track_deviation(cx, cy, rx, ry) - 0.01) < 1e-12
    # off-segment points clamp to the nearest endpoint
    assert abs(mean_track_deviation(
        np.array([2.0]), np.array([0.0]), rx, ry) - 1.0) < 1e-12


def test_plot_scripts_render(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    from benchmarks.analysis import plot_centroid, plot_energy

    d = tmp_path / "run"
    d.mkdir()
    _write_energy_csv(d / "energy_history.csv", [
        {"t": 0.1 * i, "ke": 1.0 - 0.01 * i, "se": 0.01 * i,
         "dissipation": 0.0, "total_energy": 1.0}
        for i in range(5)
    ])
    out = plot_energy.run([str(d)], out_path=str(tmp_path / "e.png"))
    assert os.path.isfile(out)

    np.savetxt(d / "centroid.csv",
               np.column_stack([np.linspace(0, 1, 8),
                                0.5 + 0.1 * np.sin(np.linspace(0, 6, 8)),
                                0.5 + 0.1 * np.cos(np.linspace(0, 6, 8))]),
               delimiter=",", header="t,cx,cy", comments="")
    out = plot_centroid.run(str(d), out_path=str(tmp_path / "c.png"))
    assert os.path.isfile(out)


def test_soft_disc_panels_render(tmp_path):
    """The rewritten L4 panels script renders both figure kinds from tiny
    synthetic snapshots (round-4 hygiene rewrite — output-semantics parity
    with the reference's post-processing, independent structure)."""
    import numpy as np

    from benchmarks.plot_soft_disc_panels import (
        SnapshotSeries,
        render_interface_comparison,
        render_run_panels,
    )
    from pyrmt_tpu.io import save_snapshot

    dirs = []
    for name, n in (("a", 24), ("b", 32)):
        d = tmp_path / name
        d.mkdir()
        x = np.linspace(0, 1, n)
        X, Y = np.meshgrid(x, x)
        for k, t in enumerate([0.5, 1.0]):
            save_snapshot(
                str(d / f"snap_t{k}.npz"),
                dict(phi=np.hypot(X - 0.5, Y - 0.5) - 0.2, a=np.sin(X),
                     b=np.cos(Y), X1=X, X2=Y),
                attrs=dict(t=t, t_target=t))
        dirs.append((name, str(d)))
    p1 = tmp_path / "panels.png"
    p2 = tmp_path / "overlay.png"
    render_run_panels(SnapshotSeries(dirs[0][1]), "t", str(p1))
    render_interface_comparison(dirs, str(p2))
    assert p1.stat().st_size > 10_000 and p2.stat().st_size > 10_000
