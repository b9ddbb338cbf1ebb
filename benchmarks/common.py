"""Shared utilities for the benchmark drivers (initialisers, IO, refs).

Capability parity with the reference's benchmarks/common.py. BCs live in
pyrmt_tpu.bcs; this module keeps the field initialisers, CSV helpers and
reference-data loaders used by the validation drivers.
"""
from __future__ import annotations

import os
import sys

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def apply_cli_platform(argv=None):
    """Honour --cpu / --f64 / PYRMT_PLATFORM=cpu for driver CLIs (the
    platform knob must be set before the first backend use), then enable
    the persistent compile cache (pyrmt_tpu.runtime.setup)."""
    argv = sys.argv if argv is None else argv
    import jax

    if "--cpu" in argv or os.environ.get("PYRMT_PLATFORM") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    if "--f64" in argv:
        jax.config.update("jax_enable_x64", True)
    # strip consumed flags so drivers can parse positionals naively
    for flag in ("--cpu",):
        while flag in argv:
            argv.remove(flag)
    from pyrmt_tpu.runtime import setup

    setup()


def cli_out_root(argv=None, default="outputs"):
    """Consume '--out-root DIR' from argv (sys.argv by default) and return
    DIR. Lets smoke/verification runs redirect their CSV/NPZ artifacts away
    from the recorded ones under outputs/ (which are committed evidence).
    Must run BEFORE positional parsing: the DIR value does not start with
    '--', so naive flag-stripping would otherwise leave it as a positional.
    """
    argv = sys.argv if argv is None else argv
    if "--out-root" in argv:
        i = argv.index("--out-root")
        if i + 1 >= len(argv):
            raise SystemExit("--out-root requires a directory argument")
        val = argv[i + 1]
        del argv[i : i + 2]
        return val
    return default


def initialize_disc(X, Y, x0, y0, R):
    """Signed-distance level set of a disc (parity: benchmarks/common.py:55-57).

    Works on both numpy and jax arrays (used as the analytic phi_init inside
    the jitted step)."""
    import jax.numpy as jnp

    mod = np if isinstance(X, np.ndarray) else jnp
    return mod.sqrt((X - x0) ** 2 + (Y - y0) ** 2) - R


def make_disc_phi_init(x0, y0, R):
    def phi_init(Xq, Yq):
        return initialize_disc(Xq, Yq, x0, y0, R)

    return phi_init


def taylor_green_velocity(X, Y, U0=1.0):
    """u = U0 k sin(kx) cos(ky), v = -U0 k cos(kx) sin(ky), k = 2 pi
    (parity: benchmarks/common.py:60-65)."""
    k = 2.0 * np.pi
    u = U0 * k * np.sin(k * X) * np.cos(k * Y)
    v = -U0 * k * np.cos(k * X) * np.sin(k * Y)
    return u, v


def load_xy_csv(path, has_header=False):
    skip = 1 if has_header else 0
    data = np.loadtxt(path, delimiter=",", skiprows=skip)
    return data[:, 0], data[:, 1]


def ensure_dir(path):
    os.makedirs(path, exist_ok=True)
    return path
