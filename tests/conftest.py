"""Test harness configuration.

Tests run on the CPU backend with float64 enabled so the reference
tolerances (down to 1e-10) are meaningful, and with an 8-device virtual CPU
mesh so multi-device sharding tests exercise real collectives. This mirrors
how the reference suite runs grid-small cases on CPU.

``JAX_PLATFORMS``, when set, names the platforms; unset, the CPU is forced.
The tests marked ``gpu`` take the ``gpu_device`` fixture, which skips them
unless JAX has a GPU: run them on a GPU machine with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/")
