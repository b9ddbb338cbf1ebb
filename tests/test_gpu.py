"""GPU checks (marker ``gpu``; skip without a GPU via the gpu_device
fixture). Run on a GPU machine with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _flagship
from pyrmt_tpu.sim import make_init_state, make_run_chunk, make_step

pytestmark = pytest.mark.gpu


def _run(dtype, device, n_steps=20):
    cfg, bc, phi_inits = _flagship(64, dtype)
    cfg = dataclasses.replace(cfg, fixed_dt=1e-4)
    with jax.default_device(device):
        chunk = make_run_chunk(make_step(cfg, bc, phi_inits, dtype=dtype),
                               n_steps)
        state, _ = chunk(make_init_state(cfg, phi_inits, dtype=dtype),
                         jnp.asarray(1e9, dtype))
    return state


def test_flagship_f32_on_gpu_matches_cpu_f64(gpu_device):
    """20 fixed-dt flagship steps at N=64: f32 on the GPU against f64 on
    the CPU. CPU f32 reaches at most 4.1e-6 relative L2 against CPU f64
    on this case (in v); the gate is ~10x that, far below the ~1e-3 of a
    TF32 matmul."""
    gpu = _run(jnp.float32, gpu_device)
    ref = _run(jnp.float64, jax.devices("cpu")[0])
    assert gpu.u.devices() == {gpu_device}
    for f in ("u", "v", "p", "X1", "X2"):
        a = np.asarray(getattr(gpu, f), np.float64)
        b = np.asarray(getattr(ref, f))
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err < 5e-5, (f, err)
