"""Platform policy: no backend choice reads the platform string, nothing
falls back to the CPU when a GPU was asked for, and the compile cache goes
where ``JAX_COMPILATION_CACHE_DIR`` says (else a fixed in-checkout path)."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import pytest

import pyrmt_tpu
from pyrmt_tpu import runtime
from pyrmt_tpu.grid import Grid
from pyrmt_tpu.sim import (
    RMTConfig,
    _resolve_dct_mats,
    _resolve_dct_precision,
    _resolve_extrap,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_KNOBS = ("jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs",
                "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture
def restore_cache_config():
    saved = {k: getattr(jax.config, k) for k in _CACHE_KNOBS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_runtime_setup_honours_jax_compilation_cache_dir(
        monkeypatch, tmp_path, restore_cache_config):
    target = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    assert runtime.setup() == target
    assert jax.config.jax_compilation_cache_dir == target
    assert os.path.isdir(target)


def test_runtime_setup_defaults_to_checkout_cache(monkeypatch,
                                                  restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


@pytest.mark.parametrize("backend", ["gpu", "tpu", "cpu"])
def test_auto_backend_choices_ignore_the_platform(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert _resolve_dct_mats("auto", 17, 17, jnp.float32) is None
    assert _resolve_dct_precision("auto") == "highest"
    from pyrmt_tpu.ops.extrapolate import extrapolate_reference_map_sparse
    assert _resolve_extrap("auto") is extrapolate_reference_map_sparse


@pytest.mark.parametrize("name", [
    "use_pallas_rhs", "momentum_method", "rmt_method", "rmt_panel_width",
    "rmt_tile", "kernel_slab_halo", "projection_method",
])
def test_removed_kernel_options_are_gone(name):
    assert name not in {f.name for f in dataclasses.fields(RMTConfig)}
    with pytest.raises(TypeError):
        RMTConfig(grid=Grid(Nx=9, Ny=9, Lx=1.0, Ly=1.0), **{name: None})


def test_pallas_extrapolation_value_is_rejected():
    with pytest.raises(ValueError, match="extrap_method"):
        _resolve_extrap("pallas")


def test_package_has_no_kernel_tier():
    assert importlib.util.find_spec("pyrmt_tpu.kernels") is None
    pkg = os.path.dirname(pyrmt_tpu.__file__)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "pallas" not in fh.read().lower(), f


def test_chip_smoke_refuses_a_cpu_backend():
    import chip_smoke

    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.require_gpu()


def test_chip_smoke_hlo_sources_survive_a_moved_checkout():
    """The trace reduction maps each compiled HLO op to its source lines in
    the repository, also for an executable that the compile cache brings
    from a checkout at another path."""
    import chip_smoke
    from pyrmt_tpu.ops import fd

    text = jax.jit(lambda u: fd.grad_central_x_2nd(u, 0.1)).lower(
        jnp.ones((16, 16))).compile().as_text()
    here = chip_smoke._hlo_sources(text)
    assert any(chain and chain[0].startswith("pyrmt_tpu/ops/fd.py:")
               for chain in here.values())
    assert chip_smoke._hlo_sources(
        text.replace(REPO, "/elsewhere/pyrmt_tpu")) == here


@pytest.mark.parametrize("chain, stage", [
    (["pyrmt_tpu/ops/extrapolate.py:351 _layer",
      "pyrmt_tpu/ops/extrapolate.py:400 extrapolate_reference_map_sparse",
      "pyrmt_tpu/sim.py:713 make_step.<locals>._step"],
     "pyrmt_tpu/sim.py:713 extrapolate_reference_map_sparse"),
    (["pyrmt_tpu/sim.py:709 make_step.<locals>._step"],
     "pyrmt_tpu/sim.py:709 (inline)"),
    (["pyrmt_tpu/ops/fd.py:24 grad_central_x_2nd",
      "pyrmt_tpu/ops/extrapolate.py:248 extrapolate_reference_map"],
     "pyrmt_tpu/ops/extrapolate.py:248 extrapolate_reference_map "
     "(inner jit)"),
    ([], "?"),
])
def test_chip_smoke_groups_ops_by_step_stage(chain, stage):
    import chip_smoke

    assert chip_smoke._stage(chain) == stage


def test_bench_refuses_a_cpu_backend(restore_cache_config):
    import bench

    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main(N=16, n_steps=2)


@pytest.mark.parametrize("platforms", ["", "cuda"])
def test_dryrun_multichip_refuses_too_few_devices(monkeypatch, platforms):
    """Without JAX_PLATFORMS=cpu there is no switch to a virtual CPU mesh:
    asking for more devices than the backend has raises before any
    compile."""
    import __graft_entry__ as ge

    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    with pytest.raises(RuntimeError, match="need 64 devices"):
        ge.dryrun_multichip(64)
