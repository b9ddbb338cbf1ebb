"""Runtime/compile-cache configuration.

The reference amortises Numba's ~18 s cold start with ``cache=True``. The
JAX equivalent is the persistent compilation cache: the first compile of
the scanned timestep takes long, later processes load the compiled
executable from disk. Call ``setup()`` before the first jitted call.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says, if it is set, and
otherwise at a fixed path inside the checkout (``<repo>/.jax_cache``,
git-ignored), so that later runs from the same checkout find it.
"""
from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def setup(enable_x64: bool = False):
    """Enable the persistent XLA compilation cache (+ optional float64).
    Returns the cache directory."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    if enable_x64:
        jax.config.update("jax_enable_x64", True)
    return path
