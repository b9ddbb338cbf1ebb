"""Multi-chip scaling: 2D spatial domain decomposition over a device mesh.

The reference has NO distributed execution of any kind (SURVEY.md section
2.3) — its only parallelism is Numba threads inside one process. The
scaling axis for a stencil PDE code is SPATIAL domain decomposition: shard
the (Ny, Nx) grid over a 2D ``jax.sharding.Mesh`` and jit the SAME step
function with sharding annotations. XLA's SPMD partitioner then inserts the
communication automatically:

  * halo exchanges (collective-permute) for the <=4-cell stencils and the
    9x9 extrapolation convolutions,
  * all-to-alls for the DCT/FFT Poisson transforms,
  * psums for the reductions (max|u| in the adaptive dt, means in the
    de-meaned pressure).

No NCCL/MPI translation layer exists or is needed — the mesh + shardings ARE
the communication backend.
"""
from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None, axis_names=("gy", "gx")):
    """Build a near-square 2D mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    ry = int(math.sqrt(n))
    while n % ry:
        ry -= 1
    rx = n // ry
    arr = np.array(devices).reshape(ry, rx)
    return Mesh(arr, axis_names)


def state_sharding(mesh: Mesh, rebasing: bool = False, S: int = 1):
    """NamedShardings for the SimState pytree: 2D fields sharded over the
    grid axes, solid stacks replicated over the (small) solid axis, scalars
    replicated. EMPTY stacks stay REPLICATED — the partitioner outputs a
    zero-size array as replicated, and declaring a split in_sharding for it
    breaks step-on-own-output chains with a sharding-mismatch ValueError:
    the (0, Ny, Nx) X1/X2 of a pure-fluid (S=0) state, and phis0 whenever
    map rebasing is off (``rebasing=False``)."""
    gy, gx = mesh.axis_names
    field = NamedSharding(mesh, P(gy, gx))
    stack = NamedSharding(mesh, P(None, gy, gx))
    scalar = NamedSharding(mesh, P())
    from pyrmt_tpu.sim import SimState

    maps = stack if S > 0 else scalar
    return SimState(u=field, v=field, p=field, X1=maps, X2=maps,
                    t=scalar, step=scalar,
                    phis0=stack if rebasing else scalar)


def _normalize_phis0(state):
    """Replace a legacy ``phis0=None`` with the canonical empty (0, Ny, Nx)
    stack so every sharded state has one pytree structure."""
    if state.phis0 is not None:
        return state
    import dataclasses

    import jax.numpy as jnp

    return dataclasses.replace(
        state, phis0=jnp.zeros((0,) + state.u.shape, state.u.dtype))


def shard_state(state, mesh: Mesh):
    """Place an existing SimState onto the mesh with the canonical layout."""
    state = _normalize_phis0(state)
    sh = state_sharding(mesh, rebasing=state.phis0.shape[0] > 0,
                        S=state.X1.shape[0])
    return jax.tree.map(jax.device_put, state, sh)


def make_sharded_step(cfg, velocity_bc, phi_inits, mesh: Mesh, dtype=None,
                      traced_params=None):
    """Jit the FSI step with explicit in/out shardings over ``mesh``.

    The step body is IDENTICAL to the single-device one — the partitioner
    owns the collectives. Returns (step_fn, shard_fn).

    ``traced_params`` (see sim.make_step): the returned step is then
    ``step(state, t_end, params)`` with the named physics scalars
    REPLICATED over the mesh — sharded physics-scalar gradients compose
    with GSPMD (the dryrun's gradient tier pins this).
    """
    import dataclasses

    import jax.numpy as jnp

    from pyrmt_tpu.sim import make_step

    dtype = dtype or jnp.float32
    S = len(phi_inits)
    # the dense shift-add extrapolation partitions into halo exchanges (the
    # sharded path tests/test_sharding.py pins)
    cfg = dataclasses.replace(cfg, extrap_method="xla")
    base_step = make_step(cfg, velocity_bc, phi_inits, dtype=dtype,
                          traced_params=traced_params)
    sh = state_sharding(mesh, rebasing=cfg.map_rebase_minj > 0.0 and S > 0,
                        S=S)
    scalar = NamedSharding(mesh, P())

    if traced_params is not None:
        step = jax.jit(
            lambda s, t_end, params: base_step(s, t_end, params),
            # `scalar` is a pytree PREFIX for the params dict: every named
            # physics scalar is replicated
            in_shardings=(sh, scalar, scalar),
            out_shardings=None,
        )
    else:
        step = jax.jit(
            lambda s, t_end: base_step(s, t_end),
            in_shardings=(sh, scalar),
            out_shardings=None,  # let the partitioner propagate
        )

    def shard(state):
        return jax.tree.map(jax.device_put, _normalize_phis0(state), sh)

    return step, shard
