"""Micro-benchmark of the Neumann DCT-I Poisson solve variants.

Times CHAINED solves (``iters`` applications compiled into one scanned XLA
program, so per-dispatch overhead drops out) for:

  * the rFFT lowering (`dct_method='fft'`),
  * the one-level even/odd fold matmuls (`'matmul'`),
  * the recursive fold (`'matmul_rec'`, odd N only) across min_leaf choices.

Usage:  python benchmarks/dct_variants_bench.py [N ...] [--cpu] [--f64]
Odd N run all variants; even N skip 'matmul_rec'.
"""
from __future__ import annotations

import sys
import time


def _chain(solve, rhs0, iters):
    import jax
    from jax import lax

    @jax.jit
    def chunk(c):
        def body(c2, _):
            p = solve(c2)
            # renormalise so the chain neither decays nor blows up; one cheap
            # reduction per iter vs four N^2-by-N matmuls
            return p / (jax.numpy.max(jax.numpy.abs(p)) + 1e-30), None

        return lax.scan(body, c, None, length=iters)[0]

    out = chunk(rhs0)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = chunk(out)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def run(N, dtype=None, iters=200, precision="high"):
    import jax.numpy as jnp
    import numpy as np

    from pyrmt_tpu.ops.poisson import (
        precompute_dct_matrices,
        precompute_dct_plan,
        precompute_poisson_eigenvalues,
        solve_poisson_dct,
    )

    dtype = dtype or jnp.float32
    dx = 1.0 / (N - 1)
    eig = np.asarray(precompute_poisson_eigenvalues(N, N, dx, dx))
    rng = np.random.default_rng(0)
    rhs = jnp.asarray(rng.standard_normal((N, N)), dtype)

    variants = [("fft", None, None)]
    variants.append(("matmul", precompute_dct_matrices(N, N, dtype=dtype),
                     precision))
    if N % 2 == 1:
        for leaf in (64, 128, 256):
            variants.append(
                (f"matmul_rec leaf={leaf}",
                 precompute_dct_plan(N, N, dtype=dtype, min_leaf=leaf),
                 precision))

    print(f"[dct_variants] N={N} dtype={jnp.dtype(dtype).name} "
          f"precision={precision} iters={iters}")
    results = {}
    for name, mats, prec in variants:
        ms = _chain(lambda c: solve_poisson_dct(c, eig, dct_mats=mats,
                                                precision=prec), rhs, iters)
        results[name] = ms
        print(f"  {name:24s} {ms:8.4f} ms/solve", flush=True)
    return results


if __name__ == "__main__":
    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from benchmarks.common import apply_cli_platform

    apply_cli_platform()
    import jax.numpy as jnp

    dtype = jnp.float64 if "--f64" in sys.argv else jnp.float32
    Ns = [int(a) for a in sys.argv[1:] if a.isdigit()] or [1025]
    for N in Ns:
        run(N, dtype=dtype)
