"""Poisson solvers and divergence/gradient companions for the projection.

Capability parity with the reference's solver hub
(pyRMT/functions.py:870-1285):

  * DCT-I direct Neumann solve whose eigenvalues match the ghost-mirror
    (p[-1]=p[1]) discrete Laplacian exactly (C17/C21),
  * periodic FFT solve on the reduced (N-1)^2 sub-grid with exact wide-central
    symbol and null-mode (constant + Nyquist checkerboard) pinning (C23),
  * plain + Rhie-Chow divergences and the matching pressure gradients
    (C18-C20),
  * matrix-free variable-density operator grad.((1/rho) grad p) with
    face-averaged 1/rho and Neumann ghost mirroring (C22), solved by
    preconditioned CG (replaces pyamg entirely: the DCT direct solve IS the
    preconditioner, which is the reference's own fast path at
    pyRMT/functions.py:1234-1237).

Design: XLA has no native DCT, so DCT-I is computed as the real part of an
rFFT of the even-symmetric extension (length 2(N-1)) — exactly the same
transform, O(N log N) on XLA's FFT path (cuFFT on a GPU). All solves are pure
functions safe to call inside one jitted timestep.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


# ── DCT-I (type 1, unnormalised — matches scipy.fft.dctn(type=1)) ───────────


def dct1(x, axis=-1):
    """Unnormalised DCT-I along ``axis`` via rFFT of the even extension.

    For x of length N the even-symmetric extension [x0..x_{N-1}, x_{N-2}..x1]
    has length 2(N-1) and its FFT is real and equals the DCT-I.
    """
    N = x.shape[axis]
    body = jax.lax.slice_in_dim(x, 1, N - 1, axis=axis)
    ext = jnp.concatenate([x, jnp.flip(body, axis=axis)], axis=axis)
    return jnp.real(jnp.fft.rfft(ext, axis=axis))


def idct1(x, axis=-1):
    """Unnormalised inverse DCT-I (scipy idctn type=1): DCT-I / (2(N-1))."""
    N = x.shape[axis]
    return dct1(x, axis=axis) / (2.0 * (N - 1))


def dct1_2d(x):
    return dct1(dct1(x, axis=-1), axis=-2)


def idct1_2d(x):
    return idct1(idct1(x, axis=-1), axis=-2)


# ── DCT-I as a dense matmul ──────────────────────────────────────────────
#
# The 2(N-1) even-extension length of the FFT lowering is usually not a
# power of two, while a dense transform matrix turns each 1D DCT-I pass into
# one (N, N) x (N, N) matmul. At N=1024 one Neumann solve is 4 matmuls
# ≈ 8.6 GFLOP. Matmuls run at HIGHEST precision so the f32 result matches
# the FFT path to roundoff. Which lowering is faster depends on the device
# and N (RMTConfig.dct_method; 'auto' is the FFT).


def dct1_matrix(N, dtype=jnp.float32):
    """Dense unnormalised DCT-I matrix: (C @ x)[k] == dct1(x)[k].

    C[k, n] = w_n cos(pi k n / (N-1)), w_0 = w_{N-1} = 1, else 2 — the same
    transform as ``dct1`` (scipy dctn type=1 convention)."""
    import numpy as np

    k = np.arange(N)[:, None]
    n = np.arange(N)[None, :]
    C = np.cos(np.pi * k * n / (N - 1))
    w = np.full(N, 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    return jnp.asarray(C * w[None, :], dtype=dtype)


def _dct1_fold_matrices(N, dtype):
    """Even/odd half-size factor matrices (E, O) of the DCT-I matrix C.

    The reflection n -> N-1-n flips the cosine's sign by (-1)^k, so folding
    the input into e_n = x_n + x_{N-1-n} and o_n = x_n - x_{N-1-n} splits the
    (N,N) transform into two independent (~N/2, ~N/2) matmuls — half the
    matmul FLOPs for the same (bit-different, roundoff-equal) transform:
    E = C[0::2, :ceil(N/2)] acts on e, O = C[1::2, :floor(N/2)] acts on o.
    """
    C = dct1_matrix(N, dtype)
    no = N // 2
    ne = N - no
    return C[0::2, :ne], C[1::2, :no]


def _dct1_inverse_fold_matrices(N, dtype):
    """Half-size factor matrices (Ie, Io) for applying the DCT-I matrix to a
    spectral vector stored in FOLD order (even-k block then odd-k block).

    Splitting z = C @ yhat by coefficient parity, Ce = C[:, 0::2] has rows
    symmetric under k -> N-1-k and Co = C[:, 1::2] antisymmetric rows, so
    only the top ceil(N/2) rows of each are needed: with s = Ie @ ye and
    a = Io @ yo, z = [s + a ; reverse((s - a)[:floor(N/2)])]. Together with
    ``_dct1_fold_matrices`` this keeps a whole Poisson solve in the fold
    domain — no interleave/deinterleave relayouts between the matmuls.
    """
    C = dct1_matrix(N, dtype)
    ne = N - N // 2
    return C[:ne, 0::2], C[:ne, 1::2]


def precompute_dct_matrices(Nx, Ny, dtype=jnp.float32):
    """(Ey, Oy, Ex, Ox, Iey, Ioy, Iex, Iox) even/odd-folded transform
    matrices for the matmul DCT-I path: forward factors from
    ``_dct1_fold_matrices`` plus fold-order inverse factors from
    ``_dct1_inverse_fold_matrices`` (used by the fold-domain Poisson
    solve)."""
    Ey, Oy = _dct1_fold_matrices(Ny, dtype)
    Ex, Ox = _dct1_fold_matrices(Nx, dtype)
    Iey, Ioy = _dct1_inverse_fold_matrices(Ny, dtype)
    Iex, Iox = _dct1_inverse_fold_matrices(Nx, dtype)
    return Ey, Oy, Ex, Ox, Iey, Ioy, Iex, Iox


# f32 matmul precision for the DCT transforms. The default HIGHEST keeps the
# matmul path equal to the FFT path to roundoff — the parity formulation
# pinned in tests/test_poisson.py. Lower precisions (on a GPU: TF32 or bf16
# passes) trade accuracy for matmul time and are not validated there
# (docs/DESIGN.md #6). Threaded as an explicit
# ``precision`` parameter (RMTConfig.dct_precision) so the choice is part
# of the traced program, not hidden module state.
_PRECISIONS = {
    None: jax.lax.Precision.HIGHEST,
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def resolve_matmul_precision(precision):
    """Map None/'highest'/'high'/'default' (or a jax.lax.Precision) to a
    jax.lax.Precision."""
    if isinstance(precision, jax.lax.Precision):
        return precision
    try:
        return _PRECISIONS[precision]
    except KeyError:
        raise ValueError(
            f"unknown dct matmul precision {precision!r}; expected one of "
            f"{sorted(k for k in _PRECISIONS if k)}") from None


def _mm(a, b, precision=None):
    return jnp.matmul(a, b, precision=resolve_matmul_precision(precision))


def _dct1_rows_folded(x, E, O, precision=None):
    """Folded DCT-I down the rows: interleave(E @ e, O @ o)."""
    ne, no = E.shape[0], O.shape[0]
    N = ne + no
    xr = x[::-1][:no]
    e = x[:no] + xr
    if ne > no:  # odd N: the middle row pairs with itself
        e = jnp.concatenate([e, x[no:no + 1]], axis=0)
    o = x[:no] - xr
    ye = _mm(E.astype(x.dtype), e, precision)
    yo = _mm(O.astype(x.dtype), o, precision)
    if ne > no:
        yo = jnp.concatenate([yo, jnp.zeros_like(yo[:1])], axis=0)
    return jnp.stack([ye, yo], axis=1).reshape(2 * ne, -1)[:N]


def dct1_2d_matmul(x, mats, precision=None):
    """2D unnormalised DCT-I via four half-size matmuls (one even/odd
    folded pass per axis); same transform as ``dct1_2d`` to roundoff."""
    Ey, Oy, Ex, Ox = mats[:4]
    y = _dct1_rows_folded(x, Ey, Oy, precision)
    return _dct1_rows_folded(y.T, Ex, Ox, precision).T


def idct1_2d_matmul(x, mats, precision=None):
    Ey, Oy, Ex, Ox = mats[:4]
    Ny = Ey.shape[0] + Oy.shape[0]
    Nx = Ex.shape[0] + Ox.shape[0]
    scale = 1.0 / (2.0 * (Ny - 1) * 2.0 * (Nx - 1))
    return dct1_2d_matmul(x, mats, precision) * jnp.asarray(scale, x.dtype)


def _fold_rows(x, ne, no):
    """(e, o) even/odd reflection fold down the rows (odd sizes keep the
    self-paired middle row on e)."""
    xr = x[::-1][:no]
    e = x[:no] + xr
    if ne > no:
        e = jnp.concatenate([e, x[no:ne]], axis=0)
    return e, x[:no] - xr


def _dct1_2d_blocks(x, mats, precision=None):
    """Forward 2D DCT-I straight into fold order: four parity blocks
    (Bee, Boe, Beo, Boo) with B<py><px>[k1, k2] = xhat[2k1(+1), 2k2(+1)].
    Same matmul count as the interleaved path, zero relayouts."""
    Ey, Oy, Ex, Ox = mats[:4]
    dt = x.dtype
    Ey, Oy, Ex, Ox = (m.astype(dt) for m in (Ey, Oy, Ex, Ox))
    ne_x, no_x = Ex.shape[0], Ox.shape[0]
    # x-axis fold + transform (columns)
    xr = x[:, ::-1][:, :no_x]
    ex = x[:, :no_x] + xr
    if ne_x > no_x:
        ex = jnp.concatenate([ex, x[:, no_x:ne_x]], axis=1)
    ox = x[:, :no_x] - xr
    Ae = _mm(ex, Ex.T, precision)  # (Ny, ne_x): even-kx spectral columns
    Ao = _mm(ox, Ox.T, precision)  # (Ny, no_x): odd-kx
    # y-axis fold + transform (rows)
    ne_y, no_y = Ey.shape[0], Oy.shape[0]
    eye, oye = _fold_rows(Ae, ne_y, no_y)
    eyo, oyo = _fold_rows(Ao, ne_y, no_y)
    return (_mm(Ey, eye, precision), _mm(Oy, oye, precision),
            _mm(Ey, eyo, precision), _mm(Oy, oyo, precision))


def _idct1_2d_from_blocks(Bee, Boe, Beo, Boo, mats, precision=None):
    """Inverse of ``_dct1_2d_blocks`` (including the 1/(4(Ny-1)(Nx-1))
    normalisation): fold-order inverse factors plus two symmetric /
    antisymmetric reconstruction butterflies."""
    Iey, Ioy, Iex, Iox = mats[4:8]
    dt = Bee.dtype
    Iey, Ioy, Iex, Iox = (m.astype(dt) for m in (Iey, Ioy, Iex, Iox))
    no_y = Ioy.shape[1]
    no_x = Iox.shape[1]
    Ny = Iey.shape[0] + no_y
    Nx = Iex.shape[0] + no_x

    def unfold_rows(s, a, no):
        return jnp.concatenate([s + a, (s - a)[:no][::-1]], axis=0)

    Ze = unfold_rows(_mm(Iey, Bee, precision),
                     _mm(Ioy, Boe, precision), no_y)  # (Ny, ne_x)
    Zo = unfold_rows(_mm(Iey, Beo, precision),
                     _mm(Ioy, Boo, precision), no_y)  # (Ny, no_x)
    s2 = _mm(Ze, Iex.T, precision)
    a2 = _mm(Zo, Iox.T, precision)
    out = jnp.concatenate([s2 + a2, (s2 - a2)[:, :no_x][:, ::-1]], axis=1)
    scale = 1.0 / (2.0 * (Ny - 1) * 2.0 * (Nx - 1))
    return out * jnp.asarray(scale, dt)


# ── Recursive even/odd folding (2^k+1 grids) ────────────────────────────────
#
# The one-level fold above works for any N, but for ODD N it can recurse: the
# even-row factor of the DCT-I matrix IS the DCT-I matrix of size (N+1)/2
# (C_N[:M, 0::2] == C_M exactly, M=(N+1)/2), so while the half size stays odd
# each level halves the dominant matmul again. For N-1 a power of two
# (2^k+1 grids) the
# 1D-pass FLOPs drop from ~N^2/2 (one fold) toward ~N^2/3. Spectral
# coefficients stay in recursive fold order end-to-end — the eigenvalue
# divide uses a host-side permutation instead of any interleave relayout.


def _dct1_rec_plan(N, dtype, min_leaf):
    """Nested factor matrices for the recursive DCT-I fold of an odd-N axis.

    Node = {'O': odd-row factor (no, no), 'Io': odd-coefficient inverse
    factor C_N[:M, 1::2] (M, no), 'even': plan for the size-M even chain,
    'M': (N+1)//2, 'no': N - M}; leaf = {'C': dense DCT-I matrix}.
    """
    if N % 2 == 1 and N > min_leaf:
        M = (N + 1) // 2
        no = N - M
        C = dct1_matrix(N, dtype)
        return {
            "O": C[1::2, :no],
            "Io": C[:M, 1::2],
            "even": _dct1_rec_plan(M, dtype, min_leaf),
            "M": M,
            "no": no,
        }
    return {"C": dct1_matrix(N, dtype)}


def dct1_fold_perm(N, min_leaf):
    """Natural spectral index at each recursive-fold-order position:
    perm = concat(2 * perm(M), odd indices); leaves are natural-ordered."""
    import numpy as np

    if N % 2 == 1 and N > min_leaf:
        M = (N + 1) // 2
        return np.concatenate(
            [2 * dct1_fold_perm(M, min_leaf), 2 * np.arange(N - M) + 1])
    return np.arange(N)


def precompute_dct_plan(Nx, Ny, dtype=jnp.float32, min_leaf=64):
    """Recursive fold plan for ``solve_poisson_dct`` (dct_method='matmul_rec').

    Requires odd Nx and Ny — for even sizes the fold cannot recurse and the
    one-level ``precompute_dct_matrices`` path is strictly better. Depth per
    axis is the 2-adic valuation of N-1 (capped by ``min_leaf``), so 2^k+1
    grids fold all the way down.
    """
    if Nx % 2 == 0 or Ny % 2 == 0:
        raise ValueError(
            f"dct_method='matmul_rec' needs odd grid sizes (2^k+1 preferred); "
            f"got ({Ny}, {Nx}) — use dct_method='matmul'")
    return {
        "plan_y": _dct1_rec_plan(Ny, dtype, min_leaf),
        "plan_x": _dct1_rec_plan(Nx, dtype, min_leaf),
        "perm_y": dct1_fold_perm(Ny, min_leaf),
        "perm_x": dct1_fold_perm(Nx, min_leaf),
        "Ny": Ny,
        "Nx": Nx,
    }


def _dct1_rec_fwd_rows(x, plan, precision):
    if "C" in plan:
        return _mm(plan["C"].astype(x.dtype), x, precision)
    M, no = plan["M"], plan["no"]
    xr = x[::-1][:no]
    # middle row doubled: C_N's even rows weight it 2, C_M's last column 1
    ehat = jnp.concatenate([x[:no] + xr, 2.0 * x[no:M]], axis=0)
    return jnp.concatenate([
        _dct1_rec_fwd_rows(ehat, plan["even"], precision),
        _mm(plan["O"].astype(x.dtype), x[:no] - xr, precision),
    ], axis=0)


def _dct1_rec_fwd_cols(x, plan, precision):
    if "C" in plan:
        return _mm(x, plan["C"].astype(x.dtype).T, precision)
    M, no = plan["M"], plan["no"]
    xr = x[:, ::-1][:, :no]
    ehat = jnp.concatenate([x[:, :no] + xr, 2.0 * x[:, no:M]], axis=1)
    return jnp.concatenate([
        _dct1_rec_fwd_cols(ehat, plan["even"], precision),
        _mm(x[:, :no] - xr, plan["O"].astype(x.dtype).T, precision),
    ], axis=1)


def _dct1_rec_inv_rows(y, plan, precision):
    """Apply C_N to a spectral vector in recursive fold order (rows):
    s = C_M @ y_even recurses; the odd block is one matmul; rows j >= M come
    from the even/odd (anti)symmetry under j -> N-1-j."""
    if "C" in plan:
        return _mm(plan["C"].astype(y.dtype), y, precision)
    M, no = plan["M"], plan["no"]
    s = _dct1_rec_inv_rows(y[:M], plan["even"], precision)
    a = _mm(plan["Io"].astype(y.dtype), y[M:], precision)
    return jnp.concatenate([s + a, (s - a)[:no][::-1]], axis=0)


def _dct1_rec_inv_cols(y, plan, precision):
    if "C" in plan:
        return _mm(y, plan["C"].astype(y.dtype).T, precision)
    M, no = plan["M"], plan["no"]
    s = _dct1_rec_inv_cols(y[:, :M], plan["even"], precision)
    a = _mm(y[:, M:], plan["Io"].astype(y.dtype).T, precision)
    return jnp.concatenate([s + a, (s - a)[:, :no][:, ::-1]], axis=1)


def dct1_2d_rec(x, plan2d, precision=None):
    """2D unnormalised DCT-I via the recursive fold; output is in recursive
    fold order on both axes (natural index = perm_y/perm_x)."""
    y = _dct1_rec_fwd_cols(x, plan2d["plan_x"], precision)
    return _dct1_rec_fwd_rows(y, plan2d["plan_y"], precision)


def idct1_2d_rec(y_fold, plan2d, precision=None):
    """Inverse of ``dct1_2d_rec`` including the 1/(4(Ny-1)(Nx-1)) DCT-I
    inverse normalisation; input in recursive fold order, output natural."""
    z = _dct1_rec_inv_rows(y_fold, plan2d["plan_y"], precision)
    z = _dct1_rec_inv_cols(z, plan2d["plan_x"], precision)
    Ny, Nx = plan2d["Ny"], plan2d["Nx"]
    return z * jnp.asarray(1.0 / (4.0 * (Ny - 1) * (Nx - 1)), z.dtype)


def build_poisson_matrix(Nx, Ny, dx, dy):
    """Explicit sparse 5-point Neumann Laplacian with ghost mirroring
    p[-1]=p[1], p[N]=p[N-2] (parity: pyRMT/functions.py:870-924).

    The solvers here are matrix-free; this host-side builder exists for API
    parity, for tests that verify the DCT eigenvalues diagonalise exactly
    this matrix, and for external tooling. Singular (all-Neumann): pin a node
    or de-mean when solving against it.
    """
    import numpy as np
    from scipy.sparse import lil_matrix

    N = Nx * Ny
    A = lil_matrix((N, N))
    cx = 1.0 / dx**2
    cy = 1.0 / dy**2

    def idx(i, j):
        return i + j * Nx

    for j in range(Ny):
        for i in range(Nx):
            k = idx(i, j)
            A[k, k] = -2 * cx - 2 * cy
            A[k, idx(i - 1, j) if i > 0 else idx(i + 1, j)] += cx
            A[k, idx(i + 1, j) if i < Nx - 1 else idx(i - 1, j)] += cx
            A[k, idx(i, j - 1) if j > 0 else idx(i, j + 1)] += cy
            A[k, idx(i, j + 1) if j < Ny - 1 else idx(i, j - 1)] += cy
    return A.tocsr()


# ── Neumann (ghost-mirror) eigenvalues + direct solve ────────────────────────


def precompute_poisson_eigenvalues(Nx, Ny, dx, dy, dtype=jnp.float64):
    """Eigenvalues of the ghost-mirror Neumann Laplacian under DCT-I:
    lambda = -2(1-cos(pi k/(N-1)))/h^2 (parity: pyRMT/functions.py:1012-1025).
    The (0,0) mode is pinned to 1 (mean removed separately)."""
    import numpy as np

    kx = np.arange(Nx)
    ky = np.arange(Ny)
    lam_x = -2.0 * (1.0 - np.cos(np.pi * kx / (Nx - 1))) / dx**2
    lam_y = -2.0 * (1.0 - np.cos(np.pi * ky / (Ny - 1))) / dy**2
    eig = lam_x[None, :] + lam_y[:, None]
    eig[0, 0] = 1.0
    return jnp.asarray(eig, dtype=dtype)


def solve_poisson_dct(rhs_2d, eigenvalues, dct_mats=None, precision=None,
                      demean=True):
    """Direct Neumann Poisson solve (pyRMT/functions.py:1028-1040).

    ``demean=False`` skips the final Euclidean de-mean — used by the
    symmetrized variable-rho PCG, whose preconditioner must be EXACTLY
    symmetric (the DCT-I modes are orthogonal under the trapezoidal
    boundary-weight inner product, so zeroing the (0,0) mode coefficient is
    the symmetric gauge fix; an extra Euclidean de-mean breaks symmetry at
    the ~1e-4 level).

    DCT-I diagonalises the asymmetric ghost-mirror matrix exactly; the
    transforms are unnormalised on purpose (a normalised/'ortho' pair changes
    the transform matrix and breaks the diagonalisation).

    ``dct_mats`` — the (Ey, Oy, Ex, Ox, Iey, Ioy, Iex, Iox) tuple from
    ``precompute_dct_matrices`` — switches the transforms from the rFFT
    lowering to dense matmuls (same transform to roundoff). The matmul solve
    stays entirely in the even/odd FOLD domain (forward parity blocks,
    eigenvalue divide on parity-sliced eigenvalues, fold-order inverse) —
    no interleave/deinterleave relayouts between the matmuls. The parity
    slicing of the eigenvalues happens HOST-side at trace time whenever
    ``eigenvalues`` is a concrete (precomputed) array, so no in-graph f64
    strided slice is needed.

    Passing a ``precompute_dct_plan`` dict instead selects the RECURSIVE
    fold (odd N only; fewest matmul FLOPs on 2^k+1 grids).
    """
    if isinstance(dct_mats, dict):
        # recursive fold plan (precompute_dct_plan): everything stays in
        # recursive fold order; the eigenvalue divide uses the fold->natural
        # permutation, sliced host-side when the eigenvalues are concrete.
        yhat = dct1_2d_rec(rhs_2d, dct_mats, precision)
        perm_y, perm_x = dct_mats["perm_y"], dct_mats["perm_x"]
        if isinstance(eigenvalues, jax.core.Tracer):
            # Traced eigenvalues pay an IN-GRAPH 2D gather here. sim.py
            # always passes concrete precomputed eigenvalues
            # (the branch below, permuted host-side at trace time); keep it
            # that way for any hot caller.
            eig = eigenvalues[perm_y][:, perm_x].astype(yhat.dtype)
        else:
            import numpy as np

            e = np.asarray(eigenvalues)
            eig = jnp.asarray(e[perm_y][:, perm_x], yhat.dtype)
        p = idct1_2d_rec(yhat / eig, dct_mats, precision)
    elif dct_mats is not None:
        Bs = _dct1_2d_blocks(rhs_2d, dct_mats, precision)
        dt = Bs[0].dtype
        if isinstance(eigenvalues, jax.core.Tracer):
            eig = eigenvalues.astype(dt)
            eig_blocks = (eig[0::2, 0::2], eig[1::2, 0::2],
                          eig[0::2, 1::2], eig[1::2, 1::2])
        else:
            import numpy as np

            e = np.asarray(eigenvalues)
            eig_blocks = tuple(
                jnp.asarray(e[a::2, b::2], dt)
                for a, b in ((0, 0), (1, 0), (0, 1), (1, 1)))
        Bee, Boe, Beo, Boo = (b / eb for b, eb in zip(Bs, eig_blocks))
        p = _idct1_2d_from_blocks(Bee, Boe, Beo, Boo, dct_mats, precision)
    else:
        rhs_hat = dct1_2d(rhs_2d)
        p_hat = rhs_hat / eigenvalues.astype(rhs_hat.dtype)
        p = idct1_2d(p_hat)
    return (p - jnp.mean(p)) if demean else p


# ── Periodic (FFT) solver on the reduced sub-grid ────────────────────────────


def precompute_poisson_eigenvalues_periodic(Nx, Ny, dx, dy, dtype=jnp.float64):
    """Exact Fourier symbol of the WIDE central div∘grad operator,
    -sin(2 pi k / m)^2 / h^2, on the reduced (Ny-1, Nx-1) periodic sub-grid
    (parity: pyRMT/functions.py:1098-1123). Returns (eig, null_mask) with the
    constant and Nyquist/checkerboard null modes pinned to 1."""
    import numpy as np

    mx, my = Nx - 1, Ny - 1
    kx = np.arange(mx)
    ky = np.arange(my)
    lam_x = -((np.sin(2.0 * np.pi * kx / mx) / dx) ** 2)
    lam_y = -((np.sin(2.0 * np.pi * ky / my) / dy) ** 2)
    eig = lam_x[None, :] + lam_y[:, None]
    null = np.abs(eig) < 1e-12
    eig = eig.copy()
    eig[null] = 1.0
    return jnp.asarray(eig, dtype=dtype), jnp.asarray(null)


def tile_overlap(field_reduced, Ny, Nx):
    """Pad a reduced (Ny-1, Nx-1) periodic field back to the full overlap grid
    by wrapping row/col 0 onto the last row/col (pyRMT/functions.py:1126-1134)."""
    top = jnp.concatenate([field_reduced, field_reduced[:, 0:1]], axis=1)
    return jnp.concatenate([top, top[0:1, :]], axis=0)


def solve_poisson_fft(rhs_full, eigenvalues_periodic):
    """Direct periodic Poisson solve on the reduced sub-grid
    (parity: pyRMT/functions.py:1137-1154). Null-mode corrections are zeroed.

    The 2D transform runs as per-axis 1D FFTs with EXPLICIT transposes
    (mathematically identical to fft2): under GSPMD the partitioner feeds
    the fused fft2 custom-call a transposed (non-dim0-major) operand
    layout, which XLA:CPU's fft thunk RET_CHECK-rejects
    (fft_thunk.cc: IsMonotonicWithDim0Major) — the explicit transposes
    materialize default-layout operands for every 1D transform, and the
    axis-1 FFTs keep each device's row shard local (the transpose carries
    the all-to-all). Pinned sharded-vs-single in tests/test_sharding.py."""
    eig, null = eigenvalues_periodic
    Ny, Nx = rhs_full.shape
    r = rhs_full[:-1, :-1]
    r = r - jnp.mean(r)
    rhat = jnp.fft.fft(r, axis=1)
    rhat = jnp.fft.fft(rhat.T, axis=1).T
    phat = rhat / eig.astype(rhat.real.dtype)
    phat = jnp.where(null, 0.0, phat)
    g = jnp.fft.ifft(phat, axis=1)
    g = jnp.fft.ifft(g.T, axis=1).T
    p_reduced = jnp.real(g).astype(rhs_full.dtype)
    p = tile_overlap(p_reduced, Ny, Nx)
    return p - jnp.mean(p)


# ── Divergences and pressure gradients ───────────────────────────────────────


def compute_divergence(a_star, b_star, dx, dy):
    """Wide central divergence, zero boundary ring
    (parity: pyRMT/functions.py:926-935)."""
    div_i = (a_star[1:-1, 2:] - a_star[1:-1, :-2]) / (2.0 * dx) + (
        b_star[2:, 1:-1] - b_star[:-2, 1:-1]
    ) / (2.0 * dy)
    return jnp.pad(div_i, 1)


def _grad_x_cc(p, dx):
    inv = 1.0 / (2.0 * dx)
    interior = (p[:, 2:] - p[:, :-2]) * inv
    left = (-3.0 * p[:, 0:1] + 4.0 * p[:, 1:2] - p[:, 2:3]) * inv
    right = (3.0 * p[:, -1:] - 4.0 * p[:, -2:-1] + p[:, -3:-2]) * inv
    return jnp.concatenate([left, interior, right], axis=1)


def _grad_y_cc(p, dy):
    inv = 1.0 / (2.0 * dy)
    interior = (p[2:, :] - p[:-2, :]) * inv
    bottom = (-3.0 * p[0:1, :] + 4.0 * p[1:2, :] - p[2:3, :]) * inv
    top = (3.0 * p[-1:, :] - 4.0 * p[-2:-1, :] + p[-3:-2, :]) * inv
    return jnp.concatenate([bottom, interior, top], axis=0)


def compute_divergence_rc(a_star, b_star, p_prev, dt, rho, dx, dy, variable_rho,
                          st_faces=None):
    """Rhie-Chow face-velocity divergence — kills the collocated-grid
    odd-even (checkerboard) pressure decoupling
    (parity: pyRMT/functions.py:937-992).

    ``variable_rho`` is a STATIC flag (trace-time dispatch replaces the
    reference's runtime np.ptp check).

    ``st_faces`` (optional) = (Fx_face, Fy_face, fx_cell, fy_cell): the
    balanced-force CSF surface-tension force sampled COMPACTLY at faces and
    its cell average (the one the momentum RHS used). It enters the face
    velocities exactly like the pressure gradient but with opposite sign —
    u_f += d_f (F_face - F_avg) — so at discrete equilibrium the face
    pressure jump cancels the face capillary force identically (the
    balanced-force property, Francois et al. 2006 JCP 213:141 on a
    collocated Rhie-Chow scheme). Shapes: Fx_face (Ny, Nx-1) on x-faces,
    Fy_face (Ny-1, Nx) on y-faces.
    """
    dpdx_cc = _grad_x_cc(p_prev, dx)
    dpdy_cc = _grad_y_cc(p_prev, dy)

    u_face = 0.5 * (a_star[:, :-1] + a_star[:, 1:])
    face_dpdx = (p_prev[:, 1:] - p_prev[:, :-1]) / dx
    avg_dpdx = 0.5 * (dpdx_cc[:, :-1] + dpdx_cc[:, 1:])

    v_face = 0.5 * (b_star[:-1, :] + b_star[1:, :])
    face_dpdy = (p_prev[1:, :] - p_prev[:-1, :]) / dy
    avg_dpdy = 0.5 * (dpdy_cc[:-1, :] + dpdy_cc[1:, :])

    if variable_rho:
        inv_rho = 1.0 / rho
        d_f_x = dt * 0.5 * (inv_rho[:, :-1] + inv_rho[:, 1:])
        d_f_y = dt * 0.5 * (inv_rho[:-1, :] + inv_rho[1:, :])
    else:
        d_scalar = dt / jnp.mean(rho)
        d_f_x = d_scalar
        d_f_y = d_scalar

    if st_faces is not None:
        Fx_face, Fy_face, fx_cell, fy_cell = st_faces
        face_dpdx = face_dpdx - Fx_face
        avg_dpdx = avg_dpdx - 0.5 * (fx_cell[:, :-1] + fx_cell[:, 1:])
        face_dpdy = face_dpdy - Fy_face
        avg_dpdy = avg_dpdy - 0.5 * (fy_cell[:-1, :] + fy_cell[1:, :])

    u_face_rc = u_face - d_f_x * (face_dpdx - avg_dpdx)
    v_face_rc = v_face - d_f_y * (face_dpdy - avg_dpdy)

    div_i = (u_face_rc[1:-1, 1:] - u_face_rc[1:-1, :-1]) / dx + (
        v_face_rc[1:, 1:-1] - v_face_rc[:-1, 1:-1]
    ) / dy
    return jnp.pad(div_i, 1)


def compute_pressure_gradient(p, dx, dy):
    """Central interior + one-sided boundary pressure gradient
    (parity: pyRMT/functions.py:994-1010). NOTE the reference zeroes the
    non-normal component on boundary rows/cols (it only fills dpdx on x-faces
    of the interior rows via the [1:-1,1:-1] slice and boundary columns);
    we reproduce that exactly."""
    # Built scatter-free (concat + row/col masks): XLA's SPMD partitioner
    # miscompiles the fused scatter-into-zeros formulation at shard
    # boundaries (observed on the 8-device CPU mesh), and masks fuse better
    # anyway.
    Ny, Nx = p.shape
    jj = jnp.arange(Ny)[:, None]
    ii = jnp.arange(Nx)[None, :]

    dpdx_full = _grad_x_cc(p, dx)
    row_interior = (jj > 0) & (jj < Ny - 1)
    col_boundary = (ii == 0) | (ii == Nx - 1)
    dpdx = jnp.where(col_boundary | row_interior, dpdx_full, 0.0)

    dpdy_full = _grad_y_cc(p, dy)
    col_interior = (ii > 0) & (ii < Nx - 1)
    row_boundary = (jj == 0) | (jj == Ny - 1)
    dpdy = jnp.where(row_boundary | col_interior, dpdy_full, 0.0)
    return dpdx, dpdy


def compute_divergence_periodic(a_star, b_star, dx, dy):
    """Wide central divergence with periodic wrap on the reduced sub-grid
    (parity: pyRMT/functions.py:1157-1164)."""
    Ny, Nx = a_star.shape
    au = a_star[:-1, :-1]
    bv = b_star[:-1, :-1]
    dudx = (jnp.roll(au, -1, axis=1) - jnp.roll(au, 1, axis=1)) / (2.0 * dx)
    dvdy = (jnp.roll(bv, -1, axis=0) - jnp.roll(bv, 1, axis=0)) / (2.0 * dy)
    return tile_overlap(dudx + dvdy, Ny, Nx)


def compute_pressure_gradient_periodic(p, dx, dy):
    """Wide central pressure gradient with periodic wrap
    (parity: pyRMT/functions.py:1167-1173)."""
    Ny, Nx = p.shape
    pr = p[:-1, :-1]
    dpdx_r = (jnp.roll(pr, -1, axis=1) - jnp.roll(pr, 1, axis=1)) / (2.0 * dx)
    dpdy_r = (jnp.roll(pr, -1, axis=0) - jnp.roll(pr, 1, axis=0)) / (2.0 * dy)
    return tile_overlap(dpdx_r, Ny, Nx), tile_overlap(dpdy_r, Ny, Nx)


# ── Matrix-free variable-density operator + preconditioned CG ────────────────


def _mirror_pad_x(f):
    return jnp.concatenate([f[:, 1:2], f, f[:, -2:-1]], axis=1)


def _mirror_pad_y(f):
    return jnp.concatenate([f[1:2, :], f, f[-2:-1, :]], axis=0)


def apply_variable_poisson(p, inv_rho, dx, dy):
    """Matrix-free grad.((1/rho) grad p) with face-averaged 1/rho and Neumann
    ghost mirroring p[-1]=p[1], p[N]=p[N-2]
    (parity: pyRMT/functions.py:1043-1089). Operates on 2D fields."""
    cx = 1.0 / dx**2
    cy = 1.0 / dy**2

    p_padx = _mirror_pad_x(p)
    ir_padx = _mirror_pad_x(inv_rho)
    beta_e = 0.5 * (ir_padx[:, 1:-1] + ir_padx[:, 2:])
    beta_w = 0.5 * (ir_padx[:, 0:-2] + ir_padx[:, 1:-1])
    out = cx * (beta_e * (p_padx[:, 2:] - p) - beta_w * (p - p_padx[:, :-2]))

    p_pady = _mirror_pad_y(p)
    ir_pady = _mirror_pad_y(inv_rho)
    beta_n = 0.5 * (ir_pady[1:-1, :] + ir_pady[2:, :])
    beta_s = 0.5 * (ir_pady[0:-2, :] + ir_pady[1:-1, :])
    out = out + cy * (beta_n * (p_pady[2:, :] - p) - beta_s * (p - p_pady[:-2, :]))
    return out


def _pin_null_mode(eigenvalues):
    """Set the (0,0) eigenvalue to +inf so the DCT solve ZEROES the constant
    mode's coefficient (x/inf == 0 in every lowering: fft divide, matmul
    block divide, recursive-fold divide) — the exact pseudo-inverse gauge in
    the trapezoidal-weight inner product. ``.at[].set`` works for both
    concrete arrays and tracers (the sole caller is inside a jitted solve,
    so the update is a compile-time constant fold when concrete)."""
    return jnp.asarray(eigenvalues).at[0, 0].set(jnp.inf)


def _trapezoid_weights(shape, dtype):
    """w = wy (x) wx with half weights on boundary rows/cols: the diagonal D
    that symmetrizes the ghost-mirror operator (D A is symmetric negative
    semidefinite with null space = constants; verified to machine zero)."""
    Ny, Nx = shape
    wx = jnp.ones((Nx,), dtype).at[jnp.array([0, Nx - 1])].set(0.5)
    wy = jnp.ones((Ny,), dtype).at[jnp.array([0, Ny - 1])].set(0.5)
    return wy[:, None] * wx[None, :]


def _variable_poisson_cg_core(rhs, inv_rho, eigenvalues, dct_mats, dx, dy,
                              tol, maxiter, precision):
    """The raw PCG loop (see ``solve_variable_poisson_cg_counted`` for the
    math). Reverse-mode AD must never reach this function — the
    ``lax.while_loop`` has no VJP rule — which is exactly why the public
    entry wraps it in the implicit-adjoint ``jax.custom_vjp`` below."""
    w = _trapezoid_weights(rhs.shape, rhs.dtype)
    inv_w = 1.0 / w
    eig_pre = _pin_null_mode(eigenvalues)

    def matvec(p):
        return w * apply_variable_poisson(p, inv_rho, dx, dy)

    def precond(r):
        return solve_poisson_dct(r * inv_w, eig_pre, dct_mats=dct_mats,
                                 precision=precision, demean=False)

    b = w * rhs
    b = b - jnp.mean(b)
    bnorm = jnp.sqrt(jnp.sum(b * b))
    atol2 = tol * bnorm  # jax cg: max(tol*||b||, atol), atol defaults to 0

    r0 = b  # x0 = 0
    z0 = precond(r0)
    gamma0 = jnp.sum(r0 * z0)
    x0 = jnp.zeros_like(b)
    k0 = jnp.zeros((), jnp.int32)

    def cond(carry):
        _, r, _, _, k = carry
        return (jnp.sqrt(jnp.sum(r * r)) > atol2) & (k < maxiter)

    def body(carry):
        x, r, gamma, d, k = carry
        Ad = matvec(d)
        alpha = gamma / jnp.sum(d * Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = precond(r)
        gamma_new = jnp.sum(r * z)
        beta = gamma_new / gamma
        d = z + beta * d
        return x, r, gamma_new, d, k + 1

    x, r, _, _, k = jax.lax.while_loop(cond, body, (x0, r0, gamma0, z0, k0))
    relres = jnp.sqrt(jnp.sum(r * r)) / jnp.maximum(
        bnorm, jnp.finfo(rhs.dtype).tiny)
    return x - jnp.mean(x), k, relres


def _zero_cotangent(x):
    """Zero cotangent matching a primal leaf (float0 for integer leaves —
    dct plan dicts carry int64 fold permutations and python-int sizes)."""
    import numpy as np

    a = jnp.asarray(x)
    if jnp.issubdtype(a.dtype, jnp.inexact):
        return jnp.zeros(a.shape, a.dtype)
    return np.zeros(a.shape, dtype=jax.dtypes.float0)


@partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8))
def _variable_poisson_cg_diff(rhs, inv_rho, eigenvalues, dct_mats, dx, dy,
                              tol, maxiter, precision):
    return _variable_poisson_cg_core(rhs, inv_rho, eigenvalues, dct_mats,
                                     dx, dy, tol, maxiter, precision)


def _variable_poisson_cg_fwd(rhs, inv_rho, eigenvalues, dct_mats, dx, dy,
                             tol, maxiter, precision):
    out = _variable_poisson_cg_core(rhs, inv_rho, eigenvalues, dct_mats,
                                    dx, dy, tol, maxiter, precision)
    # residuals: the SOLUTION (not rhs) + everything the adjoint solve needs
    return out, (out[0], inv_rho, eigenvalues, dct_mats)


def _variable_poisson_cg_bwd(dx, dy, tol, maxiter, precision, residuals, cts):
    """Implicit-function-theorem adjoint (O(tol)-exact, one extra PCG solve).

    With S(θ) = D A(θ) symmetric and p = S⁺ b(rhs), b = P D rhs (P = demean):
    for output cotangent g on p, the adjoint solves S λ = P g with the SAME
    preconditioned CG (self-adjoint system — no transpose solver needed),
    then  ∂rhs = D λ  and  ∂θ = −(∂_θ [S(θ) p])ᵀ λ  via one jax.vjp of the
    matrix-free operator. The preconditioner operands (eigenvalues,
    dct_mats) do not enter the converged solution, so their cotangents are
    zero; the iters/relres diagnostics are likewise non-differentiable.
    This is what makes variable-density steps reverse-differentiable at all:
    unrolling the lax.while_loop has no VJP rule, and a fixed-length unroll
    would store every CG iterate."""
    p, inv_rho, eigenvalues, dct_mats = residuals
    ct_p = cts[0]
    g = ct_p - jnp.mean(ct_p)
    w = _trapezoid_weights(p.shape, p.dtype)
    lam, _, _ = _variable_poisson_cg_core(
        g / w, inv_rho, eigenvalues, dct_mats, dx, dy, tol, maxiter,
        precision)  # core builds b = w*(g/w) - mean = g: solves S lam = g
    grad_rhs = w * lam
    _, vjp_ir = jax.vjp(
        lambda ir: w * apply_variable_poisson(p, ir, dx, dy), inv_rho)
    grad_inv_rho = -vjp_ir(lam)[0]
    return (grad_rhs, grad_inv_rho,
            jax.tree_util.tree_map(_zero_cotangent, eigenvalues),
            jax.tree_util.tree_map(_zero_cotangent, dct_mats))


_variable_poisson_cg_diff.defvjp(_variable_poisson_cg_fwd,
                                 _variable_poisson_cg_bwd)


@partial(jax.jit, static_argnames=("dx", "dy", "tol", "maxiter", "precision"))
def solve_variable_poisson_cg_counted(
    rhs, inv_rho, eigenvalues, dx, dy, tol=1e-6, maxiter=200, dct_mats=None,
    precision=None,
):
    """SYMMETRIZED preconditioned CG for the variable-density Neumann Poisson
    problem, with solver observability: returns ``(p, iters, relres)``.

    Deliberate deviation from the reference (documented, docs/DESIGN.md):
    the reference runs scipy CG directly on the ghost-mirror operator
    (pyRMT/functions.py:1221-1246), which is NONSYMMETRIC at boundary rows
    (the mirrored ghost doubles the inward-neighbour coefficient) — CG's
    convergence theory does not apply, and measured on a 10:1 density
    contrast it stagnates at ~1e-3 relative residual without ever reaching
    its tol=1e-6 (scipy's info flag is discarded upstream). Here the system
    is left-scaled by the trapezoidal boundary weights D (half on boundary
    rows/cols, quarter on corners): D A is exactly symmetric negative
    semidefinite with null space = constants, the preconditioner
    M = A_c^+ D^{-1} (the DCT direct solve of the weighted residual, zero
    mode zeroed — the reference's own preconditioner choice,
    functions.py:1234-1237, made symmetric) is symmetric, and PCG converges
    like a proper PCG (~tens of iterations at 10:1 contrast instead of
    stagnating). The rhs is projected onto range(D A) (zero-sum after
    weighting) — the minimal consistency fix for the all-Neumann problem.

    Termination: ||r|| <= tol * ||b|| in the symmetrized system, capped at
    ``maxiter``. Update ordering matches jax.scipy.sparse.linalg.cg.

    DIFFERENTIABLE (beyond reference): reverse-mode AD w.r.t. ``rhs`` and
    ``inv_rho`` goes through an implicit-adjoint ``jax.custom_vjp`` (one
    extra PCG solve on the self-adjoint system; gradients are exact up to
    O(tol)) instead of unrolling the while-loop — this is what lets
    ``sim.make_rollout``/``diff.make_diff_step`` differentiate variable-
    density simulations end-to-end (tests/test_diff.py). Gradients flow
    only through ``p``; the iters/relres diagnostics are non-differentiable.
    """
    return _variable_poisson_cg_diff(rhs, inv_rho, eigenvalues, dct_mats,
                                     dx, dy, tol, maxiter, precision)


def solve_variable_poisson_cg(
    rhs, inv_rho, eigenvalues, dx, dy, tol=1e-6, maxiter=200, dct_mats=None,
    precision=None,
):
    """``solve_variable_poisson_cg_counted`` without the info outputs (the
    drop-in signature the projection hub uses when no observability is
    requested)."""
    p, _, _ = solve_variable_poisson_cg_counted(
        rhs, inv_rho, eigenvalues, dx, dy, tol=tol, maxiter=maxiter,
        dct_mats=dct_mats, precision=precision,
    )
    return p
