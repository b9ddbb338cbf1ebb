"""Reference-map extrapolation: linear exactness + band growth.

Mirrors tests/test_interp_extrap_energy.py:33-48 in the reference and adds
band-coverage/idempotence checks for the layer-synchronous formulation.
"""

import pytest

pytestmark = pytest.mark.slow  # full local tier only; fast tier = -m 'not slow'
import numpy as np

from pyrmt_tpu.grid import create_grid
from pyrmt_tpu.ops.extrapolate import extrapolate_reference_map


def test_extrapolation_exact_on_linear_reference_map():
    """A linear reference map is extrapolated exactly into the band."""
    N = 65
    X, Y, dx, dy = create_grid(N, N, 1.0, 1.0, dtype=np.float64)
    X, Y = np.asarray(X), np.asarray(Y)
    phi = np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2) - 0.25
    solid = (phi < 0).astype(float)
    X1 = (1.3 * X + 0.2 * Y) * solid
    X2 = (-0.4 * X + 0.9 * Y) * solid
    X1e, X2e = extrapolate_reference_map(X1, X2, phi, dx, dy, max_layers=3)
    X1e, X2e = np.asarray(X1e), np.asarray(X2e)
    band = (phi >= 0) & (phi < 3 * dx)
    err1 = np.abs(X1e[band] - (1.3 * X[band] + 0.2 * Y[band]))
    err2 = np.abs(X2e[band] - (-0.4 * X[band] + 0.9 * Y[band]))
    assert err1.max() < 1e-8
    assert err2.max() < 1e-8


def test_extrapolation_preserves_solid_values():
    """Solid cells (phi < 0) must be returned untouched."""
    N = 49
    X, Y, dx, dy = create_grid(N, N, 1.0, 1.0, dtype=np.float64)
    X, Y = np.asarray(X), np.asarray(Y)
    phi = np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2) - 0.22
    solid = (phi < 0).astype(float)
    X1 = np.sin(3 * X) * Y * solid
    X2 = np.cos(2 * Y) * X * solid
    X1e, X2e = extrapolate_reference_map(X1, X2, phi, dx, dy, max_layers=3)
    X1e, X2e = np.asarray(X1e), np.asarray(X2e)
    s = phi < 0
    assert np.array_equal(X1e[s], X1[s])
    assert np.array_equal(X2e[s], X2[s])


def test_extrapolation_band_growth_per_layer():
    """Each sweep grows the known region by exactly one cell layer
    (Chebyshev distance), so max_layers layers cover the blend band."""
    N = 65
    X, Y, dx, dy = create_grid(N, N, 1.0, 1.0, dtype=np.float64)
    X, Y = np.asarray(X), np.asarray(Y)
    phi = np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2) - 0.25
    solid = (phi < 0).astype(float)
    X1 = (2.0 * X) * solid
    X2 = (3.0 * Y) * solid
    for L in (1, 2, 3):
        X1e, _ = extrapolate_reference_map(X1, X2, phi, dx, dy, max_layers=L)
        X1e = np.asarray(X1e)
        inner_band = (phi >= 0) & (phi < (L - 0.5) * dx)
        # all cells well inside L layers got a value (not the zeroed fluid)
        assert np.all(np.abs(X1e[inner_band]) > 1e-12)
        # cells clearly beyond the band are untouched (still zero)
        far = phi > (L + 2.5) * dx
        assert np.allclose(X1e[far], 0.0)


def test_separable_normal_equations_match_dense():
    """The separable (two 1D passes) normal-equation correlations must equal
    the dense 9x9 2D correlation formulation."""
    import jax.numpy as jnp

    from pyrmt_tpu.ops.extrapolate import (
        _correlate,
        _kernels,
        _kernels_1d,
        _normal_equations_separable,
    )

    N = 40
    dx = dy = 1.0 / (N - 1)
    rng = np.random.default_rng(5)
    kf = (rng.uniform(size=(N, N)) > 0.5).astype(np.float64)
    X1 = rng.standard_normal((N, N))
    X2 = rng.standard_normal((N, N))

    fields = jnp.stack([jnp.asarray(kf), jnp.asarray(kf * X1), jnp.asarray(kf * X2)])
    dense = np.asarray(_correlate(fields, _kernels(dx, dy, jnp.float64)))
    fx, fy = _kernels_1d(dx, dy, jnp.float64)
    sep = np.asarray(_normal_equations_separable(
        jnp.asarray(kf), jnp.asarray(kf * X1), jnp.asarray(kf * X2), fx, fy))

    pairs = [(0, (0, 0)), (1, (0, 1)), (2, (0, 2)), (3, (0, 3)), (4, (0, 4)),
             (5, (0, 5)), (6, (0, 6)), (7, (1, 1)), (8, (1, 2)), (9, (1, 3)),
             (10, (2, 1)), (11, (2, 2)), (12, (2, 3))]
    for si, (ci, ki) in pairs:
        assert np.allclose(sep[si], dense[ci, ki], atol=1e-12), (si, ci, ki)


def test_sparse_frontier_path_matches_dense():
    """The frontier-gather CPU fast path (extrapolate_reference_map_sparse)
    must match the dense correlations to summation-order rounding, including
    its dense fallback when the frontier exceeds the static bound."""
    from pyrmt_tpu.ops.extrapolate import extrapolate_reference_map_sparse

    N = 80
    X, Y, dx, dy = create_grid(N, N, 1.0, 1.0, dtype=np.float64)
    X, Y = np.asarray(X), np.asarray(Y)
    phi = np.sqrt((X - 0.5) ** 2 + (Y - 0.45) ** 2) - 0.23
    solid = (phi < 0).astype(float)
    X1 = (X + 0.02 * np.sin(5 * np.pi * Y)) * solid
    X2 = (Y - 0.02 * np.cos(3 * np.pi * X)) * solid
    ref = [np.asarray(a) for a in
           extrapolate_reference_map(X1, X2, phi, dx, dy, max_layers=3)]
    got = [np.asarray(a) for a in
           extrapolate_reference_map_sparse(X1, X2, phi, dx, dy, 3)]
    assert np.abs(got[0] - ref[0]).max() < 1e-12
    assert np.abs(got[1] - ref[1]).max() < 1e-12
    # overflow -> per-layer dense fallback, still identical
    fb = [np.asarray(a) for a in
          extrapolate_reference_map_sparse(X1, X2, phi, dx, dy, 3,
                                           max_frontier=8)]
    assert np.abs(fb[0] - ref[0]).max() < 1e-12
    assert np.abs(fb[1] - ref[1]).max() < 1e-12


def test_strain_energy_matches_stress_no_lnJ():
    """For a uniform stretch the (lnJ-free) strain-energy density equals the
    neo-Hookean W = (mu/2)(I1 - 2) consistent with sigma = mu*b
    (parity: reference tests/test_interp_extrap_energy.py:50-64)."""
    from pyrmt_tpu.diagnostics import compute_strain_energy

    N = 81
    X, Y, dx, dy = create_grid(N, N, 1.0, 1.0, dtype=np.float64)
    X, Y = np.asarray(X), np.asarray(Y)
    phi = np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2) - 0.25
    lam = 1.4
    mu_s = 2.0
    se = float(compute_strain_energy(X / lam, Y.copy(), phi, mu_s, dx, dy,
                                     kappa=0.0))
    solid_area = np.sum(phi <= 0) * dx * dy
    expected = 0.5 * mu_s * (lam**2 - 1.0) * solid_area
    assert abs(se - expected) / expected < 0.05
