"""Level-set reinitialisation: dispatcher + signed-distance accuracy.

Mirrors the reference's tests/test_reinit.py; the 'fmm' method here is the
parallel PDE-sweep substitute honouring the same behavioural tolerances.
"""

import pytest

pytestmark = pytest.mark.slow  # full local tier only; fast tier = -m 'not slow'
import numpy as np
import pytest

from pyrmt_tpu.grid import create_grid
from pyrmt_tpu.ops.levelset import reinitialize_level_set


def _disc(N, R=0.25):
    X, Y, dx, dy = create_grid(N, N, 1.0, 1.0, dtype=np.float64)
    X, Y = np.asarray(X), np.asarray(Y)
    sdf = np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2) - R
    return X, Y, dx, dy, sdf


def test_none_is_identity():
    _, _, dx, dy, sdf = _disc(65)
    phi = sdf * 1.0
    out = reinitialize_level_set(phi, dx, dy, method="none")
    assert np.array_equal(np.asarray(out), phi)


def test_unknown_method_raises():
    _, _, dx, dy, sdf = _disc(33)
    with pytest.raises(ValueError):
        reinitialize_level_set(sdf, dx, dy, method="bogus")


def test_fmm_equivalent_recovers_signed_distance():
    N = 129
    _, _, dx, dy, sdf = _disc(N)
    phi = np.sign(sdf) * (sdf**2 + 0.3)
    out = np.asarray(reinitialize_level_set(phi, dx, dy, method="fmm"))
    band = np.abs(sdf) < 0.05
    gy, gx = np.gradient(out, dy, dx)
    mag = np.sqrt(gx**2 + gy**2)
    assert abs(mag[band].mean() - 1.0) < 0.05
    assert np.max(np.abs((out - sdf)[band])) < 0.02


def test_fsm_clean_sdf_is_near_fixed_point():
    # redistancing an already-signed-distance field must not move it
    # beyond the first-order front-interpolation error O(dx)
    N = 129
    _, _, dx, dy, sdf = _disc(N)
    from pyrmt_tpu.ops.levelset import reinitialize_phi_fsm

    out = np.asarray(reinitialize_phi_fsm(sdf, dx, dy))
    region = np.abs(sdf) < 0.2
    assert np.max(np.abs((out - sdf)[region])) < 0.5 * dx
    # sign is preserved everywhere
    assert np.all(np.sign(out) == np.sign(sdf))


def test_fsm_two_passes_converged():
    # the 4-ordering sweep set converges in 2 passes for a convex front:
    # a third pass changes nothing
    N = 65
    _, _, dx, dy, sdf = _disc(N)
    phi = np.sign(sdf) * (sdf**2 + 0.3)
    from pyrmt_tpu.ops.levelset import reinitialize_phi_fsm

    out2 = np.asarray(reinitialize_phi_fsm(phi, dx, dy, n_passes=2))
    out3 = np.asarray(reinitialize_phi_fsm(phi, dx, dy, n_passes=3))
    assert np.array_equal(out2, out3)


def test_fsm_beats_pde_substitute_accuracy():
    # the sweeping method must be at least as accurate near the front as
    # the long-horizon PDE substitute it replaced
    N = 129
    _, _, dx, dy, sdf = _disc(N)
    phi = np.sign(sdf) * (sdf**2 + 0.3)
    from pyrmt_tpu.ops.levelset import (
        reinitialize_phi_fmm_equivalent,
        reinitialize_phi_fsm,
    )

    band = np.abs(sdf) < 0.05
    e_fsm = np.max(np.abs((np.asarray(reinitialize_phi_fsm(phi, dx, dy)) - sdf)[band]))
    e_pde = np.max(
        np.abs((np.asarray(reinitialize_phi_fmm_equivalent(phi, dx, dy)) - sdf)[band])
    )
    assert e_fsm <= e_pde + 1e-12


def test_fmm_equivalent_agrees_with_pde_near_interface():
    N = 129
    _, _, dx, dy, sdf = _disc(N)
    phi = np.sign(sdf) * (sdf**2 + 0.3)
    fmm = np.asarray(reinitialize_level_set(phi, dx, dy, method="fmm"))
    pde = np.asarray(
        reinitialize_level_set(
            phi.copy(), dx, dy, method="pde", num_iters=200, dt_reinit_factor=0.2
        )
    )
    band = np.abs(sdf) < 0.03
    assert np.max(np.abs((fmm - pde)[band])) < 0.03
