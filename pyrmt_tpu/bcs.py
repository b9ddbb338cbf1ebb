"""Velocity boundary-condition library (pure functions (u, v) -> (u, v)).

Capability parity with benchmarks/common.py:27-50 in the reference plus the
periodic wrap used by its Poisson tests. BCs are closed over in the jitted
step at trace time (the reference threads a Python closure through every
call — pyRMT/functions.py:867-868).
"""
from __future__ import annotations

import functools


def no_slip_lid_bc(u, v, lid_speed=1.0):
    """Lid-driven cavity: no-slip on left/right/bottom, moving lid on top,
    corners pinned to zero (parity: benchmarks/common.py:27-37)."""
    u = u.at[:, 0].set(0.0).at[:, -1].set(0.0).at[0, :].set(0.0)
    v = v.at[:, 0].set(0.0).at[:, -1].set(0.0).at[0, :].set(0.0)
    u = u.at[-1, :].set(lid_speed)
    v = v.at[-1, :].set(0.0)
    u = u.at[0, 0].set(0.0).at[0, -1].set(0.0).at[-1, 0].set(0.0).at[-1, -1].set(0.0)
    v = v.at[0, 0].set(0.0).at[0, -1].set(0.0).at[-1, 0].set(0.0).at[-1, -1].set(0.0)
    return u, v


def make_lid_bc(lid_speed=1.0):
    return functools.partial(no_slip_lid_bc, lid_speed=lid_speed)


def free_slip_box_bc(u, v):
    """Free-slip impermeable walls: zero normal velocity, zero-gradient
    tangential (parity: benchmarks/common.py:40-50)."""
    u = u.at[:, 0].set(0.0).at[:, -1].set(0.0)
    v = v.at[:, 0].set(v[:, 1]).at[:, -1].set(v[:, -2])
    v = v.at[0, :].set(0.0).at[-1, :].set(0.0)
    u = u.at[0, :].set(u[1, :]).at[-1, :].set(u[-2, :])
    return u, v


def periodic_bc(u, v):
    """Doubly-periodic overlap-grid wrap: last row/col mirror the first."""
    u = u.at[:, -1].set(u[:, 0]).at[-1, :].set(u[0, :])
    v = v.at[:, -1].set(v[:, 0]).at[-1, :].set(v[0, :])
    return u, v


def noop_bc(u, v):
    return u, v
