"""Uniform collocated grid factory.

Capability parity: ``create_grid`` in the reference (pyRMT/functions.py:25-31):
a node-centred uniform grid on [0,Lx]x[0,Ly]; fields are (Ny, Nx) row-major
with axis 0 = y, axis 1 = x.

Design notes: the grid is pure metadata plus two coordinate fields. The
coordinate fields are materialised once (device-resident) and threaded through
jitted programs as ordinary operands, so every downstream stencil sees static
shapes.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static grid metadata. Hashable, safe to close over in jitted code."""

    Nx: int
    Ny: int
    Lx: float
    Ly: float

    @property
    def dx(self) -> float:
        return self.Lx / (self.Nx - 1)

    @property
    def dy(self) -> float:
        return self.Ly / (self.Ny - 1)

    @property
    def shape(self):
        return (self.Ny, self.Nx)

    def coords(self, dtype=jnp.float32):
        """Return (X, Y) meshes of shape (Ny, Nx)."""
        x = jnp.linspace(0.0, self.Lx, self.Nx, dtype=dtype)
        y = jnp.linspace(0.0, self.Ly, self.Ny, dtype=dtype)
        X, Y = jnp.meshgrid(x, y)
        return X, Y


def create_grid(Nx, Ny, Lx, Ly, dtype=jnp.float32):
    """Reference-compatible helper: returns (X, Y, dx, dy).

    dx/dy are returned as Python floats (static), so they fold into compiled
    constants rather than being traced operands.
    """
    g = Grid(Nx=Nx, Ny=Ny, Lx=Lx, Ly=Ly)
    X, Y = g.coords(dtype=dtype)
    return X, Y, g.dx, g.dy
