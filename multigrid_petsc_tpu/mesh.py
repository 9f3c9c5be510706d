"""Structured tensor-product meshes on [0,1]^2 with analytic metric terms.

Capability parity with the reference mesh module (reference: src/mesh.c):
  * UNIFORM mesh (src/mesh.c:170),
  * NONUNIFORM1: cosine-stretched y (src/mesh.c:165),
  * NONUNIFORM2: exponential-stretched y (src/mesh.c:166-169),
  * per-point metric coefficients of the coordinate transform used by the
    discrete operator (src/mesh.c:29-107).

Redesign: coordinates and metrics are evaluated analytically and
vectorized with jnp at whatever points a grid needs — there is no stored
fine-mesh array that coarse grids index into.  A coarse grid point (i, j) of
grid g sits at computational coordinate xi = (j+1)/(n_g+1), eta = (i+1)/(n_g+1)
which is identical to the computational coordinate of the corresponding fine
point (reference: src/solver.c:231-235 evaluates metrics at the fine-mesh
coordinate of each coarse point; the mappings below reproduce those physical
coordinates exactly from the analytic transform).

Metric vector convention (reference: src/mesh.c:29-43):
  m0 = (xi_x)^2 + (xi_y)^2        -- multiplies x-direction second difference
  m1 = (eta_x)^2 + (eta_y)^2      -- multiplies y-direction second difference
  m2 = xi_xx + xi_yy              -- multiplies x-direction first difference
  m3 = eta_xx + eta_yy            -- multiplies y-direction first difference
  m4 = cross term (always 0 for these tensor-product meshes)
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


class MeshType(enum.Enum):
    """Mesh families of the reference (src/mesh.h:19)."""

    UNIFORM = 0
    NONUNIFORM1 = 1  # cosine stretch in y
    NONUNIFORM2 = 2  # exponential stretch in y


@dataclass(frozen=True)
class Mesh1D:
    """One direction of a tensor-product mesh.

    ``npts`` is the total number of points including both boundary points
    (the reference's ``-npts``); interior unknown count is ``npts - 2``.
    """

    npts: int
    lo: float = 0.0
    hi: float = 1.0
    stretched: bool = False  # True for the stretched (y) direction

    @property
    def n_interior(self) -> int:
        return self.npts - 2

    @property
    def h(self) -> float:
        """Computational-space spacing 1/(npts-1)."""
        return (self.hi - self.lo) / (self.npts - 1)


def physical_coords(
    mesh_type: MeshType, npts: int, axis: int, dtype=jnp.float64
) -> jnp.ndarray:
    """Physical coordinates of ALL npts points along ``axis`` (0=x, 1=y).

    x is always uniform; y is stretched for NONUNIFORM1/2
    (reference: src/mesh.c:144-175 stretches only direction 1).
    """
    xi = np.arange(npts, dtype=np.float64) / (npts - 1)
    if axis == 0 or mesh_type == MeshType.UNIFORM:
        c = xi
    elif mesh_type == MeshType.NONUNIFORM1:
        # y = 1 - cos(pi/2 * eta) on [0,1] (src/mesh.c:165)
        c = 1.0 - np.cos(np.pi * 0.5 * xi)
    elif mesh_type == MeshType.NONUNIFORM2:
        # y = (exp(2 eta) - 1)/(e^2 - 1) on [0,1] (src/mesh.c:166-169)
        c = (np.exp(2.0 * xi) - 1.0) / (math.exp(2.0) - 1.0)
    else:  # pragma: no cover
        raise ValueError(mesh_type)
    # Endpoints are exact bounds in every branch above.
    return jnp.asarray(c, dtype=dtype)


def metric_terms(mesh_type: MeshType, y: jnp.ndarray):
    """Metric coefficients (m0, m1, m2, m3) at physical height(s) y.

    All three mesh families have metrics depending on y only
    (reference: src/mesh.c:29-107 with unit bounds).  Returns broadcastable
    arrays (same shape as y, or python floats for UNIFORM).
    """
    if mesh_type == MeshType.UNIFORM:
        one = jnp.ones_like(y)
        zero = jnp.zeros_like(y)
        return one, one, zero, zero
    if mesh_type == MeshType.NONUNIFORM1:
        # temp = 1 - (1-y)^2 ; m1 = 4/(pi^2 temp); m3 = -2(1-y)/(pi temp^{3/2})
        # (src/mesh.c:69-74 with bounds [0,1])
        t = 1.0 - (1.0 - y) ** 2
        m1 = 4.0 / (jnp.pi**2 * t)
        m3 = -2.0 * (1.0 - y) / (jnp.pi * jnp.sqrt(t**3))
        return jnp.ones_like(y), m1, jnp.zeros_like(y), m3
    if mesh_type == MeshType.NONUNIFORM2:
        # temp = (e^2-1)^2 / (y (e^2-1) + 1)^2 ; m1 = temp/4 ; m3 = -temp/2
        # (src/mesh.c:101-106 with bounds [0,1])
        e2m1 = math.exp(2.0) - 1.0
        t = e2m1**2 / (y * e2m1 + 1.0) ** 2
        return jnp.ones_like(y), 0.25 * t, jnp.zeros_like(y), -0.5 * t
    raise ValueError(mesh_type)  # pragma: no cover


@dataclass(frozen=True)
class Mesh:
    """A 2-D tensor-product mesh: type + point counts (x, y).

    ``max_spacing`` reproduces the reference's mesh->h diagnostic
    (src/mesh.c:188-192): sqrt(dx_max^2 + dy_max^2).
    """

    mesh_type: MeshType
    npts_x: int
    npts_y: int

    def coords(self, dtype=jnp.float64):
        """(x coords (npts_x,), y coords (npts_y,)) including boundaries."""
        return (
            physical_coords(self.mesh_type, self.npts_x, 0, dtype),
            physical_coords(self.mesh_type, self.npts_y, 1, dtype),
        )

    @property
    def max_spacing(self) -> float:
        xs, ys = self.coords()
        dx = float(jnp.max(jnp.abs(jnp.diff(xs))))
        dy = float(jnp.max(jnp.abs(jnp.diff(ys))))
        return math.sqrt(dx * dx + dy * dy)


def make_mesh(mesh_type: MeshType | int, npts: int) -> Mesh:
    """Square mesh with the same point count per dimension (reference
    src/poisson.c:73-75 copies -npts to every dimension)."""
    if isinstance(mesh_type, int):
        mesh_type = MeshType(mesh_type)
    return Mesh(mesh_type, npts, npts)
