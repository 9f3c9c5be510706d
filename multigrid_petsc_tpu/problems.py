"""Problem definitions: PDE right-hand side, exact solution, stencil generator.

Capability parity with the reference problem module (reference:
src/problem.c:3-46): the manufactured Poisson problem

    laplacian(u) = f,   u(x,y) = sin(pi x) sin(pi y),
    f(x,y) = -2 pi^2 sin(pi x) sin(pi y),

homogeneous Dirichlet on [0,1]^2, discretized with a 5-point
variable-coefficient stencil whose coefficients come from the mesh metrics
(reference: src/problem.c:3-22 `OpA`):

    A_s = m1/hy^2 - m3/(2 hy)     (south:  u[i-1, j])
    A_w = m0/hx^2 - m2/(2 hx)     (west:   u[i, j-1])
    A_c = -2 (m0/hx^2 + m1/hy^2)  (center: u[i, j])
    A_e = m0/hx^2 + m2/(2 hx)     (east:   u[i, j+1])
    A_n = m1/hy^2 + m3/(2 hy)     (north:  u[i+1, j])

(The neighbor identification follows the assembly loop at
src/solver.c:218-252; row index i is the y direction, column j is x.)

Redesign: coefficients are evaluated vectorized on-device as broadcastable
arrays.  For the tensor-product meshes the metrics depend on y only, so
coefficient arrays have shape (ny, 1) and broadcast across x — a large
memory-bandwidth saving versus materializing (ny, nx) fields.  A fully
variable-coefficient 9-point path is provided by ops.stencil.Stencil9.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax.numpy as jnp

from multigrid_petsc_tpu.mesh import MeshType, metric_terms, physical_coords
from multigrid_petsc_tpu.ops.stencil import Stencil5


@dataclass(frozen=True)
class Problem:
    """An analytic test problem (RHS + exact solution)."""

    f: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]
    u_exact: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]
    name: str = "poisson-sin"


def poisson_sin_problem() -> Problem:
    """The reference's manufactured problem (src/problem.c:24-34)."""

    def f(x, y):
        return -2.0 * jnp.pi**2 * jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)

    def u_exact(x, y):
        return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)

    return Problem(f=f, u_exact=u_exact)


def interior_coords(mesh_type: MeshType, npts_grid: int, npts_fine: int, axis: int, dtype):
    """Physical coords of the npts_grid-2 interior points of a (possibly
    coarsened) grid.

    The coarse grid's computational coordinates coincide with a subset of the
    fine mesh's, and both are generated by the same analytic transform, so we
    evaluate the transform directly at the coarse points (equivalent to the
    reference's indexing into the fine coord array, src/solver.c:231-235).
    ``npts_fine`` is accepted for interface clarity but unused.
    """
    del npts_fine
    return physical_coords(mesh_type, npts_grid, axis, dtype)[1:-1]


def stencil_coefficients(
    mesh_type: MeshType,
    ny: int,
    nx: int,
    dtype=jnp.float64,
) -> Stencil5:
    """5-point stencil coefficients for a grid with (ny, nx) interior points.

    hx = 1/(nx+1), hy = 1/(ny+1) in computational space (reference:
    src/matbuild.c:99-104).  Metrics are evaluated at each interior point's
    physical location.  Returns (ny, 1)-shaped coefficient arrays
    (broadcast across x, exact for these tensor-product meshes).
    """
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    y = physical_coords(mesh_type, ny + 2, 1, dtype)[1:-1].reshape(ny, 1)
    m0, m1, m2, m3 = metric_terms(mesh_type, y)

    hx2 = hx * hx
    hy2 = hy * hy
    cs = m1 / hy2 - m3 / (2.0 * hy)
    cw = m0 / hx2 - m2 / (2.0 * hx)
    cc = -2.0 * (m0 / hx2 + m1 / hy2)
    ce = m0 / hx2 + m2 / (2.0 * hx)
    cn = m1 / hy2 + m3 / (2.0 * hy)
    return Stencil5(
        cs=cs.astype(dtype),
        cw=cw.astype(dtype),
        cc=cc.astype(dtype),
        ce=ce.astype(dtype),
        cn=cn.astype(dtype),
    )


def rhs_grid(problem: Problem, mesh_type: MeshType, ny: int, nx: int, dtype=jnp.float64):
    """f evaluated at the interior points of an (ny, nx)-interior grid
    (reference: src/solver.c:593-597 evaluates f at the grid's physical
    coordinates)."""
    x = physical_coords(mesh_type, nx + 2, 0, dtype)[1:-1].reshape(1, nx)
    y = physical_coords(mesh_type, ny + 2, 1, dtype)[1:-1].reshape(ny, 1)
    return problem.f(x, y)


def exact_grid(problem: Problem, mesh_type: MeshType, ny: int, nx: int, dtype=jnp.float64):
    """u_exact at the interior points of an (ny, nx)-interior grid."""
    x = physical_coords(mesh_type, nx + 2, 0, dtype)[1:-1].reshape(1, nx)
    y = physical_coords(mesh_type, ny + 2, 1, dtype)[1:-1].reshape(ny, 1)
    return problem.u_exact(x, y)


# --------------------------------------------------------------------------
# Anisotropic / variable-coefficient 9-point problem family
# (framework extension; BASELINE.md config 4).  Operator (expanded form):
#
#     L u = a u_xx + a_x u_x + c u_yy + c_y u_y + 2 b u_xy
#
# with a = a(x), c = c(y) (so L u = (a u_x)_x + (c u_y)_y + 2 b u_xy) and
# constant mixed coefficient b (b^2 < a*c for ellipticity).  The 9-point
# stencil discretizes u_xy with the corner cross (NE - NW - SE + SW)/(4 h^2).
# Manufactured solution: the same sin(pi x) sin(pi y).
# --------------------------------------------------------------------------

from multigrid_petsc_tpu.ops.stencil import Stencil9


@dataclass(frozen=True)
class AnisoProblem:
    """Variable-coefficient anisotropic diffusion with manufactured RHS.

    a(x) = ax0 + ax2 * x^2,  c(y) = cy0 + cy2 * y^2,  b constant.
    eps-style anisotropy comes from ax0 << cy0 (strong y coupling).
    """

    ax0: float = 1.0
    ax2: float = 0.0
    cy0: float = 1.0
    cy2: float = 0.0
    b: float = 0.0
    name: str = "aniso-9pt"

    def coeffs(self, x, y):
        a = self.ax0 + self.ax2 * x * x
        a_x = 2.0 * self.ax2 * x
        c = self.cy0 + self.cy2 * y * y
        c_y = 2.0 * self.cy2 * y
        return a, a_x, c, c_y

    def u_exact(self, x, y):
        return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)

    def f(self, x, y):
        pi = jnp.pi
        u = jnp.sin(pi * x) * jnp.sin(pi * y)
        u_x = pi * jnp.cos(pi * x) * jnp.sin(pi * y)
        u_y = pi * jnp.sin(pi * x) * jnp.cos(pi * y)
        u_xy = pi * pi * jnp.cos(pi * x) * jnp.cos(pi * y)
        a, a_x, c, c_y = self.coeffs(x, y)
        return (
            -a * pi * pi * u + a_x * u_x
            - c * pi * pi * u + c_y * u_y
            + 2.0 * self.b * u_xy
        )


def stencil9_coefficients(
    prob: AnisoProblem, ny: int, nx: int, dtype=jnp.float64
) -> Stencil9:
    """9-point stencil fields for the anisotropic operator on a uniform
    (ny, nx)-interior grid (coefficients are full (ny, nx)-broadcastable
    fields: (1, nx) for x-dependent, (ny, 1) for y-dependent terms)."""
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    x = (jnp.arange(1, nx + 1, dtype=dtype) * hx).reshape(1, nx)
    y = (jnp.arange(1, ny + 1, dtype=dtype) * hy).reshape(ny, 1)
    a, a_x, c, c_y = prob.coeffs(x, y)
    zero = jnp.zeros((1, 1), dtype)
    bq = prob.b / (2.0 * hx * hy)
    bq = jnp.full((1, 1), bq, dtype)
    ce = a / (hx * hx) + a_x / (2.0 * hx)
    cw = a / (hx * hx) - a_x / (2.0 * hx)
    cn = c / (hy * hy) + c_y / (2.0 * hy)
    cs = c / (hy * hy) - c_y / (2.0 * hy)
    cc = (-2.0 * a / (hx * hx) + zero) + (-2.0 * c / (hy * hy))
    return Stencil9(
        csw=bq, cs=cs + zero, cse=-bq,
        cw=cw + zero, cc=cc, ce=ce + zero,
        cnw=-bq, cn=cn + zero, cne=bq,
    )


def aniso_rhs_grid(prob: AnisoProblem, ny: int, nx: int, dtype=jnp.float64):
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    x = (jnp.arange(1, nx + 1, dtype=dtype) * hx).reshape(1, nx)
    y = (jnp.arange(1, ny + 1, dtype=dtype) * hy).reshape(ny, 1)
    return prob.f(x, y)


def aniso_exact_grid(prob: AnisoProblem, ny: int, nx: int, dtype=jnp.float64):
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    x = (jnp.arange(1, nx + 1, dtype=dtype) * hx).reshape(1, nx)
    y = (jnp.arange(1, ny + 1, dtype=dtype) * hy).reshape(ny, 1)
    return prob.u_exact(x, y)
