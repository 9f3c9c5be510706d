"""multigrid_petsc_tpu: a matrix-free geometric-multigrid Poisson framework.

A from-scratch JAX/XLA re-design with the capabilities of the
reference C99+PETSc+MPI program (SyamVangara/multigrid-petsc): 2-D Poisson on
(possibly stretched) structured grids, discretized with a 5-point
variable-coefficient stencil, solved by a zoo of multigrid cycle variants
(V, I, E, D1, D2, D1PS, additive, additive2, and an outer-Krylov "PCMG"
equivalent), with residual history, discrete-error reporting and timing.

Design notes (not a port):
  * unknowns are dense 2-D jnp arrays of grid interiors (Dirichlet boundary
    eliminated), not distributed CSR matrices;
  * operators are matrix-free stencil applies (jnp shifts that XLA fuses,
    and a CUDA k-sweep smoother on a GPU's large f32 levels); an explicit
    sparse backend exists for parity/benchmarking;
  * parallelism is row or 2-D block sharding over a jax.sharding.Mesh with
    one-cell halo exchange, replacing the reference's MPI row partition
    (reference: src/matbuild.c:120-144, PETSc MatMult halo exchange);
  * the composite "merged grid" levels of the reference
    (src/solver.c:255-487) become coupled pytrees of per-grid blocks with
    matrix-free coupling applies.
"""

from multigrid_petsc_tpu.mesh import MeshType, Mesh1D, make_mesh
from multigrid_petsc_tpu.problems import Problem, poisson_sin_problem
from multigrid_petsc_tpu.hierarchy import GridSpec, LevelSpec, build_hierarchy
from multigrid_petsc_tpu.utils.config import SolverConfig, CycleType

__all__ = [
    "MeshType",
    "Mesh1D",
    "make_mesh",
    "Problem",
    "poisson_sin_problem",
    "GridSpec",
    "LevelSpec",
    "build_hierarchy",
    "SolverConfig",
    "CycleType",
]

__version__ = "0.1.0"
