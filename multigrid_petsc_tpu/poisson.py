"""CLI entry point: the framework's equivalent of the reference binary.

Usage (mirrors `mpirun -n P ./poisson` with poisson.in in cwd; reference:
src/poisson.c:27-138):

    python -m multigrid_petsc_tpu.poisson [options_file] [-key value ...]

Reads a poisson.in-style options file (default ./poisson.in if present),
then applies any command-line overrides using the same -key value syntax,
runs the configured solve, prints the run banner / errors / timings, and
writes the reference's artifact files.
"""

from __future__ import annotations

import sys
from pathlib import Path

from multigrid_petsc_tpu.mesh import MeshType
from multigrid_petsc_tpu.postprocess import error_norms, write_artifacts
from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils import runtime
from multigrid_petsc_tpu.utils.config import (
    SolverConfig,
    parse_options,
    parse_options_file,
)
from multigrid_petsc_tpu.utils.logging import print_info


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    runtime.configure()
    cfg = SolverConfig()

    # Positional options file (or ./poisson.in, like PetscInitialize's
    # default file argument at src/poisson.c:29).
    if argv and not argv[0].startswith("-"):
        cfg = parse_options_file(argv.pop(0), cfg)
    elif Path("poisson.in").exists():
        cfg = parse_options_file("poisson.in", cfg)

    # Command-line -key value overrides (the PETSc options-DB behavior).
    if argv:
        cfg = parse_options(
            [f"{argv[i]} {argv[i + 1]}" for i in range(0, len(argv) - 1, 2)],
            cfg,
        )

    try:
        cfg = cfg.validate()
    except ValueError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 1

    # -map selects the distributed layout when more than one device is
    # attached (the reference's three ordering styles decided how unknowns
    # were laid out over MPI ranks, src/matbuild.c:146-323): style 2
    # ("local grid after grid", driven by the fine-grid decomposition —
    # the default) maps to the 1-D row partition; styles 0/1
    # (grid-after-grid / through-grids) map to the 2-D block plan.
    plan = None
    import jax

    if jax.device_count() > 1:
        from multigrid_petsc_tpu.parallel.device_mesh import (
            ShardingPlan,
            make_device_mesh,
            row_plan,
        )

        if cfg.map_style == 2:
            plan = row_plan()
        else:
            plan = ShardingPlan(make_device_mesh())

    res = solve(cfg, plan=plan)
    mesh_type = MeshType(cfg.mesh)
    errs = error_norms(res.ctx.problem, mesh_type, res.u_fine)

    print_info(cfg, res, errs)
    if cfg.view_solver:
        # Per-level solver dump — the reference prints KSPView for every
        # level after the V-cycle solve (src/solver.c:1560-1564).
        from multigrid_petsc_tpu.utils.views import view_solver

        print(view_solver(res.ctx))
    r_global = r_grid = None
    if res.aux is not None:
        r_global = res.aux["r_global"]
        r_grid = {g: res.aux["r_grid"][g] for g in range(res.aux["r_grid"].shape[0])}
    write_artifacts(".", mesh_type, res.u_fine, res.rnorm, errs,
                    r_global=r_global, r_grid=r_grid)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
