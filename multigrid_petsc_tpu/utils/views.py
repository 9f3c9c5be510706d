"""Diagnostic views: human-readable dumps of meshes, hierarchies and
operators.

Capability parity with the reference's View* debug functions
(reference: src/poisson.c:216-425: ViewMeshInfo, ViewGridsInfo,
ViewIndexMapsInfo, ViewRangesInfo, ViewSolverInfo, ViewOperatorInfo,
ViewLinSysMatsInfo, ViewGridTransferMatsInfo — mostly commented out at
their call sites but part of the debugging surface).
"""

from __future__ import annotations

import numpy as np

from multigrid_petsc_tpu.mesh import MeshType, physical_coords
from multigrid_petsc_tpu.ops.transfer import (
    PROLONG_3x3,
    RESTRICT_3x3,
    composed_transfer_stencil,
)


def view_mesh(mesh_type: MeshType, npts: int) -> str:
    """Mesh coordinates + max spacing (ViewMeshInfo)."""
    xs = np.asarray(physical_coords(mesh_type, npts, 0))
    ys = np.asarray(physical_coords(mesh_type, npts, 1))
    lines = [f"mesh type={mesh_type.name} npts={npts}"]
    lines.append(f"x: {np.array2string(xs, precision=4, threshold=12)}")
    lines.append(f"y: {np.array2string(ys, precision=4, threshold=12)}")
    lines.append(
        f"max spacing: dx={np.max(np.diff(xs)):.5f} dy={np.max(np.diff(ys)):.5f}"
    )
    return "\n".join(lines)


def view_hierarchy(specs) -> str:
    """Grids-per-level layout (ViewGridsInfo / ViewRangesInfo)."""
    lines = []
    for l, spec in enumerate(specs):
        gs = ", ".join(
            f"g{g.g}:{g.ny}x{g.nx}(h={g.hy:.4g})" for g in spec.grids
        )
        lines.append(f"level {l}: [{gs}]"
                     + ("  <- composite" if spec.is_composite else ""))
    return "\n".join(lines)


def view_transfer_operators(max_gap: int = 3) -> str:
    """Composed transfer stencils (ViewOperatorInfo)."""
    lines = []
    for gap in range(1, max_gap + 1):
        r = composed_transfer_stencil(RESTRICT_3x3, gap)
        p = composed_transfer_stencil(PROLONG_3x3, gap)
        lines.append(f"gap {gap}: res {r.shape} sum={r.sum():.4f}, "
                     f"pro {p.shape} sum={p.sum():.4f}")
    return "\n".join(lines)


def view_operator(ctx, level: int = 0, max_rows: int = 8) -> str:
    """First rows of the level operator via the native CSR assembly
    (ViewLinSysMatsInfo)."""
    from multigrid_petsc_tpu.ops.sparse import assemble_level_csr

    spec = ctx.levels[level].spec
    indptr, indices, data = assemble_level_csr(
        ctx.config.npts, ctx.config.mesh, spec.gids
    )
    lines = [f"level {level} operator: {len(indptr)-1} rows, {len(data)} nnz"]
    for r in range(min(max_rows, len(indptr) - 1)):
        lo, hi = indptr[r], indptr[r + 1]
        ents = " ".join(
            f"({c},{v:.3g})" for c, v in zip(indices[lo:hi], data[lo:hi])
        )
        lines.append(f"  row {r}: {ents}")
    return "\n".join(lines)


def view_solver(ctx) -> str:
    """Per-level solver dump — the KSPView analogue (reference:
    src/solver.c:1560-1564 dumps every level's KSP after the solve:
    smoother type, iteration counts, preconditioner).  Reports each
    level's grids, operator backend, smoother configuration, layout
    (sharding / pad), and the coarsest-level solver choice."""
    cfg = ctx.config
    lines = [
        f"solver: cycle={cfg.cycle.name} v={cfg.v} rtol={cfg.rtol:g} "
        f"divtol={cfg.divtol:g} dtype={cfg.dtype}"
        + (f" outer_dtype={cfg.outer_dtype}" if cfg.outer_dtype else "")
        + f" path={ctx.path}"
    ]
    L = len(ctx.levels)
    for l, lvl in enumerate(ctx.levels):
        gs = ", ".join(f"g{g.g}:{g.ny}x{g.nx}" for g in lvl.spec.grids)
        if lvl.sparse_full is not None:
            backend = f"sparse(ell, nnz={lvl.sparse_full.nnz})"
        elif lvl.cuda_smoother:
            backend = "cuda-smoother"
        else:
            backend = "xla"
        if lvl.spec.is_composite:
            smoother = f"{cfg.composite_smoother}(inner={cfg.v[0]})"
        else:
            smoother = cfg.smoother.value
            if cfg.smoother.value == "chebyshev" and lvl.lmax is not None:
                smoother += f"(lmax={lvl.lmax:.4g})"
            elif cfg.smoother.value == "jacobi":
                smoother += f"(omega={cfg.omega})"
        sweeps = cfg.v[1] if (l == L - 1 and L > 1) else cfg.v[0]
        layout = ""
        if lvl.shardings is not None:
            layout = f" layout={tuple(lvl.shardings[0].spec)}"
        coarse = ""
        if l == L - 1 and L > 1:
            coarse = (" coarse=smooth" if lvl.coarse_solve is None
                      else f" coarse={cfg.coarse_solver}")
        lines.append(
            f"level {l}: [{gs}] op={backend} smoother={smoother} "
            f"sweeps={sweeps}{layout}{coarse}"
        )
    return "\n".join(lines)
