"""Residual-history cross-check artifact (SURVEY section 4 items 1-2).

Runs the reference's poisson.in default (17^2, 2 grids, V(3,3);
/root/reference/poisson.in) plus a matrix of cycle variants and records
the full normalized residual histories and the eData error norms
(reference: src/solver.c:1211-1237, 1549-1557) into
results/convergence.json.

Runs on any platform (CPU or a card); histories are deterministic for
fixed config + platform dtype semantics.

Usage (from the repository root): python benchmarks/record_convergence.py
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np

from multigrid_petsc_tpu.mesh import MeshType
from multigrid_petsc_tpu.postprocess import error_norms
from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils import runtime
from multigrid_petsc_tpu.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)


def record(name: str, cfg: SolverConfig) -> dict:
    res = solve(cfg)
    emax, el1, el2 = error_norms(
        res.ctx.problem, MeshType(cfg.mesh), np.asarray(res.u[0], np.float64)
    )
    return {
        "name": name,
        "npts": cfg.npts,
        "grids": cfg.grids,
        "levels": cfg.levels,
        "cycle": cfg.cycle.name,
        "smoother": cfg.smoother.value,
        "v": list(cfg.v),
        "mesh": cfg.mesh,
        "dtype": cfg.dtype,
        "rtol": cfg.rtol,
        "iters": int(res.iters),
        "converged": bool(res.converged),
        "rnorm_history": [float(x) for x in res.rnorm],
        "error_max": emax,
        "error_l1": el1,
        "error_l2": el2,
    }


def main() -> None:
    # The poisson.in default: 17^2, 2 grids / 2 levels, V(3,3).  The
    # reference's inner per-level KSP defaults differ from our weighted-
    # Jacobi/Chebyshev smoothers, so histories are framework-defining
    # records, not bit-comparisons against PETSc; the CONTRACT pinned here
    # is h^2 discretization error + grid-independent V-cycle rates.
    runtime.configure()
    runs = []
    base = dict(npts=17, grids=2, levels=2, v=(3, 3), rtol=1e-7,
                max_iter=200, dtype="float64")
    runs.append(("poisson_in_default_vcycle",
                 SolverConfig(cycle=CycleType.VCYCLE, **base)))
    for cyc in (CycleType.ICYCLE, CycleType.ECYCLE, CycleType.ADDITIVE,
                CycleType.PCMG):
        runs.append((f"poisson_in_{cyc.name.lower()}",
                     SolverConfig(cycle=cyc, **base)))
    # Delayed cycles: one composite level (the reference's guard,
    # /root/reference/src/poisson.c:61-65).
    d_base = dict(base, levels=1)
    for cyc in (CycleType.D1CYCLE, CycleType.D2CYCLE, CycleType.D1PSCYCLE):
        runs.append((f"poisson_in_{cyc.name.lower()}",
                     SolverConfig(cycle=cyc, **d_base)))
    # Grid-independence of the V-cycle rate (SURVEY section 4 item 2) + the
    # h^2 error contract at three resolutions on uniform + stretched mesh.
    for npts, grids in ((129, 5), (257, 6), (513, 7)):
        runs.append((
            f"vcycle_{npts}_uniform",
            SolverConfig(npts=npts, grids=grids, levels=grids,
                         cycle=CycleType.VCYCLE, rtol=1e-7, max_iter=60,
                         dtype="float64"),
        ))
    runs.append((
        "vcycle_257_stretched",
        SolverConfig(npts=257, grids=6, levels=6, mesh=1,
                     cycle=CycleType.VCYCLE, smoother=SmootherType.CHEBYSHEV,
                     rtol=1e-7, max_iter=60, dtype="float64"),
    ))
    # mg-CG at 1025^2 f32 (the headline solver family, small enough to be
    # re-run anywhere).
    runs.append((
        "mgcg_1025_f32",
        SolverConfig(npts=1025, grids=8, levels=8, cycle=CycleType.MGCG,
                     rtol=1e-5, max_iter=60, dtype="float32"),
    ))

    out = {"device": str(jax.devices()[0]), "records": []}
    for name, cfg in runs:
        print(f"== {name} ==", flush=True)
        rec = record(name, cfg)
        print(f"   iters={rec['iters']} converged={rec['converged']} "
              f"errL2={rec['error_l2']:.3e}", flush=True)
        out["records"].append(rec)

    path = Path("results/convergence.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
