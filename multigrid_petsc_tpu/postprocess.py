"""Post-processing: discrete error norms and diagnostic artifact files.

Capability parity with the reference (reference: src/solver.c:1211-1380):
  * GetError: max / L1 / L2 norms of |u - u_exact| over the fine grid
    (unnormalized sums, exactly as src/solver.c:1224-1236),
  * Postprocessing writers: uData.dat, rData.dat (residual history),
    eData.dat (3 error norms), XgridData.dat / YgridData.dat
    (src/solver.c:151-166, 1329-1354), plus rGlobal.dat / rGrid<i>.dat for
    the per-grid inner-sweep monitors (src/solver.c:1356-1376).

Redesign: no rank-0 MPI gather is needed — the solution is (or can be
gathered to) a single device array; error norms are computed on-device.
The reference's GetSol send/recv (src/solver.c:1239-1315, including its
latent MPI_DOUBLE count bug) has no analogue here by design.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from multigrid_petsc_tpu.mesh import MeshType, physical_coords
from multigrid_petsc_tpu.problems import Problem, exact_grid


def error_norms(problem: Problem, mesh_type: MeshType, u_fine: np.ndarray):
    """(max, L1, L2) of |u - u_exact| on the fine interior grid
    (src/solver.c:1211-1237: L1/L2 are unnormalized sums)."""
    ny, nx = u_fine.shape
    ue = exact_grid(problem, mesh_type, ny, nx, jnp.asarray(u_fine).dtype)
    diff = jnp.abs(jnp.asarray(u_fine) - ue)
    return (
        float(jnp.max(diff)),
        float(jnp.sum(diff)),
        float(jnp.sqrt(jnp.sum(diff * diff))),
    )


def write_artifacts(
    outdir: str | Path,
    mesh_type: MeshType,
    u_fine: np.ndarray,
    rnorm: np.ndarray,
    errors: tuple[float, float, float],
    r_global: np.ndarray | None = None,
    r_grid: dict[int, np.ndarray] | None = None,
) -> None:
    """Write the reference's artifact files (same names/layout:
    src/solver.c:159-165, 1329-1376)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    ny, nx = u_fine.shape
    xs = np.asarray(physical_coords(mesh_type, nx + 2, 0))
    ys = np.asarray(physical_coords(mesh_type, ny + 2, 1))

    with open(outdir / "eData.dat", "w") as f:
        for e in errors:
            f.write(f"{e:.16e}\n")
    with open(outdir / "rData.dat", "w") as f:
        f.write(" ".join(f"{v:.16e}" for v in np.asarray(rnorm)) + " \n")
    with open(outdir / "uData.dat", "w") as f:
        for i in range(ny):
            f.write("    ".join(f"{v:.16e}" for v in u_fine[i]) + "    \n")
    # Grid files hold the coordinate of each interior point, row-major,
    # matching the reference's per-point dump (src/solver.c:1339-1348,
    # which indexes coord[0][j] / coord[1][i] over interior rows/cols).
    with open(outdir / "XgridData.dat", "w") as f:
        for _ in range(ny):
            f.write("    ".join(f"{v:f}" for v in xs[:nx]) + "    \n")
    with open(outdir / "YgridData.dat", "w") as f:
        for i in range(ny):
            f.write("    ".join(f"{ys[i]:f}" for _ in range(nx)) + "    \n")
    if r_global is not None:
        with open(outdir / "rGlobal.dat", "w") as f:
            f.write(" ".join(f"{v:.16e}" for v in np.asarray(r_global)) + " \n")
    if r_grid is not None:
        for g, vals in r_grid.items():
            with open(outdir / f"rGrid{g}.dat", "w") as f:
                f.write(" ".join(f"{v:.16e}" for v in np.asarray(vals)) + " \n")
