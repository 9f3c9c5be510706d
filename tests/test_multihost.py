"""Multi-host (2-process jax.distributed) execution: the DCN analogue of
the reference's multi-rank MPI runs (src/solver.c:1239-1315 GetSol;
SURVEY.md section 4 item 5 'mpirun -n P').

Spawns two coordinated CPU processes (4 virtual devices each, 8 global),
runs sharded solves over the joint mesh — the block plan and the row
plan, with halos crossing the process boundary — exercises
the multihost gather_solution branch and the sharding-aware checkpoint,
and checks the answers against the in-process single-host solve.
"""

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mh_results(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("mh")
    port = _free_port()
    worker = Path(__file__).parent / "_mh_worker.py"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", str(port),
             str(outdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out)
    rcs = [p.returncode for p in procs]
    if any(rcs):
        pytest.fail("multihost workers failed:\n" + "\n----\n".join(logs))
    res = json.loads((outdir / "result.json").read_text())
    res["u_blocks"] = np.load(outdir / "u_blocks.npy")
    res["u_rows"] = np.load(outdir / "u_rows.npy")
    return res


def test_multihost_blocks_solve(mh_results):
    ref = solve(SolverConfig(npts=65, grids=3, levels=3,
                             cycle=CycleType.MGCG, max_iter=50))
    assert mh_results["blocks"]["converged"]
    assert mh_results["blocks"]["iters"] == ref.iters
    np.testing.assert_allclose(mh_results["u_blocks"], ref.u_fine,
                               rtol=1e-6, atol=1e-11)


def test_multihost_rows_solve(mh_results):
    """Row plan on GSPMD across both processes: the fine level is really
    row-sharded and the solve matches the single-process one."""
    ref = solve(SolverConfig(npts=129, grids=4, levels=4,
                             cycle=CycleType.VCYCLE, max_iter=60))
    assert mh_results["rows"]["converged"]
    assert mh_results["rows"]["fine_spec"] == ["y", None]
    assert mh_results["rows"]["iters"] == ref.iters
    np.testing.assert_allclose(mh_results["u_rows"], ref.u_fine,
                               rtol=1e-6, atol=1e-11)
