"""Worker process for the 2-process multi-host test (test_multihost.py).

Runs under ``jax.distributed`` with 4 virtual CPU devices per process
(8 global) — the DCN-connected-hosts analogue of the reference's
``mpirun -n P`` execution model (src/solver.c:1239-1315 GetSol across
ranks).  Not collected by pytest (no test_ prefix).
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
outdir = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")

import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    f"localhost:{port}", num_processes=nproc, process_id=pid
)
jax.config.update("jax_enable_x64", True)

import dataclasses
import json
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp

from multigrid_petsc_tpu.parallel.device_mesh import (
    ShardingPlan,
    make_device_mesh,
    put_sharded,
    row_plan,
)
from multigrid_petsc_tpu.parallel.gather import gather_solution
from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils import checkpoint
from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig

assert jax.process_count() == nproc and jax.device_count() == 4 * nproc

out = {}

# 1. GSPMD blocks plan across both processes.
cfg_b = SolverConfig(npts=65, grids=3, levels=3, cycle=CycleType.MGCG,
                     max_iter=50)
res_b = solve(cfg_b, plan=ShardingPlan(make_device_mesh(), min_local=8))
u_b = gather_solution(res_b.u)
out["blocks"] = {"iters": int(res_b.iters), "converged": bool(res_b.converged)}

# 2. Row partition on GSPMD, halos crossing the process boundary.
cfg_r = SolverConfig(npts=129, grids=4, levels=4, cycle=CycleType.VCYCLE,
                     max_iter=60)
res_r = solve(cfg_r, plan=row_plan(min_local=8))
u_r = gather_solution(res_r.u)
out["rows"] = {
    "iters": int(res_r.iters),
    "converged": bool(res_r.converged),
    "fine_spec": list(res_r.ctx.levels[0].shardings[0].spec),
}

# 3. Sharding-aware checkpoint round trip on the RAW (still device-sharded)
#    level-0 state of a partial solve.
cfg_c = dataclasses.replace(cfg_r, max_iter=3)
part = solve(cfg_c, plan=row_plan(min_local=8))
lvl0 = part.ctx.levels[0]
raw = (put_sharded(jnp.full(lvl0.shapes[0], 1.5, part.ctx.dtype),
                   lvl0.shardings[0]),)  # multi-host sharded array
ck = Path(outdir) / "mh_ckpt.npz"
checkpoint.save(ck, cfg_c, raw, part.rnorm, part.iters)
if pid == 0:
    u_l, rn_l, it_l = checkpoint.load(ck, cfg_c)
    assert u_l[0].shape == (127, 127), u_l[0].shape
    assert np.allclose(u_l[0], 1.5)
    assert it_l == part.iters

if pid == 0:
    np.save(Path(outdir) / "u_blocks.npy", u_b)
    np.save(Path(outdir) / "u_rows.npy", u_r)
    (Path(outdir) / "result.json").write_text(json.dumps(out))
print(f"[worker {pid}] ok", flush=True)
