"""Weak/strong/size scaling study over a device mesh.

BASELINE.md asks for nnz/s per card and weak-scaling efficiency at
1 card / 1 host / N hosts.  This harness runs the REAL distributed code
path over however many devices the backend exposes — virtual CPU devices
for functional validation (virtual devices share one host's cores, so CPU
"efficiency" numbers validate the communication structure, not hardware
scaling), real cards when they are attached.  Usage:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py --npts 513 --mode weak --plan blocks

Modes:
  weak   — problem grows with device count (constant points/device)
  strong — fixed problem, growing device count
  size   — single device, growing problem size (the roofline-saturation
           curve on a card: points/s should rise to the memory-bandwidth
           plateau as launch latency amortizes)

Plans: blocks (2-D GSPMD) | rows (1-D row partition, GSPMD).

Reports one JSON line per run with points/s and efficiency relative to
the base run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax

from multigrid_petsc_tpu.utils import runtime

runtime.configure()

# --platform cpu must take effect BEFORE backend init.
if "--platform" in sys.argv:
    _plat = sys.argv[sys.argv.index("--platform") + 1]
    if _plat == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        jax.config.update("jax_platforms", "cpu")


def run_one(npts: int, n_dev: int, cycle: str, dtype: str, max_iter: int,
            plan_kind: str):
    from multigrid_petsc_tpu.parallel.device_mesh import (
        ShardingPlan,
        make_device_mesh,
        row_plan,
    )
    from multigrid_petsc_tpu.solvers.solve import solve
    from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig

    levels = 1
    while (npts - 1) % (2**levels) == 0 and (npts - 1) // (2**levels) > 4:
        levels += 1
    plan = None
    if n_dev > 1:
        devices = jax.devices()[:n_dev]
        if plan_kind == "rows":
            plan = row_plan(devices=devices, min_local=16)
        else:
            plan = ShardingPlan(make_device_mesh(devices=devices),
                                min_local=16)
    cfg = SolverConfig(
        npts=npts, grids=levels, levels=levels,
        cycle=CycleType[cycle], dtype=dtype, max_iter=max_iter, rtol=1e-5,
    )
    res = solve(cfg, plan=plan, timed=True)
    n = npts - 2
    pts = n * n * max(res.iters, 1)
    return {
        "devices": n_dev,
        "npts": npts,
        "plan": plan_kind if plan is not None else "none",
        "iters": int(res.iters),
        "converged": bool(res.converged),
        "wall_s": res.wall_time,
        "points_per_s": pts / res.wall_time,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--npts", type=int, default=257)
    ap.add_argument("--mode", choices=["weak", "strong", "size"],
                    default="weak")
    ap.add_argument("--plan", choices=["blocks", "rows"], default="blocks")
    ap.add_argument("--cycle", default="MGCG")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--max-iter", type=int, default=20)
    ap.add_argument("--platform", default=None,
                    help="cpu forces the 8-virtual-device CPU mesh")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    rows = []
    if args.mode == "size":
        base = None
        npts = args.npts
        while True:
            r = run_one(npts, 1, args.cycle, args.dtype, args.max_iter,
                        args.plan)
            base = base or r
            r["efficiency"] = r["points_per_s"] / base["points_per_s"]
            rows.append(r)
            print(json.dumps(r), flush=True)
            npts = (npts - 1) * 2 + 1
            if npts > 8193:
                break
    else:
        n_all = len(jax.devices())
        counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n_all]
        base = None
        for c in counts:
            npts = args.npts
            if args.mode == "weak":
                import math

                factor = int(round(math.sqrt(c)))
                npts = (args.npts - 1) * factor + 1
            r = run_one(npts, c, args.cycle, args.dtype, args.max_iter,
                        args.plan)
            if base is None:
                base = r
            if args.mode == "weak":
                r["efficiency"] = (r["points_per_s"] / c) / base["points_per_s"]
            else:
                r["efficiency"] = r["points_per_s"] / (base["points_per_s"] * c)
            rows.append(r)
            print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                              for k, v in r.items()}), flush=True)

    if args.out:
        from pathlib import Path

        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        note = ""
        if jax.devices()[0].platform == "cpu":
            note = ("virtual CPU devices share one host's cores: these "
                    "efficiencies validate the distributed code path "
                    "(sharding/halo/collectives), NOT hardware scaling")
        out.write_text(json.dumps(
            {"mode": args.mode, "plan": args.plan,
             "device": str(jax.devices()[0]), "note": note,
             "rows": rows}, indent=1))
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
