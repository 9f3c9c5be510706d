"""Benchmark: FULL mg-CG Poisson solve throughput on one card.

Prints the device report on earlier lines and ONE JSON line last:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Headline metric: the complete 8193^2 f32 mg-CG solve (11-level
hierarchy, V(3,3) Jacobi, direct coarse solve, rtol 1e-5).  ``value`` is
fine-grid point-updates/s over the marginal outer iteration;
``vs_baseline`` is the fraction of the measured memory stream rate the
solve achieves under the traffic model
(benchmarks/baseline_configs.modeled_bytes_per_iter).  Needs a GPU: it
fails rather than measure the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import statistics

from multigrid_petsc_tpu.utils import runtime

EXPECTED_PATH = "cuda"  # the CUDA smoother on the large levels


def main() -> None:
    runtime.configure()
    device = runtime.device_report()
    for k, v in device.items():
        print(f"{k}: {v}", flush=True)

    from benchmarks.baseline_configs import (
        measured_bandwidth_info,
        modeled_bytes_per_iter,
    )
    from multigrid_petsc_tpu.solvers.solve import solve
    from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig

    npts, grids = 8193, 11
    cfg = SolverConfig(
        npts=npts, grids=grids, levels=grids, cycle=CycleType.MGCG,
        dtype="float32", rtol=1e-5, max_iter=100,
    )
    res = solve(cfg, timed=True)
    assert res.converged, "bench solve failed to converge"
    assert res.path == EXPECTED_PATH, (
        f"expected path {EXPECTED_PATH!r}, got {res.path!r}")

    # Per-iteration device time by differencing two forced-length runs of
    # the same solve: the difference cancels the setup V-cycle and the
    # transfers every call carries.  Median of three pairs.
    forced = dataclasses.replace(cfg, rtol=1e-30, divtol=1e30)
    k1, k2 = 3, 23
    pairs = []
    for _ in range(3):
        t1 = solve(dataclasses.replace(forced, max_iter=k1),
                   timed=True).wall_time
        t2 = solve(dataclasses.replace(forced, max_iter=k2),
                   timed=True).wall_time
        pairs.append((t2 - t1) / (k2 - k1))
    s_per_iter = statistics.median(pairs)

    bw_info = measured_bandwidth_info(npts - 2)
    bw = bw_info["bytes_per_s"]
    per_iter = modeled_bytes_per_iter(res.ctx)
    n2 = (npts - 2) ** 2
    print(json.dumps({
        "metric": "mgcg_full_solve_points_per_s",
        "value": n2 / s_per_iter,
        "unit": "point-updates/s",
        "vs_baseline": (per_iter / s_per_iter) / bw,
        "ms_per_iter_device": 1e3 * s_per_iter,
        "ms_per_iter_samples": [1e3 * p for p in pairs],
        "achieved_GBps_vs_model": per_iter / s_per_iter / 1e9,
        "stream_GBps": bw / 1e9,
        "stream_samples_GBps": bw_info["samples_GBps"],
        "peak_GBps": bw_info["peak_GBps"],
        "modeled_MB_per_iter": per_iter / 1e6,
        "solve_iters": int(res.iters),
        "path": res.path,
        "device": {k: device[k] for k in ("platform", "kind", "count")},
    }))


if __name__ == "__main__":
    main()
