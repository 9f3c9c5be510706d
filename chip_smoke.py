"""Smoke test of the mg-CG Poisson solver on an NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # four cards: block and row plans only

Phases (one card), each fatal on failure:
  1. device report (no GPU: exit 1, no result line);
  2. parity at small size: GPU vs the same solve on the host CPU backend,
     both vs a host f64 sparse direct solve; the CLI on the reference's
     poisson.in configuration; the coarse solve free of TF32;
  3. the headline solve: 8193^2 f32 mg-CG, V(3,3) Jacobi, 11 levels,
     direct coarsest solve, rtol 1e-5; then the same solve under an f64
     outer, whose true residual is checked in f64 on the host;
  4. the CUDA smoother decision: the plain XLA smoother and the kernel on
     the fine level, then the whole solve with each, in turns;
  5. 1e-8 certification at 1025^2: native f64 outer and float32x2 outer;
  6. the tests marked ``gpu``, in this process.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from multigrid_petsc_tpu.utils import runtime

runtime.configure()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multigrid_petsc_tpu.mesh import MeshType  # noqa: E402
from multigrid_petsc_tpu.problems import rhs_grid  # noqa: E402
from multigrid_petsc_tpu.solvers.solve import solve  # noqa: E402
from multigrid_petsc_tpu.utils.config import (  # noqa: E402
    CycleType,
    SolverConfig,
)

CARD = ""  # "name, power limit" of the card, printed beside every number


def say(msg: str) -> None:
    print(f"{msg}  [{CARD}]", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")
    say(f"ok: {what}")


def headline(npts: int = 8193, levels: int = 11, **kw) -> SolverConfig:
    return SolverConfig(npts=npts, grids=levels, levels=levels,
                        cycle=CycleType.MGCG, dtype="float32", rtol=1e-5,
                        max_iter=100, **kw)


def host_operator(cfg: SolverConfig):
    """Level-0 operator of ``cfg`` as a host f64 scipy sparse matrix (the
    assembly of solvers/coarse.dense_from_stencil, kept sparse)."""
    import scipy.sparse as sp

    from multigrid_petsc_tpu.problems import stencil_coefficients
    from multigrid_petsc_tpu.solvers.coarse import stencil_coo

    n = cfg.npts - 2
    st = stencil_coefficients(MeshType(cfg.mesh), n, n, np.float64)
    r, c, v = stencil_coo(st, n, n)
    return sp.csr_matrix((v, (r, c)), shape=(n * n, n * n))


def host_rhs(cfg: SolverConfig) -> np.ndarray:
    from multigrid_petsc_tpu.problems import poisson_sin_problem

    n = cfg.npts - 2
    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(rhs_grid(poisson_sin_problem(), MeshType(cfg.mesh),
                                   n, n, jnp.float64))


def true_residual(cfg: SolverConfig, u: np.ndarray) -> float:
    """||b - A u|| / ||b|| in f64 on the host, by the matrix-free stencil
    in numpy (no device arithmetic)."""
    from multigrid_petsc_tpu.problems import stencil_coefficients

    n = cfg.npts - 2
    st = [np.asarray(c, np.float64) for c in
          stencil_coefficients(MeshType(cfg.mesh), n, n, np.float64)]
    cs, cw, cc, ce, cn = st
    u = np.asarray(u, np.float64)
    p = np.pad(u, 1)
    au = (cc * u + cs * p[:-2, 1:-1] + cn * p[2:, 1:-1]
          + cw * p[1:-1, :-2] + ce * p[1:-1, 2:])
    b = host_rhs(cfg)
    return float(np.linalg.norm(b - au) / np.linalg.norm(b))


def rel_error(cfg: SolverConfig, u: np.ndarray) -> float:
    """||u - u_exact|| / ||u_exact|| in f64 on the host."""
    from multigrid_petsc_tpu.problems import exact_grid, poisson_sin_problem

    n = cfg.npts - 2
    with jax.default_device(jax.devices("cpu")[0]):
        ue = np.asarray(exact_grid(poisson_sin_problem(), MeshType(cfg.mesh),
                                   n, n, jnp.float64))
    return float(np.linalg.norm(np.asarray(u, np.float64) - ue)
                 / np.linalg.norm(ue))


def time_ms(fn, *args, reps: int = 10) -> float:
    """Mean device time of ``fn(*args)`` over ``reps`` back-to-back calls
    (compiled and warmed first), ended by block_until_ready."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return 1e3 * (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# Phase 2: parity at small size
# ---------------------------------------------------------------------------


def parity_case(name: str, cfg: SolverConfig, f64: bool) -> None:
    """GPU solve vs the same solve on the host's CPU backend, and both vs
    a host f64 sparse direct solve of the same discrete system."""
    import scipy.sparse.linalg as spla

    gpu = solve(cfg)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = solve(cfg)
    say(f"{name}: gpu iters={gpu.iters} cpu iters={cpu.iters} "
        f"path={gpu.path} final rnorm gpu={gpu.rnorm[-1]:.3e} "
        f"cpu={cpu.rnorm[-1]:.3e}")
    check(gpu.converged and cpu.converged, f"{name}: both converged")
    check(gpu.iters == cpu.iters, f"{name}: same iteration count")
    if f64:
        # Both f64: the runs differ only in summation order and FMA
        # contraction, ~1e-16 per operation.
        d = np.abs(gpu.u_fine - cpu.u_fine).max() / np.abs(cpu.u_fine).max()
        say(f"{name}: max|u_gpu - u_cpu| / max|u_cpu| = {d:.3e}")
        check(d <= 1e-10, f"{name}: u within 1e-10 relative of the CPU run")
    else:
        # f32 recurrences in another summation order: 1e-4 relative per
        # entry, plus 16 eps32 absolute.  The history is relative to
        # ||b||, and each f32 update r -= alpha A p leaves roundoff of a few
        # eps32 ||b|| in r, which dominates the entries within a few
        # decades of eps32 (observed: 1.7e-7 at an entry of 1.1e-4).
        d = np.abs(gpu.rnorm - cpu.rnorm)
        bound = 1e-4 * np.abs(cpu.rnorm) + 16 * np.finfo(np.float32).eps
        say(f"{name}: history gpu {np.array2string(gpu.rnorm, precision=6)}"
            f" cpu {np.array2string(cpu.rnorm, precision=6)}")
        check(bool(np.all(d <= bound)),
              f"{name}: residual histories within 1e-4 relative + eps32")

    a = host_operator(cfg)
    b = host_rhs(cfg).ravel()
    u_star = spla.spsolve(a.tocsc(), b)
    lam_min = abs(float(spla.eigsh(-a, k=1, sigma=0, which="LM",
                                   return_eigenvectors=False)[0]))
    # ||u - u*|| <= ||A^-1|| ||b - A u||, and the solve stops at
    # ||b - A u|| <= rtol ||b|| (x2 for the drift of an f32 recurrence
    # from the true residual).
    allowed = 2.0 * cfg.rtol * np.linalg.norm(b) / lam_min
    for tag, res in (("gpu", gpu), ("cpu", cpu)):
        err = np.linalg.norm(res.u_fine.ravel() - u_star)
        say(f"{name}: ||u_{tag} - u_direct|| = {err:.3e} "
            f"(allowed by rtol: {allowed:.3e})")
        check(err <= allowed, f"{name}: {tag} solve within rtol of the "
                              f"host direct solve")


def coarse_no_tf32() -> None:
    """The direct coarse solve at 4096 unknowns in f32 against the host
    f64 inverse: TF32 keeps ~3 digits and would miss 1e-5 by far."""
    from multigrid_petsc_tpu.problems import stencil_coefficients
    from multigrid_petsc_tpu.solvers.coarse import (
        build_direct_solver,
        dense_from_stencil,
    )

    n = 64
    st = stencil_coefficients(MeshType.UNIFORM, n, n, jnp.float32)
    a = dense_from_stencil(st, n, n)
    solver = build_direct_solver(None, [(n, n)], jnp.float32, stencils=[st])
    b = np.random.default_rng(0).standard_normal((n, n))
    got = np.asarray(jax.jit(solver)((jnp.asarray(b, jnp.float32),))[0])
    ref = np.linalg.solve(a, b.ravel()).reshape(n, n)
    d = np.abs(got - ref).max() / np.abs(ref).max()
    say(f"coarse solve f32 vs host f64 inverse: rel max err {d:.3e}")
    check(d <= 1e-5, "coarse solve free of TF32")


def phase_parity() -> None:
    for name, cfg, f64 in (
        ("129^2 mg-CG f64", SolverConfig(npts=129, grids=4, levels=4,
                                         cycle=CycleType.MGCG), True),
        ("129^2 mg-CG f32", SolverConfig(npts=129, grids=4, levels=4,
                                         cycle=CycleType.MGCG,
                                         dtype="float32", rtol=1e-5), False),
        ("poisson.in 17^2 V(3,3)", SolverConfig(npts=17, grids=2, levels=2,
                                                cycle=CycleType.VCYCLE,
                                                v=(3, 3)), True),
    ):
        parity_case(name, cfg, f64)
    coarse_no_tf32()

    # The CLI on the reference's poisson.in configuration.
    from multigrid_petsc_tpu import poisson

    outdir = os.path.join("results", "cli_17")
    os.makedirs(outdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(outdir)
    try:
        rc = poisson.main(["-npts", "17", "-grids", "2", "-levels", "2",
                           "-cycle", "0", "-v", "3,3"])
    finally:
        os.chdir(cwd)
    check(rc == 0 and all(
        os.path.exists(os.path.join(outdir, f))
        for f in ("uData.dat", "rData.dat", "eData.dat")),
        "CLI -npts 17 -grids 2 -levels 2 -cycle 0 -v 3,3")


# ---------------------------------------------------------------------------
# Phase 3: the headline solve
# ---------------------------------------------------------------------------


def run_headline(cfg: SolverConfig, expect_path: str):
    res = solve(cfg, timed=True)
    ms_solve = time_ms(res.compiled, *res.args, reps=5)
    say(f"{cfg.npts}^2 mg-CG backend={cfg.backend}: path={res.path} "
        f"iters={res.iters} converged={res.converged} "
        f"compile={res.phases['compile']:.2f} s "
        f"solve={ms_solve:.3f} ms "
        f"({ms_solve / max(res.iters, 1):.3f} ms per outer iteration, "
        f"setup V-cycle included)")
    check(res.converged, f"{cfg.npts}^2 solve converged")
    check(res.path == expect_path, f"path is {expect_path!r}")
    return res, ms_solve


def phase_headline(cfg: SolverConfig, expect_path: str):
    res, _ = run_headline(cfg, expect_path)
    say(f"memory_analysis: {res.compiled.memory_analysis()}")
    # What an f32 solve can reach at this size: the rounding of u to f32 is
    # white noise that A amplifies by ~8/h^2, so the f64 true residual of
    # ANY f32 vector floors near eps32 (8/h^2) ||u|| / ||b||; and the f32
    # matvec cancels terms ~2^26 times larger than its result, which
    # bounds the error to the same f32 floor, not to rtol.
    n = cfg.npts - 2
    floor = np.finfo(np.float32).eps * 8 * (n + 1) ** 2 / (2 * np.pi ** 2)
    err32 = rel_error(cfg, res.u_fine)
    say(f"f32 solve, f64 on the host: true relative residual "
        f"{true_residual(cfg, res.u_fine):.3e} (storage floor ~{floor:.1e}),"
        f" relative error against the analytic solution {err32:.3e}")

    # The f64 check of the same solve: the f64 outer PCG around the same
    # f32 V-cycle (CUDA smoother levels included), same rtol.
    mcfg = dataclasses.replace(cfg, outer_dtype="float64")
    mixed = solve(mcfg, timed=True)
    ms = time_ms(mixed.compiled, *mixed.args, reps=3)
    rel = true_residual(mcfg, mixed.u_fine)
    err = rel_error(mcfg, mixed.u_fine)
    say(f"{cfg.npts}^2 f64-outer mg-CG: path={mixed.path} "
        f"iters={mixed.iters} solve={ms:.3f} ms; f64 true relative "
        f"residual on the host {rel:.3e}, relative error {err:.3e}")
    check(mixed.converged and mixed.path == expect_path,
          f"f64-outer solve converged on {expect_path!r}")
    # rtol 1e-5 plus slack for the drift of the CG recurrence from the
    # true residual.
    check(rel <= 2e-5, "f64 true relative residual <= 2e-5")
    return res, err32


# ---------------------------------------------------------------------------
# Phase 4: the CUDA smoother decision
# ---------------------------------------------------------------------------


def phase_kernel(res_kernel, err32: float) -> None:
    from benchmarks.baseline_configs import measured_bandwidth_info
    from multigrid_petsc_tpu.solvers.context import build_context

    cfg = dataclasses.replace(res_kernel.ctx.config, backend="xla")
    lvl_k = res_kernel.ctx.levels[0]
    lvl_x = build_context(cfg).levels[0]
    check(lvl_k.cuda_smoother and not lvl_x.cuda_smoother,
          "fine level: kernel under auto, plain under xla")
    ny, nx = lvl_k.spec.primary.shape
    b = (jax.random.normal(jax.random.PRNGKey(1), (ny, nx), jnp.float32),)
    u = (jax.random.normal(jax.random.PRNGKey(2), (ny, nx), jnp.float32),)
    k = cfg.v[0]
    arr = ny * nx * 4
    bw = measured_bandwidth_info(ny)
    say(f"copy rate (triad, read+write) {bw['bytes_per_s'] / 1e9:.1f} GB/s "
        f"samples {bw['samples_GBps']}")
    for tag, lvl, bytes_per_sweep in (
            ("plain", lvl_x, 3 * arr),        # reads u, b; writes u
            ("kernel", lvl_k, 3 * arr / k)):  # once for all k sweeps
        smooth = jax.jit(lambda b, u, _l=lvl: _l.smooth(b, u, k))
        down = jax.jit(lambda b, _l=lvl: _l.visit_down(b, None, k))
        ms_s = time_ms(smooth, b, u, reps=20)
        ms_d = time_ms(down, b, reps=20)
        say(f"fine level {ny}x{nx} {tag}: {k} sweeps {ms_s:.3f} ms "
            f"({ms_s / k:.3f} ms/sweep, {bytes_per_sweep / 1e6:.0f} MB/sweep "
            f"modelled, {3 * arr / ms_s / 1e6:.0f} GB/s of u,b,u'); "
            f"zero-guess down visit {ms_d:.3f} ms")

    res_plain = solve(cfg, timed=True)
    check(res_plain.path == "generic" and res_plain.converged
          and res_plain.iters == res_kernel.iters,
          "plain solve converged on 'generic' in as many iterations")
    # Kernel and plain path run the same f32 algorithm in another
    # summation order: they may differ by as much as either differs from
    # the exact solution (the f32 floor), no more.
    d = (np.linalg.norm(res_kernel.u_fine - res_plain.u_fine)
         / np.linalg.norm(res_plain.u_fine))
    say(f"||u_kernel - u_plain|| / ||u_plain|| = {d:.3e} (f32 error of the "
        f"solve: {err32:.3e})")
    check(d <= err32, "kernel and plain solutions agree within the f32 "
                      "error of the solve")
    runs = {"plain": res_plain, "kernel": res_kernel}
    turns = []
    for tag in ("plain", "kernel", "kernel", "plain"):
        r = runs[tag]
        ms = time_ms(r.compiled, *r.args, reps=5)
        turns.append((tag, ms))
        say(f"whole solve {tag}: {ms:.3f} ms, {r.iters} iterations, "
            f"{ms / r.iters:.3f} ms/iteration")
    p = [ms for t, ms in turns if t == "plain"]
    q = [ms for t, ms in turns if t == "kernel"]
    say(f"decision: kernel {np.mean(q):.3f} ms vs plain {np.mean(p):.3f} ms "
        f"per solve -> {'kernel faster' if max(q) < min(p) else 'NOT faster'}")


# ---------------------------------------------------------------------------
# Phase 5: 1e-8 certification
# ---------------------------------------------------------------------------


def phase_certify() -> None:
    base = headline(npts=1025, levels=8)
    out = {}
    for odt in ("float64", "float32x2"):
        cfg = dataclasses.replace(base, outer_dtype=odt, rtol=1e-8)
        res = solve(cfg, timed=True)
        rel = true_residual(cfg, res.u_fine)
        out[odt] = rel
        say(f"1025^2 outer_dtype={odt}: iters={res.iters} "
            f"converged={res.converged} recursion rnorm={res.rnorm[-1]:.3e} "
            f"true f64 residual={rel:.3e} wall={1e3 * res.wall_time:.3f} ms")
        check(res.converged, f"{odt} outer converged to 1e-8")
        # The outer's own f64 (or double-single) recursion stops at 1e-8;
        # its true residual may sit a few f64/2^-47 roundoffs above.
        check(rel <= 1.1e-8, f"{odt} true residual <= 1.1e-8")
    say(f"float32x2 vs float64 final true residual: {out['float32x2']:.3e} "
        f"vs {out['float64']:.3e}")


def phase_gpu_tests() -> None:
    import pytest

    os.environ["MG_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu", "tests"])
    check(rc == 0, "tests marked gpu")


# ---------------------------------------------------------------------------
# Phase 7 (--multi): block and row plans over four cards
# ---------------------------------------------------------------------------


def phase_multi(npts: int = 8193, levels: int = 11, n: int = 4) -> None:
    from multigrid_petsc_tpu.parallel.device_mesh import (
        ShardingPlan,
        make_device_mesh,
        row_plan,
    )

    devices = jax.devices()[:n]
    check(len(devices) == n, f"{n} devices")
    # The sharded levels run the plain operators (the CUDA smoother is a
    # one-device kernel), so the single-card reference runs them too.
    cfg = headline(npts, levels, backend="xla")
    ref = solve(cfg, timed=True)
    say(f"single card: iters={ref.iters} path={ref.path} "
        f"solve={time_ms(ref.compiled, *ref.args, reps=3):.3f} ms")
    scale = float(np.abs(ref.u_fine).max())
    for name, plan in (
            ("blocks 2x2", ShardingPlan(make_device_mesh(devices=devices,
                                                         shape=(2, 2)))),
            (f"rows {n}x1", row_plan(devices=devices))):
        res = solve(cfg, plan=plan, timed=True)
        d = float(np.abs(res.u_fine - ref.u_fine).max())
        say(f"{name}: iters={res.iters} path={res.path} "
            f"solve={time_ms(res.compiled, *res.args, reps=3):.3f} ms "
            f"max|du|={d:.3e} (max|u|={scale:.3e})")
        say(f"{name}: b0 sharding {res.ctx.b0[0].sharding}")
        say(f"{name}: level specs "
            f"{[tuple(l.shardings[0].spec) for l in res.ctx.levels]}")
        say(f"{name}: output shardings {res.compiled.output_shardings}")
        check(res.converged and res.iters == ref.iters,
              f"{name}: same iteration count as one card")
        # Both stop at ||b - A u|| <= rtol ||b||: they differ by at most
        # 2 rtol ||A^-1|| ||b|| (~2e-5 of ||u|| here); 1e-4 of max|u|
        # leaves room for the max norm and f32 summation order.
        check(d <= 1e-4 * scale, f"{name}: max|du| <= 1e-4 max|u|")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the block and row plans vs one card")
    args = ap.parse_args(argv)

    rep = runtime.device_report()
    CARD = rep["card"]
    for k, v in rep.items():
        say(f"{k}: {v}")
    if args.multi:
        phase_multi()
    else:
        phase_parity()
        res, err32 = phase_headline(headline(), expect_path="cuda")
        phase_kernel(res, err32)
        phase_certify()
        phase_gpu_tests()
    print(f"card: {CARD}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": rep["platform"], "kind": rep["kind"],
        "count": rep["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
