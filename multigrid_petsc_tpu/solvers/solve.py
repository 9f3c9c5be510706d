"""Solve dispatch: config -> cycle driver -> result.

Capability parity with the reference dispatch (reference:
src/solver.c:2617-2630 Solve maps the Cycle enum to its 9 drivers), plus
the framework's Krylov/FMG extensions.  Also carries the reference's
post-solve bookkeeping: wall/CPU timing around the solve only
(src/solver.c:1526-1553) and the residual history normalized by its first
entry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import numpy as np

from multigrid_petsc_tpu.solvers.context import MGContext, build_context
from multigrid_petsc_tpu.solvers.outer import OuterResult
from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig


@dataclass
class SolveResult:
    u: tuple  # final level-0 state (tuple of per-grid arrays)
    rnorm: np.ndarray  # normalized residual history, entries 0..iters
    iters: int
    converged: bool
    wall_time: float  # solve-loop wall seconds (compile excluded)
    cpu_time: float
    ctx: MGContext
    aux: dict | None = None  # moreNorm monitor arrays etc.
    phases: dict | None = None  # per-phase wall seconds (compile/solve)
    path: str = "generic"  # MGContext.path
    # The AOT-compiled solve and its arguments: ``compiled(*args)`` re-runs
    # the same solve (timing, memory_analysis()).
    compiled: object | None = None
    args: tuple = ()

    @property
    def u_fine(self) -> np.ndarray:
        """Solution on the finest grid (interior points)."""
        return np.asarray(self.u[0])


_DRIVERS = {}


def _driver(ctx: MGContext, u0_mixed=None):
    # Imported here to avoid import cycles.
    from multigrid_petsc_tpu.solvers import cycles as cy
    from multigrid_petsc_tpu.solvers import delayed as dl
    from multigrid_petsc_tpu.solvers import krylov as kr
    from multigrid_petsc_tpu.solvers import vcycle as vc

    c = ctx.config.cycle
    # Every driver takes the RHS as an explicit argument so it enters the
    # jitted computation as a parameter, NOT a baked-in HLO constant
    # (large constants bloat executables at production grid sizes).
    if c == CycleType.VCYCLE:
        return lambda b0: vc.solve_vcycle(ctx, b0)
    if c == CycleType.PCMG:
        return lambda b0: vc.solve_mg_richardson(ctx, b0)
    if c == CycleType.FMG:
        return lambda b0: vc.solve_fmg(ctx, b0)
    if c == CycleType.MGCG:
        if ctx.config.outer_dtype is not None:
            if u0_mixed is not None:
                # Warm start rides as a traced ARGUMENT, not a
                # production-size HLO constant.
                return lambda b0, u0: kr.solve_mgcg_mixed(ctx, b0, u0=u0)
            return lambda b0: kr.solve_mgcg_mixed(ctx, b0)
        return lambda b0: kr.solve_mgcg(ctx, b0)
    if c == CycleType.MGFGMRES:
        return lambda b0: kr.solve_mgfgmres(ctx, b0)
    if c == CycleType.ICYCLE:
        return lambda b0: cy.solve_icycle(ctx, b0)
    if c == CycleType.ECYCLE:
        return lambda b0: cy.solve_ecycle(ctx, b0)
    if c == CycleType.ADDITIVE:
        return lambda b0: cy.solve_additive(ctx, b0)
    if c == CycleType.ADDITIVE2:
        return lambda b0: cy.solve_additive2(ctx, b0)
    if c in (CycleType.D1CYCLE, CycleType.D2CYCLE, CycleType.D1PSCYCLE):
        return lambda b0: dl.solve_delayed(ctx, c, b0)
    raise ValueError(f"unknown cycle {c}")


def solve(
    cfg: SolverConfig,
    problem=None,
    ctx: MGContext | None = None,
    plan=None,
    u0=None,
    timed: bool = False,
    profile_phases: bool = False,
) -> SolveResult:
    """Set up (unless given a prebuilt context) and run the configured
    solver.  ``plan`` (a parallel.ShardingPlan) enables the distributed
    path.

    By default the solve runs ONCE; ``wall_time``/``cpu_time`` then bracket
    that single execution (compile time excluded — the driver is jitted and
    lowered/compiled explicitly first).  ``timed=True`` additionally re-runs
    the already-compiled solve and reports the re-run's timing — the
    benchmark path mirroring the reference's solver-stage timers
    (src/solver.c:1526-1553), opt-in so production-size runs pay once.

    ``u0`` warm-starts the solve (checkpoint resume): by linearity the
    driver solves A e = b - A u0 from zero and u0 is added back — no
    driver needs to know.
    """
    cfg = cfg.validate()
    if ctx is None:
        ctx = build_context(cfg, problem, plan=plan)

    mixed = cfg.outer_dtype is not None and cfg.cycle == CycleType.MGCG
    b_in = ctx.b0
    if mixed:
        # Mixed-precision outer: evaluate the RHS directly in the outer
        # dtype (see solve_mgcg_mixed).
        import jax.numpy as jnp

        from multigrid_petsc_tpu.mesh import MeshType

        g0 = ctx.levels[0].spec.primary
        # float32x2 (double-single) outer: the RHS is evaluated in f64 and
        # split exactly inside the driver (ops/twofloat.from_f64).
        odt = jnp.dtype(
            "float64" if cfg.outer_dtype == "float32x2" else cfg.outer_dtype
        )
        if cfg.problem == "aniso":
            from multigrid_petsc_tpu.problems import aniso_rhs_grid

            b_in = (aniso_rhs_grid(ctx.problem, g0.ny, g0.nx, odt),)
        else:
            from multigrid_petsc_tpu.problems import rhs_grid

            b_in = (
                rhs_grid(ctx.problem, MeshType(cfg.mesh), g0.ny, g0.nx, odt),
            )

    u0_mixed = None
    if u0 is not None:
        import dataclasses

        import jax.numpy as jnp

        from multigrid_petsc_tpu.ops.norms import tree_norm2

        if mixed:
            # The defect-correction outer is already a correction solve:
            # warm-start it directly (it recomputes its own first residual
            # in the outer dtype).
            wdt = (
                "float64" if cfg.outer_dtype == "float32x2"
                else cfg.outer_dtype
            )
            u0_mixed = tuple(jnp.asarray(x, wdt) for x in u0)
            u0 = None
        else:
            u0 = tuple(jnp.asarray(x, ctx.dtype) for x in u0)
            bn_orig = float(tree_norm2(b_in))
            b_in = jax.jit(ctx.levels[0].residual)(b_in, u0)
            bn_new = float(tree_norm2(b_in))
            # The driver solves the correction system A e = b - A u0; keep
            # the stopping target equivalent to rtol * ||b_original||.
            eff_rtol = min(1.0, cfg.rtol * bn_orig / max(bn_new, 1e-300))
            cfg = dataclasses.replace(cfg, rtol=eff_rtol)
            ctx = dataclasses.replace(ctx, config=cfg)

    run = jax.jit(_driver(ctx, u0_mixed=u0_mixed))
    args = (b_in,) if u0_mixed is None else (b_in, u0_mixed)
    t0 = time.perf_counter()
    compiled = run.lower(*args).compile()
    t_compile = time.perf_counter() - t0

    t0w, t0c = time.perf_counter(), time.process_time()
    res: OuterResult = jax.block_until_ready(compiled(*args))
    t1w, t1c = time.perf_counter(), time.process_time()
    iters = int(res.iters)

    if timed:
        # Benchmark path: re-run the compiled solve so the reported timing
        # excludes any first-execution overhead (state-free drivers:
        # rerunning reproduces the same solve).
        t0w, t0c = time.perf_counter(), time.process_time()
        res = jax.block_until_ready(compiled(*args))
        t1w, t1c = time.perf_counter(), time.process_time()
        iters = int(res.iters)

    hist = np.asarray(res.rnorm_history)[: iters + 1]
    aux = None
    if res.aux is not None:
        # Truncate monitor arrays to the iterations actually run: the
        # delayed cycles record (v+1) inner entries per outer iteration
        # (src/solver.c:2534-2536 sizing), the I/E monitors one entry per
        # outer iteration incl. the initial state.
        if cfg.cycle in (
            CycleType.D1CYCLE, CycleType.D2CYCLE, CycleType.D1PSCYCLE
        ):
            n_inner = iters * (cfg.v[0] + 1)
        else:
            n_inner = iters + 1
        aux = {
            "r_global": np.asarray(res.aux["r_global"])[:n_inner],
            "r_grid": np.asarray(res.aux["r_grid"])[:, :n_inner],
        }
    phases = {"compile": t_compile, "solve": t1w - t0w}
    if profile_phases:
        # Per-phase building-block breakdown — the -log_view analogue
        # (reference: src/solver.c:1528-1551 PetscLogStage "Solver").
        from multigrid_petsc_tpu.utils.profiling import phase_breakdown

        phases.update(phase_breakdown(ctx))

    u_out = res.u
    if u0 is not None:
        u_out = tuple(a + b for a, b in zip(u_out, u0))
    return SolveResult(
        u=tuple(np.asarray(x) for x in u_out),
        rnorm=hist,
        iters=iters,
        converged=bool(res.converged),
        wall_time=t1w - t0w,
        cpu_time=t1c - t0c,
        ctx=ctx,
        aux=aux,
        phases=phases,
        path=ctx.path,
        compiled=compiled,
        args=args,
    )
