"""Multiplicative V-cycle and FMG drivers.

Capability parity with the reference V-cycle (reference:
src/solver.c:1414-1575 MultigridVcycle): per outer iteration
  * pre-smooth v0 sweeps on the fine level (continuing from current u),
  * down-leg: residual -> restrict -> smooth with zero initial guess
    (v0 sweeps on mid levels, v1 on the coarsest; src/solver.c:1533-1538),
  * up-leg: prolong + correct + post-smooth v0 sweeps
    (src/solver.c:1539-1544),
with the stopping rule and history handled by ``outer_iterate``.

The level recursion unrolls at trace time (static level count), every
operator is matrix-free, and the whole solve is one jitted lax.while_loop.
"""

from __future__ import annotations

import jax.numpy as jnp

from multigrid_petsc_tpu.solvers.context import MGContext, State
from multigrid_petsc_tpu.solvers.outer import OuterResult, outer_iterate


def v_cycle(
    ctx: MGContext, b0: State, u0: State | None, v0: int, v1: int,
    emit_r: bool = False,
):
    """One V-cycle starting/ending on level 0.

    With ``emit_r`` the level-0 post-smoother also returns the final
    residual b - A u, which the outer loop's convergence norm reuses.

    Each level visit runs through LevelCtx.visit_down / visit_up: the
    smoother plus residual and first restriction gap (down), and the last
    prolongation gap plus correction and smoother (up).  On CUDA-smoother
    levels the sweeps and residual of a visit are one kernel.

    ``u0=None`` means zero initial guess (every preconditioner
    application, and every down-leg level below the finest): the CUDA
    smoother then never reads an initial u.
    """
    return _cycle(ctx, 0, b0, u0, v0, v1, emit_r)


def _visit_sweeps(ctx, l: int, v0: int, v1: int) -> int:
    """Sweep count for level ``l``'s visits: per-level override
    (cfg.level_v, the reference's per-tier -v capability) when configured,
    else the caller-passed (v0 fine/mid, v1 coarsest) rule."""
    lv = getattr(getattr(ctx, "config", None), "level_v", None)
    L = len(ctx.levels)
    if lv is not None:
        return int(lv[l])
    return v1 if (l == L - 1 and L > 1) else v0


def _cycle(ctx, l: int, b: State, u: State | None, v0: int, v1: int,
           emit: bool):
    """The V-cycle recursion from level ``l`` down."""
    L = len(ctx.levels)
    lvl = ctx.levels[l]
    k = _visit_sweeps(ctx, l, v0, v1)
    if l == L - 1:
        if L > 1 and lvl.coarse_solve is not None:
            u = lvl.constrain(lvl.coarse_solve(b))
        else:
            if u is None:
                u = lvl.zeros(b[0].dtype)
            u = lvl.smooth(b, u, k)
        return (u, lvl.residual(b, u)) if emit else u
    u, rc1 = lvl.visit_down(b, u, k)
    b_next = ctx.restrict_rc1(l, rc1)
    u_next = _cycle(ctx, l + 1, b_next, None, v0, v1, False)
    e_c = ctx.prolong_half(l, u_next)
    return lvl.visit_up(b, u, e_c, k, emit)


def mg_apply(ctx: MGContext, r: State, v0: int, v1: int) -> State:
    """M r: one V-cycle with zero initial guess — the linear MG
    preconditioner used by the Krylov outer loops and the PCMG-equivalent
    Richardson driver."""
    return v_cycle(ctx, r, None, v0, v1)


def solve_vcycle(ctx: MGContext, b0: State | None = None) -> OuterResult:
    cfg = ctx.config
    v0, v1 = cfg.v

    def step(b, u):
        return v_cycle(ctx, b, u, v0, v1, emit_r=True)

    u0 = ctx.levels[0].zeros(ctx.dtype)
    return outer_iterate(
        step,
        ctx.levels[0].residual,
        ctx.b0 if b0 is None else b0,
        u0,
        cfg.max_iter,
        cfg.rtol,
        cfg.divtol,
        cfg.hist_len,
        step_emits_residual=True,
    )


def solve_mg_richardson(ctx: MGContext, b0: State | None = None) -> OuterResult:
    """MG-preconditioned Richardson: u += M (b - A u).

    The framework's equivalent of the reference's PETSc-PCMG cross-check
    path (src/solver.c:1884-1989: Richardson KSP with PCMG preconditioner).
    For linear smoothers this is algebraically identical to plain V-cycle
    iteration — kept as a separate driver precisely so the two can be
    differentially tested against each other (SURVEY.md section 4 item 3).
    """
    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]

    def step(b, u):
        r = lvl0.residual(b, u)
        z = mg_apply(ctx, r, v0, v1)
        return tuple(uk + zk for uk, zk in zip(u, z))

    u0 = lvl0.zeros(ctx.dtype)
    return outer_iterate(
        step, lvl0.residual, ctx.b0 if b0 is None else b0, u0,
        cfg.max_iter, cfg.rtol, cfg.divtol, cfg.hist_len,
    )


def fmg_initial_guess(ctx: MGContext, b0: State | None = None, n_coarse_cycles: int = 1) -> State:
    """Full-multigrid start: restrict the RHS to every level, solve upward
    from the coarsest with one V-cycle per level, prolonging between levels.

    No reference equivalent (extension; BASELINE.md config 5 requires an
    FMG start).  Only supports 1-grid-per-level hierarchies for the
    intermediate levels (same constraint as the reference's std-MG path,
    src/solver.c:1042-1047).
    """
    cfg = ctx.config
    v0, v1 = cfg.v
    L = len(ctx.levels)
    dtype = ctx.dtype

    # Restrict the primary-grid RHS down the hierarchy.
    bs: list[State] = [ctx.b0 if b0 is None else b0]
    for l in range(L - 1):
        bs.append(ctx.restrict_to_next(l, bs[l][0]))

    # Coarsest: real solve if available, else smooth from zero.
    last = ctx.levels[L - 1]
    if L > 1 and last.coarse_solve is not None:
        u = last.constrain(last.coarse_solve(bs[L - 1]))
    else:
        u = last.smooth(bs[L - 1], last.zeros(dtype),
                        _visit_sweeps(ctx, L - 1, v0, v1))
    for l in range(L - 2, -1, -1):
        u = (ctx.prolong_from_next(l, u),) + tuple(
            jnp.zeros(g.shape, dtype) for g in ctx.levels[l].spec.grids[1:]
        )
        # One (or more) V-cycles at this depth using the truncated hierarchy.
        sub = _TruncatedCtx(ctx, l)
        for _ in range(n_coarse_cycles):
            u = v_cycle(sub, bs[l], u, v0, v1)
    return u


class _TruncatedCtx:
    """View of an MGContext starting at level ``start`` (for FMG).
    Duck-types the subset of MGContext that ``v_cycle`` uses."""

    def __init__(self, ctx: MGContext, start: int):
        import dataclasses

        self._ctx = ctx
        self._start = start
        self.levels = ctx.levels[start:]
        self.dtype = ctx.dtype
        # Per-level sweep overrides shift with the truncation.
        lv = ctx.config.level_v
        self.config = (
            ctx.config if lv is None
            else dataclasses.replace(ctx.config, level_v=tuple(lv[start:]))
        )

    def restrict_to_next(self, l, r):
        return self._ctx.restrict_to_next(self._start + l, r)

    def prolong_from_next(self, l, u_next):
        return self._ctx.prolong_from_next(self._start + l, u_next)

    def restrict_rc1(self, l, rc1):
        return self._ctx.restrict_rc1(self._start + l, rc1)

    def prolong_half(self, l, u_next):
        return self._ctx.prolong_half(self._start + l, u_next)


def solve_fmg(ctx: MGContext, b0: State | None = None) -> OuterResult:
    """FMG start followed by standard V-cycle iteration to tolerance."""
    cfg = ctx.config
    v0, v1 = cfg.v

    def step(b, u):
        return v_cycle(ctx, b, u, v0, v1, emit_r=True)

    u0 = fmg_initial_guess(ctx, b0)
    return outer_iterate(
        step, ctx.levels[0].residual, ctx.b0 if b0 is None else b0, u0,
        cfg.max_iter, cfg.rtol, cfg.divtol, cfg.hist_len,
        step_emits_residual=True,
    )
