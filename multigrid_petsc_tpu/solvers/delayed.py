"""Delayed cycles D1, D2, D1PS on a single composite level.

Capability parity with the reference (restricted to levels == 1, enforced
at src/poisson.c:61-65):
  * the level matrix is the grid-DIAGONAL composite A1 only
    (src/solver.c:1167-1168 assembles levelMatrixA1 for delayed cycles);
  * "delayed" restriction feeds each bottom grid g >= 1 the single-gap
    full-weighting restriction of the residual on grid g-1
    (src/solver.c:879-953 Res_delayed: row grid g, source grid g-1);
  * "delayed" prolongation corrects each top grid g <= G-2 with the
    single-gap bilinear prolongation of u on grid g+1
    (src/solver.c:955-1033 Pro_delayed);
  * the residual used by the transfers is the one computed at the END of
    the previous outer iteration — deliberately stale, that is the
    "delay" (src/solver.c:2562-2571: bBot/rTop views of the carried r).

Per-iteration orders (v = v[0] smoothing sweeps on the whole composite):
  D1   (src/solver.c:2562-2571): restrict, prolong-correct, smooth
  D2   (src/solver.c:2252-2261): restrict, smooth, prolong-correct
  D1PS (src/solver.c:2407-2417): prolong-correct, smooth, restrict, smooth
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from multigrid_petsc_tpu.ops.norms import tree_norm2, vdot
from multigrid_petsc_tpu.ops.transfer import prolong_bilinear, restrict_fw
from multigrid_petsc_tpu.solvers.context import MGContext, State
from multigrid_petsc_tpu.solvers.outer import OuterResult
from multigrid_petsc_tpu.solvers.cycles import _diag_smoother
from multigrid_petsc_tpu.utils.config import CycleType


def _restrict_delayed(b: State, r: State) -> State:
    """New RHS: b[0] kept (f on the finest grid), bottom grids get the
    single-gap restriction of the stale residual on the next-finer grid."""
    return (b[0],) + tuple(restrict_fw(r[g - 1]) for g in range(1, len(r)))

def _prolong_correct(u: State) -> State:
    """Top grids get corrected by the single-gap prolongation of the
    next-coarser grid's current iterate; the last grid is untouched."""
    G = len(u)
    return tuple(
        u[g] + prolong_bilinear(u[g + 1]) if g < G - 1 else u[g]
        for g in range(G)
    )


def solve_delayed(ctx: MGContext, kind: CycleType, b0: State | None = None) -> OuterResult:
    cfg = ctx.config
    assert len(ctx.levels) == 1, "delayed cycles require levels == 1"
    lvl = ctx.levels[0]
    G = len(lvl.spec.grids)
    assert G >= 2, "delayed cycles need at least 2 merged grids"
    v = cfg.v[0]
    smooth = _diag_smoother(ctx, lvl)

    def residual_diag(b, u):
        a1u = lvl.apply_diag(u)
        return tuple(bk - ak for bk, ak in zip(b, a1u))

    b0 = ctx.b0 if b0 is None else b0
    bnorm = tree_norm2(b0)
    u = lvl.zeros(ctx.dtype)
    r = residual_diag(b0, u)
    rn0 = tree_norm2(r)
    hist_len = cfg.hist_len
    hist = jnp.zeros(hist_len + 1, dtype=rn0.dtype).at[0].set(rn0)

    # moreNorm monitors (reference: src/solver.c:1382-1399 rNormGridMonitor
    # + KSPSetResidualHistory at src/solver.c:2534-2536): per inner-sweep
    # global and per-grid residual 2-norms, (v+1) entries per outer
    # iteration, recorded for the first smooth of each outer iteration
    # (matching the reference's rNormGlobal/rNormGrid array sizing of
    # max_iter*(v+1)).  Requires the Jacobi diag smoother so "one inner
    # iteration" is well defined.
    more = cfg.more_norm
    mon_len = min(cfg.max_iter, hist_len) * (v + 1)
    r_global = jnp.zeros(mon_len, dtype=rn0.dtype) if more else None
    r_grid = jnp.zeros((G, mon_len), dtype=rn0.dtype) if more else None

    def smooth_monitored(b, u, base, r_global, r_grid):
        from multigrid_petsc_tpu.solvers import smoothers as smod

        def sweep_body(s, carry):
            u, r_global, r_grid = carry
            rr = residual_diag(b, u)
            idx = jnp.minimum(base + s, mon_len - 1)
            r_global = r_global.at[idx].set(tree_norm2(rr))
            for g in range(G):
                r_grid = r_grid.at[g, idx].set(
                    jnp.sqrt(vdot(rr[g], rr[g]).real)
                )
            u = jax.lax.cond(
                s < v,
                lambda u: smod.jacobi(
                    lvl.apply_diag, lvl.dinv, b, u, 1, cfg.omega
                ),
                lambda u: u,
                u,
            )
            return (u, r_global, r_grid)

        return jax.lax.fori_loop(
            0, v + 1, sweep_body, (u, r_global, r_grid)
        )

    def do_smooth(b, u, i, r_global, r_grid, record):
        if more and record:
            return smooth_monitored(b, u, i * (v + 1), r_global, r_grid)
        return smooth(b, u, v), r_global, r_grid

    def body(carry):
        u, r, b, i, rn, hist, r_global, r_grid = carry
        if kind == CycleType.D1CYCLE:
            b = _restrict_delayed(b, r)
            u = _prolong_correct(u)
            u, r_global, r_grid = do_smooth(b, u, i, r_global, r_grid, True)
        elif kind == CycleType.D2CYCLE:
            b = _restrict_delayed(b, r)
            u, r_global, r_grid = do_smooth(b, u, i, r_global, r_grid, True)
            u = _prolong_correct(u)
        elif kind == CycleType.D1PSCYCLE:
            u = _prolong_correct(u)
            u, r_global, r_grid = do_smooth(b, u, i, r_global, r_grid, True)
            b = _restrict_delayed(b, r)
            u, r_global, r_grid = do_smooth(b, u, i, r_global, r_grid, False)
        else:  # pragma: no cover
            raise ValueError(kind)
        r = residual_diag(b, u)
        rn = tree_norm2(r)
        hist = hist.at[jnp.minimum(i + 1, hist_len)].set(rn)
        return (u, r, b, i + 1, rn, hist, r_global, r_grid)

    def cond(carry):
        u, r, b, i, rn, hist, r_global, r_grid = carry
        return (
            (i < cfg.max_iter)
            & (cfg.divtol * bnorm > rn)
            & (rn > cfg.rtol * bnorm)
        )

    u, r, b, iters, rn, hist, r_global, r_grid = jax.lax.while_loop(
        cond, body, (u, r, b0, 0, rn0, hist, r_global, r_grid)
    )
    aux = None
    if more:
        # Normalized by the first entry, like the reference
        # (src/solver.c:2593-2603).
        aux = {
            "r_global": r_global / r_global[0],
            "r_grid": r_grid / r_grid[:, :1],
        }
    return OuterResult(
        u=u,
        rnorm_history=hist / hist[0],
        iters=iters,
        converged=rn <= cfg.rtol * bnorm,
        aux=aux,
    )
