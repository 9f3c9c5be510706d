"""The non-V cycle zoo: I, E, Additive, Additive2 (delayed cycles live in
solvers/delayed.py).

Capability parity with the reference drivers:
  * I-cycle (src/solver.c:1991-2060): plain smoother iteration on the ONE
    composite system that already contains all inter-grid couplings inside
    its matrix — no explicit cycling.
  * E-cycle (src/solver.c:2062-2152): split composite A = A1 (grid-diagonal
    blocks) + A2 (couplings); iterate u <- Smooth_v(A1, b - A2 u); the
    convergence norm is ||b - A1 u|| exactly as the reference computes it
    (src/solver.c:2126-2128).
  * Additive (src/solver.c:1722-1882): BPX-flavored cycle using the filter
    F_l = P_l R_l (src/solver.c:1758-1761): each level smooths the filtered
    component restricted down and the complement in place, then corrections
    are summed on the way up.
  * Additive2 (src/solver.c:1577-1720): two-level additive cycle with a
    per-iteration step length lambda = <r0, r1>/<r0, r0>
    (src/solver.c:1674-1675).

All drivers are single jitted lax.while_loops with the shared stopping rule.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from multigrid_petsc_tpu.ops.norms import tree_dot, tree_norm2, vdot
from multigrid_petsc_tpu.solvers.context import MGContext, State
from multigrid_petsc_tpu.solvers.outer import OuterResult, outer_iterate


def _grid_monitor(ctx: MGContext, residual_fn, b: State):
    """moreNorm monitor for the merged-grid one-level cycles: per outer
    iteration record the global residual norm and the per-grid residual
    2-norms (the rNormGridMonitor analogue for I/E cycles — the reference
    wires KSPSetResidualHistory + monitors there,
    src/solver.c:2017-2018, 2225-2227; per-grid splitting via IS sub-views
    src/solver.c:1382-1399)."""
    cfg = ctx.config
    lvl = ctx.levels[0]
    G = len(lvl.spec.grids)
    length = min(cfg.max_iter, cfg.hist_len) + 1
    dtype = ctx.dtype
    aux0 = {
        "r_global": jnp.zeros(length, dtype),
        "r_grid": jnp.zeros((G, length), dtype),
    }

    def update(aux, i, u, rn):
        rr = residual_fn(b, u)
        idx = jnp.minimum(i, length - 1)
        r_global = aux["r_global"].at[idx].set(rn)
        r_grid = aux["r_grid"]
        for g in range(G):
            r_grid = r_grid.at[g, idx].set(
                jnp.sqrt(vdot(rr[g], rr[g]).real)
            )
        return {"r_global": r_global, "r_grid": r_grid}

    return aux0, update


def solve_icycle(ctx: MGContext, b0: State | None = None) -> OuterResult:
    """One smoother sweep per outer iteration on the full composite
    operator (couplings included in the matvec)."""
    cfg = ctx.config
    lvl = ctx.levels[0]
    b = ctx.b0 if b0 is None else b0

    def step(b, u):
        return lvl.smooth(b, u, 1)

    return outer_iterate(
        step, lvl.residual, b, lvl.zeros(ctx.dtype),
        cfg.max_iter, cfg.rtol, cfg.divtol, cfg.hist_len,
        monitor=_grid_monitor(ctx, lvl.residual, b) if cfg.more_norm else None,
    )


def solve_ecycle(ctx: MGContext, b0: State | None = None) -> OuterResult:
    """Block-Jacobi across grids: v sweeps on the diagonal blocks with the
    couplings moved to the right-hand side each outer iteration.

    Known property (shared with the reference, verified in
    tests/test_cycles.py::test_ecycle_plateau_identity): the driver's own
    convergence metric ||b - A1 u|| (src/solver.c:2126-2128) plateaus at
    ||R f||/||b|| because at the merged fixed point the coarse variables
    vanish while their RHS R f stays; the FINE-grid iterate still converges
    to the discrete solution.  This cycle therefore runs to max_iter under
    a tight rtol — exactly like the reference binary does."""
    cfg = ctx.config
    v0 = cfg.v[0]
    lvl = ctx.levels[0]
    sm = _diag_smoother(ctx, lvl)
    b = ctx.b0 if b0 is None else b0

    def step(b, u):
        a2u = lvl.apply_couplings(u)
        rhs = tuple(bk - ck for bk, ck in zip(b, a2u))
        return sm(rhs, u, v0)

    def residual_diag(b, u):
        a1u = lvl.apply_diag(u)
        return tuple(bk - ak for bk, ak in zip(b, a1u))

    return outer_iterate(
        step, residual_diag, b, lvl.zeros(ctx.dtype),
        cfg.max_iter, cfg.rtol, cfg.divtol, cfg.hist_len,
        monitor=_grid_monitor(ctx, residual_diag, b) if cfg.more_norm else None,
    )


def _diag_smoother(ctx: MGContext, lvl):
    """Smoother over the diagonal blocks only (A1)."""
    from multigrid_petsc_tpu.solvers import smoothers as smod
    from multigrid_petsc_tpu.utils.config import SmootherType

    cfg = ctx.config
    if cfg.smoother == SmootherType.CHEBYSHEV:
        shapes = [g.shape for g in lvl.spec.grids]
        lmax = float(
            smod.estimate_dinv_a_lmax(
                lvl.apply_diag, lvl.dinv, shapes, dtype=lvl.dinv[0].dtype
            )
        )

        def smooth(b, u, sweeps):
            return smod.chebyshev(lvl.apply_diag, lvl.dinv, b, u, sweeps, lmax)
    else:
        def smooth(b, u, sweeps):
            return smod.jacobi(lvl.apply_diag, lvl.dinv, b, u, sweeps, cfg.omega)
    return smooth


def solve_additive(ctx: MGContext, b0: State | None = None) -> OuterResult:
    """BPX-style additive cycle with the P*R filter (matrix-free)."""
    cfg = ctx.config
    v0, v1 = cfg.v
    L = len(ctx.levels)
    assert L >= 2, "Additive cycle requires levels >= 2 (src/solver.c:1754)"

    def filter_l(l: int, r):
        """F_l r = P_l (R_l r) (reference builds this with MatMatMult,
        src/solver.c:1758-1761)."""
        return ctx.prolong_from_next(l, ctx.restrict_to_next(l, r))

    def step(b0, u0):
        # Down: fine pre-smooth continues from current u (guess nonzero).
        us = [None] * L
        es = [None] * L
        bs = [None] * L
        bs[0] = b0
        us[0] = ctx.levels[0].smooth(b0, u0, v0)
        for l in range(L - 1):
            lvl = ctx.levels[l]
            r = lvl.residual(bs[l], us[l])[0]
            ef = filter_l(l, r)
            r_comp = ((r - ef),)
            bs[l + 1] = ctx.restrict_to_next(l, ef)
            es[l] = lvl.smooth(r_comp, lvl.zeros(r.dtype), v0)
            sweeps = v0 if l + 1 < L - 1 else v1
            us[l + 1] = ctx.levels[l + 1].smooth(
                bs[l + 1], ctx.levels[l + 1].zeros(r.dtype), sweeps
            )
        # Up: add complement correction + prolonged coarse correction.
        for l in range(L - 2, -1, -1):
            lvl = ctx.levels[l]
            corr = ctx.prolong_from_next(l, us[l + 1])
            us[l] = (us[l][0] + es[l][0] + corr,) + us[l][1:]
            us[l] = lvl.smooth(bs[l], us[l], v0)
        return us[0]

    return outer_iterate(
        step, ctx.levels[0].residual, ctx.b0 if b0 is None else b0,
        ctx.levels[0].zeros(ctx.dtype),
        cfg.max_iter, cfg.rtol, cfg.divtol, cfg.hist_len,
    )


def solve_additive2(ctx: MGContext, b0: State | None = None) -> OuterResult:
    """Two-level additive cycle with adaptive step length
    lambda = <r0, r1>/<r0, r0> (src/solver.c:1670-1693)."""
    cfg = ctx.config
    v0, v1 = cfg.v
    assert len(ctx.levels) == 2, "Additive2 requires exactly 2 levels"
    lvl0, lvl1 = ctx.levels
    b = ctx.b0 if b0 is None else b0
    max_iter, hist_len = cfg.max_iter, cfg.hist_len

    bnorm = tree_norm2(b)
    u = lvl0.zeros(ctx.dtype)
    r0 = lvl0.residual(b, u)
    rn0 = tree_norm2(r0)
    hist = jnp.zeros(hist_len + 1, dtype=rn0.dtype).at[0].set(rn0)

    def cond(c):
        u, r0, i, rn, hist = c
        return (i < max_iter) & (cfg.divtol * bnorm > rn) & (rn > cfg.rtol * bnorm)

    def body(c):
        u, r0, i, rn, hist = c
        # Coarse RHS from the PRE-smoothing residual (src/solver.c:1671).
        b1 = ctx.restrict_to_next(0, r0[0])
        u = lvl0.smooth(b, u, v0)
        r1 = lvl0.residual(b, u)
        lam = tree_dot(r0, r1) / (rn * rn)
        u1 = lvl1.smooth(b1, lvl1.zeros(r0[0].dtype), v1)
        corr = ctx.prolong_from_next(0, u1)
        u = (u[0] + lam * corr,) + u[1:]
        r0 = lvl0.residual(b, u)
        rn = tree_norm2(r0)
        hist = hist.at[jnp.minimum(i + 1, hist_len)].set(rn)
        return (u, r0, i + 1, rn, hist)

    u, r0, iters, rn, hist = jax.lax.while_loop(
        cond, body, (u, r0, 0, rn0, hist)
    )
    return OuterResult(
        u=u,
        rnorm_history=hist / hist[0],
        iters=iters,
        converged=rn <= cfg.rtol * bnorm,
    )
