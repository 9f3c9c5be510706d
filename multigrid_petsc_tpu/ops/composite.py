"""Composite ("merged grid") level operators.

The reference's central design idea: a level may contain several grids
merged into ONE linear system whose matrix holds the per-grid Jacobians
plus inter-grid coupling blocks R*A_h (restriction of the finer grid's
operator) and A_h*P (finer operator times prolongation)
(reference: src/solver.c:255-345 fillRestrictionPortion,
src/solver.c:347-487 fillProlongationPortion, assembled variants
levelMatrixA/A1/A2 at src/solver.c:489-556).

Redesign: the composite matrix is never formed.  A composite
state is a tuple of per-grid arrays and the coupled matvec is composed from
matrix-free pieces:

    y_f = A_f u_f                            (diagonal block, every grid)
    y_c += R_{f->c} (A_f u_f)                (restriction portion, f finer)
    y_f += A_f (P_{c->f} u_c)                (prolongation portion)

which equals the assembled composite product exactly (linear-operator
composition; the reference's 9 boundary cases in the prolongation fill are
subsumed by the zero-Dirichlet padding of the matrix-free ops).

The split into A1 (diagonal blocks only) and A2 (couplings only) used by
the E-cycle (src/solver.c:512-556, 2062-2152) falls out by selecting terms.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

from multigrid_petsc_tpu.ops.stencil import Stencil5, apply_stencil5
from multigrid_petsc_tpu.ops.transfer import restrict_multi, prolong_multi


def composite_apply(
    stencils: Sequence[Stencil5],
    gids: tuple[int, ...],
    u: tuple[jnp.ndarray, ...],
    include_diag: bool = True,
    include_couplings: bool = True,
) -> tuple[jnp.ndarray, ...]:
    """Matrix-free composite matvec over a tuple of per-grid arrays.

    ``stencils[k]`` is grid k's 5-point operator (its own spacing h_k,
    matching src/solver.c:236 which evaluates OpA with level->h[lg]).
    ``gids`` are the grids' ids (ascending).  ``include_diag`` /
    ``include_couplings`` select the A / A1 / A2 variants.
    """
    k = len(u)
    au = [apply_stencil5(stencils[i], u[i]) for i in range(k)]
    if include_diag:
        y = list(au)
    else:
        y = [jnp.zeros_like(x) for x in u]
    if include_couplings:
        for kf in range(k):
            for kc in range(kf + 1, k):
                gap = gids[kc] - gids[kf]
                # Restriction portion: rows on coarse grid kc.
                y[kc] = y[kc] + restrict_multi(au[kf], gap)
                # Prolongation portion: rows on fine grid kf.
                y[kf] = y[kf] + apply_stencil5(
                    stencils[kf], prolong_multi(u[kc], gap)
                )
    return tuple(y)


def composite_residual(stencils, gids, b, u, **kw):
    au = composite_apply(stencils, gids, u, **kw)
    return tuple(bb - aa for bb, aa in zip(b, au))


def composite_rhs(f_fine: jnp.ndarray, gids: tuple[int, ...]) -> tuple[jnp.ndarray, ...]:
    """Level RHS: f on the level's primary grid, composed restrictions of f
    for the coarser merged grids (reference: src/solver.c:558-620
    levelvecb restricts f, not the residual)."""
    out = [f_fine]
    for g in gids[1:]:
        out.append(restrict_multi(f_fine, g - gids[0]))
    return tuple(out)
