"""Shared outer-iteration driver with residual history.

Every reference cycle driver wraps the same outer loop (e.g.
src/solver.c:1530-1550): iterate while

    iter < max_iter  AND  divtol * ||b|| > ||r||  AND  ||r|| > rtol * ||b||

recording ||r|| per outer iteration and finally normalizing the history by
its first entry (src/solver.c:1554-1557).  Here that loop is a single
lax.while_loop so the entire solve jits into one XLA computation; the
history lives in a fixed-capacity on-device array.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from multigrid_petsc_tpu.ops.norms import tree_norm2

State = tuple


class OuterResult(NamedTuple):
    u: State
    rnorm_history: jnp.ndarray  # normalized by entry 0; length hist_len+1
    iters: jnp.ndarray  # i32
    converged: jnp.ndarray  # bool
    aux: dict | None = None  # driver extras (e.g. moreNorm monitor arrays)


def outer_iterate(
    step: Callable[[State, State], State],  # (b, u) -> u (one cycle)
    residual: Callable[[State, State], State],
    b: State,
    u0: State,
    max_iter: int,
    rtol: float,
    divtol: float,
    hist_len: int | None = None,
    step_emits_residual: bool = False,
    monitor=None,
) -> OuterResult:
    """``step_emits_residual``: the step returns (u, r) with r = b - A u
    already computed (by the level-0 up visit), so the
    convergence norm costs no extra operator application.

    ``monitor``: optional ``(aux0, update)`` pair — the per-iteration
    residual-monitor hook (the KSPMonitor analogue, reference:
    src/solver.c:1382-1412 + KSPSetResidualHistory src/solver.c:2017-2018).
    ``aux0`` is a pytree of preallocated arrays; ``update(aux, i, u, rn)``
    records iteration ``i`` (0 = initial state) and returns the new aux.
    """
    hist_len = max_iter if hist_len is None else min(hist_len, max_iter)
    bnorm = tree_norm2(b)
    r0 = residual(b, u0)
    rn0 = tree_norm2(r0)
    hist = jnp.zeros(hist_len + 1, dtype=rn0.dtype).at[0].set(rn0)
    aux0, mon_update = monitor if monitor is not None else (None, None)
    if mon_update is not None:
        aux0 = mon_update(aux0, 0, u0, rn0)

    def cond(carry):
        u, i, rn, hist, aux = carry
        return (i < max_iter) & (divtol * bnorm > rn) & (rn > rtol * bnorm)

    def body(carry):
        u, i, rn, hist, aux = carry
        if step_emits_residual:
            u, r = step(b, u)
            rn = tree_norm2(r)
        else:
            u = step(b, u)
            rn = tree_norm2(residual(b, u))
        hist = hist.at[jnp.minimum(i + 1, hist_len)].set(rn)
        if mon_update is not None:
            aux = mon_update(aux, i + 1, u, rn)
        return (u, i + 1, rn, hist, aux)

    u, iters, rn, hist, aux = jax.lax.while_loop(
        cond, body, (u0, 0, rn0, hist, aux0)
    )
    hist = hist / hist[0]
    converged = rn <= rtol * bnorm
    return OuterResult(u=u, rnorm_history=hist, iters=iters,
                       converged=converged, aux=aux)
