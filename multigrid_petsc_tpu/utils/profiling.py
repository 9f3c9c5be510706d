"""Profiling: per-phase timing breakdowns + device trace capture.

The analogue of the reference's PETSc log stages
(reference: src/solver.c:1528-1551 PetscLogStageRegister/Push/Pop around
the solve loop, enabling -log_view breakdowns) and its wall/CPU timers
(src/solver.c:1526-1553).

Two tools:
  * ``phase_breakdown``: times each building block of a context's fine
    level (smooth / residual / restrict / prolong / norm) with compile
    excluded, each ended by ``block_until_ready`` — the per-op "-log_view".
  * ``trace``: context manager around ``jax.profiler`` for full device
    traces viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time

import jax


def _time_op(fn, *args, reps: int = 5) -> float:
    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def phase_breakdown(ctx, v: int | None = None, reps: int = 5) -> dict:
    """Per-phase times (seconds) of the fine-level building blocks."""
    cfg = ctx.config
    v = cfg.v[0] if v is None else v
    lvl0 = ctx.levels[0]
    b = ctx.b0
    u = lvl0.zeros(ctx.dtype)

    out = {}
    out["smooth_v"] = _time_op(
        jax.jit(lambda b, u: lvl0.smooth(b, u, v)), b, u, reps=reps
    )
    out["residual"] = _time_op(jax.jit(lvl0.residual), b, u, reps=reps)
    if len(ctx.levels) > 1:
        r0 = b[0]
        out["restrict"] = _time_op(
            jax.jit(lambda r: ctx.restrict_to_next(0, r)), r0, reps=reps
        )
        un = ctx.levels[1].zeros(ctx.dtype)
        out["prolong"] = _time_op(
            jax.jit(lambda un: ctx.prolong_from_next(0, un)), un, reps=reps
        )
    from multigrid_petsc_tpu.ops.norms import tree_norm2

    out["norm"] = _time_op(jax.jit(tree_norm2), b, reps=reps)
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace: ``with profiling.trace(dir): solve(...)``."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
