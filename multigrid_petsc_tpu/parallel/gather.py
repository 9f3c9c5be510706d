"""Solution gather: assemble the (possibly sharded / multi-host) fine-grid
solution on every host as a numpy array.

Capability parity with the reference's GetSol (reference:
src/solver.c:1239-1315: rank-0 MPI_Send/Recv gather + reorder through the
global index map — including a latent bug where counts are sent with
MPI_DOUBLE, deliberately NOT replicated here).  Here addressable shards
are read directly; multi-host runs use
jax.experimental.multihost_utils.process_allgather.
"""

from __future__ import annotations

import jax
import numpy as np


def gather_solution(u, interior_shape: tuple[int, int] | None = None) -> np.ndarray:
    """Fine-grid solution as a host numpy array, on every process.

    ``interior_shape`` strips distributed pad rows/cols when the caller
    passes raw (padded) level-0 state instead of SolveResult.u."""
    arr = u[0] if isinstance(u, tuple) else u
    if isinstance(arr, np.ndarray):
        out = arr
    elif isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        from jax.experimental import multihost_utils

        out = np.asarray(multihost_utils.process_allgather(arr, tiled=True))
    else:
        out = np.asarray(arr)
    if interior_shape is not None:
        out = out[: interior_shape[0], : interior_shape[1]]
    return out
