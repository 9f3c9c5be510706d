"""Explicit one-cell halo exchange via ppermute inside shard_map.

The explicit equivalent of the neighbor halo exchange PETSc performs
inside every distributed MatMult (reference: src/solver.c:1516,1535,1540 —
all SpMVs; SURVEY.md C23).  ``ppermute`` with missing source/destination
pairs delivers ZEROS to edge shards, which is exactly the eliminated
homogeneous-Dirichlet boundary — no special-casing needed.

This module is the manual-control backend; the default distribution path
relies on GSPMD propagating shardings through the jnp stencil ops (XLA
inserts equivalent collective-permutes automatically).  Keeping both lets
tests assert they agree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _shift_perm(n: int, direction: int):
    """Pairs (src, dst) sending each shard's slab to its neighbor.
    direction=+1: shard p -> p+1 (receiver gets data from the SOUTH/WEST).
    """
    if direction > 0:
        return [(i, i + 1) for i in range(n - 1)]
    return [(i + 1, i) for i in range(n - 1)]


def halo_pad_local(u: jnp.ndarray, y_axis: str = "y", x_axis: str = "x",
                   corners: bool = False) -> jnp.ndarray:
    """Inside shard_map: return the local block padded by one ring of
    neighbor data (zeros at the global boundary).

    5-point stencils need edges only; set ``corners=True`` for 9-point
    stencils (second exchange pass carries the corner cells).
    """
    ny_dev = lax.axis_size(y_axis)
    nx_dev = lax.axis_size(x_axis)

    # y-direction: my top halo row comes from the y-neighbor below? No:
    # row index grows with y position; halo row ABOVE local block (index -1)
    # comes from shard p-1's LAST row.
    top = lax.ppermute(u[-1:, :], y_axis, _shift_perm(ny_dev, +1))
    bot = lax.ppermute(u[:1, :], y_axis, _shift_perm(ny_dev, -1))
    u_y = jnp.concatenate([top, u, bot], axis=0)

    if corners:
        left = lax.ppermute(u_y[:, -1:], x_axis, _shift_perm(nx_dev, +1))
        right = lax.ppermute(u_y[:, :1], x_axis, _shift_perm(nx_dev, -1))
        return jnp.concatenate([left, u_y, right], axis=1)

    # Corner cells are unused by 5-point stencils: pad the exchanged edge
    # columns with zeros top/bottom instead of a second exchange pass.
    left = jnp.pad(lax.ppermute(u[:, -1:], x_axis, _shift_perm(nx_dev, +1)),
                   ((1, 1), (0, 0)))
    right = jnp.pad(lax.ppermute(u[:, :1], x_axis, _shift_perm(nx_dev, -1)),
                    ((1, 1), (0, 0)))
    return jnp.concatenate([left, u_y, right], axis=1)


def apply_stencil5_local(cs, cw, cc, ce, cn, u):
    """Local 5-point apply given a halo-padded neighborhood (shard_map
    body).  Overlap note: XLA schedules the ppermutes concurrently with
    the interior multiplies since only the rim depends on them."""
    p = halo_pad_local(u)
    return (
        cc * u
        + cs * p[:-2, 1:-1]
        + cn * p[2:, 1:-1]
        + cw * p[1:-1, :-2]
        + ce * p[1:-1, 2:]
    )
