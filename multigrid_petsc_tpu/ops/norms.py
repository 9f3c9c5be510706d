"""Norms and dot products over level states.

A level state is a tuple of per-grid 2-D arrays (one entry for simple
levels, several for composite "merged grid" levels).  Norms flatten across
all grids — matching the reference's VecNorm over the whole composite
vector (e.g. src/solver.c:1512, 2237).

Accumulation dtype is configurable: f32 data with f64 accumulation
keeps norms/dots accurate enough for 1e-8 stopping tests while the heavy
stencil work stays in f32.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def vdot(x, y):
    """<x, y> at HIGHEST precision: on the GPU an f32 dot may otherwise
    round its inputs to TF32 (about three decimal digits)."""
    return jnp.vdot(x, y, precision=lax.Precision.HIGHEST)


def tree_dot(xs, ys, acc_dtype=None):
    total = None
    for x, y in zip(xs, ys):
        if acc_dtype is not None:
            x = x.astype(acc_dtype)
            y = y.astype(acc_dtype)
        s = vdot(x, y)
        total = s if total is None else total + s
    return total


def tree_norm2(xs, acc_dtype=None):
    """l2 norm over all grids (reference: VecNorm NORM_2)."""
    return jnp.sqrt(tree_dot(xs, xs, acc_dtype=acc_dtype))


def tree_axpy(a, xs, ys):
    """ys + a * xs, elementwise over the tuple."""
    return tuple(y + a * x for x, y in zip(xs, ys))


def tree_scale(a, xs):
    return tuple(a * x for x in xs)


def tree_sub(xs, ys):
    return tuple(x - y for x, y in zip(xs, ys))


def tree_add(xs, ys):
    return tuple(x + y for x, y in zip(xs, ys))


def tree_zeros_like(xs):
    return tuple(jnp.zeros_like(x) for x in xs)
