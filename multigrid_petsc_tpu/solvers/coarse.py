"""Coarsest-level solvers.

The reference's coarsest "solve" is v1 Richardson sweeps whose PETSc
default ILU preconditioner makes them near-direct on small grids
(src/solver.c:1495-1510).  Plain damped Jacobi is NOT an adequate stand-in
(the V-cycle degenerates to rate ~1 - O(h_coarse^2)), so the framework
provides real coarse solvers:

  * "direct": dense LU of the (possibly composite) coarsest operator,
    built once at setup by probing the matrix-free apply with identity
    columns and inverted on the host; application is one small dense
    matvec.  Exact + linear, so Krylov outers stay happy.  Used when the
    coarsest level has <= max_direct_size unknowns.
  * "cg": fixed-iteration conjugate gradients, matrix-free (for coarse
    grids too large to densify).
  * "smooth": the reference-faithful v1 smoother sweeps.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from multigrid_petsc_tpu.ops.norms import vdot


def _flatten(state):
    return jnp.concatenate([x.ravel() for x in state])


def _unflatten(vec, shapes):
    out, off = [], 0
    for s in shapes:
        n = s[0] * s[1]
        out.append(vec[off : off + n].reshape(s))
        off += n
    return tuple(out)


def stencil_coo(st, ny: int, nx: int):
    """(rows, cols, vals) of a (possibly 9-point) stencil operator with
    eliminated Dirichlet boundary, assembled analytically on host in f64
    (reference analogue: the per-row fill of src/solver.c:185-253)."""
    import numpy as np

    ii, jj = np.mgrid[0:ny, 0:nx]
    rows = (ii * nx + jj).ravel()
    out_r, out_c, out_v = [], [], []
    # (name, dy, dx) neighbor table; Stencil5 lacks the corner fields.
    offsets = [("cc", 0, 0), ("cs", -1, 0), ("cn", 1, 0),
               ("cw", 0, -1), ("ce", 0, 1), ("csw", -1, -1),
               ("cse", -1, 1), ("cnw", 1, -1), ("cne", 1, 1)]
    for name, dy, dx in offsets:
        if not hasattr(st, name):
            continue
        i2, j2 = ii + dy, jj + dx
        ok = ((i2 >= 0) & (i2 < ny) & (j2 >= 0) & (j2 < nx)).ravel()
        vals = np.broadcast_to(
            np.asarray(getattr(st, name), np.float64), (ny, nx)).ravel()
        out_r.append(rows[ok])
        out_c.append((i2 * nx + j2).ravel()[ok])
        out_v.append(vals[ok])
    return (np.concatenate(out_r), np.concatenate(out_c),
            np.concatenate(out_v))


def dense_from_stencil(st, ny: int, nx: int):
    """Dense (N, N) matrix of ``stencil_coo`` — replaces O(N) probing
    matvecs at setup and doesn't cap how big an agglomerated coarse level
    can be."""
    import numpy as np

    a = np.zeros((ny * nx, ny * nx))
    r, c, v = stencil_coo(st, ny, nx)
    a[r, c] = v
    return a


def dense_from_csr(indptr, indices, data):
    """Dense (N, N) matrix from a host CSR triple (the native composite
    assembly, ops/sparse.assemble_level_csr) — lets composite coarsest
    levels densify without O(N) probing matvecs."""
    import numpy as np

    N = len(indptr) - 1
    a = np.zeros((N, N))
    rows = np.repeat(np.arange(N), np.diff(indptr))
    a[rows, np.asarray(indices)] = np.asarray(data)
    return a


def build_direct_solver(
    apply_fn: Callable, shapes, dtype, stencils=None, dense=None
) -> Callable:
    """Build A once, invert on host, return b -> A^-1 b.

    Non-composite levels (``stencils`` given, one grid) assemble A
    analytically from the stencil coefficients; composite poisson-family
    levels pass ``dense`` assembled from the native CSR engine.  Only
    operators with no explicit form left (e.g. padded/exotic composites)
    probe the matrix-free apply column-by-column.  The inversion happens
    on host in f64 at setup (LAPACK, once — the analogue of the
    reference's assembly step).  The per-cycle application is a single
    dense (N, N) matvec at HIGHEST precision: an f32 product may otherwise
    run in TF32 on the GPU, which keeps about three decimal digits.
    """
    import numpy as np

    N = sum(ny * nx for ny, nx in shapes)

    if dense is not None:
        a = np.asarray(dense, dtype=np.float64)
    elif stencils is not None and len(shapes) == 1:
        a = dense_from_stencil(stencils[0], *shapes[0])
    else:
        def mv(xflat):
            return _flatten(apply_fn(_unflatten(xflat, shapes)))

        # vmap over identity rows: row k of the result is A e_k = col k.
        at = jax.vmap(mv)(jnp.eye(N, dtype=dtype))
        a = np.asarray(at, dtype=np.float64).T
    a_inv = jnp.asarray(np.linalg.inv(a), dtype=dtype)

    def solve(b_state):
        x = jnp.matmul(a_inv, _flatten(b_state),
                       precision=jax.lax.Precision.HIGHEST)
        return _unflatten(x, shapes)

    return solve


def build_cg_solver(
    apply_fn: Callable, shapes, iters: int = 64
) -> Callable:
    """Fixed-iteration matrix-free CG (valid for the negative-definite
    operator: both inner products flip sign).  Fixed trip count keeps the
    coarse solve linear, so outer Krylov methods remain consistent."""

    def solve(b_state):
        b = _flatten(b_state)

        def mv(x):
            return _flatten(apply_fn(_unflatten(x, shapes)))

        x = jnp.zeros_like(b)
        r = b
        p = r
        rr = vdot(r, r)

        def body(_, carry):
            x, r, p, rr = carry
            ap = mv(p)
            denom = vdot(p, ap)
            alpha = jnp.where(denom != 0, rr / denom, 0.0)
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = vdot(r, r)
            beta = jnp.where(rr != 0, rr_new / rr, 0.0)
            p = r + beta * p
            return (x, r, p, rr_new)

        x, *_ = jax.lax.fori_loop(0, iters, body, (x, r, p, rr))
        return _unflatten(x, shapes)

    return solve
