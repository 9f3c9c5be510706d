"""Smoothers over (possibly composite) level states.

The reference's smoother is a fixed-sweep Richardson KSP with norms off and
PETSc's default preconditioner (reference: src/solver.c:1463-1510).  The
framework pins explicit, compiler-friendly smoothers instead (SURVEY.md
section 7 hard-part 3): damped Jacobi, Chebyshev-accelerated Jacobi, and
red-black Gauss-Seidel; all are fixed trip-count lax loops with no
data-dependent control flow.

A smoother acts on a level state ``u`` (tuple of per-grid arrays) given the
level's matrix-free apply and the tuple of inverse diagonals.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from multigrid_petsc_tpu.ops.norms import vdot


State = tuple  # tuple of per-grid 2-D arrays


def jacobi(
    apply_fn: Callable[[State], State],
    dinv: State,
    b: State,
    u: State,
    sweeps: int,
    omega: float = 0.8,
) -> State:
    """``sweeps`` damped-Jacobi iterations u += omega D^-1 (b - A u)."""

    def body(_, u):
        au = apply_fn(u)
        return tuple(
            uk + omega * dk * (bk - ak) for uk, dk, bk, ak in zip(u, dinv, b, au)
        )

    return jax.lax.fori_loop(0, sweeps, body, u)


def chebyshev(
    apply_fn: Callable[[State], State],
    dinv: State,
    b: State,
    u: State,
    sweeps: int,
    lmax: float,
    lmin_frac: float = 0.1,
    lmax_scale: float = 1.05,
) -> State:
    """Chebyshev-accelerated Jacobi smoothing on [lmin_frac*lmax, scale*lmax].

    ``lmax`` is an upper bound on the spectrum of D^-1 A (estimate with
    ``estimate_dinv_a_lmax``).  Fixed-k Chebyshev needs no inner products,
    so a sharded smoother runs no collectives.
    """
    lo = lmin_frac * lmax
    hi = lmax_scale * lmax
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta

    def dinv_res(u):
        au = apply_fn(u)
        return tuple(dk * (bk - ak) for dk, bk, ak in zip(dinv, b, au))

    z = dinv_res(u)
    p = tuple(zk / theta for zk in z)
    u = tuple(uk + pk for uk, pk in zip(u, p))
    rho = 1.0 / sigma

    def body(_, carry):
        u, p, rho = carry
        rho_new = 1.0 / (2.0 * sigma - rho)
        z = dinv_res(u)
        p = tuple(
            rho_new * rho * pk + (2.0 * rho_new / delta) * zk
            for pk, zk in zip(p, z)
        )
        u = tuple(uk + pk for uk, pk in zip(u, p))
        return (u, p, rho_new)

    u, _, _ = jax.lax.fori_loop(0, sweeps - 1, body, (u, p, rho))
    return u


def jacobi_step_coeffs(sweeps: int, omega: float) -> tuple:
    """(alpha, beta) steps of damped Jacobi in the polynomial-smoother form
    z = D^-1 (b - A u); p = beta p + alpha z; u = u + p."""
    return tuple((omega, 0.0) for _ in range(sweeps))


def chebyshev_step_coeffs(sweeps: int, lmax: float,
                          lmin_frac: float = 0.1,
                          lmax_scale: float = 1.05) -> tuple:
    """(alpha, beta) steps reproducing ``chebyshev`` (same theta/delta/rho
    recurrence)."""
    lo = lmin_frac * lmax
    hi = lmax_scale * lmax
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    steps = [(1.0 / theta, 0.0)]
    rho = 1.0 / sigma
    for _ in range(sweeps - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        steps.append((2.0 * rho_new / delta, rho_new * rho))
        rho = rho_new
    return tuple(steps)


def composite_block_gs(
    stencils,
    gids: tuple[int, ...],
    dinv: State,
    b: State,
    u: State,
    sweeps: int,
    inner: int = 3,
    omega: float = 0.8,
) -> State:
    """Grid-ordered block Gauss-Seidel for composite ("merged grid") levels.

    The reference smooths the composite matrix with Richardson + PETSc's
    default ILU/block-Jacobi preconditioner (src/solver.c:2011-2020), which
    point-Jacobi cannot replace (the coupling blocks break diagonal
    dominance).  The matrix-free equivalent: one sweep visits the level's
    grids fine-to-coarse, moving the inter-grid couplings to the RHS with
    the LATEST iterates and running ``inner`` damped-Jacobi iterations on
    the grid's own 5-point block.  With couplings R*A_f / A_f*P this is a
    two-grid correction scheme in disguise, so it contracts like multigrid.
    """
    from multigrid_petsc_tpu.ops.stencil import apply_stencil5
    from multigrid_petsc_tpu.ops.transfer import prolong_multi, restrict_multi

    G = len(u)

    def one_sweep(_, u):
        u = list(u)
        for k in range(G):
            rhs = b[k]
            # Couplings from finer grids (restriction portion rows).
            for kf in range(k):
                gap = gids[k] - gids[kf]
                rhs = rhs - restrict_multi(
                    apply_stencil5(stencils[kf], u[kf]), gap
                )
            # Couplings from coarser grids (prolongation portion rows).
            for kc in range(k + 1, G):
                gap = gids[kc] - gids[k]
                rhs = rhs - apply_stencil5(
                    stencils[k], prolong_multi(u[kc], gap)
                )

            def body(_, uk, _k=k, _rhs=rhs):
                r = _rhs - apply_stencil5(stencils[_k], uk)
                return uk + omega * dinv[_k] * r

            u[k] = jax.lax.fori_loop(0, inner, body, u[k])
        return tuple(u)

    return jax.lax.fori_loop(0, sweeps, one_sweep, u)


def estimate_dinv_a_lmax(
    apply_fn: Callable[[State], State],
    dinv: State,
    shapes: Sequence[tuple[int, int]],
    iters: int = 20,
    dtype=jnp.float64,
) -> jnp.ndarray:
    """Power iteration for the largest eigenvalue of D^-1 A.

    Deterministic start vector (no RNG needed: a constant-plus-checkerboard
    vector has components on both smooth and oscillatory modes).
    """
    v = []
    for (ny, nx) in shapes:
        ii = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0)
        jj = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1)
        v.append((1.0 + 0.5 * ((ii + jj) % 2)).astype(dtype))
    v = tuple(v)

    def norm(xs):
        return jnp.sqrt(sum(vdot(x, x) for x in xs).real)

    def body(_, carry):
        v, _ = carry
        w = apply_fn(v)
        w = tuple(dk * wk for dk, wk in zip(dinv, w))
        nrm = norm(w)
        return tuple(wk / nrm for wk in w), nrm

    _, lmax = jax.lax.fori_loop(0, iters, body, (v, jnp.asarray(1.0, dtype)))
    return lmax
