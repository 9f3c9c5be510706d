"""Matrix-free stencil operators on dense interior grids.

The matrix-free replacement for the reference's distributed CSR assembly +
SpMV (reference: src/solver.c:185-253 fillJacobians + PETSc MatMult).  The
5-point operator acts on an (ny, nx) array of interior unknowns with the
homogeneous-Dirichlet boundary eliminated: out-of-range neighbors contribute
zero, exactly like the dropped boundary entries in the reference's row fill
(src/solver.c:239-251).

Coefficients are stored as broadcastable arrays: scalars for constant
stencils, (ny, 1) for y-dependent metrics (the stretched meshes), or
(ny, nx) for fully variable coefficients.  XLA fuses the shifted adds into a
single bandwidth-bound pass; ops/smooth5_cuda.py fuses k smoother sweeps
on a GPU.

Convention (matches src/solver.c:218-252): row index i = y, column j = x;
``cs`` multiplies u[i-1, j] (south), ``cw`` u[i, j-1] (west), ``cc`` u[i, j],
``ce`` u[i, j+1] (east), ``cn`` u[i+1, j] (north).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Stencil5(NamedTuple):
    """5-point stencil coefficients (each broadcastable to (ny, nx))."""

    cs: jnp.ndarray
    cw: jnp.ndarray
    cc: jnp.ndarray
    ce: jnp.ndarray
    cn: jnp.ndarray

    def scale(self, a) -> "Stencil5":
        return Stencil5(*(a * c for c in self))


class Stencil9(NamedTuple):
    """9-point stencil coefficients (each broadcastable to (ny, nx)).

    Layout: c[dy][dx] for dy, dx in {-1, 0, +1}; names: s=south (i-1),
    n=north (i+1), w=west (j-1), e=east (j+1).
    """

    csw: jnp.ndarray
    cs: jnp.ndarray
    cse: jnp.ndarray
    cw: jnp.ndarray
    cc: jnp.ndarray
    ce: jnp.ndarray
    cnw: jnp.ndarray
    cn: jnp.ndarray
    cne: jnp.ndarray


def _pad1(u: jnp.ndarray) -> jnp.ndarray:
    """Zero halo ring = eliminated Dirichlet boundary."""
    return jnp.pad(u, 1)


def apply_stencil5(st: Stencil5, u: jnp.ndarray) -> jnp.ndarray:
    """y = A u, matrix-free (one fused bandwidth-bound pass under XLA)."""
    p = _pad1(u)
    return (
        st.cc * u
        + st.cs * p[:-2, 1:-1]
        + st.cn * p[2:, 1:-1]
        + st.cw * p[1:-1, :-2]
        + st.ce * p[1:-1, 2:]
    )


def apply_stencil9(st: Stencil9, u: jnp.ndarray) -> jnp.ndarray:
    p = _pad1(u)
    return (
        st.cc * u
        + st.cs * p[:-2, 1:-1]
        + st.cn * p[2:, 1:-1]
        + st.cw * p[1:-1, :-2]
        + st.ce * p[1:-1, 2:]
        + st.csw * p[:-2, :-2]
        + st.cse * p[:-2, 2:]
        + st.cnw * p[2:, :-2]
        + st.cne * p[2:, 2:]
    )


def residual(st: Stencil5, b: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """r = b - A u (reference: KSPBuildResidual / MatResidual semantics)."""
    return b - apply_stencil5(st, u)


def jacobi_sweeps(
    st: Stencil5,
    b: jnp.ndarray,
    u: jnp.ndarray,
    sweeps: int,
    omega: float = 0.8,
) -> jnp.ndarray:
    """``sweeps`` damped-Jacobi iterations u += omega D^-1 (b - A u).

    The replacement for the reference's fixed-sweep Richardson
    KSP smoother (src/solver.c:1463-1510: KSPRICHARDSON, KSP_NORM_NONE,
    maxits=v).  A fixed trip count maps to lax.fori_loop — no data-dependent
    control flow under jit.
    """
    dinv = omega / st.cc  # cc is strictly negative for these operators

    def body(_, u):
        return u + dinv * residual(st, b, u)

    return jax.lax.fori_loop(0, sweeps, body, u)


def sor_redblack_sweeps(
    st: Stencil5,
    b: jnp.ndarray,
    u: jnp.ndarray,
    sweeps: int,
    omega: float = 1.0,
) -> jnp.ndarray:
    """Red-black Gauss-Seidel/SOR: two masked half-sweeps per sweep.

    Expressed as masked Jacobi updates so the whole sweep stays dense and
    vectorized (no scatter/gather); the checkerboard masks are compile-time
    constants.
    """
    ny, nx = u.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1)
    red = ((ii + jj) % 2 == 0)
    dinv = omega / st.cc

    def half(u, mask):
        return jnp.where(mask, u + dinv * residual(st, b, u), u)

    def body(_, u):
        u = half(u, red)
        return half(u, ~red)

    return jax.lax.fori_loop(0, sweeps, body, u)


def diag(st: Stencil5, shape) -> jnp.ndarray:
    """Operator diagonal broadcast to full shape."""
    return jnp.broadcast_to(st.cc, shape)


def thomas_tridiagonal(dl, d, du, rhs):
    """Batched Thomas solve of tridiagonal systems along axis 0.

    dl, d, du, rhs: broadcastable to (n, m) — m independent systems down
    the columns; dl[0] and du[n-1] are ignored.  Sequential lax.scan over
    rows with vectorized columns (fine for diagonally dominant smoother
    lines; a cyclic-reduction kernel can replace this for very long lines).
    """
    n = rhs.shape[0]
    dl = jnp.broadcast_to(dl, rhs.shape)
    d = jnp.broadcast_to(d, rhs.shape)
    du = jnp.broadcast_to(du, rhs.shape)

    def fwd(carry, x):
        cp_prev, dp_prev = carry
        a, b, c, r = x
        denom = b - a * cp_prev
        cp = c / denom
        dp = (r - a * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zeros = jnp.zeros_like(rhs[0])
    _, (cps, dps) = jax.lax.scan(
        fwd, (zeros, zeros), (dl, d, du, rhs)
    )

    def bwd(x_next, x):
        cp, dp = x
        xi = dp - cp * x_next
        return xi, xi

    _, xs = jax.lax.scan(bwd, zeros, (cps, dps), reverse=True)
    return xs


def _shift_fwd(x: jnp.ndarray, s: int, fill: float) -> jnp.ndarray:
    """y[i] = x[i - s] (rows shifted toward larger i), ``fill`` outside."""
    pad = jnp.full((s,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([pad, x[:-s]], axis=0)


def _shift_bwd(x: jnp.ndarray, s: int, fill: float) -> jnp.ndarray:
    """y[i] = x[i + s], ``fill`` outside."""
    pad = jnp.full((s,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([x[s:], pad], axis=0)


class PCRFactor(NamedTuple):
    """Parallel-cyclic-reduction factorization of a tridiagonal matrix.

    The matrix-only part of the reduction (the per-step elimination
    multipliers and the fully-reduced diagonal) is precomputed once; each
    ``pcr_solve`` then runs only ceil(log2 n) fully-vectorized passes over
    the RHS — the parallel replacement for a sequential Thomas scan,
    whose 2n lax.scan steps are latency-bound on (1, nx) rows.  Step k of
    the stored sequence uses stride 2**k (implied; not stored).
    """

    alphas: tuple  # per-step -a_i / d_{i-s}, broadcastable to (n, w)
    gammas: tuple  # per-step -c_i / d_{i+s}
    dinv: jnp.ndarray  # 1 / fully-reduced diagonal


def pcr_factor(dl, d, du, n: int) -> PCRFactor:
    """Precompute the PCR elimination for the n×n tridiagonal systems
    (dl, d, du) (each broadcastable to (n, w); dl[0], du[n-1] ignored).

    Numerically stable for the diagonally dominant systems produced by
    line relaxation.  Cost: ceil(log2 n) vectorized passes over the
    coefficient arrays, once at setup.
    """
    shape = jnp.broadcast_shapes(
        jnp.shape(dl), jnp.shape(d), jnp.shape(du), (n, 1)
    )
    dt = jnp.result_type(dl, d, du)
    a = jnp.broadcast_to(dl, shape).astype(dt).at[0].set(0.0)
    dd = jnp.broadcast_to(d, shape).astype(dt)
    c = jnp.broadcast_to(du, shape).astype(dt).at[-1].set(0.0)

    alphas, gammas = [], []
    s = 1
    while s < n:
        # Equations at i-s / i+s; out-of-range rows are identity equations
        # (d=1, a=c=0, r=0), which leave eq i unchanged there.
        alpha = -a / _shift_fwd(dd, s, 1.0)
        gamma = -c / _shift_bwd(dd, s, 1.0)
        dd = (dd + alpha * _shift_fwd(c, s, 0.0)
              + gamma * _shift_bwd(a, s, 0.0))
        a = alpha * _shift_fwd(a, s, 0.0)
        c = gamma * _shift_bwd(c, s, 0.0)
        alphas.append(alpha)
        gammas.append(gamma)
        s *= 2
    return PCRFactor(tuple(alphas), tuple(gammas), 1.0 / dd)


def pcr_solve(fac: PCRFactor, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve the factored tridiagonal systems for ``rhs`` (n, m):
    ceil(log2 n) shift+FMA passes, all columns in parallel."""
    r = rhs
    s = 1
    for alpha, gamma in zip(fac.alphas, fac.gammas):
        r = r + alpha * _shift_fwd(r, s, 0.0) + gamma * _shift_bwd(r, s, 0.0)
        s *= 2
    return fac.dinv * r


def line_jacobi_sweeps_y(
    st: Stencil9,
    b: jnp.ndarray,
    u: jnp.ndarray,
    sweeps: int,
    omega: float = 1.0,
) -> jnp.ndarray:
    """Damped y-line Jacobi: each sweep solves, for every column
    simultaneously, the tridiagonal system coupling u[i-1,j], u[i,j],
    u[i+1,j] with all x-direction and corner terms moved to the RHS from
    the previous iterate.

    The line-smoother variant (BASELINE.md config 4): strong
    y-coupling (stretched/anisotropic operators) makes point smoothers
    stall; line relaxation in the strong direction restores textbook MG
    rates.  The batched tridiagonal solve runs all nx lines at once.
    """
    ny, nx = u.shape
    # Factor the (static) line systems once per call with PCR; each sweep
    # then costs only log2(ny) vectorized passes instead of a 2*ny-step
    # sequential Thomas scan (2 ny dependent steps).
    fac = pcr_factor(st.cs, st.cc, st.cn, ny)

    def off_line(u):
        p = _pad1(u)
        return (
            st.cw * p[1:-1, :-2]
            + st.ce * p[1:-1, 2:]
            + st.csw * p[:-2, :-2]
            + st.cse * p[:-2, 2:]
            + st.cnw * p[2:, :-2]
            + st.cne * p[2:, 2:]
        )

    def body(_, u):
        rhs = b - off_line(u)
        u_line = pcr_solve(fac, rhs)
        return (1.0 - omega) * u + omega * u_line

    return jax.lax.fori_loop(0, sweeps, body, u)


def line_jacobi_sweeps_x(
    st: Stencil9,
    b: jnp.ndarray,
    u: jnp.ndarray,
    sweeps: int,
    omega: float = 1.0,
) -> jnp.ndarray:
    """x-line Jacobi (transpose of the y-line smoother)."""
    stT = Stencil9(
        csw=jnp.asarray(st.csw).T, cs=jnp.asarray(st.cw).T,
        cse=jnp.asarray(st.cnw).T, cw=jnp.asarray(st.cs).T,
        cc=jnp.asarray(st.cc).T, ce=jnp.asarray(st.cn).T,
        cnw=jnp.asarray(st.cse).T, cn=jnp.asarray(st.ce).T,
        cne=jnp.asarray(st.cne).T,
    )
    return line_jacobi_sweeps_y(stT, b.T, u.T, sweeps, omega).T
