"""Outer Krylov loops with the V-cycle as preconditioner.

The framework's generalization of the reference's PCMG cross-check path
(reference: src/solver.c:1884-1989 wires the same operators into PETSc's
PCMG under an outer Richardson KSP).  Here the outer loops are our own:

  * PCG — preconditioned conjugate gradients (SPD path; the BASELINE.md
    "mg-CG" headline solver),
  * FGMRES — flexible restarted GMRES (robust for the nonsymmetric
    stretched-mesh operators).

Both run as single jitted lax.while_loops over level-0 states, with the
same stopping rule and residual history as the cycle drivers.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from multigrid_petsc_tpu.ops.norms import tree_dot, tree_norm2, vdot
from multigrid_petsc_tpu.solvers.context import MGContext, State
from multigrid_petsc_tpu.solvers.outer import OuterResult
from multigrid_petsc_tpu.solvers.vcycle import mg_apply


def _mg_precond(ctx: MGContext, v0: int, v1: int) -> Callable[[State], State]:
    """The V-cycle preconditioner closure, routed through the
    reduced-precision context when cfg.precond_dtype is set (the bf16
    preconditioner halves the device-memory bytes per application; the
    Krylov outer keeps full accuracy — M only shapes the rate)."""
    pctx = ctx.precond_ctx
    if pctx is None:
        return lambda r: mg_apply(ctx, r, v0, v1)
    pdt = pctx.dtype

    def precond(r: State) -> State:
        z = mg_apply(pctx, tuple(x.astype(pdt) for x in r), v0, v1)
        return tuple(x.astype(r0.dtype) for x, r0 in zip(z, r))

    return precond


def solve_mgcg(ctx: MGContext, b0: State | None = None) -> OuterResult:
    """Preconditioned CG with one V-cycle as M.

    Standard PCG formulas hold verbatim for the negative-definite discrete
    Laplacian (both inner products flip sign, ratios stay positive).
    """
    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]
    b = ctx.b0 if b0 is None else b0
    max_iter, hist_len = cfg.max_iter, cfg.hist_len

    precond = _mg_precond(ctx, v0, v1)
    # A reduced-precision preconditioner is only approximately symmetric/
    # constant; plain PCG's Fletcher-Reeves beta loses conjugacy there
    # (observed: residual blow-up with the bf16 V-cycle at 1025^2).  The
    # flexible Polak-Ribiere beta <z, r - r_prev>/<z_prev, r_prev>
    # tolerates varying M at the cost of keeping r_prev.
    flexible = ctx.precond_ctx is not None

    bnorm = tree_norm2(b)
    u = lvl0.zeros(ctx.dtype)
    r = lvl0.residual(b, u)
    rn0 = tree_norm2(r)
    z = precond(r)
    p = z
    rz = tree_dot(r, z)
    hist = jnp.zeros(hist_len + 1, dtype=rn0.dtype).at[0].set(rn0)

    def cond(c):
        u, r, r_prev, p, rz, i, rn, hist = c
        return (i < max_iter) & (cfg.divtol * bnorm > rn) & (rn > cfg.rtol * bnorm)

    def body(c):
        u, r, r_prev, p, rz, i, rn, hist = c
        ap = lvl0.apply(p)
        # Breakdown guards: once the f32 residual floors, pap/rz can hit
        # exact 0 (or the recurrences NaN) — guarded ratios turn the
        # iteration into a harmless stall instead of a silent NaN exit
        # (forced-length benchmark runs rely on the loop running).
        pap = tree_dot(p, ap)
        alpha = jnp.where(pap != 0, rz / pap, 0.0)
        u = tuple(uk + alpha * pk for uk, pk in zip(u, p))
        r_new = tuple(rk - alpha * ak for rk, ak in zip(r, ap))
        rn = tree_norm2(r_new)
        z = precond(r_new)
        rz_new = tree_dot(r_new, z)
        if flexible:
            num = rz_new - tree_dot(r, z)
            beta = jnp.where(rz != 0, jnp.maximum(num / rz, 0.0), 0.0)
        else:
            beta = jnp.where(rz != 0, rz_new / rz, 0.0)
        p = tuple(zk + beta * pk for zk, pk in zip(z, p))
        hist = hist.at[jnp.minimum(i + 1, hist_len)].set(rn)
        return (u, r_new, r, p, rz_new, i + 1, rn, hist)

    u, r, r_prev, p, rz, iters, rn, hist = jax.lax.while_loop(
        cond, body, (u, r, r, p, rz, 0, rn0, hist)
    )
    return OuterResult(
        u=u,
        rnorm_history=hist / hist[0],
        iters=iters,
        converged=rn <= cfg.rtol * bnorm,
    )


def outer_precision_operator(ctx: MGContext, odt):
    """(apply_fn, stencil) evaluating the FINE-level operator of ``ctx``'s
    own problem family in the outer dtype — the f64 defect-correction
    operator for any supported family (5-pt Poisson on all three meshes,
    9-pt anisotropic), not a hand-built special case."""
    from multigrid_petsc_tpu.mesh import MeshType
    from multigrid_petsc_tpu.ops.stencil import apply_stencil5, apply_stencil9

    cfg = ctx.config
    g0 = ctx.levels[0].spec.primary
    if cfg.problem == "aniso":
        from multigrid_petsc_tpu.problems import stencil9_coefficients

        st = stencil9_coefficients(ctx.problem, g0.ny, g0.nx, odt)
        return (lambda u: apply_stencil9(st, u)), st
    from multigrid_petsc_tpu.problems import stencil_coefficients

    st = stencil_coefficients(MeshType(cfg.mesh), g0.ny, g0.nx, odt)
    return (lambda u: apply_stencil5(st, u)), st


def outer_precision_operator_tf(ctx: MGContext):
    """(apply_fn, stencil) like ``outer_precision_operator`` but in
    two-float32 (double-single) arithmetic: the f64 coefficients are split
    once at setup into hi/lo f32 pairs and applied with the ops.twofloat
    kernels — f32-bandwidth applies with ~2^-47 effective precision."""
    from multigrid_petsc_tpu.ops import twofloat as tf

    _, st = outer_precision_operator(ctx, jnp.float64)
    st_tf = tf.split_stencil(st)
    if isinstance(st_tf, tf.Stencil9TF):
        return (lambda u: tf.apply_stencil9(st_tf, u)), st_tf
    return (lambda u: tf.apply_stencil5(st_tf, u)), st_tf


def _solve_mgcg_mixed_tf(
    ctx: MGContext, b0: State | None = None, u0=None
) -> OuterResult:
    """Two-float32 outer PCG (``outer_dtype="float32x2"``): the defect-
    correction outer runs in double-single arithmetic (ops/twofloat.py)
    instead of native f64 — same 1e-8 certification up to ~8193^2, moving
    two f32 words per element like f64 does.

    The CG scalars (alpha, beta, norms) are plain f32: only the vector
    updates and the operator apply set the attainable-residual floor; a
    rounded step size just perturbs the search direction, and the residual
    recursion stays consistent because the same alpha feeds both updates.
    """
    from multigrid_petsc_tpu.ops import twofloat as tf

    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]
    assert not lvl0.spec.is_composite, "mixed outer: simple fine level only"
    g0 = lvl0.spec.primary
    apply_tf, _ = outer_precision_operator_tf(ctx)

    inner_precond = _mg_precond(ctx, v0, v1)

    def precond(r: tf.TF) -> tf.TF:
        # hi is the correctly-rounded f32 view of the double-single value.
        z = inner_precond((r.hi.astype(ctx.dtype),))[0]
        return tf.from_f32(z.astype(jnp.float32))

    # b0 arrives evaluated in f64 (solve() does this); split exactly.
    b = tf.from_f64((ctx.b0 if b0 is None else b0)[0].astype(jnp.float64))
    bnorm = tf.norm2(b)
    hist_len = cfg.hist_len
    flexible = ctx.precond_ctx is not None  # see solve_mgcg

    if u0 is None:
        u = tf.from_f32(jnp.zeros(g0.shape, jnp.float32))
    else:
        u = tf.from_f64(u0[0].astype(jnp.float64))
    r = tf.sub(b, apply_tf(u))
    rn0 = tf.norm2(r)
    z = precond(r)
    p = z
    rz = tf.dot(r, z)
    hist = jnp.zeros(hist_len + 1, dtype=rn0.dtype).at[0].set(rn0)

    def cond(c):
        u, r, r_prev, p, rz, i, rn, hist = c
        return (
            (i < cfg.max_iter)
            & (cfg.divtol * bnorm > rn)
            & (rn > cfg.rtol * bnorm)
        )

    def body(c):
        u, r, r_prev, p, rz, i, rn, hist = c
        ap = apply_tf(p)
        alpha = rz / tf.dot(p, ap)
        u = tf.axpy(alpha, p, u)
        r_new = tf.axpy(-alpha, ap, r)
        rn = tf.norm2(r_new)
        z = precond(r_new)
        rz_new = tf.dot(r_new, z)
        if flexible:
            num = rz_new - tf.dot(r, z)
            beta = jnp.maximum(num / rz, 0.0)
        else:
            beta = rz_new / rz
        p = tf.axpy(beta, p, z)
        hist = hist.at[jnp.minimum(i + 1, hist_len)].set(rn)
        return (u, r_new, r, p, rz_new, i + 1, rn, hist)

    u, r, r_prev, p, rz, iters, rn, hist = jax.lax.while_loop(
        cond, body, (u, r, r, p, rz, 0, rn0, hist)
    )
    return OuterResult(
        u=(tf.to_f64(u),),
        rnorm_history=hist / hist[0],
        iters=iters,
        converged=rn <= cfg.rtol * bnorm,
    )


def solve_mgcg_mixed(
    ctx: MGContext, b0: State | None = None, u0=None
) -> OuterResult:
    """Mixed-precision mg-CG: f64 outer PCG, f32 MG V-cycle preconditioner.

    The CG iteration (operator applies, vector updates, inner products)
    runs entirely in ``outer_dtype`` — one f64 stencil apply per
    iteration — while the expensive preconditioner (the multigrid V-cycle)
    runs in the f32 working dtype.  A
    low-precision *preconditioner* only affects the convergence rate;
    attainable accuracy follows the f64 operator (~eps64 * kappa), so this
    certifies 1e-8 residuals even at 8193^2 where iterative-refinement
    structures stall (kappa * eps32 ~ 3 > 1 there — an f32 inner solve can
    no longer reduce the error).  The outer operator comes from the
    level's own problem family (``outer_precision_operator``), so the
    stretched-mesh and anisotropic 9-point configs certify the same way
    as uniform Poisson.  ``u0`` warm-starts the outer iteration.
    """
    cfg = ctx.config
    if cfg.outer_dtype == "float32x2":
        return _solve_mgcg_mixed_tf(ctx, b0, u0)
    odt = jnp.dtype(cfg.outer_dtype)
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]
    assert not lvl0.spec.is_composite, "mixed outer: simple fine level only"
    g0 = lvl0.spec.primary
    apply64, _ = outer_precision_operator(ctx, odt)

    inner_precond = _mg_precond(ctx, v0, v1)

    def precond(r64):
        return inner_precond((r64.astype(ctx.dtype),))[0].astype(odt)

    # NOTE: callers must supply b0 already evaluated in the outer dtype
    # (solve() does); upcasting an f32 RHS would bake an eps32*||b|| error
    # into the certified residual.
    b = (ctx.b0 if b0 is None else b0)[0].astype(odt)
    bnorm = jnp.linalg.norm(b.ravel())
    hist_len = cfg.hist_len

    flexible = ctx.precond_ctx is not None  # see solve_mgcg

    u = jnp.zeros(g0.shape, odt) if u0 is None else u0[0].astype(odt)
    r = b - apply64(u)
    rn0 = jnp.linalg.norm(r.ravel())
    z = precond(r)
    p = z
    rz = vdot(r.ravel(), z.ravel())
    hist = jnp.zeros(hist_len + 1, dtype=odt).at[0].set(rn0)

    def cond(c):
        u, r, r_prev, p, rz, i, rn, hist = c
        return (
            (i < cfg.max_iter)
            & (cfg.divtol * bnorm > rn)
            & (rn > cfg.rtol * bnorm)
        )

    def body(c):
        u, r, r_prev, p, rz, i, rn, hist = c
        ap = apply64(p)
        alpha = rz / vdot(p.ravel(), ap.ravel())
        u = u + alpha * p
        r_new = r - alpha * ap
        rn = jnp.linalg.norm(r_new.ravel())
        z = precond(r_new)
        rz_new = vdot(r_new.ravel(), z.ravel())
        if flexible:
            num = rz_new - vdot(r.ravel(), z.ravel())
            beta = jnp.maximum(num / rz, 0.0)
        else:
            beta = rz_new / rz
        p = z + beta * p
        hist = hist.at[jnp.minimum(i + 1, hist_len)].set(rn)
        return (u, r_new, r, p, rz_new, i + 1, rn, hist)

    u, r, r_prev, p, rz, iters, rn, hist = jax.lax.while_loop(
        cond, body, (u, r, r, p, rz, 0, rn0, hist)
    )
    return OuterResult(
        u=(u,),
        rnorm_history=hist / hist[0],
        iters=iters,
        converged=rn <= cfg.rtol * bnorm,
    )


def _flatten(state: State):
    return jnp.concatenate([x.ravel() for x in state])


def _unflatten(vec, shapes):
    out, off = [], 0
    for s in shapes:
        n = s[0] * s[1]
        out.append(vec[off : off + n].reshape(s))
        off += n
    return tuple(out)


def solve_mgfgmres(ctx: MGContext, b0: State | None = None,
                   restart: int | None = None) -> OuterResult:
    """Flexible GMRES(restart) with one V-cycle as the (right)
    preconditioner.  History records ||r|| once per restart block.

    The restart block is a single ``fori_loop`` over the Krylov steps with
    masked modified Gram-Schmidt and INCREMENTAL Givens rotations (no
    per-restart lstsq, no O(m^2) unrolled trace) — compile size is O(1)
    in ``restart``.  Memory is inherent to FGMRES(m): V (m+1 vectors) and
    Z (m preconditioned vectors) stay live; tune ``fgmres_restart`` down
    for very large grids.
    """
    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]
    shapes = lvl0.shapes
    m = restart if restart is not None else cfg.fgmres_restart
    b = ctx.b0 if b0 is None else b0
    hist_len = cfg.hist_len
    max_restarts = cfg.max_iter

    _precond = _mg_precond(ctx, v0, v1)

    def precond_flat(rflat):
        z = _precond(_unflatten(rflat, shapes))
        return _flatten(z)

    def apply_flat(xflat):
        return _flatten(lvl0.apply(_unflatten(xflat, shapes)))

    bflat = _flatten(b)
    n = bflat.shape[0]
    dtype = bflat.dtype
    bnorm = jnp.linalg.norm(bflat)
    u = jnp.zeros(n, dtype)
    r = bflat - apply_flat(u)
    rn0 = jnp.linalg.norm(r)
    hist = jnp.zeros(hist_len + 1, dtype=dtype).at[0].set(rn0)

    def restart_block(u):
        r = bflat - apply_flat(u)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype).at[0].set(
            r / jnp.where(beta > 0, beta, 1.0)
        )
        Z = jnp.zeros((m, n), dtype)
        R = jnp.zeros((m, m), dtype)  # triangularized Hessenberg
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def arnoldi(j, carry):
            V, Z, R, cs, sn, g = carry
            zj = precond_flat(V[j])
            w = apply_flat(zj)

            # Masked MGS: orthogonalize against V[i] for i <= j only.
            def mgs(i, wh):
                w, hcol = wh
                hij = jnp.where(i <= j, vdot(V[i], w), 0.0)
                return (w - hij * V[i], hcol.at[i].set(hij))

            w, hcol = jax.lax.fori_loop(
                0, m + 1, mgs, (w, jnp.zeros(m + 1, dtype))
            )
            hj1 = jnp.linalg.norm(w)
            hcol = hcol.at[j + 1].set(hj1)
            V = V.at[j + 1].set(w / jnp.where(hj1 > 0, hj1, 1.0))
            Z = Z.at[j].set(zj)

            # Apply the previous Givens rotations to the new column.
            def rot(i, hc):
                t1 = cs[i] * hc[i] + sn[i] * hc[i + 1]
                t2 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
                on = i < j
                return (hc.at[i].set(jnp.where(on, t1, hc[i]))
                          .at[i + 1].set(jnp.where(on, t2, hc[i + 1])))

            hcol = jax.lax.fori_loop(0, m, rot, hcol)
            # New rotation annihilating the subdiagonal entry.
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = jnp.where(denom > 0, hcol[j] / denom, 1.0)
            s = jnp.where(denom > 0, hcol[j + 1] / denom, 0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            hcol = hcol.at[j].set(c * hcol[j] + s * hcol[j + 1])
            R = R.at[:, j].set(hcol[:m])
            g = g.at[j + 1].set(-s * g[j])
            g = g.at[j].set(c * g[j])
            return (V, Z, R, cs, sn, g)

        V, Z, R, cs, sn, g = jax.lax.fori_loop(
            0, m, arnoldi, (V, Z, R, cs, sn, g)
        )
        # Back-substitution R y = g[:m] (R upper triangular by Givens; a
        # zero diagonal only occurs on exact breakdown = already converged,
        # where g's tail is zero too — guard the division).
        from jax.scipy.linalg import solve_triangular

        Rsafe = R + jnp.diag(jnp.where(jnp.abs(jnp.diag(R)) > 0, 0.0, 1.0))
        y = solve_triangular(Rsafe, g[:m], lower=False)
        # HIGHEST: an f32 product may otherwise run in TF32 on the GPU
        # (about three decimal digits).
        return u + jnp.matmul(Z.T, y, precision=jax.lax.Precision.HIGHEST)

    def cond(c):
        u, i, rn, hist = c
        return (i < max_restarts) & (cfg.divtol * bnorm > rn) & (rn > cfg.rtol * bnorm)

    def body(c):
        u, i, rn, hist = c
        u = restart_block(u)
        rn = jnp.linalg.norm(bflat - apply_flat(u))
        hist = hist.at[jnp.minimum(i + 1, hist_len)].set(rn)
        return (u, i + 1, rn, hist)

    u, iters, rn, hist = jax.lax.while_loop(cond, body, (u, 0, rn0, hist))
    return OuterResult(
        u=_unflatten(u, shapes),
        rnorm_history=hist / hist[0],
        iters=iters,
        converged=rn <= cfg.rtol * bnorm,
    )
