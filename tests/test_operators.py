"""The plain jnp operators — the path XLA compiles for every device —
against an independent host f64 reference.

The reference is the level matrix assembled on the host in f64
(``solvers.coarse.stencil_coo``, the assembly behind ``dense_from_stencil``)
in scipy.sparse form, with the smoothers, transfers and the two-grid cycle
written out again in numpy.  Shapes include non-square and non-power-of-two
grids; sweeps 1/3/5; Jacobi and Chebyshev; 5- and 9-point; zero-guess and
emitted-residual visit variants.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg)

from multigrid_petsc_tpu.mesh import MeshType
from multigrid_petsc_tpu.ops.stencil import (
    Stencil9,
    apply_stencil5,
    apply_stencil9,
    jacobi_sweeps,
    residual,
    sor_redblack_sweeps,
)
from multigrid_petsc_tpu.problems import stencil_coefficients
from multigrid_petsc_tpu.solvers import smoothers as sm
from multigrid_petsc_tpu.solvers.coarse import stencil_coo
from multigrid_petsc_tpu.solvers.context import build_context
from multigrid_petsc_tpu.utils.config import CycleType, SmootherType, SolverConfig

CASES = [(63, 63), (100, 63), (127, 31), (257, 129)]
MESHES = [MeshType.UNIFORM, MeshType.NONUNIFORM1, MeshType.NONUNIFORM2]


# --------------------------------------------------------------------------
# Host f64 reference
# --------------------------------------------------------------------------


def host_matrix(st, ny, nx):
    r, c, v = stencil_coo(st, ny, nx)
    return sp.csr_matrix((v, (r, c)), shape=(ny * nx, ny * nx))


def host_diag(st, ny, nx):
    return np.broadcast_to(np.asarray(st.cc, np.float64), (ny, nx)).ravel()


def host_steps(a, d, b, u, steps):
    """The polynomial smoother z = D^-1 (b - A u); p = beta p + alpha z;
    u += p, on flattened f64 vectors."""
    u = u.copy()
    p = np.zeros_like(u)
    for alpha, beta in steps:
        p = beta * p + alpha * (b - a @ u) / d
        u = u + p
    return u


def host_jacobi_steps(sweeps, omega=0.8):
    return [(omega, 0.0)] * sweeps


def host_chebyshev_steps(sweeps, lmax, lo_frac=0.1, hi_scale=1.05):
    """Chebyshev on [lo_frac lmax, hi_scale lmax] written from the
    three-term recurrence (Saad, Iterative Methods, alg. 12.1)."""
    lo, hi = lo_frac * lmax, hi_scale * lmax
    theta, delta = (hi + lo) / 2, (hi - lo) / 2
    sigma = theta / delta
    steps = [(1 / theta, 0.0)]
    rho = 1 / sigma
    for _ in range(sweeps - 1):
        rho_new = 1 / (2 * sigma - rho)
        steps.append((2 * rho_new / delta, rho * rho_new))
        rho = rho_new
    return steps


_W = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0])


def host_restrict(r):
    """Full weighting (2n+1, 2m+1) -> (n, m), written as a 3x3 sum."""
    n, m = (r.shape[0] - 1) // 2, (r.shape[1] - 1) // 2
    out = np.zeros((n, m))
    for a in range(3):
        for b in range(3):
            out += _W[a, b] / 16 * r[a:a + 2 * n:2, b:b + 2 * m:2]
    return out


def host_prolong(e):
    """Bilinear prolongation (n, m) -> (2n+1, 2m+1) = 4 R^T."""
    n, m = e.shape
    out = np.zeros((2 * n + 1, 2 * m + 1))
    for a in range(3):
        for b in range(3):
            out[a:a + 2 * n:2, b:b + 2 * m:2] += _W[a, b] / 4 * e
    return out


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, ref, rtol=1e-12):
    got = np.asarray(got, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= rtol * scale


def _aniso_st9(ny, nx):
    from multigrid_petsc_tpu.problems import AnisoProblem, stencil9_coefficients

    return stencil9_coefficients(AnisoProblem(1.0, 0.5, 100.0), ny, nx)


def _rand_st9(ny, nx):
    """Fully variable 9-point stencil with a dominant center."""
    rng = np.random.default_rng(ny * nx)
    f = [jnp.asarray(rng.standard_normal((ny, nx))) for _ in range(8)]
    cc = -(8.0 + jnp.asarray(rng.random((ny, nx))) * 4.0)
    return Stencil9(csw=f[0], cs=f[1], cse=f[2], cw=f[3], cc=cc, ce=f[4],
                    cnw=f[5], cn=f[6], cne=f[7])


# --------------------------------------------------------------------------
# Stencil applies, residual, sweeps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", CASES)
def test_apply5_matches_host(shape, mesh):
    ny, nx = shape
    st = stencil_coefficients(mesh, ny, nx)
    u = _rand(shape, ny + nx)
    _close(apply_stencil5(st, jnp.asarray(u)), host_matrix(st, ny, nx) @ u.ravel())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", CASES)
def test_residual5_matches_host(shape, mesh):
    ny, nx = shape
    st = stencil_coefficients(mesh, ny, nx)
    u, b = _rand(shape, 1), _rand(shape, 2)
    ref = b.ravel() - host_matrix(st, ny, nx) @ u.ravel()
    _close(residual(st, jnp.asarray(b), jnp.asarray(u)), ref)


@pytest.mark.parametrize("impl", ["ops", "solvers"])
@pytest.mark.parametrize("sweeps", [1, 3, 5])
@pytest.mark.parametrize("shape", CASES)
def test_jacobi_matches_host(shape, sweeps, impl):
    ny, nx = shape
    st = stencil_coefficients(MeshType.NONUNIFORM1, ny, nx)
    u, b = _rand(shape, sweeps), _rand(shape, nx)
    if impl == "ops":
        got = jacobi_sweeps(st, jnp.asarray(b), jnp.asarray(u), sweeps, 0.8)
    else:
        got = sm.jacobi(lambda s: (apply_stencil5(st, s[0]),),
                        (1.0 / st.cc,), (jnp.asarray(b),), (jnp.asarray(u),),
                        sweeps, 0.8)[0]
    ref = host_steps(host_matrix(st, ny, nx), host_diag(st, ny, nx),
                     b.ravel(), u.ravel(), host_jacobi_steps(sweeps))
    _close(got, ref)


@pytest.mark.parametrize("sweeps", [1, 3, 5])
@pytest.mark.parametrize("shape", CASES)
def test_chebyshev_matches_host(shape, sweeps):
    ny, nx = shape
    st = stencil_coefficients(MeshType.NONUNIFORM2, ny, nx)
    u, b = _rand(shape, sweeps + 7), _rand(shape, ny)
    got = sm.chebyshev(lambda s: (apply_stencil5(st, s[0]),), (1.0 / st.cc,),
                       (jnp.asarray(b),), (jnp.asarray(u),), sweeps, 1.9)[0]
    ref = host_steps(host_matrix(st, ny, nx), host_diag(st, ny, nx),
                     b.ravel(), u.ravel(), host_chebyshev_steps(sweeps, 1.9))
    _close(got, ref)


@pytest.mark.parametrize("sweeps", [1, 2, 3, 4, 5])
def test_step_coeffs_match_host(sweeps):
    """The (alpha, beta) schedules the CUDA smoother runs."""
    np.testing.assert_allclose(sm.chebyshev_step_coeffs(sweeps, 1.7),
                               host_chebyshev_steps(sweeps, 1.7), rtol=1e-15)
    assert sm.jacobi_step_coeffs(sweeps, 0.7) == tuple(
        host_jacobi_steps(sweeps, 0.7))


@pytest.mark.parametrize("shape", CASES)
def test_red_black_matches_host(shape):
    ny, nx = shape
    st = stencil_coefficients(MeshType.NONUNIFORM1, ny, nx)
    u, b = _rand(shape, 5), _rand(shape, 6)
    a, d = host_matrix(st, ny, nx), host_diag(st, ny, nx)
    ii, jj = np.mgrid[0:ny, 0:nx]
    red = ((ii + jj) % 2 == 0).ravel()
    x = u.ravel().copy()
    for _ in range(2):
        for mask in (red, ~red):
            x = np.where(mask, x + (b.ravel() - a @ x) / d, x)
    got = sor_redblack_sweeps(st, jnp.asarray(b), jnp.asarray(u), 2, 1.0)
    _close(got, x)


@pytest.mark.parametrize("make", [_aniso_st9, _rand_st9])
@pytest.mark.parametrize("shape", CASES[:3])
def test_apply9_matches_host(shape, make):
    ny, nx = shape
    st = make(ny, nx)
    u = _rand(shape, 3)
    _close(apply_stencil9(st, jnp.asarray(u)), host_matrix(st, ny, nx) @ u.ravel())


@pytest.mark.parametrize("kind", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("sweeps", [1, 3])
@pytest.mark.parametrize("shape", CASES[:3])
def test_smooth9_matches_host(shape, sweeps, kind):
    ny, nx = shape
    st = _aniso_st9(ny, nx) if kind == "jacobi" else _rand_st9(ny, nx)
    u, b = _rand(shape, 8), _rand(shape, 9)
    apply = lambda s: (apply_stencil9(st, s[0]),)
    dinv = (1.0 / st.cc,)
    if kind == "jacobi":
        got = sm.jacobi(apply, dinv, (jnp.asarray(b),), (jnp.asarray(u),),
                        sweeps, 0.8)[0]
        steps = host_jacobi_steps(sweeps)
    else:
        got = sm.chebyshev(apply, dinv, (jnp.asarray(b),),
                           (jnp.asarray(u),), sweeps, 1.9)[0]
        steps = host_chebyshev_steps(sweeps, 1.9)
    ref = host_steps(host_matrix(st, ny, nx), host_diag(st, ny, nx),
                     b.ravel(), u.ravel(), steps)
    _close(got, ref)


# --------------------------------------------------------------------------
# Level visits as build_context wires them
# --------------------------------------------------------------------------


def _level0(npts, **kw):
    cfg = SolverConfig(npts=npts, grids=3, levels=3, mesh=2, **kw)
    ctx = build_context(cfg)
    lvl = ctx.levels[0]
    return ctx, lvl, lvl.stencils[0], lvl.spec.primary.shape


def _visit_steps(ctx, lvl, sweeps):
    if ctx.config.smoother == SmootherType.CHEBYSHEV:
        return host_chebyshev_steps(sweeps, lvl.lmax)
    return host_jacobi_steps(sweeps, ctx.config.omega)


@pytest.mark.parametrize("zero_guess", [False, True])
@pytest.mark.parametrize("sweeps", [1, 3])
@pytest.mark.parametrize("npts", [65, 129, 257])
def test_visit_down_matches_host(npts, sweeps, zero_guess):
    """(u', restrict_fw(b - A u')) of the down visit."""
    ctx, lvl, st, (ny, nx) = _level0(npts)
    u = np.zeros((ny, nx)) if zero_guess else _rand((ny, nx), npts)
    b = _rand((ny, nx), sweeps)
    a = host_matrix(st, ny, nx)
    u_ref = host_steps(a, host_diag(st, ny, nx), b.ravel(), u.ravel(),
                       _visit_steps(ctx, lvl, sweeps))
    rc_ref = host_restrict((b.ravel() - a @ u_ref).reshape(ny, nx))
    u_got, rc_got = lvl.visit_down(
        (jnp.asarray(b),), None if zero_guess else (jnp.asarray(u),), sweeps)
    _close(u_got[0], u_ref)
    _close(rc_got, rc_ref)


@pytest.mark.parametrize("emit_r", [False, True])
@pytest.mark.parametrize("sweeps", [1, 3])
@pytest.mark.parametrize("npts", [65, 129, 257])
def test_visit_up_matches_host(npts, sweeps, emit_r):
    """u'' = smooth(b, u + P e) (and b - A u'') of the up visit."""
    ctx, lvl, st, (ny, nx) = _level0(npts)
    u, b = _rand((ny, nx), 1), _rand((ny, nx), 2)
    e = _rand(((ny - 1) // 2, (nx - 1) // 2), 3)
    a = host_matrix(st, ny, nx)
    u_ref = host_steps(a, host_diag(st, ny, nx), b.ravel(),
                       (u + host_prolong(e)).ravel(),
                       _visit_steps(ctx, lvl, sweeps))
    out = lvl.visit_up((jnp.asarray(b),), (jnp.asarray(u),), jnp.asarray(e),
                       sweeps, emit_r)
    if emit_r:
        out, r = out
        _close(r[0], b.ravel() - a @ u_ref)
    _close(out[0], u_ref)


@pytest.mark.parametrize("sweeps", [2, 4])
@pytest.mark.parametrize("npts", [65, 129])
def test_visit_chebyshev_matches_host(npts, sweeps):
    ctx, lvl, st, (ny, nx) = _level0(npts, smoother=SmootherType.CHEBYSHEV)
    b = _rand((ny, nx), 4)
    a = host_matrix(st, ny, nx)
    u_ref = host_steps(a, host_diag(st, ny, nx), b.ravel(), np.zeros(ny * nx),
                       _visit_steps(ctx, lvl, sweeps))
    u_got, rc_got = lvl.visit_down((jnp.asarray(b),), None, sweeps)
    _close(u_got[0], u_ref)
    _close(rc_got, host_restrict((b.ravel() - a @ u_ref).reshape(ny, nx)))


def _aniso_level0(npts):
    cfg = SolverConfig(npts=npts, grids=3, levels=3, problem="aniso",
                       aniso=(1.0, 0.5, 50.0, 0.0, 0.2))
    lvl = build_context(cfg).levels[0]
    return lvl, lvl.stencils[0], lvl.spec.primary.shape


@pytest.mark.parametrize("zero_guess", [False, True])
@pytest.mark.parametrize("sweeps", [1, 3])
@pytest.mark.parametrize("npts", [65, 129, 257])
def test_visit_down9_matches_host(npts, sweeps, zero_guess):
    lvl, st, (ny, nx) = _aniso_level0(npts)
    u = np.zeros((ny, nx)) if zero_guess else _rand((ny, nx), 5)
    b = _rand((ny, nx), 6)
    a = host_matrix(st, ny, nx)
    u_ref = host_steps(a, host_diag(st, ny, nx), b.ravel(), u.ravel(),
                       host_jacobi_steps(sweeps))
    u_got, rc_got = lvl.visit_down(
        (jnp.asarray(b),), None if zero_guess else (jnp.asarray(u),), sweeps)
    _close(u_got[0], u_ref)
    _close(rc_got, host_restrict((b.ravel() - a @ u_ref).reshape(ny, nx)))


@pytest.mark.parametrize("emit_r", [False, True])
@pytest.mark.parametrize("sweeps", [1, 3])
@pytest.mark.parametrize("npts", [65, 257])
def test_visit_up9_matches_host(npts, sweeps, emit_r):
    lvl, st, (ny, nx) = _aniso_level0(npts)
    u, b = _rand((ny, nx), 7), _rand((ny, nx), 8)
    e = _rand(((ny - 1) // 2, (nx - 1) // 2), 9)
    a = host_matrix(st, ny, nx)
    u_ref = host_steps(a, host_diag(st, ny, nx), b.ravel(),
                       (u + host_prolong(e)).ravel(),
                       host_jacobi_steps(sweeps))
    out = lvl.visit_up((jnp.asarray(b),), (jnp.asarray(u),), jnp.asarray(e),
                       sweeps, emit_r)
    if emit_r:
        out, r = out
        _close(r[0], b.ravel() - a @ u_ref)
    _close(out[0], u_ref)


# --------------------------------------------------------------------------
# The multigrid step and the mg-CG solve
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sweeps", [1, 3])
@pytest.mark.parametrize("npts", [33, 65])
def test_two_grid_cycle_matches_host(npts, sweeps):
    """One V-cycle on two levels with the direct coarse solve, against a
    host two-grid cycle: pre-smooth, restrict, coarse solve, prolong,
    post-smooth."""
    from multigrid_petsc_tpu.solvers.vcycle import v_cycle

    cfg = SolverConfig(npts=npts, grids=2, levels=2, mesh=1, v=(sweeps, 1))
    ctx = build_context(cfg)
    (ny, nx), (nyc, nxc) = (l.spec.primary.shape for l in ctx.levels)
    st, stc = (l.stencils[0] for l in ctx.levels)
    a, ac = host_matrix(st, ny, nx), host_matrix(stc, nyc, nxc)
    d = host_diag(st, ny, nx)
    b, u = _rand((ny, nx), 10), _rand((ny, nx), 11)
    steps = host_jacobi_steps(sweeps, cfg.omega)
    x = host_steps(a, d, b.ravel(), u.ravel(), steps)
    rc = host_restrict((b.ravel() - a @ x).reshape(ny, nx))
    ec = sp.linalg.spsolve(ac.tocsc(), rc.ravel()).reshape(nyc, nxc)
    x = host_steps(a, d, b.ravel(), x + host_prolong(ec).ravel(), steps)
    got = v_cycle(ctx, (jnp.asarray(b),), (jnp.asarray(u),), sweeps, 1)
    _close(got[0], x, rtol=1e-10)


@pytest.mark.parametrize("smoother", [SmootherType.JACOBI,
                                      SmootherType.CHEBYSHEV])
@pytest.mark.parametrize("npts", [65, 129])
def test_mgcg_matches_host_direct(npts, smoother):
    """mg-CG to 1e-10 equals the host sparse direct solve."""
    from multigrid_petsc_tpu.problems import poisson_sin_problem, rhs_grid
    from multigrid_petsc_tpu.solvers.solve import solve

    cfg = SolverConfig(npts=npts, grids=4, levels=4, mesh=1,
                       cycle=CycleType.MGCG, smoother=smoother, rtol=1e-10)
    res = solve(cfg)
    n = npts - 2
    st = stencil_coefficients(MeshType.NONUNIFORM1, n, n)
    b = np.asarray(rhs_grid(poisson_sin_problem(), MeshType.NONUNIFORM1, n,
                            n, jnp.float64)).ravel()
    ref = sp.linalg.spsolve(host_matrix(st, n, n).tocsc(), b)
    assert res.converged and res.path == "generic"
    _close(res.u_fine, ref, rtol=1e-8)


@pytest.mark.parametrize("iters", [1, 2])
def test_mgcg_iterates_match_host_pcg(iters):
    """The first mg-CG iterates against host PCG whose preconditioner is
    the host two-grid cycle (zero initial guess)."""
    from multigrid_petsc_tpu.solvers.krylov import solve_mgcg

    cfg = SolverConfig(npts=33, grids=2, levels=2, cycle=CycleType.MGCG,
                       rtol=1e-30, max_iter=iters)
    ctx = build_context(cfg)
    (ny, nx), (nyc, nxc) = (l.spec.primary.shape for l in ctx.levels)
    st, stc = (l.stencils[0] for l in ctx.levels)
    a, ac = host_matrix(st, ny, nx), host_matrix(stc, nyc, nxc)
    d = host_diag(st, ny, nx)
    steps = host_jacobi_steps(cfg.v[0], cfg.omega)

    def m(r):
        x = host_steps(a, d, r, np.zeros_like(r), steps)
        rc = host_restrict((r - a @ x).reshape(ny, nx))
        ec = sp.linalg.spsolve(ac.tocsc(), rc.ravel()).reshape(nyc, nxc)
        return host_steps(a, d, r, x + host_prolong(ec).ravel(), steps)

    b = np.asarray(ctx.b0[0]).ravel()
    x, r = np.zeros_like(b), b.copy()
    z = m(r)
    p, rz = z, r @ z
    for _ in range(iters):
        ap = a @ p
        alpha = rz / (p @ ap)
        x, r = x + alpha * p, r - alpha * ap
        z = m(r)
        rz, rz_old = r @ z, rz
        p = z + rz / rz_old * p
    got = solve_mgcg(ctx)
    assert int(got.iters) == iters
    _close(got.u[0], x, rtol=1e-9)


def test_precond_dtype_config_builds_second_hierarchy():
    cfg = SolverConfig(npts=65, grids=3, levels=3, cycle=CycleType.MGCG,
                       dtype="float32", precond_dtype="bfloat16")
    ctx = build_context(cfg)
    assert ctx.precond_ctx is not None
    assert [l.shapes for l in ctx.precond_ctx.levels] == [
        l.shapes for l in ctx.levels]
    assert dataclasses.replace(cfg, precond_dtype=None).precond_dtype is None
