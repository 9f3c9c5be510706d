"""Anisotropic / variable-coefficient 9-point family + line smoothers
(BASELINE.md config 4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_petsc_tpu.ops.stencil import (
    Stencil9,
    apply_stencil9,
    line_jacobi_sweeps_x,
    line_jacobi_sweeps_y,
    pcr_factor,
    pcr_solve,
    thomas_tridiagonal,
)
from multigrid_petsc_tpu.problems import (
    AnisoProblem,
    aniso_exact_grid,
    aniso_rhs_grid,
    stencil9_coefficients,
)
from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils.config import CycleType, SmootherType, SolverConfig


def test_thomas_matches_dense():
    rng = np.random.default_rng(0)
    n, m = 17, 5
    d = jnp.asarray(rng.uniform(3, 4, (n, m)))
    dl = jnp.asarray(rng.standard_normal((n, m)))
    du = jnp.asarray(rng.standard_normal((n, m)))
    rhs = jnp.asarray(rng.standard_normal((n, m)))
    x = np.asarray(thomas_tridiagonal(dl, d, du, rhs))
    for j in range(m):
        a = np.diag(np.asarray(d[:, j]))
        a += np.diag(np.asarray(dl[1:, j]), -1)
        a += np.diag(np.asarray(du[:-1, j]), 1)
        expect = np.linalg.solve(a, np.asarray(rhs[:, j]))
        np.testing.assert_allclose(x[:, j], expect, rtol=1e-10)


@pytest.mark.parametrize("n", [2, 3, 17, 64, 127])
def test_pcr_matches_thomas(n):
    """PCR (the vectorized line solve on the smoother hot path) solves the
    same diagonally dominant systems as the sequential Thomas scan."""
    rng = np.random.default_rng(n)
    m = 5
    d = jnp.asarray(rng.uniform(3, 4, (n, m)))
    dl = jnp.asarray(rng.standard_normal((n, m)))
    du = jnp.asarray(rng.standard_normal((n, m)))
    rhs = jnp.asarray(rng.standard_normal((n, m)))
    expect = np.asarray(thomas_tridiagonal(dl, d, du, rhs))
    got = np.asarray(pcr_solve(pcr_factor(dl, d, du, n), rhs))
    np.testing.assert_allclose(got, expect, rtol=1e-9, atol=1e-12)


def test_pcr_broadcast_coefficients():
    """(n, 1) / scalar coefficient widths factor at their own width and
    broadcast against a full-width RHS (the stretched-mesh line systems)."""
    n, m = 33, 7
    rng = np.random.default_rng(1)
    d = jnp.asarray(rng.uniform(3, 4, (n, 1)))
    dl, du = jnp.asarray(-1.0), jnp.asarray(-1.0)
    rhs = jnp.asarray(rng.standard_normal((n, m)))
    fac = pcr_factor(dl, d, du, n)
    assert fac.dinv.shape == (n, 1)
    expect = np.asarray(thomas_tridiagonal(
        jnp.broadcast_to(dl, (n, m)), jnp.broadcast_to(d, (n, m)),
        jnp.broadcast_to(du, (n, m)), rhs))
    np.testing.assert_allclose(np.asarray(pcr_solve(fac, rhs)), expect,
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize(
    "prob",
    [
        AnisoProblem(),  # plain Poisson as 9-pt
        AnisoProblem(ax0=0.05),  # strong anisotropy
        AnisoProblem(ax2=1.0, cy2=2.0),  # variable coefficients
        AnisoProblem(b=0.3),  # mixed derivative
    ],
)
def test_stencil9_truncation(prob):
    errs = []
    for n in (31, 63):
        st = stencil9_coefficients(prob, n, n)
        u = aniso_exact_grid(prob, n, n)
        f = aniso_rhs_grid(prob, n, n)
        r = np.asarray(apply_stencil9(st, u) - f)[1:-1, 1:-1]
        errs.append(np.max(np.abs(r)))
    assert errs[1] < errs[0] / 3.0  # 2nd order


def test_line_smoother_beats_point_on_anisotropic():
    """eps u_xx + u_yy with eps << 1: y-line smoothing restores textbook
    MG convergence where point Jacobi stalls."""
    base = dict(npts=65, grids=4, levels=4, max_iter=60,
                problem="aniso", aniso=(0.02, 0.0, 1.0, 0.0, 0.0))
    line = solve(SolverConfig(**base, smoother=SmootherType.LINE_Y,
                              omega=0.7))
    assert line.converged
    assert line.iters <= 8  # textbook rate with damped line relaxation
    point = solve(SolverConfig(**base, smoother=SmootherType.JACOBI))
    assert line.iters < point.iters  # point smoothing degrades


def test_variable_coefficient_mgcg():
    cfg = SolverConfig(npts=65, grids=4, levels=4, cycle=CycleType.MGCG,
                       problem="aniso", aniso=(1.0, 1.0, 1.0, 2.0, 0.0),
                       max_iter=40)
    res = solve(cfg)
    assert res.converged
    ue = np.asarray(aniso_exact_grid(res.ctx.problem, 63, 63))
    assert np.max(np.abs(res.u_fine - ue)) < 4.0 / 64 / 64


def test_mixed_term_converges():
    cfg = SolverConfig(npts=33, grids=3, levels=3, cycle=CycleType.MGFGMRES,
                       problem="aniso", aniso=(1.0, 0.0, 1.0, 0.0, 0.4),
                       max_iter=60)
    res = solve(cfg)
    assert res.converged
    ue = np.asarray(aniso_exact_grid(res.ctx.problem, 31, 31))
    assert np.max(np.abs(res.u_fine - ue)) < 8.0 / 32 / 32


def test_alternating_line_smoother():
    cfg = SolverConfig(npts=33, grids=3, levels=3,
                       problem="aniso", aniso=(0.1, 0.0, 1.0, 0.0, 0.0),
                       smoother=SmootherType.LINE_XY, omega=0.7, max_iter=40)
    res = solve(cfg)
    assert res.converged
    assert res.iters <= 12


def test_mixed_precision_outer_aniso():
    """BASELINE config-4 closure: the anisotropic 9-point operator
    certifies a true f64 residual <= 1e-8 with the f32 inner MG — the
    f64 defect-correction outer now routes through the level's own
    problem family instead of a hand-built Poisson stencil."""
    cfg = SolverConfig(
        npts=65, grids=4, levels=4, cycle=CycleType.MGCG, dtype="float32",
        problem="aniso", aniso=(0.05, 0.0, 1.0, 0.0, 0.0),
        smoother=SmootherType.LINE_Y, omega=0.7,
        outer_dtype="float64", rtol=1e-9, max_iter=40,
    )
    res = solve(cfg)
    assert res.converged
    assert res.u_fine.dtype == np.float64
    prob = res.ctx.problem
    st = stencil9_coefficients(prob, 63, 63, jnp.float64)
    b = aniso_rhs_grid(prob, 63, 63, jnp.float64)
    true_rel = float(
        np.linalg.norm(
            np.asarray(b - apply_stencil9(st, jnp.asarray(res.u_fine)))
        )
        / np.linalg.norm(np.asarray(b))
    )
    assert true_rel < 1e-8


def test_mixed_precision_outer_stretched_mesh():
    """Stretched-mesh (NONUNIFORM2) 5-pt operator certifies through the
    same generalized mixed-precision outer."""
    from multigrid_petsc_tpu.mesh import MeshType
    from multigrid_petsc_tpu.ops.stencil import apply_stencil5
    from multigrid_petsc_tpu.problems import (
        poisson_sin_problem, rhs_grid, stencil_coefficients,
    )

    cfg = SolverConfig(
        npts=65, grids=4, levels=4, cycle=CycleType.MGCG, dtype="float32",
        mesh=2, outer_dtype="float64", rtol=1e-9, max_iter=40,
    )
    res = solve(cfg)
    assert res.converged
    st = stencil_coefficients(MeshType.NONUNIFORM2, 63, 63, jnp.float64)
    b = rhs_grid(poisson_sin_problem(), MeshType.NONUNIFORM2, 63, 63,
                 jnp.float64)
    true_rel = float(
        np.linalg.norm(
            np.asarray(b - apply_stencil5(st, jnp.asarray(res.u_fine)))
        )
        / np.linalg.norm(np.asarray(b))
    )
    assert true_rel < 1e-8


def test_mixed_precision_warm_start():
    """Checkpoint-resume composes with the mixed-precision outer: the
    defect-correction loop warm-starts from u0 directly."""
    import dataclasses

    base = SolverConfig(
        npts=65, grids=4, levels=4, cycle=CycleType.MGCG, dtype="float32",
        outer_dtype="float64", rtol=1e-10, max_iter=30,
    )
    full = solve(base)
    assert full.converged

    part = solve(dataclasses.replace(base, max_iter=2))
    assert not part.converged
    resumed = solve(base, u0=part.u)
    assert resumed.converged
    assert resumed.iters < full.iters
    np.testing.assert_allclose(resumed.u_fine, full.u_fine,
                               rtol=1e-8, atol=1e-12)
