"""Convergence tests: V-cycle, FMG, Krylov — SURVEY.md section 4 tiers 1-3.

* manufactured-solution h^2 error under refinement (the reference's
  implicit correctness oracle, src/solver.c:1211-1237),
* grid-independent MG contraction rate,
* differential test: plain V-cycle vs MG-preconditioned Richardson
  (the reference's PCMG cross-check role, src/solver.c:1884-1989).
"""

import numpy as np
import pytest

from multigrid_petsc_tpu.mesh import MeshType
from multigrid_petsc_tpu.postprocess import error_norms
from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils.config import CycleType, SmootherType, SolverConfig


def _cfg(**kw):
    base = dict(npts=17, grids=2, levels=2, max_iter=100, cycle=CycleType.VCYCLE)
    base.update(kw)
    return SolverConfig(**base)


def test_vcycle_poisson_in_baseline():
    """The reference's shipped config: 17^2, 2 grids/2 levels, V(3,3)."""
    res = solve(_cfg())
    assert res.converged
    assert res.rnorm[-1] <= 1e-7
    # Textbook MG: converge in a handful of cycles.
    assert res.iters < 25
    errs = error_norms(res.ctx.problem, MeshType.UNIFORM, res.u_fine)
    # Discretization error ~ C h^2 with h=1/16 for the sin*sin problem.
    assert errs[0] < 5e-3


@pytest.mark.parametrize("npts", [33, 65])
def test_h2_error_convergence(npts):
    levels = 4
    res = solve(_cfg(npts=npts, grids=levels, levels=levels))
    assert res.converged
    errs = error_norms(res.ctx.problem, MeshType.UNIFORM, res.u_fine)
    h = 1.0 / (npts - 1)
    # max error of the 2nd-order scheme for sin*sin: ~ (pi^2/12) h^2 pi^2...
    # just assert the h^2 trend with a generous constant.
    assert errs[0] < 4.0 * h * h


def test_grid_independent_rate():
    iters = []
    for npts in (33, 65, 129):
        levels = 4
        res = solve(_cfg(npts=npts, grids=levels, levels=levels))
        assert res.converged
        iters.append(res.iters)
    # Iteration count must not blow up with refinement.
    assert max(iters) <= min(iters) + 3


@pytest.mark.parametrize("mesh", [1, 2])
def test_stretched_mesh_converges(mesh):
    res = solve(_cfg(npts=33, grids=3, levels=3, mesh=mesh, max_iter=300))
    assert res.converged
    errs = error_norms(res.ctx.problem, MeshType(mesh), res.u_fine)
    assert errs[0] < 2e-2


def test_chebyshev_smoother():
    res = solve(_cfg(npts=65, grids=4, levels=4,
                     smoother=SmootherType.CHEBYSHEV, v=(4, 4)))
    assert res.converged
    assert res.iters < 20


def test_vcycle_vs_mg_richardson_differential():
    """Linear smoothers make V-cycle iteration == MG-preconditioned
    Richardson; the two independent drivers must match closely."""
    r1 = solve(_cfg(npts=33, grids=3, levels=3))
    r2 = solve(_cfg(npts=33, grids=3, levels=3, cycle=CycleType.PCMG))
    assert r1.iters == r2.iters
    # Algebraically identical; floating-point op order differs slightly.
    np.testing.assert_allclose(r1.rnorm, r2.rnorm, rtol=1e-5)
    np.testing.assert_allclose(r1.u_fine, r2.u_fine, rtol=1e-6, atol=1e-10)


def test_mgcg():
    res = solve(_cfg(npts=129, grids=4, levels=4, cycle=CycleType.MGCG))
    assert res.converged
    assert res.iters <= 10  # mg-CG should crush Poisson in a few iterations
    errs = error_norms(res.ctx.problem, MeshType.UNIFORM, res.u_fine)
    assert errs[0] < 4.0 / 128 / 128


def test_mgfgmres():
    res = solve(_cfg(npts=65, grids=3, levels=3, cycle=CycleType.MGFGMRES))
    assert res.converged
    errs = error_norms(res.ctx.problem, MeshType.UNIFORM, res.u_fine)
    assert errs[0] < 4.0 / 64 / 64


def test_fmg():
    res = solve(_cfg(npts=65, grids=4, levels=4, cycle=CycleType.FMG))
    assert res.converged
    # FMG start should cut iterations vs cold-start V-cycles.
    cold = solve(_cfg(npts=65, grids=4, levels=4))
    assert res.iters <= cold.iters


def test_rnorm_history_semantics():
    res = solve(_cfg())
    assert res.rnorm[0] == 1.0  # normalized by first entry
    assert len(res.rnorm) == res.iters + 1
    assert np.all(res.rnorm[:-1] > res.rnorm[-1])  # monotone-ish decline


def test_mixed_precision_outer():
    """f32 MG + f64 defect-correction outer: certifies residuals far below
    the f32 floor (the path to BASELINE's 1e-8)."""
    import jax.numpy as jnp
    from multigrid_petsc_tpu.ops.stencil import apply_stencil5
    from multigrid_petsc_tpu.problems import (
        rhs_grid, stencil_coefficients, poisson_sin_problem,
    )

    cfg = _cfg(npts=129, grids=5, levels=5, cycle=CycleType.MGCG,
               dtype="float32", max_iter=20)
    import dataclasses
    cfg = dataclasses.replace(cfg, outer_dtype="float64", rtol=1e-10)
    res = solve(cfg)
    assert res.converged
    assert res.u_fine.dtype == np.float64
    # Certify with an independent f64 residual computation.
    st = stencil_coefficients(MeshType.UNIFORM, 127, 127, jnp.float64)
    b = rhs_grid(poisson_sin_problem(), MeshType.UNIFORM, 127, 127, jnp.float64)
    true_rel = float(
        np.linalg.norm(np.asarray(b - apply_stencil5(st, jnp.asarray(res.u_fine))))
        / np.linalg.norm(np.asarray(b))
    )
    assert true_rel < 1e-10


def test_rbgs_smoother():
    from multigrid_petsc_tpu.utils.config import SmootherType
    res = solve(_cfg(npts=65, grids=4, levels=4,
                     smoother=SmootherType.RBGS, omega=1.0))
    assert res.converged
    assert res.iters <= 8  # RB-GS smooths better than damped Jacobi


def test_profiling_and_views():
    from multigrid_petsc_tpu.hierarchy import build_hierarchy
    from multigrid_petsc_tpu.solvers.context import build_context
    from multigrid_petsc_tpu.utils import profiling, views

    cfg = _cfg(npts=33, grids=3, levels=3)
    ctx = build_context(cfg)
    t = profiling.phase_breakdown(ctx, reps=2)
    assert set(t) == {"smooth_v", "residual", "restrict", "prolong", "norm"}
    assert all(v > 0 for v in t.values())
    s = views.view_hierarchy(build_hierarchy(33, 3, 3))
    assert "level 0" in s and "level 2" in s
    s = views.view_mesh(MeshType.NONUNIFORM2, 9)
    assert "max spacing" in s
    s = views.view_transfer_operators(2)
    assert "gap 2" in s
    s = views.view_operator(ctx, 0, max_rows=2)
    assert "nnz" in s


def test_gather_solution():
    from multigrid_petsc_tpu.parallel.gather import gather_solution
    res = solve(_cfg())
    g = gather_solution(res.u)
    assert g.shape == (15, 15)


def test_checkpoint_resume():
    """Save after a truncated solve, resume via warm start, land at the
    same solution as an uninterrupted solve."""
    import tempfile, os
    from multigrid_petsc_tpu.utils import checkpoint

    cfg_full = _cfg(npts=33, grids=3, levels=3)
    full = solve(cfg_full)

    cfg_part = _cfg(npts=33, grids=3, levels=3, max_iter=2)
    part = solve(cfg_part)
    assert not part.converged
    path = os.path.join(tempfile.mkdtemp(), "ck.npz")
    checkpoint.save(path, cfg_part, part.u, part.rnorm, part.iters)

    u0, rnorm, iters = checkpoint.load(path, cfg_part)
    assert iters == 2
    resumed = solve(cfg_full, u0=u0)
    assert resumed.converged
    np.testing.assert_allclose(resumed.u_fine, full.u_fine,
                               rtol=1e-6, atol=1e-10)
    # total work: 2 checkpointed + resumed <= full + 1 (restart rounding)
    assert iters + resumed.iters <= full.iters + 1

    # Mismatched config refuses to resume.
    import pytest as _pytest
    with _pytest.raises(ValueError):
        checkpoint.load(path, _cfg(npts=65, grids=3, levels=3))


def test_bf16_preconditioner_mgcg():
    """cfg.precond_dtype='bfloat16': the V-cycle preconditioner runs in
    bf16 (half the memory bytes) while the CG outer keeps full accuracy —
    converges to the same tolerance with at most a few extra iterations."""
    import dataclasses

    from multigrid_petsc_tpu.utils.config import CycleType

    cfg = SolverConfig(npts=65, grids=4, levels=4, cycle=CycleType.MGCG,
                       max_iter=60)
    ref = solve(cfg)
    res = solve(dataclasses.replace(cfg, precond_dtype="bfloat16"))
    assert res.ctx.precond_ctx is not None
    assert res.converged
    assert res.iters <= ref.iters + 4
    np.testing.assert_allclose(res.u_fine, ref.u_fine, rtol=1e-5, atol=1e-9)


def test_bf16_preconditioner_mixed_1e8():
    """bf16 preconditioner + f64 outer PCG still certifies 1e-8."""
    import dataclasses

    from multigrid_petsc_tpu.utils.config import CycleType

    cfg = SolverConfig(npts=129, grids=5, levels=5, cycle=CycleType.MGCG,
                       dtype="float32", outer_dtype="float64", rtol=1e-8,
                       precond_dtype="bfloat16", max_iter=80)
    res = solve(cfg)
    assert res.converged
    assert float(res.rnorm[-1]) <= 1e-8


def test_per_level_smoothers():
    """Per-level smoother configuration (the reference's fine_/levels_/
    coarse_ KSP prefixes, src/solver.c:1624-1648): Chebyshev on the fine
    level, RBGS mid-hierarchy, Jacobi on the coarsest — converges, and
    each level actually got its tier's smoother."""
    cfg = SolverConfig(
        npts=65, grids=4, levels=4, cycle=CycleType.VCYCLE,
        fine_smoother=SmootherType.CHEBYSHEV,
        levels_smoother=SmootherType.RBGS,
        coarse_smoother=SmootherType.JACOBI,
        coarse_solver="smooth",  # keep the coarsest on its smoother
    )
    res = solve(cfg)
    # smooth-only coarsest (3 Jacobi sweeps on 7^2) slows the rate vs a
    # real coarse solve — convergence itself is the assertion here.
    assert res.converged and res.iters < 60
    lv = res.ctx.levels
    assert lv[0].lmax is not None          # Chebyshev estimated lmax
    assert all(l.lmax is None for l in lv[1:])  # RBGS/Jacobi tiers
    # Tier resolution itself:
    assert cfg.smoother_at(0, 4) == SmootherType.CHEBYSHEV
    assert cfg.smoother_at(1, 4) == SmootherType.RBGS
    assert cfg.smoother_at(2, 4) == SmootherType.RBGS
    assert cfg.smoother_at(3, 4) == SmootherType.JACOBI


def test_per_level_smoothers_explicit_list():
    """level_smoothers wins over tiers; None entries fall through."""
    cfg = SolverConfig(
        npts=65, grids=3, levels=3, cycle=CycleType.MGCG,
        smoother=SmootherType.JACOBI,
        level_smoothers=(SmootherType.CHEBYSHEV, None, None),
    )
    res = solve(cfg)
    assert res.converged
    assert res.ctx.levels[0].lmax is not None
    assert res.ctx.levels[1].lmax is None


def test_per_level_sweeps():
    """level_v: per-level sweep counts for the V-cycle family.  More
    sweeps on coarse levels, fewer on fine — still converges; and an
    all-equal level_v reproduces the default (v0==level_v) solve
    iterate-for-iterate."""
    import dataclasses

    base = SolverConfig(npts=65, grids=4, levels=4, cycle=CycleType.VCYCLE,
                        v=(2, 2))
    ref = solve(base)
    same = solve(dataclasses.replace(base, level_v=(2, 2, 2, 2)))
    assert int(same.iters) == int(ref.iters)
    np.testing.assert_allclose(same.u_fine, ref.u_fine, rtol=1e-12)

    varied = solve(dataclasses.replace(base, level_v=(1, 2, 4, 8)))
    assert varied.converged


def test_per_level_config_validation():
    import dataclasses

    import pytest as _pytest

    cfg = SolverConfig(npts=65, grids=3, levels=3)
    with _pytest.raises(ValueError):
        dataclasses.replace(cfg, level_v=(1, 2)).validate()
    with _pytest.raises(ValueError):
        dataclasses.replace(
            cfg, level_smoothers=(SmootherType.JACOBI,)
        ).validate()
