"""The 1-D row plan (``row_plan``) over the 8 virtual devices against the
single-device solve.  The row plan runs the plain operators through GSPMD:
XLA partitions every sharded level and inserts the halo exchanges."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_petsc_tpu.parallel.device_mesh import (
    ShardingPlan,
    make_device_mesh,
    row_plan,
)
from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils.config import CycleType, SmootherType, SolverConfig


def _compare(tol=1e-6, plan=None, **kw):
    ref = solve(SolverConfig(**kw))
    res = solve(SolverConfig(**kw), plan=plan or row_plan(min_local=8))
    assert res.converged and res.iters == ref.iters
    n = min(len(ref.rnorm), len(res.rnorm))
    np.testing.assert_allclose(res.rnorm[:n], ref.rnorm[:n], rtol=tol,
                               atol=1e-9)
    np.testing.assert_allclose(res.u_fine, ref.u_fine, rtol=tol, atol=1e-12)
    return res


@pytest.mark.parametrize(
    "cycle", [CycleType.VCYCLE, CycleType.MGCG, CycleType.PCMG,
              CycleType.FMG, CycleType.MGFGMRES])
def test_rows_solve_matches_single_device(cycle):
    res = _compare(npts=129, grids=4, levels=4, cycle=cycle, max_iter=60)
    # 127 rows shard over 8 devices (15 each >= 8); 63, 31 and 15
    # agglomerate (replicate).
    assert [tuple(l.shardings[0].spec) for l in res.ctx.levels] == [
        ("y", None), (None, None), (None, None), (None, None)]


def test_rows_solve_chebyshev():
    _compare(npts=129, grids=4, levels=4, cycle=CycleType.MGCG,
             smoother=SmootherType.CHEBYSHEV, max_iter=60)


@pytest.mark.parametrize("mesh", [1, 2])
def test_rows_solve_stretched_mesh(mesh):
    _compare(npts=129, grids=4, levels=4, cycle=CycleType.VCYCLE, mesh=mesh,
             max_iter=80)


def test_rows_solve_composite_last_level():
    """grids > levels: a merged (composite) last level under the plan."""
    _compare(npts=129, grids=5, levels=3, cycle=CycleType.VCYCLE,
             max_iter=80)


def test_rows_solve_aniso_9pt():
    _compare(npts=129, grids=4, levels=4, cycle=CycleType.MGCG,
             problem="aniso", aniso=(1.0, 0.0, 10.0, 0.0, 0.0),
             max_iter=80, tol=1e-5)


def test_rows_solve_mixed_f64_outer():
    _compare(npts=129, grids=4, levels=4, cycle=CycleType.MGCG,
             dtype="float32", outer_dtype="float64", rtol=1e-8,
             max_iter=60, tol=1e-5)


def test_rows_warm_start_resume():
    cfg = SolverConfig(npts=129, grids=4, levels=4, cycle=CycleType.VCYCLE,
                       max_iter=3)
    plan = row_plan(min_local=8)
    part = solve(cfg, plan=plan)
    assert not part.converged
    full = solve(dataclasses.replace(cfg, max_iter=60), plan=plan,
                 u0=tuple(jnp.asarray(x) for x in part.u))
    assert full.converged
    ref = solve(dataclasses.replace(cfg, max_iter=60))
    np.testing.assert_allclose(full.u_fine, ref.u_fine, rtol=1e-5, atol=1e-11)


def test_rows_and_blocks_agree():
    cfg = SolverConfig(npts=129, grids=4, levels=4, cycle=CycleType.MGCG,
                       dtype="float32", rtol=1e-5)
    rows = solve(cfg, plan=row_plan(min_local=8))
    blocks = solve(cfg, plan=ShardingPlan(make_device_mesh(), min_local=8))
    assert rows.iters == blocks.iters
    np.testing.assert_allclose(rows.u_fine, blocks.u_fine, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("ny,min_local,spec", [
    (127, 8, ("y", None)), (127, 16, (None, None)), (63, 4, ("y", None)),
    (8191, 32, ("y", None)), (15, 1, ("y", None)), (7, 1, (None, None)),
])
def test_rows_spec_rule(ny, min_local, spec):
    """Rows shard while each device keeps >= min_local of them."""
    plan = row_plan(min_local=min_local)
    assert tuple(plan.spec(ny, ny)) == spec
    assert plan.mesh.devices.shape == (len(jax.devices()), 1)


def test_rows_fine_state_is_sharded_in_the_solve():
    """Inside the compiled solve the fine-level state really is split over
    the devices: the partitioned program works on 16-row blocks of the
    127-row level (GSPMD pads 127 to 128) and exchanges halos."""
    cfg = SolverConfig(npts=129, grids=3, levels=3, cycle=CycleType.MGCG,
                       max_iter=2)
    res = solve(cfg, plan=row_plan(min_local=8))
    hlo = res.compiled.as_text()
    assert "f64[16,127]" in hlo
    assert "collective-permute" in hlo
