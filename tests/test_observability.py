"""Observability parity: per-level solver dump (KSPView analogue),
I/E-cycle residual monitors, per-phase timings on SolveResult."""

import numpy as np
import pytest

from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig
from multigrid_petsc_tpu.utils.views import view_solver


def test_view_solver_dump():
    cfg = SolverConfig(npts=33, grids=3, levels=3, max_iter=30)
    res = solve(cfg)
    out = view_solver(res.ctx)
    assert "cycle=VCYCLE" in out
    assert "level 0" in out and "level 2" in out
    assert "jacobi(omega=0.8)" in out
    assert "coarse=" in out
    assert "g0:31x31" in out


def test_view_solver_sparse_backend():
    cfg = SolverConfig(npts=33, grids=2, levels=2, max_iter=30,
                       backend="sparse")
    res = solve(cfg)
    out = view_solver(res.ctx)
    assert "sparse(" in out and "nnz=" in out


@pytest.mark.parametrize("cycle", [CycleType.ICYCLE, CycleType.ECYCLE])
def test_merged_cycle_more_norm_monitor(cycle):
    """moreNorm on I/E cycles records global + per-grid residual norms per
    outer iteration (reference: monitors/history wired at
    src/solver.c:2017-2018 and the rNormGridMonitor machinery)."""
    cfg = SolverConfig(npts=17, grids=2, levels=1, cycle=cycle,
                       max_iter=40, rtol=1e-6, more_norm=True)
    res = solve(cfg)
    assert res.aux is not None
    r_global = res.aux["r_global"]
    r_grid = res.aux["r_grid"]
    n = res.iters + 1
    assert r_global.shape == (n,)
    assert r_grid.shape == (2, n)
    # The recorded global norm history must equal the (unnormalized)
    # residual history the outer loop keeps.
    np.testing.assert_allclose(
        r_global / r_global[0], res.rnorm[:n], rtol=1e-12
    )
    # Per-grid norms must compose to the global norm.
    np.testing.assert_allclose(
        np.sqrt((r_grid**2).sum(axis=0)), r_global, rtol=1e-12
    )


def test_profile_phases_attached():
    cfg = SolverConfig(npts=33, grids=3, levels=3, max_iter=30)
    res = solve(cfg, profile_phases=True)
    for key in ("compile", "solve", "smooth_v", "residual", "restrict",
                "prolong", "norm"):
        assert key in res.phases
        assert res.phases[key] >= 0.0


def test_cli_view_flag(tmp_path, capsys, monkeypatch):
    """-view 1 prints the per-level solver dump after the solve
    (the reference's KSPView output, src/solver.c:1560-1564)."""
    from multigrid_petsc_tpu import poisson as cli

    monkeypatch.chdir(tmp_path)
    rc = cli.main(["-npts", "17", "-grids", "2", "-levels", "2",
                   "-view", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "level 0" in out and "smoother=" in out


def test_traffic_model_shapes():
    """Benchmark traffic model: mg-CG > V-cycle overhead; a bf16
    preconditioner roughly halves the visit bytes."""
    import dataclasses

    from benchmarks.baseline_configs import modeled_bytes_per_iter
    from multigrid_petsc_tpu.solvers.context import build_context
    from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig

    cfg = SolverConfig(npts=65, grids=3, levels=3, cycle=CycleType.MGCG,
                       dtype="float32")
    ctx = build_context(cfg)
    m_cg = modeled_bytes_per_iter(ctx)
    m_v = modeled_bytes_per_iter(ctx, cycle=CycleType.VCYCLE)
    assert m_cg > m_v
    ctx_bf = build_context(
        dataclasses.replace(cfg, precond_dtype="bfloat16"))
    m_bf = modeled_bytes_per_iter(ctx_bf)
    # Visit bytes halve; the CG overhead (13 n^2 B) stays f32.
    assert m_v * 0.4 < m_bf - (m_cg - m_v) - 0.0 < m_v * 0.7
