"""Explicit sparse backend vs matrix-free: strong differential tests.

The native C++ CSR assembly (native/csr_assemble.cpp) and the matrix-free
composite apply were written independently from the same spec (the
reference's assembly semantics) — agreement on random vectors is a real
cross-implementation check (SURVEY.md section 4 item 3 style).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_petsc_tpu.mesh import MeshType
from multigrid_petsc_tpu.ops.composite import composite_apply
from multigrid_petsc_tpu.ops.sparse import SparseLevelOp
from multigrid_petsc_tpu.problems import stencil_coefficients


def _random_state(shapes, seed):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.standard_normal(s)) for s in shapes)


@pytest.mark.parametrize("mesh_type", [0, 1, 2])
@pytest.mark.parametrize("gids", [(0,), (1,)])
def test_sparse_matches_matrix_free_single_grid(mesh_type, gids):
    npts = 17
    op = SparseLevelOp(npts, mesh_type, gids)
    st = tuple(
        stencil_coefficients(MeshType(mesh_type), ny, nx)
        for (ny, nx) in op.shapes
    )
    u = _random_state(op.shapes, 1)
    ref = composite_apply(st, gids, u)
    got = op.apply(u)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("mesh_type", [0, 2])
@pytest.mark.parametrize("gids", [(0, 1), (0, 1, 2), (1, 3)])
def test_sparse_matches_matrix_free_composite(mesh_type, gids):
    npts = 33
    op = SparseLevelOp(npts, mesh_type, gids)
    st = tuple(
        stencil_coefficients(MeshType(mesh_type), ny, nx)
        for (ny, nx) in op.shapes
    )
    u = _random_state(op.shapes, 2)
    ref = composite_apply(st, gids, u)
    got = op.apply(u)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-11, atol=1e-8)


def test_sparse_diag_coupling_split():
    gids = (0, 1)
    npts = 17
    full = SparseLevelOp(npts, 0, gids)
    diag = SparseLevelOp(npts, 0, gids, include_couplings=False)
    coup = SparseLevelOp(npts, 0, gids, include_diag=False)
    u = _random_state(full.shapes, 3)
    yf = full.apply(u)
    yd = diag.apply(u)
    yc = coup.apply(u)
    for f, d, c in zip(yf, yd, yc):
        np.testing.assert_allclose(np.asarray(f), np.asarray(d + c), rtol=1e-12)


def test_nnz_counts():
    """5-point interior rows have 5 entries; corners 3 (Dirichlet
    elimination, reference src/solver.c:239-251)."""
    op = SparseLevelOp(17, 0, (0,))
    n = 15
    assert op.nnz == 5 * n * n - 4 * n  # 2n boundary rows lose 1, each edge


# ---------------------------------------------------------------------------
# backend="sparse": full solves over the explicit assembled operator
# (reference: the solve ALWAYS runs over explicit level matrices,
# src/solver.c:489-556 + MatMult everywhere).
# ---------------------------------------------------------------------------


def _histories(cfg_kwargs, expect_converged=True):
    from multigrid_petsc_tpu.solvers.solve import solve
    from multigrid_petsc_tpu.utils.config import SolverConfig

    out = {}
    for backend in ("xla", "sparse"):
        res = solve(SolverConfig(backend=backend, **cfg_kwargs))
        assert res.converged == expect_converged
        out[backend] = (res.iters, res.rnorm, res.u_fine)
    return out["xla"], out["sparse"]


@pytest.mark.parametrize("mesh_type", [0, 1, 2])
def test_sparse_backend_vcycle_matches_matrix_free(mesh_type):
    """V-cycle over the explicit operator: iteration-for-iteration
    identical residual history to the matrix-free path."""
    (it_x, h_x, u_x), (it_s, h_s, u_s) = _histories(
        dict(npts=33, grids=3, levels=3, mesh=mesh_type, rtol=1e-9)
    )
    assert it_x == it_s
    np.testing.assert_allclose(h_s, h_x, rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(u_s, u_x, rtol=1e-8, atol=1e-12)


def test_sparse_backend_mgcg_matches_matrix_free():
    from multigrid_petsc_tpu.utils.config import CycleType

    (it_x, h_x, _), (it_s, h_s, _) = _histories(
        dict(npts=33, grids=3, levels=3, cycle=CycleType.MGCG, rtol=1e-9)
    )
    assert it_x == it_s
    np.testing.assert_allclose(h_s, h_x, rtol=1e-8, atol=1e-12)


def test_sparse_backend_composite_level_matches():
    """Composite (merged-grid) coarse level: couplings ride the explicit
    A / A1 / A2 matrices."""
    (it_x, h_x, _), (it_s, h_s, _) = _histories(
        dict(npts=33, grids=3, levels=2, rtol=1e-8)
    )
    assert it_x == it_s
    np.testing.assert_allclose(h_s, h_x, rtol=1e-8, atol=1e-12)


def test_sparse_backend_ecycle_matches():
    """E-cycle's A1/A2 split over explicit matrices (levelMatrixA1/A2,
    src/solver.c:512-556)."""
    from multigrid_petsc_tpu.utils.config import CycleType

    # The E-cycle's own convergence metric ||b - A1 u|| plateaus at
    # ||R f||/||b|| (see solvers/cycles.py::solve_ecycle): it runs to
    # max_iter like the reference binary — compare the histories only.
    (it_x, h_x, _), (it_s, h_s, _) = _histories(
        dict(npts=17, grids=2, levels=1, cycle=CycleType.ECYCLE,
             max_iter=40, rtol=1e-6),
        expect_converged=False,
    )
    assert it_x == it_s
    np.testing.assert_allclose(h_s, h_x, rtol=1e-8, atol=1e-12)


def test_sparse_backend_guards():
    from multigrid_petsc_tpu.solvers.solve import solve
    from multigrid_petsc_tpu.parallel.device_mesh import (
        ShardingPlan, make_device_mesh,
    )
    from multigrid_petsc_tpu.utils.config import SolverConfig

    with pytest.raises(ValueError, match="poisson"):
        solve(SolverConfig(backend="sparse", problem="aniso",
                           npts=17, grids=2, levels=2))
    plan = ShardingPlan(make_device_mesh(), min_local=2)
    with pytest.raises(ValueError, match="single-device"):
        solve(SolverConfig(backend="sparse", npts=17, grids=2, levels=2),
              plan=plan)
