"""Distribution tests on the 8-virtual-device CPU mesh.

The single-host analogue of the reference's `mpirun -n P` testing (SURVEY.md
section 4 item 5): the same solves must produce identical answers on a
2-D sharded device mesh, with coarse levels agglomerated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from multigrid_petsc_tpu.mesh import MeshType
from multigrid_petsc_tpu.ops.stencil import apply_stencil5
from multigrid_petsc_tpu.parallel.device_mesh import ShardingPlan, make_device_mesh
from multigrid_petsc_tpu.parallel.halo import apply_stencil5_local
from multigrid_petsc_tpu.postprocess import error_norms
from multigrid_petsc_tpu.problems import stencil_coefficients
from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig


def test_device_mesh_shape():
    mesh = make_device_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("y", "x")
    assert mesh.devices.shape in ((2, 4), (4, 2))


def test_sharding_plan_agglomeration():
    plan = ShardingPlan(make_device_mesh(), min_local=32)
    my, mx = plan.mesh.devices.shape
    assert plan.spec(256, 256) == P("y", "x")
    assert plan.spec(8, 8) == P(None, None)  # agglomerated


def test_shard_map_stencil_matches_single_device():
    """Explicit ppermute halo exchange == single-device stencil apply."""
    mesh = make_device_mesh(shape=(2, 4))
    n = 32
    st = stencil_coefficients(MeshType.NONUNIFORM2, n, n)
    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.standard_normal((n, n)))
    expect = np.asarray(apply_stencil5(st, u))

    # Coefficient (n, 1) columns: sharded along y, replicated across x —
    # local blocks broadcast against the (ny_loc, nx_loc) state block.
    f = shard_map(
        apply_stencil5_local,
        mesh=mesh,
        in_specs=(P("y", None),) * 5 + (P("y", "x"),),
        out_specs=P("y", "x"),
    )
    got = np.asarray(f(*st, u))
    np.testing.assert_allclose(got, expect, rtol=1e-12)


def test_gspmd_sharded_stencil_matches():
    """GSPMD path: shifted-slice stencil on a 2-D sharded array."""
    mesh = make_device_mesh(shape=(2, 4))
    n = 64
    st = stencil_coefficients(MeshType.UNIFORM, n, n)
    rng = np.random.default_rng(8)
    u = jnp.asarray(rng.standard_normal((n, n)))
    expect = np.asarray(apply_stencil5(st, u))
    us = jax.device_put(u, NamedSharding(mesh, P("y", "x")))
    got = np.asarray(jax.jit(lambda x: apply_stencil5(st, x))(us))
    np.testing.assert_allclose(got, expect, rtol=1e-12)


@pytest.mark.parametrize("cycle", [CycleType.VCYCLE, CycleType.MGCG])
def test_distributed_solve_matches_single_device(cycle):
    cfg = SolverConfig(npts=65, grids=3, levels=3, cycle=cycle, max_iter=50)
    ref = solve(cfg)
    plan = ShardingPlan(make_device_mesh(), min_local=8)
    dist = solve(cfg, plan=plan)
    assert dist.converged
    assert dist.iters == ref.iters
    # GSPMD partitioning reassociates reductions; histories agree to
    # roundoff accumulated over the run, not bitwise.
    np.testing.assert_allclose(dist.rnorm, ref.rnorm, rtol=1e-6)
    np.testing.assert_allclose(dist.u_fine, ref.u_fine, rtol=1e-6, atol=1e-11)


def test_distributed_solve_with_agglomeration():
    """Coarse levels below the threshold replicate; answers unchanged."""
    cfg = SolverConfig(npts=129, grids=5, levels=5, cycle=CycleType.MGCG,
                      max_iter=30)
    plan = ShardingPlan(make_device_mesh(), min_local=16)
    # 127 and 63 shard; 31, 15, 7 agglomerate (min_local=16, mesh 2x4 or 4x2).
    dist = solve(cfg, plan=plan)
    assert dist.converged
    errs = error_norms(dist.ctx.problem, MeshType.UNIFORM, dist.u_fine)
    assert errs[0] < 4.0 / 128 / 128


def test_halo_corners_9pt_matches_single_device():
    """corners=True halo exchange (the 9-point second pass) == single-device
    9-point apply."""
    from multigrid_petsc_tpu.ops.stencil import apply_stencil9
    from multigrid_petsc_tpu.parallel.halo import halo_pad_local
    from multigrid_petsc_tpu.problems import AnisoProblem, stencil9_coefficients

    mesh = make_device_mesh(shape=(2, 4))
    n = 32
    st = stencil9_coefficients(AnisoProblem(1.0, 0.5, 50.0, 0.0, 0.3), n, n)
    rng = np.random.default_rng(21)
    u = jnp.asarray(rng.standard_normal((n, n)))
    expect = np.asarray(apply_stencil9(st, u))

    def local9(csw, cs, cse, cw, cc, ce, cnw, cn, cne, u):
        p = halo_pad_local(u, corners=True)
        return (
            cc * u
            + cs * p[:-2, 1:-1] + cn * p[2:, 1:-1]
            + cw * p[1:-1, :-2] + ce * p[1:-1, 2:]
            + csw * p[:-2, :-2] + cse * p[:-2, 2:]
            + cnw * p[2:, :-2] + cne * p[2:, 2:]
        )

    # Coefficient fields are (ny,1)/(1,nx)/(1,1) broadcastables: shard the
    # big axis where present, replicate the rest.
    def cspec(c):
        cb = jnp.broadcast_to(c, (n, n))
        return cb, P("y", "x")

    cs_full = [cspec(c) for c in st]
    f = shard_map(
        local9, mesh=mesh,
        in_specs=tuple(s for _, s in cs_full) + (P("y", "x"),),
        out_specs=P("y", "x"),
    )
    got = np.asarray(f(*(c for c, _ in cs_full), u))
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)


def test_distributed_aniso_solve_matches_single_device():
    """9-point anisotropic family distributed over the 2-D mesh (GSPMD)
    == single device, iteration-for-iteration."""
    from multigrid_petsc_tpu.utils.config import SmootherType

    cfg = SolverConfig(npts=65, grids=3, levels=3, cycle=CycleType.MGCG,
                       problem="aniso", aniso=(1.0, 0.0, 100.0, 0.0, 0.0),
                       smoother=SmootherType.LINE_Y, max_iter=60)
    ref = solve(cfg)
    dist = solve(cfg, plan=ShardingPlan(make_device_mesh(), min_local=8))
    assert dist.converged
    assert dist.iters == ref.iters
    np.testing.assert_allclose(dist.rnorm, ref.rnorm, rtol=1e-6)
    np.testing.assert_allclose(dist.u_fine, ref.u_fine, rtol=1e-6, atol=1e-11)
