"""Card tier: tests that need an NVIDIA GPU (skipped elsewhere).

Run with ``MG_TEST_PLATFORM=gpu python -m pytest tests -m gpu`` on a
machine with a card; ``python chip_smoke.py`` runs them in-process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_petsc_tpu.mesh import MeshType
from multigrid_petsc_tpu.ops.stencil import apply_stencil5
from multigrid_petsc_tpu.problems import stencil_coefficients
from multigrid_petsc_tpu.solvers import smoothers as sm
from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig

pytestmark = pytest.mark.gpu


def _rel_max(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("kind", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("variant", ["u", "zero_r", "u_r"])
def test_cuda_smoother_parity_8193(kind, variant):
    """The kernel against the plain jnp sweeps on the 8193^2 fine level.
    f32, 1e-5 relative max error after 3 sweeps: only the summation order
    differs."""
    from multigrid_petsc_tpu.ops.smooth5_cuda import smooth5

    n, k, lmax = 8191, 3, 1.9
    st = stencil_coefficients(MeshType.NONUNIFORM2, n, n, jnp.float32)
    b = jax.random.normal(jax.random.PRNGKey(1), (n, n), jnp.float32)
    u = (None if variant == "zero_r"
         else jax.random.normal(jax.random.PRNGKey(2), (n, n), jnp.float32))
    emit_r = variant != "u"
    apply = lambda s: (apply_stencil5(st, s[0]),)
    dinv = (1.0 / st.cc,)
    steps = (sm.jacobi_step_coeffs(k, 0.8) if kind == "jacobi"
             else sm.chebyshev_step_coeffs(k, lmax))

    def plain(b, u):
        u0 = (jnp.zeros_like(b) if u is None else u,)
        if kind == "jacobi":
            out = sm.jacobi(apply, dinv, (b,), u0, k, 0.8)[0]
        else:
            out = sm.chebyshev(apply, dinv, (b,), u0, k, lmax)[0]
        return (out, b - apply_stencil5(st, out)) if emit_r else out

    ref = jax.jit(plain)(b, u)
    got = jax.jit(lambda b, u: smooth5(st, b, u, steps, emit_r))(b, u)
    for g, r in zip(got, ref) if emit_r else ((got, ref),):
        assert _rel_max(g, r) <= 1e-5


def test_coarse_solve_no_tf32():
    """Direct coarse solve at 4096 unknowns against the f64 host inverse:
    TF32 (about three digits) would miss 1e-5 by far."""
    from multigrid_petsc_tpu.solvers.coarse import (
        build_direct_solver,
        dense_from_stencil,
    )

    n = 64
    st = stencil_coefficients(MeshType.UNIFORM, n, n, jnp.float32)
    solver = build_direct_solver(None, [(n, n)], jnp.float32, stencils=[st])
    b = np.random.default_rng(0).standard_normal((n, n))
    got = jax.jit(solver)((jnp.asarray(b, jnp.float32),))[0]
    ref = np.linalg.solve(dense_from_stencil(st, n, n), b.ravel())
    assert _rel_max(np.asarray(got).ravel(), ref) <= 1e-5


@pytest.mark.parametrize("op", ["restrict", "prolong"])
def test_conv_transfers_no_tf32(op):
    """The conv parity transfers in f32 against the f64 multi-gap
    transfers: TF32 would leave ~1e-3."""
    from multigrid_petsc_tpu.ops.transfer import (
        PROLONG_3x3,
        RESTRICT_3x3,
        composed_transfer_stencil,
        prolong_multi,
        prolong_with_stencil,
        restrict_multi,
        restrict_with_stencil,
    )

    rng = np.random.default_rng(3)
    if op == "restrict":
        x = rng.standard_normal((255, 255))
        w = composed_transfer_stencil(RESTRICT_3x3, 2)
        got = restrict_with_stencil(jnp.asarray(x, jnp.float32), w, 4)
        with jax.default_device(jax.devices("cpu")[0]):
            ref = restrict_multi(jnp.asarray(x), 2)
    else:
        x = rng.standard_normal((63, 63))
        w = composed_transfer_stencil(PROLONG_3x3, 2)
        got = prolong_with_stencil(jnp.asarray(x, jnp.float32), w, 4)
        with jax.default_device(jax.devices("cpu")[0]):
            ref = prolong_multi(jnp.asarray(x), 2)
    assert _rel_max(got, ref) <= 1e-5


def test_vector_dots_no_tf32():
    """The Krylov inner products: x = 1 + 2^-12 is exact in f32 but rounds
    to 1 in TF32, which would bias <x, x> by 4.9e-4."""
    from multigrid_petsc_tpu.ops.norms import tree_dot

    n = 1 << 20
    x = jnp.full((1024, n // 1024), 1 + 2.0 ** -12, jnp.float32)
    got = float(jax.jit(tree_dot)((x,), (x,)))
    assert abs(got / (n * (1 + 2.0 ** -12) ** 2) - 1) <= 1e-5


def test_solve_4097_cuda_path_matches_plain():
    """4097^2 mg-CG: the large levels take the kernel (path 'cuda'), and
    the solve matches the plain path's iterations and solution."""
    base = SolverConfig(npts=4097, grids=10, levels=10, cycle=CycleType.MGCG,
                        dtype="float32", rtol=1e-5, max_iter=100)
    fast = solve(base)
    plain = solve(dataclasses.replace(base, backend="xla"))
    assert fast.path == "cuda" and plain.path == "generic"
    assert [l.cuda_smoother for l in fast.ctx.levels][:3] == [True, True,
                                                             False]
    assert fast.converged and fast.iters == plain.iters
    assert _rel_max(fast.u_fine, plain.u_fine) <= 1e-4
