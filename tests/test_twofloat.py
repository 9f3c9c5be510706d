"""Two-float32 (double-single) arithmetic + the float32x2 outer PCG.

The float32x2 outer is the double-single route to the 1e-8 residual
certification (BASELINE.md "wall time to 1e-8"): double-single EFT
arithmetic at f32 bandwidth instead of emulated f64.  Certification
oracle: the TRUE residual of the returned solution evaluated with the
native-f64 operator (reference analogue: the true-residual outer norm of
the PCMG path, src/solver.c:1920-1923).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_petsc_tpu.mesh import MeshType
from multigrid_petsc_tpu.ops import twofloat as tf
from multigrid_petsc_tpu.ops.stencil import apply_stencil5, apply_stencil9
from multigrid_petsc_tpu.problems import (
    aniso_rhs_grid,
    rhs_grid,
    stencil9_coefficients,
    stencil_coefficients,
)
from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig


def _rand(shape, seed=0, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape)


class TestEFT:
    """Error-free transformations are exact identities in IEEE f32."""

    def test_two_sum_exact(self):
        a = jnp.asarray(_rand(4096, 1), jnp.float32)
        b = jnp.asarray(_rand(4096, 2, scale=1e-3), jnp.float32)
        s, e = jax.jit(tf.two_sum)(a, b)
        exact = a.astype(jnp.float64) + b.astype(jnp.float64)
        got = s.astype(jnp.float64) + e.astype(jnp.float64)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))

    def test_two_prod_exact(self):
        a = jnp.asarray(_rand(4096, 3), jnp.float32)
        b = jnp.asarray(_rand(4096, 4), jnp.float32)
        p, e = jax.jit(tf.two_prod)(a, b)
        # f32 products are exact in f64 (24+24 <= 53 mantissa bits).
        exact = a.astype(jnp.float64) * b.astype(jnp.float64)
        got = p.astype(jnp.float64) + e.astype(jnp.float64)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))

    def test_roundtrip_f64(self):
        # A double-single split carries ~48 mantissa bits (hi exact, lo
        # rounded to f32), so the f64 roundtrip is accurate to
        # ~2^-48 relative — NOT exact (f64 has 53 bits).
        x = np.asarray(_rand(1024, 5))
        got = np.asarray(tf.to_f64(tf.from_f64(jnp.asarray(x, jnp.float64))))
        err = np.max(np.abs(got - x) / np.abs(x))
        assert err <= 2.0**-47, err

    def test_add_mul_accuracy(self):
        x64 = jnp.asarray(_rand((64, 64), 6))
        y64 = jnp.asarray(_rand((64, 64), 7))
        x, y = tf.from_f64(x64), tf.from_f64(y64)
        add_err = jnp.max(jnp.abs(tf.to_f64(tf.add(x, y)) - (x64 + y64)))
        mul_err = jnp.max(jnp.abs(tf.to_f64(tf.mul(x, y)) - (x64 * y64)))
        # ~2^-47 relative on O(1) values.
        assert float(add_err) < 1e-13
        assert float(mul_err) < 1e-13

    def test_compiled_axpy_chain_keeps_ds_precision(self):
        """Regression canary for fma contraction in compiled EFTs.

        XLA:CPU codegen contracts a duplicated multiply feeding an add
        into one fma, which silently destroys double-single arithmetic
        when the whole update chain compiles as one fusion (the exact
        shape of the CG vector updates inside lax.while_loop).  The
        reduce_precision pins in ops/twofloat.py prevent it; this test
        fails if a backend change ever re-breaks it.
        """
        x64 = jnp.asarray(_rand(4096, 12))
        y64 = jnp.asarray(_rand(4096, 13))
        a = jnp.float32(1.0134567)

        def chain(a, x, y):
            u = tf.axpy(a, x, y)       # y + a x
            r = tf.axpy(-a, y, u)      # u - a y
            return tf.axpy(a, r, u)    # u + a r

        x, y = tf.from_f64(x64), tf.from_f64(y64)
        got = tf.to_f64(jax.jit(chain)(a, x, y))
        a64 = jnp.float64(a)
        u64 = y64 + a64 * x64
        want = u64 + a64 * (u64 - a64 * y64)
        err = float(jnp.max(jnp.abs(got - want)))
        scale = float(jnp.max(jnp.abs(want)))
        assert err < 2.0**-44 * scale, err

    def test_dot_accuracy(self):
        x64 = jnp.asarray(_rand((128, 128), 8))
        y64 = jnp.asarray(_rand((128, 128), 9))
        got = float(tf.dot(tf.from_f64(x64), tf.from_f64(y64)))
        want = float(jnp.vdot(x64.ravel(), y64.ravel()))
        assert abs(got - want) < 1e-4 * abs(want) + 1e-6


class TestStencilTF:
    def test_apply5_matches_f64(self):
        ny = nx = 127
        st64 = stencil_coefficients(MeshType.NONUNIFORM1, ny, nx, jnp.float64)
        u64 = jnp.asarray(_rand((ny, nx), 10))
        want = apply_stencil5(st64, u64)
        got = tf.to_f64(
            tf.apply_stencil5(tf.split_stencil(st64), tf.from_f64(u64))
        )
        # ||A|| ~ 1/h^2 amplifies the 2^-47 representation error.
        scale = float(jnp.max(jnp.abs(want)))
        assert float(jnp.max(jnp.abs(got - want))) < 1e-11 * scale

    def test_apply9_matches_f64(self):
        from multigrid_petsc_tpu.problems import AnisoProblem

        ny = nx = 127
        prob = AnisoProblem(1.0, 0.5, 100.0, 0.0, 0.3)
        st64 = stencil9_coefficients(prob, ny, nx, jnp.float64)
        u64 = jnp.asarray(_rand((ny, nx), 11))
        want = apply_stencil9(st64, u64)
        got = tf.to_f64(
            tf.apply_stencil9(tf.split_stencil(st64), tf.from_f64(u64))
        )
        scale = float(jnp.max(jnp.abs(want)))
        assert float(jnp.max(jnp.abs(got - want))) < 1e-11 * scale


def _true_rel_residual(res, cfg):
    """True f64 residual of the returned solution (the certification)."""
    from multigrid_petsc_tpu.solvers.krylov import outer_precision_operator

    ctx = res.ctx
    g0 = ctx.levels[0].spec.primary
    apply64, _ = outer_precision_operator(ctx, jnp.float64)
    if cfg.problem == "aniso":
        b = aniso_rhs_grid(ctx.problem, g0.ny, g0.nx, jnp.float64)
    else:
        b = rhs_grid(ctx.problem, MeshType(cfg.mesh), g0.ny, g0.nx,
                     jnp.float64)
    r = b - apply64(jnp.asarray(res.u[0], jnp.float64))
    return float(jnp.linalg.norm(r.ravel()) / jnp.linalg.norm(b.ravel()))


class TestFloat32x2Outer:
    @pytest.mark.parametrize("mesh", [0, 2])
    def test_certifies_1e8_poisson(self, mesh):
        cfg = SolverConfig(
            npts=257, grids=5, levels=5, cycle=CycleType.MGCG, mesh=mesh,
            dtype="float32", outer_dtype="float32x2", rtol=1e-8, max_iter=60,
        )
        res = solve(cfg)
        assert res.converged
        assert _true_rel_residual(res, cfg) <= 1.2e-8

    def test_certifies_1e8_aniso_line(self):
        from multigrid_petsc_tpu.utils.config import SmootherType

        cfg = SolverConfig(
            npts=129, grids=4, levels=4, cycle=CycleType.MGCG,
            problem="aniso", aniso=(1.0, 0.0, 100.0, 0.0, 0.0),
            smoother=SmootherType.LINE_Y, dtype="float32",
            outer_dtype="float32x2", rtol=1e-8, max_iter=60,
        )
        res = solve(cfg)
        assert res.converged
        assert _true_rel_residual(res, cfg) <= 1.2e-8

    def test_matches_f64_outer_iterations(self):
        """Same convergence trajectory as the emulated-f64 outer (the
        double-single noise floor is far below the 1e-8 target)."""
        base = SolverConfig(
            npts=129, grids=4, levels=4, cycle=CycleType.MGCG,
            dtype="float32", rtol=1e-8, max_iter=60,
        )
        r64 = solve(dataclasses.replace(base, outer_dtype="float64"))
        rtf = solve(dataclasses.replace(base, outer_dtype="float32x2"))
        assert rtf.iters == r64.iters
        np.testing.assert_allclose(
            rtf.rnorm[: rtf.iters], r64.rnorm[: r64.iters], rtol=1e-3
        )
        np.testing.assert_allclose(
            rtf.u[0], np.asarray(r64.u[0]), atol=1e-10
        )

    def test_warm_start(self):
        cfg = SolverConfig(
            npts=129, grids=4, levels=4, cycle=CycleType.MGCG,
            dtype="float32", outer_dtype="float32x2", rtol=1e-8, max_iter=60,
        )
        res0 = solve(dataclasses.replace(cfg, rtol=1e-4))
        res = solve(cfg, u0=res0.u)
        assert res.converged
        assert res.iters < res0.iters + 6  # warm start helps
        assert _true_rel_residual(res, cfg) <= 1.2e-8


def test_from_f64_split_is_exact_and_normalized():
    """hi + lo reproduces x to 2^-47 and |lo| <= ulp(hi)/2, across 16
    decades of magnitude."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multigrid_petsc_tpu.ops import twofloat as tf

    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096) * 10.0 ** rng.uniform(-8, 8, 4096)
    t = jax.jit(tf.from_f64)(jnp.asarray(x))
    hi, lo = np.asarray(t.hi), np.asarray(t.lo)
    back = hi.astype(np.float64) + lo.astype(np.float64)
    assert np.max(np.abs(back - x) / np.abs(x)) <= 2.0 ** -47
    assert np.all(np.abs(lo) <= np.spacing(np.abs(hi)) / 2)


def test_from_f64_has_no_f32_round_trip():
    """The split must not convert an f32 value back to f64: XLA may fold
    that round trip away (the GPU compiler does) and zero the low part."""
    import jax
    import jax.numpy as jnp

    from multigrid_petsc_tpu.ops import twofloat as tf

    jaxpr = jax.make_jaxpr(tf.from_f64)(jnp.ones(8, jnp.float64)).jaxpr
    ups = [e for e in jaxpr.eqns
           if e.primitive.name == "convert_element_type"
           and e.invars[0].aval.dtype == jnp.float32
           and e.params["new_dtype"] == jnp.float64]
    assert not ups
