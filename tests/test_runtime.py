"""Start-up, numerics settings and the measurement tables: the compile
cache location, the device report, the matrix-product precision at every
site where the GPU could pick TF32, the peak-bandwidth table, and the
native library build."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from multigrid_petsc_tpu.utils import runtime


def _eqns(jaxpr):
    """Every equation of a jaxpr, sub-jaxprs (loops, conds) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _eqns(inner)


def _precisions(fn, *args, prim):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    out = []
    for e in _eqns(jaxpr):
        if e.primitive.name == prim:
            p = e.params["precision"]
            out.append(p if isinstance(p, tuple) else (p, p))
    return out


HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


def test_precision_coarse_direct_solve():
    from multigrid_petsc_tpu.mesh import MeshType
    from multigrid_petsc_tpu.problems import stencil_coefficients
    from multigrid_petsc_tpu.solvers.coarse import build_direct_solver

    st = stencil_coefficients(MeshType.UNIFORM, 7, 7, jnp.float32)
    solver = build_direct_solver(None, [(7, 7)], jnp.float32, stencils=[st])
    precs = _precisions(solver, (jnp.ones((7, 7), jnp.float32),),
                        prim="dot_general")
    assert precs and all(p == HIGHEST for p in precs)


def test_precision_fgmres_combination():
    from multigrid_petsc_tpu.solvers.context import build_context
    from multigrid_petsc_tpu.solvers.krylov import solve_mgfgmres
    from multigrid_petsc_tpu.utils.config import CycleType, SolverConfig

    ctx = build_context(SolverConfig(npts=17, grids=2, levels=2,
                                     cycle=CycleType.MGFGMRES,
                                     dtype="float32", max_iter=2))
    precs = _precisions(lambda b: solve_mgfgmres(ctx, b), ctx.b0,
                        prim="dot_general")
    # The restart's u + Z^T y product and the Gram-Schmidt vdots.
    assert precs and all(p == HIGHEST for p in precs)


def test_precision_vector_dots():
    """tree_dot (CG, norms) and the mixed outer's dots."""
    from multigrid_petsc_tpu.ops.norms import tree_dot

    x = (jnp.ones((4, 4), jnp.float32),)
    precs = _precisions(lambda a: tree_dot(a, a), x, prim="dot_general")
    assert precs == [HIGHEST]


@pytest.mark.parametrize("op", ["restrict", "prolong"])
def test_precision_conv_transfers(op):
    from multigrid_petsc_tpu.ops.transfer import (
        PROLONG_3x3,
        RESTRICT_3x3,
        prolong_with_stencil,
        restrict_with_stencil,
    )

    if op == "restrict":
        fn = lambda x: restrict_with_stencil(x, RESTRICT_3x3, 2)
        x = jnp.ones((15, 15), jnp.float32)
    else:
        fn = lambda x: prolong_with_stencil(x, PROLONG_3x3, 2)
        x = jnp.ones((7, 7), jnp.float32)
    precs = _precisions(fn, x, prim="conv_general_dilated")
    assert precs == [HIGHEST]


def _restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    return {k: getattr(jax.config, k) for k in keys}


@pytest.mark.parametrize("env", [None, "elsewhere"])
def test_configure_compile_cache(monkeypatch, tmp_path, env):
    saved = _restore_cache_config()
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        if env is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / env))
        runtime.configure()
        assert jax.config.jax_enable_x64
        if env is None:
            # Fixed, in-checkout, no process id or timestamp.
            assert runtime.CACHE_DIR.name == ".jax_cache"
            assert jax.config.jax_compilation_cache_dir == str(
                runtime.CACHE_DIR)
        else:
            # JAX reads the variable itself; nothing is set in code.
            assert jax.config.jax_compilation_cache_dir is None
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def test_cache_dir_is_in_checkout_and_ignored():
    root = runtime.CACHE_DIR.parent
    assert (root / "multigrid_petsc_tpu").is_dir()
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


def test_device_report_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.device_report()


def test_peak_table_knows_h100(monkeypatch):
    from benchmarks import baseline_configs as bc

    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(bc.jax, "devices", lambda: [Dev()])
    assert bc.peak_memory_bandwidth() == 3350e9


def test_peak_table_unknown_device_is_an_error():
    from benchmarks import baseline_configs as bc

    with pytest.raises(KeyError, match="no published memory bandwidth"):
        bc.peak_memory_bandwidth()


def test_native_library_builds_from_source():
    """The CSR engine is not in git: it is built from csr_assemble.cpp at
    first use (atomically, under a per-process name) and loads."""
    from multigrid_petsc_tpu.ops import sparse

    lib = sparse._load_native()
    assert sparse._LIB_PATH.exists()
    assert lib.level_rows is not None


def test_x64_required_for_f64_configs():
    """A 64-bit config without x64 is an error, not a silent f32 solve
    (the check runs before any array is made)."""
    from multigrid_petsc_tpu.solvers.context import build_context
    from multigrid_petsc_tpu.utils.config import SolverConfig

    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(ValueError, match="x64"):
            build_context(SolverConfig(npts=17, dtype="float64"))
    finally:
        jax.config.update("jax_enable_x64", True)


def test_cli_parses_overrides_without_temp_files(tmp_path, monkeypatch):
    from multigrid_petsc_tpu.utils.config import (
        CycleType,
        SolverConfig,
        parse_options,
    )

    cfg = parse_options(["-npts 33", "-cycle 101", "-v 2,4", "# c"],
                        SolverConfig())
    assert (cfg.npts, cfg.cycle, cfg.v) == (33, CycleType.MGCG, (2, 4))
    np.testing.assert_equal(os.listdir(tmp_path), [])
