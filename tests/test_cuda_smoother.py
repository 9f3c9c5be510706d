"""The CUDA smoother's Python side, on the CPU: tile and halo geometry, the
choice of kernel, and its wiring into the solver.

The kernel itself (native/smooth5.cu) has no interpret mode; its parity
on the card is tests/test_gpu.py.  Here ``emulate`` replays the kernel's
block algorithm in numpy — the same window, halo, stale-ring and boundary
rules — against the host f64 smoother, and stands in for the kernel (via
``jax.pure_callback``) to drive the solver's wiring end to end.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_petsc_tpu.mesh import MeshType
from multigrid_petsc_tpu.ops import smooth5_cuda as k5
from multigrid_petsc_tpu.ops.stencil import Stencil5, Stencil9, apply_stencil5
from multigrid_petsc_tpu.problems import stencil_coefficients
from multigrid_petsc_tpu.solvers import context
from multigrid_petsc_tpu.solvers import smoothers as sm
from multigrid_petsc_tpu.solvers.solve import solve
from multigrid_petsc_tpu.utils.config import CycleType, SmootherType, SolverConfig

SHAPES = [(63, 63), (100, 63), (127, 31), (257, 129)]


def emulate(st, b, u, steps, emit_r=False, halo=None):
    """The kernel's algorithm, block by block, in f64 numpy."""
    b = np.asarray(b, np.float64)
    ny, nx = b.shape
    k = len(steps)
    h = k5.halo(k, emit_r) if halo is None else halo
    wy, wx = k5.TILE_Y + 2 * h, k5.TILE_X + 2 * h
    cols = [np.broadcast_to(np.asarray(c, np.float64), (ny, 1))[:, 0]
            for c in st]
    u_out = np.zeros((ny, nx))
    r_out = np.zeros((ny, nx))
    gx_blocks, gy_blocks = k5.grid(ny, nx)
    for by in range(gy_blocks):
        for bx in range(gx_blocks):
            gy = by * k5.TILE_Y - h + np.arange(wy)[:, None]
            gx = bx * k5.TILE_X - h + np.arange(wx)[None, :]
            row_in = (gy >= 0) & (gy < ny)
            inside = row_in & (gx >= 0) & (gx < nx)
            cy, cx = np.clip(gy, 0, ny - 1), np.clip(gx, 0, nx - 1)
            cs, cw, cc, ce, cn = (np.where(row_in, c[cy], 0.0) for c in cols)
            cc = np.where(row_in, cc, 1.0)
            U = np.where(inside & (u is not None),
                         0.0 if u is None else np.asarray(u)[cy, cx], 0.0)
            B = np.where(inside, b[cy, cx], 0.0)
            P = np.zeros_like(U)

            def au(U):
                p = np.pad(U, 1)
                return (cc * U + cs * p[:-2, 1:-1] + cn * p[2:, 1:-1]
                        + cw * p[1:-1, :-2] + ce * p[1:-1, 2:])

            ii, jj = np.arange(wy)[:, None], np.arange(wx)[None, :]
            for s, (alpha, beta) in enumerate(steps):
                lo = s + 1
                live = (inside & (ii >= lo) & (ii < wy - lo)
                        & (jj >= lo) & (jj < wx - lo))
                p_new = beta * P + alpha * (B - au(U)) / cc
                P = np.where(live, p_new, P)
                U = np.where(live, U + p_new, U)
            R = B - au(U)
            ys = slice(by * k5.TILE_Y, min((by + 1) * k5.TILE_Y, ny))
            xs = slice(bx * k5.TILE_X, min((bx + 1) * k5.TILE_X, nx))
            ny_t, nx_t = ys.stop - ys.start, xs.stop - xs.start
            u_out[ys, xs] = U[h:h + ny_t, h:h + nx_t]
            r_out[ys, xs] = R[h:h + ny_t, h:h + nx_t]
    return (u_out, r_out) if emit_r else u_out


def host_smooth(st, b, u, steps):
    """Reference: the whole-grid polynomial smoother in f64."""
    b = np.asarray(b, np.float64)
    u = np.zeros_like(b) if u is None else np.asarray(u, np.float64)
    cc = np.asarray(st.cc, np.float64)
    p = np.zeros_like(u)
    for alpha, beta in steps:
        r = b - np.asarray(apply_stencil5(st, jnp.asarray(u)))
        p = beta * p + alpha * r / cc
        u = u + p
    return u, b - np.asarray(apply_stencil5(st, jnp.asarray(u)))


# --------------------------------------------------------------------------
# Geometry
# --------------------------------------------------------------------------


def test_constants_match_cuda_source():
    src = (pathlib.Path(k5.__file__).resolve().parents[2] / "native"
           / "smooth5.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kTileY") == k5.TILE_Y
    assert const("kTileX") == k5.TILE_X
    assert const("kMaxSweeps") == k5.MAX_SWEEPS


@pytest.mark.parametrize("emit_r", [False, True])
@pytest.mark.parametrize("sweeps", range(1, 9))
def test_window_fits_shared_memory(sweeps, emit_r):
    """Every sweep count the kernel accepts stages a window that fits one
    block's 227 KB of shared memory."""
    wy, wx = k5.window(sweeps, emit_r)
    assert (wy, wx) == (k5.TILE_Y + 2 * (sweeps + emit_r),
                        k5.TILE_X + 2 * (sweeps + emit_r))
    assert k5.smem_bytes(sweeps, emit_r) == 4 * (4 * wy * wx + 5 * wy)
    assert k5.smem_bytes(sweeps, emit_r) <= 227 * 1024


@pytest.mark.parametrize("shape", SHAPES + [(2047, 2047), (4095, 4095),
                                            (8191, 8191)])
def test_grid_covers_level(shape):
    ny, nx = shape
    gx, gy = k5.grid(ny, nx)
    assert gx * k5.TILE_X >= nx > (gx - 1) * k5.TILE_X
    assert gy * k5.TILE_Y >= ny > (gy - 1) * k5.TILE_Y


@pytest.mark.parametrize("variant", ["u", "zero_r"])
@pytest.mark.parametrize("kind", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("sweeps", [1, 3, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_block_algorithm_matches_host(shape, sweeps, kind, variant):
    """Tiles with a (k [+1])-wide halo reproduce the whole-grid smoother
    (and residual) exactly, ragged edge tiles and boundaries included."""
    ny, nx = shape
    st = stencil_coefficients(MeshType.NONUNIFORM2, ny, nx)
    rng = np.random.default_rng(ny + sweeps)
    b = rng.standard_normal(shape)
    u = None if variant == "zero_r" else rng.standard_normal(shape)
    steps = (sm.jacobi_step_coeffs(sweeps, 0.8) if kind == "jacobi"
             else sm.chebyshev_step_coeffs(sweeps, 1.9))
    u_ref, r_ref = host_smooth(st, b, u, steps)
    if variant == "u":
        got = emulate(st, b, u, steps)
    else:
        got, r_got = emulate(st, b, u, steps, emit_r=True)
        np.testing.assert_allclose(r_got, r_ref, rtol=0,
                                   atol=1e-12 * np.abs(r_ref).max())
    np.testing.assert_allclose(got, u_ref, rtol=0,
                               atol=1e-12 * np.abs(u_ref).max())


def test_short_halo_is_wrong():
    """The halo width is load-bearing: one ring fewer than the sweep
    count breaks the tile edges."""
    st = stencil_coefficients(MeshType.UNIFORM, 100, 200)
    b = np.random.default_rng(0).standard_normal((100, 200))
    steps = sm.jacobi_step_coeffs(3, 0.8)
    u_ref, _ = host_smooth(st, b, None, steps)
    assert np.abs(emulate(st, b, None, steps, halo=2) - u_ref).max() > 1e-6


# --------------------------------------------------------------------------
# Choice of kernel
# --------------------------------------------------------------------------


def _st(n, dtype=jnp.float32):
    return stencil_coefficients(MeshType.NONUNIFORM1, n, n, dtype)


@pytest.mark.parametrize("case,expect", [
    (dict(), True),
    (dict(platform="cpu"), False),
    (dict(dtype=jnp.float64), False),
    (dict(dtype=jnp.bfloat16), False),
    (dict(n=2045), False),
    (dict(n_devices=4), False),
    (dict(max_sweeps=9), False),
    (dict(max_sweeps=8), True),
    (dict(stencil9=True), False),
    (dict(field=True), False),
])
def test_kernel_eligible(case, expect):
    n = case.get("n", 2047)
    dtype = case.get("dtype", jnp.float32)
    st = _st(n, dtype)
    if case.get("stencil9"):
        z = jnp.zeros((1, 1), dtype)
        st = Stencil9(z, st.cs, z, st.cw, st.cc, st.ce, z, st.cn, z)
    if case.get("field"):
        st = st._replace(cw=jnp.broadcast_to(st.cw, (n, n)))
    assert k5.kernel_eligible(
        st, (n, n), dtype, case.get("max_sweeps", 3),
        case.get("platform", "gpu"), case.get("n_devices", 1)) is expect


@pytest.mark.parametrize("shape", [(7, 1), (1, 1), ()])
def test_coef_columns_layout(shape):
    """Scalars and (ny, 1) columns broadcast to the (5, ny) rows the
    kernel reads, in the order cs, cw, cc, ce, cn."""
    ny = 7
    vals = [jnp.full(shape, float(i + 1)) for i in range(5)]
    cols = np.asarray(k5.coef_columns(Stencil5(*vals), ny))
    assert cols.shape == (5, ny) and cols.dtype == np.float32
    np.testing.assert_array_equal(cols[:, 0], [1, 2, 3, 4, 5])


# --------------------------------------------------------------------------
# Wiring: the emulated kernel stands in for the CUDA call
# --------------------------------------------------------------------------


def _fake_smooth5(st, b, u, steps, emit_r=False):
    steps = tuple(steps)
    out = jax.ShapeDtypeStruct(b.shape, jnp.float32)

    def host(b, *u):
        res = emulate(st, b, u[0] if u else None, steps, emit_r)
        if emit_r:
            return tuple(np.asarray(x, np.float32) for x in res)
        return np.asarray(res, np.float32)

    args = (b,) if u is None else (b, u)
    return jax.pure_callback(host, (out, out) if emit_r else out, *args)


@pytest.fixture
def fake_gpu(monkeypatch):
    """A 'GPU' whose kernel is the emulation, with the size threshold
    lowered so small grids take it."""
    monkeypatch.setattr(context, "_platform", lambda: "gpu")
    monkeypatch.setattr(k5, "MIN_SIDE", 63)
    monkeypatch.setattr(k5, "smooth5", _fake_smooth5)


def _cfg(**kw):
    base = dict(npts=129, grids=4, levels=4, cycle=CycleType.MGCG,
                dtype="float32", rtol=1e-5, max_iter=50)
    base.update(kw)
    return SolverConfig(**base)


@pytest.mark.parametrize("cycle", [CycleType.MGCG, CycleType.VCYCLE,
                                   CycleType.FMG, CycleType.PCMG])
@pytest.mark.parametrize("smoother", [SmootherType.JACOBI,
                                      SmootherType.CHEBYSHEV])
def test_wired_solve_matches_plain(fake_gpu, smoother, cycle):
    # Cycles that stop on a recomputed f32 residual floor near
    # eps32 (8/h^2) ||u|| / ||b|| ~ 4e-4 at 129^2; mg-CG's recursion
    # residual goes below it.
    rtol = 1e-5 if cycle == CycleType.MGCG else 2e-3
    fast = solve(_cfg(smoother=smoother, cycle=cycle, rtol=rtol))
    plain = solve(_cfg(smoother=smoother, cycle=cycle, rtol=rtol,
                       backend="xla"))
    # 127 and 63 take the kernel; 31 (and the direct coarsest 15) do not.
    assert [l.cuda_smoother for l in fast.ctx.levels] == [True, True,
                                                         False, False]
    assert not any(l.cuda_smoother for l in plain.ctx.levels)
    assert fast.path == "cuda"
    assert fast.converged and fast.iters == plain.iters
    np.testing.assert_allclose(fast.u_fine, plain.u_fine, rtol=0,
                               atol=1e-4 * np.abs(plain.u_fine).max())


def test_cpu_never_takes_kernel(monkeypatch):
    monkeypatch.setattr(k5, "MIN_SIDE", 63)
    res = solve(_cfg())
    assert res.path == "generic"
    assert not any(l.cuda_smoother for l in res.ctx.levels)


def test_f64_and_sparse_never_take_kernel(fake_gpu):
    assert solve(_cfg(dtype="float64")).path == "generic"
    res = solve(_cfg(dtype="float64", backend="sparse",
                     cycle=CycleType.VCYCLE))
    assert not any(l.cuda_smoother for l in res.ctx.levels)


def test_sharded_levels_never_take_kernel(fake_gpu):
    from multigrid_petsc_tpu.parallel.device_mesh import row_plan

    res = solve(_cfg(), plan=row_plan(min_local=8))
    assert not any(l.cuda_smoother for l in res.ctx.levels)


def test_view_solver_names_kernel(fake_gpu):
    from multigrid_petsc_tpu.utils.views import view_solver

    out = view_solver(solve(_cfg(max_iter=2)).ctx)
    assert "op=cuda-smoother" in out and "op=xla" in out


@pytest.mark.parametrize("backend", ["pallas", "cuda", ""])
def test_unknown_backend_is_an_error(backend):
    with pytest.raises(ValueError, match="unknown backend"):
        _cfg(backend=backend).validate()
