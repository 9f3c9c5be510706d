"""Temporally blocked 5-point smoother on NVIDIA Hopper (CUDA via jax.ffi).

The plain path (``solvers/smoothers.jacobi``/``chebyshev`` and the level
residual) reads and writes the whole level once per sweep.  The kernel in
``native/smooth5.cu`` reads u, b and the coefficient columns once, runs the
k sweeps on a ``TILE_Y x TILE_X`` tile plus a k-wide halo in shared memory,
and writes u (and, on request, r = b - A u) once.  Blocks are independent.

What stays in Python, where the CPU tests reach it: the tile and halo
geometry, the coefficient layout, and the choice of kernel
(``kernel_eligible``).  The library is built with ``nvcc`` at first use into
``native/build/`` (listed in ``.gitignore``); building it needs the CUDA
toolkit, so it happens only on a machine with a card.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from multigrid_petsc_tpu.ops.stencil import Stencil5

# Mirrors kTileY / kTileX / kMaxSweeps in native/smooth5.cu.
TILE_Y = 16
TILE_X = 128
MAX_SWEEPS = 8
# Smallest grid side that takes the kernel: below it the level's u, b and r
# fit the card's 50 MB L2 together, so the plain path's extra passes do not
# reach device memory and the kernel has nothing to save.
MIN_SIDE = 2047

_NATIVE = pathlib.Path(__file__).resolve().parents[2] / "native"
_SRC = _NATIVE / "smooth5.cu"
_LIB = _NATIVE / "build" / "libmg_smooth5.so"


def halo(sweeps: int, emit_r: bool) -> int:
    """Halo width: one ring goes stale per sweep, one more for r."""
    return sweeps + int(emit_r)


def window(sweeps: int, emit_r: bool) -> tuple[int, int]:
    """(rows, cols) of the shared-memory window one block stages."""
    h = halo(sweeps, emit_r)
    return TILE_Y + 2 * h, TILE_X + 2 * h


def smem_bytes(sweeps: int, emit_r: bool) -> int:
    """Dynamic shared memory per block: u twice (ping-pong), b, p, and
    the five coefficient rows of the window."""
    wy, wx = window(sweeps, emit_r)
    return 4 * (4 * wy * wx + 5 * wy)


def grid(ny: int, nx: int) -> tuple[int, int]:
    """CUDA grid (x blocks, y blocks) covering an (ny, nx) level."""
    return -(-nx // TILE_X), -(-ny // TILE_Y)


def coef_columns(st: Stencil5, ny: int):
    """The stencil as a (5, ny) float32 array of per-row coefficients
    (cs, cw, cc, ce, cn), or None when a coefficient varies along x."""
    if any(jnp.ndim(c) == 2 and jnp.shape(c)[1] != 1 for c in st):
        return None
    return jnp.stack([jnp.broadcast_to(c, (ny, 1))[:, 0] for c in st]
                     ).astype(jnp.float32)


def kernel_eligible(st, shape, dtype, max_sweeps: int, platform: str,
                    n_devices: int = 1) -> bool:
    """Whether a level runs the kernel: a GPU, one device, float32, a
    5-point stencil with per-row coefficients, a sweep count the kernel's
    shared memory holds, and both sides at least MIN_SIDE."""
    ny, nx = shape
    return (platform == "gpu" and n_devices == 1
            and jnp.dtype(dtype) == jnp.float32
            and isinstance(st, Stencil5)
            and 1 <= max_sweeps <= MAX_SWEEPS
            and min(ny, nx) >= MIN_SIDE
            and coef_columns(st, ny) is not None)


def build_library() -> pathlib.Path:
    """Compile native/smooth5.cu for sm_90a unless an up-to-date build
    exists; returns the library path."""
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("the CUDA smoother needs nvcc (CUDA toolkit) to "
                           "build native/smooth5.cu")
    _LIB.parent.mkdir(exist_ok=True)
    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_SRC)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stderr}")
    os.replace(tmp, _LIB)
    return _LIB


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(str(build_library()))
    for name, sym in (("mg_smooth5", lib.MgSmooth5),
                      ("mg_smooth5_res", lib.MgSmooth5Res)):
        jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(sym),
                                    platform="CUDA")


def smooth5(st: Stencil5, b, u, steps, emit_r: bool = False):
    """k = len(steps) smoother steps (alpha, beta) from ``u`` (None: zero
    initial guess, u is then never read); returns u, or (u, b - A u)."""
    _register()
    ny, nx = b.shape
    out = jax.ShapeDtypeStruct((ny, nx), jnp.float32)
    call = jax.ffi.ffi_call("mg_smooth5_res" if emit_r else "mg_smooth5",
                            (out, out) if emit_r else out)
    steps = jnp.asarray(np.asarray(steps, np.float32).reshape(-1, 2))
    return call(b if u is None else u, b, coef_columns(st, ny), steps,
                zero_guess=np.int32(u is None))
