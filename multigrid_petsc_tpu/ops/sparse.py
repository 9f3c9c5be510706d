"""Explicit sparse operator backend: CSR assembly (native C++) + SpMV.

The second operator form required by BASELINE.json ("explicit CSR/BSR
SpMV" alongside matrix-free): the level operator — including composite
merged-grid coupling blocks — is assembled into CSR by the native C++
engine (native/csr_assemble.cpp, the framework's graph-builder analogue of
the reference's fill* assembly, src/solver.c:185-556), then converted to a
fixed-width ELL layout for the SpMV.

ELL: vals (N, K) and cols (N, K) with zero padding; SpMV is K gathers + a
row sum.  The matrix-free stencil operators remain the production path;
the explicit form is the parity backend and handles arbitrary row
patterns (composite couplings included) uniformly.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libmgtpu_native.so"
_LIB_SRC = _NATIVE_DIR / "csr_assemble.cpp"


@functools.cache
def _load_native():
    """Build (make, at first use or after a source change) and load the
    native assembly library.  The build goes to a per-process name and is
    renamed into place, so concurrent first uses never load a half-written
    file."""
    if (not _LIB_PATH.exists()
            or _LIB_PATH.stat().st_mtime < _LIB_SRC.stat().st_mtime):
        tmp = f"{_LIB_PATH.name}.{os.getpid()}.tmp"
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR), f"TARGET={tmp}"],
            check=True, capture_output=True,
        )
        os.replace(_NATIVE_DIR / tmp, _LIB_PATH)
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.level_rows.restype = ctypes.c_int64
    lib.level_rows.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int
    ]
    lib.assemble_level.restype = ctypes.c_int64
    lib.assemble_level.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    return lib


def assemble_level_csr(
    npts: int,
    mesh_type: int,
    gids: tuple[int, ...],
    include_diag: bool = True,
    include_couplings: bool = True,
):
    """CSR (indptr, indices, data) of the composite level operator."""
    lib = _load_native()
    gids_arr = (ctypes.c_int * len(gids))(*gids)
    rows = lib.level_rows(npts, gids_arr, len(gids))
    # Generous cap: diag 5/row + couplings bounded by composed stencils.
    per_row = 5 + 64 * max(0, len(gids) - 1) * (4 ** (max(gids) - min(gids)))
    nnz_cap = rows * min(per_row, 4096)
    indptr = np.zeros(rows + 1, dtype=np.int64)
    indices = np.zeros(nnz_cap, dtype=np.int32)
    data = np.zeros(nnz_cap, dtype=np.float64)
    nnz = lib.assemble_level(
        npts, mesh_type, gids_arr, len(gids),
        int(include_diag), int(include_couplings),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nnz_cap,
    )
    if nnz < 0:
        raise RuntimeError(f"native assembly failed (code {nnz})")
    return indptr, indices[:nnz], data[:nnz]


def csr_to_ell(indptr, indices, data, dtype=np.float64):
    """Pad CSR rows to the max row width (ELLPACK); cols padded with 0 and
    vals with 0.0 so padded slots contribute nothing.  Fully vectorized
    (one scatter over the nnz — a Python per-row loop takes minutes at
    8193^2 / 67M rows)."""
    rows = len(indptr) - 1
    indptr = np.asarray(indptr)
    widths = np.diff(indptr)
    k = int(widths.max()) if rows else 0
    cols = np.zeros((rows, k), dtype=np.int32)
    vals = np.zeros((rows, k), dtype=dtype)
    r_of = np.repeat(np.arange(rows), widths)
    pos = np.arange(len(indices)) - np.repeat(indptr[:-1], widths)
    cols[r_of, pos] = indices
    vals[r_of, pos] = data
    return jnp.asarray(vals), jnp.asarray(cols)


def ell_spmv(vals: jnp.ndarray, cols: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """y = A x with ELL storage: K gathers + row-sum."""
    return jnp.sum(vals * x[cols], axis=1)


class SparseLevelOp:
    """Explicit operator over a flattened level state (ELL storage)."""

    def __init__(self, npts, mesh_type, gids, dtype=np.float64,
                 include_diag=True, include_couplings=True):
        self.gids = tuple(gids)
        self.shapes = [
            ((npts - 1) // 2**g - 1, (npts - 1) // 2**g - 1) for g in gids
        ]
        csr = assemble_level_csr(npts, mesh_type, self.gids,
                                 include_diag, include_couplings)
        self.nnz = len(csr[1])
        self.vals, self.cols = csr_to_ell(*csr, dtype=dtype)

    def flatten(self, state):
        return jnp.concatenate([x.ravel() for x in state])

    def unflatten(self, vec):
        out, off = [], 0
        for (ny, nx) in self.shapes:
            out.append(vec[off : off + ny * nx].reshape(ny, nx))
            off += ny * nx
        return tuple(out)

    def apply(self, state):
        """y = A x."""
        return self.unflatten(
            ell_spmv(self.vals, self.cols, self.flatten(state))
        )
