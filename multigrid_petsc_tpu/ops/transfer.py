"""Inter-grid transfer operators: full-weighting restriction, bilinear
prolongation, and multi-gap compositions.

Capability parity with the reference's stencil-wise transfer algebra
(reference: src/matbuild.c:326-442):
  * full-weighting 3x3 restriction [1,2,1;2,4,2;1,2,1]/16
    (src/matbuild.c:422-431),
  * bilinear 3x3 prolongation [1,2,1;2,4,2;1,2,1]/4
    (src/matbuild.c:398-407),
  * composed operators between grids with a gap > 1, stencil size
    (s+1)*2-1 = 3, 7, 15, ... (src/matbuild.c:336-340, 355-396).

Transfers are matrix-free.  Single-gap restriction is
three strided adds (XLA strided slices); prolongation is an interleave of
four averaged planes built from reshapes/concats — no scatter.  Multi-gap
transfers are applied as repeated single-gap transfers, which is
mathematically identical to the reference's composed stencil (verified in
tests against ``composed_transfer_stencil`` + the conv-based appliers
below).

Grid-size relation: a grid with n interior points per dim coarsens to
(n - 1)/2 interior points; fine n_f = 2 n_c + 1.  Coarse point (I, J)
coincides with fine point (2I+1, 2J+1) (interior indexing; reference:
src/matbuild.c:64-67 and src/solver.c:1081-1082).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

# The 3x3 stencils (reference: src/matbuild.c:398-431).
RESTRICT_3x3 = np.array(
    [[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]
) / 16.0
PROLONG_3x3 = np.array(
    [[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]
) / 4.0


def restrict_fw(r: jnp.ndarray) -> jnp.ndarray:
    """Full-weighting restriction, fine (2n+1, 2m+1) -> coarse (n, m).

    Separable [1,2,1]/4 x [1,2,1]/4 form: two passes of single-axis
    strided slices."""
    rows = r[0:-2:2, :] + 2.0 * r[1::2, :] + r[2::2, :]  # (n, 2m+1)
    out = rows[:, 0:-2:2] + 2.0 * rows[:, 1::2] + rows[:, 2::2]
    return 0.0625 * out


def prolong_bilinear(e: jnp.ndarray) -> jnp.ndarray:
    """Bilinear prolongation, coarse (n, m) -> fine (2n+1, 2m+1).

    Built as an interleave of four averaged planes (zero Dirichlet halo),
    using only pads/averages/stack/reshape — no scatter.
    """
    n, m = e.shape
    p = jnp.pad(e, 1)  # zero boundary ring
    ph = (p[:, :-1] + p[:, 1:]) * 0.5  # horizontal midpoints (n+2, m+1)
    pv = (p[:-1, :] + p[1:, :]) * 0.5  # vertical midpoints (n+1, m+2)
    pc = (p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:]) * 0.25  # (n+1, m+1)

    def interleave_cols(a, b):
        # a: (..., k+1), b: (..., k) -> (..., 2k+1) alternating a b a b ... a
        k = b.shape[-1]
        body = jnp.stack([a[..., :k], b], axis=-1).reshape(*a.shape[:-1], 2 * k)
        return jnp.concatenate([body, a[..., -1:]], axis=-1)

    # Even fine rows (2I, I=0..n): corners at even cols, vertical mids at odd.
    rows_even = interleave_cols(pc, pv[:, 1:-1])  # (n+1, 2m+1)
    # Odd fine rows (2I+1, I=0..n-1): horizontal mids at even cols, e at odd.
    rows_odd = interleave_cols(ph[1:-1, :], e)  # (n, 2m+1)

    k = rows_odd.shape[0]
    body = jnp.stack([rows_even[:k], rows_odd], axis=1).reshape(
        2 * k, rows_even.shape[1]
    )
    return jnp.concatenate([body, rows_even[-1:]], axis=0)


def restrict_multi(r: jnp.ndarray, gap: int) -> jnp.ndarray:
    """Restriction across ``gap`` grid levels = gap repeated full-weightings
    (identical to applying the reference's composed stencil,
    src/matbuild.c:355-396)."""
    for _ in range(gap):
        r = restrict_fw(r)
    return r


def prolong_multi(e: jnp.ndarray, gap: int) -> jnp.ndarray:
    """Prolongation across ``gap`` grid levels = gap repeated bilinears."""
    for _ in range(gap):
        e = prolong_bilinear(e)
    return e


def composed_transfer_stencil(base3x3: np.ndarray, gap: int) -> np.ndarray:
    """Explicit composed transfer stencil for a ``gap``-level jump.

    Host-side replica of the reference's stencil-composition algebra
    (src/matbuild.c:355-396): sizes 3, 7, 15, ..., 2^{gap+1} - 1.  Used for
    parity tests and by the explicit sparse backend.
    """
    w = np.asarray(base3x3, dtype=np.float64)
    cur = w.copy()
    for _ in range(gap - 1):
        nl = cur.shape[0]
        nu = (nl + 1) * 2 - 1
        nxt = np.zeros((nu, nu))
        for il in range(nl):
            for jl in range(nl):
                iu = 2 * (il + 1) - 1 - 1  # factor*(il+1)-1 - ni0//2
                ju = 2 * (jl + 1) - 1 - 1
                nxt[iu : iu + 3, ju : ju + 3] += w * cur[il, jl]
        cur = nxt
    return cur


def restrict_with_stencil(r: jnp.ndarray, stencil, stride: int) -> jnp.ndarray:
    """Apply an explicit (symmetric) restriction stencil via strided
    convolution — the parity path for ``restrict_multi``.

    Coarse (I, J) correlates the stencil against fine window starting at
    (stride*I, stride*J) (valid window, see src/solver.c:1081-1088).
    """
    w = jnp.asarray(stencil, dtype=r.dtype)
    out = lax.conv_general_dilated(
        r[None, None],
        w[None, None],
        window_strides=(stride, stride),
        padding="VALID",
        precision=lax.Precision.HIGHEST,  # no TF32 on the GPU
    )
    return out[0, 0]


def prolong_with_stencil(e: jnp.ndarray, stencil, stride: int) -> jnp.ndarray:
    """Apply an explicit (symmetric) prolongation stencil via input-dilated
    convolution — the parity path for ``prolong_multi``."""
    w = jnp.asarray(stencil, dtype=e.dtype)
    s = w.shape[0]
    out = lax.conv_general_dilated(
        e[None, None],
        w[None, None],
        window_strides=(1, 1),
        padding=[(s - 1, s - 1), (s - 1, s - 1)],
        lhs_dilation=(stride, stride),
        precision=lax.Precision.HIGHEST,  # no TF32 on the GPU
    )
    return out[0, 0]
