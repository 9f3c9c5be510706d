"""Two-float32 ("double-single") arithmetic for the high-precision outer.

An alternative to native float64 for the 1e-8 residual certification
(BASELINE.md: "wall time to 1e-8").  A value is carried as an unevaluated
sum hi + lo of two float32 arrays with |lo| <= ulp(hi)/2, giving ~2^-47
effective relative precision — enough to certify 1e-8 relative residuals
up to ~8193^2 (attainable residual ~ eps * ||A|| ||u|| / ||b||) — while
every operation runs as a handful of native f32 vector ops.  The kernels
are the classic error-free transformations (Knuth two-sum, Dekker
two-product), fused under jit.

Role in the framework: `outer_dtype="float32x2"` runs the defect-
correction outer PCG (solvers/krylov.py) in this arithmetic; the f32
multigrid V-cycle stays the preconditioner.  Reference analogue: the
outer true-residual loop of the PCMG path (src/solver.c:1884-1989) —
the reference runs everything in native double.

Correctness requires IEEE-754 f32 ops with round-to-nearest AND that
every intermediate is rounded to f32.  The second condition is the subtle
one under XLA: backend codegen may CONTRACT a multiply feeding an
add/subtract into one fused-multiply-add, skipping the product's
rounding.  Contracting ``a*b - p`` inside two_prod's error term is exact
(that IS the fma of the error), but contracting the product ``p = a*b``
itself into a downstream sum (observed on XLA:CPU: ``s = p + p2`` became
``fma(a, b, p2)``, changing s by 1 ulp and silently destroying the
renormalization invariant |lo| <= ulp(hi)/2) breaks the arithmetic at
eps32 scale.  Every intermediate whose ROUNDED value is load-bearing —
two_prod's p, the Dekker split's t, and the EFT sums s — is therefore
pinned with ``lax.reduce_precision(v, 8, 23)``: semantically the f32
identity, but an explicit HLO rounding op (``lax.optimization_barrier``
does NOT work for this — XLA's barrier expander strips it before fusion,
observed on XLA:CPU).  All other products only feed low-order error terms
where an fma rewrite is harmless or beneficial.  The f64 -> double-single
split avoids f32 round trips for the same reason (see ``from_f64``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_F32 = jnp.float32
# Dekker split constant for binary32: 2^ceil(24/2) + 1.
_SPLIT = jnp.float32(4097.0)


class TF(NamedTuple):
    """Unevaluated f32 sum hi + lo (both same-shape float32 arrays)."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def shape(self):
        return self.hi.shape


# ---------------------------------------------------------------------------
# Error-free transformations (all exact identities in IEEE f32).
# ---------------------------------------------------------------------------

def _rp32(v):
    """Pin ``v`` to its rounded f32 value: an explicit rounding op that
    backend codegen cannot fma-contract across (see module docstring)."""
    return jax.lax.reduce_precision(v, exponent_bits=8, mantissa_bits=23)


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a+b) (Knuth; branch-free)."""
    s = _rp32(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Exact sum assuming |a| >= |b| (Dekker)."""
    s = _rp32(a + b)
    e = b - (s - a)
    return s, e


def _split(a):
    # t must be the ROUNDED product (an fma-contracted t - a would skip
    # that rounding and corrupt the split) — see module docstring.
    t = _rp32(_SPLIT * a)
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a*b) (Dekker split; an FMA rewrite
    of the error TERM ``a*b - p`` is exact and therefore harmless, but p
    itself must stay a rounded value — see module docstring)."""
    p = _rp32(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# Double-single operations (QD-library style, accurate variants).
# ---------------------------------------------------------------------------

def add(x: TF, y: TF) -> TF:
    """x + y with two-term renormalization (error O(2^-47))."""
    s1, s2 = two_sum(x.hi, y.hi)
    t1, t2 = two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = fast_two_sum(s1, s2)
    s2 = s2 + t2
    return TF(*fast_two_sum(s1, s2))


def neg(x: TF) -> TF:
    return TF(-x.hi, -x.lo)


def sub(x: TF, y: TF) -> TF:
    return add(x, neg(y))


def mul(x: TF, y: TF) -> TF:
    """x * y (broadcasts; use for coefficient * field products)."""
    p1, p2 = two_prod(x.hi, y.hi)
    p2 = p2 + (x.hi * y.lo + x.lo * y.hi)
    return TF(*fast_two_sum(p1, p2))


def scale_f32(x: TF, a) -> TF:
    """x * a for a plain f32 scalar a (CG step sizes)."""
    p1, p2 = two_prod(x.hi, a)
    p2 = p2 + x.lo * a
    return TF(*fast_two_sum(p1, p2))


def axpy(a, x: TF, y: TF) -> TF:
    """y + a * x, a a plain f32 scalar."""
    return add(y, scale_f32(x, a))


# ---------------------------------------------------------------------------
# Conversions.
# ---------------------------------------------------------------------------

def from_f32(x) -> TF:
    x = jnp.asarray(x, _F32)
    return TF(x, jnp.zeros_like(x))


_HI_MASK = 0xFFFFFFFFE0000000  # keeps the sign, exponent, top 23 mantissa bits


def from_f64(x) -> TF:
    """Split an f64 array into its two-float32 parts (needs
    jax_enable_x64 when tracing on device).

    The high part is x with its mantissa cut to f32's width by masking
    bits, not by an f32 round trip: XLA may fold convert(convert(x, f32),
    f64) back into x (the GPU compiler does, as it allows excess precision
    by default), which would zero every low part.  x - hi is then exact in
    f64, and a final fast_two_sum restores |lo| <= ulp(hi)/2."""
    bits = jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float64),
                                        jnp.uint64)
    hi64 = jax.lax.bitcast_convert_type(bits & jnp.uint64(_HI_MASK),
                                        jnp.float64)
    return TF(*fast_two_sum(hi64.astype(_F32), (x - hi64).astype(_F32)))


def to_f64(x: TF):
    return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)


def to_f64_np(x: TF):
    """Host-side f64 view (works without jax_enable_x64)."""
    import numpy as np

    return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)


# ---------------------------------------------------------------------------
# Reductions.  CG's scalars (alpha, beta, norms) only need working
# precision — the attainable-residual floor is set by the precision of
# the vector updates and the operator apply, not the step sizes — so
# dots reduce the exact elementwise double-single products with XLA's
# (tree-ordered) f32 sums: relative error ~ eps32 * log2(n).
# ---------------------------------------------------------------------------

def dot(x: TF, y: TF):
    p = mul(x, y)
    return jnp.sum(p.hi) + jnp.sum(p.lo)


def norm2(x: TF):
    return jnp.sqrt(dot(x, x))


# ---------------------------------------------------------------------------
# Stencil applies in double-single precision (the outer defect operator).
# Mirrors ops/stencil.py apply_stencil5/9; zero halo ring = eliminated
# homogeneous-Dirichlet boundary (reference: src/solver.c:239-251).
# ---------------------------------------------------------------------------

class Stencil5TF(NamedTuple):
    cs: TF
    cw: TF
    cc: TF
    ce: TF
    cn: TF


class Stencil9TF(NamedTuple):
    csw: TF
    cs: TF
    cse: TF
    cw: TF
    cc: TF
    ce: TF
    cnw: TF
    cn: TF
    cne: TF


def split_stencil(st) -> "Stencil5TF | Stencil9TF":
    """Split an f64 Stencil5/Stencil9 into two-float32 coefficients."""
    parts = tuple(from_f64(jnp.asarray(c)) for c in st)
    return (Stencil5TF if len(parts) == 5 else Stencil9TF)(*parts)


def _pad1(x: TF) -> TF:
    return TF(jnp.pad(x.hi, 1), jnp.pad(x.lo, 1))


def apply_stencil5(st: Stencil5TF, u: TF) -> TF:
    p = _pad1(u)
    out = mul(st.cc, u)
    out = add(out, mul(st.cs, TF(p.hi[:-2, 1:-1], p.lo[:-2, 1:-1])))
    out = add(out, mul(st.cn, TF(p.hi[2:, 1:-1], p.lo[2:, 1:-1])))
    out = add(out, mul(st.cw, TF(p.hi[1:-1, :-2], p.lo[1:-1, :-2])))
    out = add(out, mul(st.ce, TF(p.hi[1:-1, 2:], p.lo[1:-1, 2:])))
    return out


def apply_stencil9(st: Stencil9TF, u: TF) -> TF:
    p = _pad1(u)
    out = mul(st.cc, u)
    out = add(out, mul(st.cs, TF(p.hi[:-2, 1:-1], p.lo[:-2, 1:-1])))
    out = add(out, mul(st.cn, TF(p.hi[2:, 1:-1], p.lo[2:, 1:-1])))
    out = add(out, mul(st.cw, TF(p.hi[1:-1, :-2], p.lo[1:-1, :-2])))
    out = add(out, mul(st.ce, TF(p.hi[1:-1, 2:], p.lo[1:-1, 2:])))
    out = add(out, mul(st.csw, TF(p.hi[:-2, :-2], p.lo[:-2, :-2])))
    out = add(out, mul(st.cse, TF(p.hi[:-2, 2:], p.lo[:-2, 2:])))
    out = add(out, mul(st.cnw, TF(p.hi[2:, :-2], p.lo[2:, :-2])))
    out = add(out, mul(st.cne, TF(p.hi[2:, 2:], p.lo[2:, 2:])))
    return out
