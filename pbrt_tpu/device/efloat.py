"""Batched EFloat interval arithmetic (src/core/efloat.rs).

The reference tracks every intersection quantity as an interval
[low, high] widened by one ulp (next_float_down/up) after each operation,
then accepts a quadric root iff its interval is strictly positive and its
upper bound is within t_max (sphere.rs:91-102). Per-lane next-ulp bit
bumps are costly integer work per lane, so this module widens by +/- 2*eps*|x|
instead — for normal f32, |next_float_up(x) - x| <= 2*eps*|x|, so the
interval here always CONTAINS the reference's (conservative, never
tighter in the unsafe direction). Exact zeros stay zero, which matches
denormal flushing (next_float_down(0) is a denormal, flushed to 0 under
XLA's default flush-to-zero).

Values are (v, lo, hi) triples of same-shape f32 arrays. Only the ops the
quadric solves need are provided.

Deviation from the reference, documented: quadratic() computes the
discriminant in f32 (efloat.rs:211 uses f64); an f64 discriminant is a
fidelity item on the roadmap.
The b*b and 4ac products are widened by the interval rules instead, so
near-tangent hits degrade to conservative misses rather than phantoms.
"""
from __future__ import annotations

import jax.numpy as jnp

# 2 * machine epsilon for f32 (directed-rounding inflation factor).
# Kept as a PYTHON float so it inlines as a scalar literal: a module-level
# jnp array would be captured as a hoisted closure constant in every trace
# that touches these ops.
_TWO_EPS = float(2.0 * 2.0 ** -23)


def _down(x):
    return x - jnp.abs(x) * _TWO_EPS


def _up(x):
    return x + jnp.abs(x) * _TWO_EPS


def ef(v, err=None):
    """EFloat::new(v, err) — exact if err is None/0 (efloat.rs:12-25)."""
    v = jnp.asarray(v, jnp.float32)
    if err is None:
        return (v, v, v)
    err = jnp.asarray(err, jnp.float32)
    return (v, _down(v - err), _up(v + err))


def add(a, b):
    av, alo, ahi = a
    bv, blo, bhi = b
    return (av + bv, _down(alo + blo), _up(ahi + bhi))


def sub(a, b):
    av, alo, ahi = a
    bv, blo, bhi = b
    return (av - bv, _down(alo - bhi), _up(ahi - blo))


def mul(a, b):
    av, alo, ahi = a
    bv, blo, bhi = b
    p00 = alo * blo
    p01 = alo * bhi
    p10 = ahi * blo
    p11 = ahi * bhi
    lo = jnp.minimum(jnp.minimum(p00, p01), jnp.minimum(p10, p11))
    hi = jnp.maximum(jnp.maximum(p00, p01), jnp.maximum(p10, p11))
    return (av * bv, _down(lo), _up(hi))


def div(a, b):
    """Interval division; a divisor interval straddling 0 yields
    [-inf, inf] (efloat.rs Div: the reference returns infinite bounds)."""
    av, alo, ahi = a
    bv, blo, bhi = b
    straddle = (blo <= 0.0) & (bhi >= 0.0)
    safe_blo = jnp.where(straddle, 1.0, blo)
    safe_bhi = jnp.where(straddle, 1.0, bhi)
    q00 = alo / safe_blo
    q01 = alo / safe_bhi
    q10 = ahi / safe_blo
    q11 = ahi / safe_bhi
    lo = jnp.minimum(jnp.minimum(q00, q01), jnp.minimum(q10, q11))
    hi = jnp.maximum(jnp.maximum(q00, q01), jnp.maximum(q10, q11))
    lo = jnp.where(straddle, -float("inf"), _down(lo))
    hi = jnp.where(straddle, float("inf"), _up(hi))
    vv = av / jnp.where(bv != 0.0, bv, 1e-30)
    return (vv, lo, hi)


def sqr(a):
    """a*a with the tighter same-operand bounds (interval square >= 0)."""
    av, alo, ahi = a
    m0 = alo * alo
    m1 = ahi * ahi
    lo = jnp.minimum(m0, m1)
    hi = jnp.maximum(m0, m1)
    crosses = (alo <= 0.0) & (ahi >= 0.0)
    lo = jnp.where(crosses, 0.0, lo)
    return (av * av, _down(lo), _up(hi))


def neg(a):
    av, alo, ahi = a
    return (-av, -ahi, -alo)


def scale(a, s):
    """Multiply by an EXACT scalar/array s."""
    return mul(a, ef(s))


def quadratic(a, b, c):
    """EFloat quadratic solve (efloat.rs:211-233).

    Returns (has_root, t0, t1) with t0 <= t1 (by midpoint value); each t is
    a (v, lo, hi) triple. has_root is False where the f32 discriminant is
    negative.
    """
    av, _, _ = a
    bv, _, _ = b
    cv, _, _ = c
    disc = bv * bv - 4.0 * av * cv
    has = disc >= 0.0
    rd = jnp.sqrt(jnp.maximum(disc, 0.0))
    # interval discriminant: the f32 cancellation error of b*b - 4ac is NOT
    # bounded by eps*rd (the reference sidesteps this with an f64 disc,
    # efloat.rs:212; here f32 throughout), so propagate bounds through the
    # products and sqrt instead
    Edisc = sub(sqr(b), mul(mul(ef(jnp.float32(4.0)), a), c))
    frd = (rd,
           jnp.sqrt(jnp.maximum(Edisc[1], 0.0)),
           jnp.sqrt(jnp.maximum(Edisc[2], 0.0)))
    q_neg = mul(sub(b, frd), ef(jnp.float32(-0.5)))
    q_pos = mul(add(b, frd), ef(jnp.float32(-0.5)))
    is_neg = bv < 0.0
    q = tuple(jnp.where(is_neg, n, p) for n, p in zip(q_neg, q_pos))
    t0 = div(q, a)
    t1 = div(c, q)
    swap = t0[0] > t1[0]
    lo_t = tuple(jnp.where(swap, x1, x0) for x0, x1 in zip(t0, t1))
    hi_t = tuple(jnp.where(swap, x0, x1) for x0, x1 in zip(t0, t1))
    return has, lo_t, hi_t


def transform_ray_error(w2o, o, d):
    """FP error introduced by transforming an (exact) world ray into object
    space (transform.rs transform_point_error :433 / transform_vector
    error): o_err = gamma(3) (|M||o| + |m_t|), d_err = gamma(3) |M||d|.
    w2o: (..., 3, 4); o, d: (..., 3). Returns (o_err, d_err)."""
    g3 = jnp.float32(3.0 * 2.0 ** -24 / (1.0 - 3.0 * 2.0 ** -24))
    absM = jnp.abs(w2o[..., :3])
    o_err = g3 * (jnp.einsum("...ij,...j->...i", absM, jnp.abs(o))
                  + jnp.abs(w2o[..., 3]))
    d_err = g3 * jnp.einsum("...ij,...j->...i", absM, jnp.abs(d))
    return o_err, d_err
