"""Stateless device RNG + low-discrepancy sample generation.

The reference threads mutable sampler objects through the render loop
(src/core/sampler.rs, src/core/rng.rs PCG32, src/core/lowdiscrepancy.rs).
On the device every sample must be a pure function of (pixel, sample_index,
dimension), so samplers become stateless counter-based hashes / generator
matrices over uint32 lanes — the same decomposition the reference's *global*
samplers already use (get_index_for_sample / sample_dimension).
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

U32 = jnp.uint32
ONE_MINUS_EPS = np.float32(1.0 - 2.0 ** -24)
_INV_2_32 = np.float32(2.3283064365386963e-10)  # 0x1p-32


def _u32(x):
    if isinstance(x, int):
        return jnp.asarray(np.uint32(x & 0xFFFFFFFF))
    return jnp.asarray(x).astype(U32)


def pcg_hash(x):
    """PCG output permutation as an integer hash (one round).

    Mirrors the reference's PCG32 core (src/core/rng.rs:6-67) used as a
    stateless mixer; standard pcg_hash from Jarzynski & Olano.
    """
    x = _u32(x)
    state = x * U32(747796405) + U32(2891336453)
    word = ((state >> (state >> U32(28)) + U32(4)) ^ state) * U32(277803737)
    return (word >> U32(22)) ^ word


def hash_combine(*xs):
    h = _u32(0x9E3779B9)
    for x in xs:
        h = pcg_hash(h ^ _u32(x))
    return h


def u32_to_float(u):
    """uint32 -> [0, 1) float32 (matches reference one_minus_epsilon clamp)."""
    f = u.astype(jnp.float32) * _INV_2_32
    return jnp.minimum(f, ONE_MINUS_EPS)


def uniform_1d(seed, pixel, sample, dim):
    return u32_to_float(hash_combine(seed, pixel, sample, dim))


def uniform_2d(seed, pixel, sample, dim):
    u = uniform_1d(seed, pixel, sample, dim)
    v = uniform_1d(seed, pixel, sample, _u32(dim) + U32(0x5555))
    return u, v


# ---------------------------------------------------------------------------
# Radical inverse / Van der Corput / Sobol' (0,2)-sequence
# ---------------------------------------------------------------------------


def reverse_bits_32(x):
    x = _u32(x)
    x = ((x << U32(16)) | (x >> U32(16)))
    x = ((x & U32(0x00FF00FF)) << U32(8)) | ((x & U32(0xFF00FF00)) >> U32(8))
    x = ((x & U32(0x0F0F0F0F)) << U32(4)) | ((x & U32(0xF0F0F0F0)) >> U32(4))
    x = ((x & U32(0x33333333)) << U32(2)) | ((x & U32(0xCCCCCCCC)) >> U32(2))
    x = ((x & U32(0x55555555)) << U32(1)) | ((x & U32(0xAAAAAAAA)) >> U32(1))
    return x


def van_der_corput(index, scramble):
    """Base-2 radical inverse with XOR scramble (lowdiscrepancy.rs Gray-code
    VanDerCorput path — bit reversal is the closed form, tests/sampling.rs:16)."""
    return u32_to_float(reverse_bits_32(index) ^ _u32(scramble))


# Sobol' second-dimension generator matrix (direction numbers for the
# Davies-linked (0,2)-sequence; same matrix the reference's sobol_2d uses:
# src/core/lowdiscrepancy.rs Sobol2D). Precomputed as 32 uint32 columns.
def _sobol2_matrix():
    v = np.zeros(32, dtype=np.uint64)
    a = 1 << 31
    for i in range(32):
        v[i] = a
        a ^= a >> 1
    return v.astype(np.uint32)


_SOBOL2 = _sobol2_matrix()


def sobol_2nd_dim(index, scramble):
    """Second component of the (0,2)-sequence via generator-matrix multiply."""
    index = _u32(index)
    result = _u32(scramble)
    for i in range(32):
        bit = (index >> U32(i)) & U32(1)
        result = result ^ (bit * U32(int(_SOBOL2[i])))
    return u32_to_float(result)


def sample_02(index, scramble_x, scramble_y):
    """One point of the scrambled (0,2)-sequence (ZeroTwoSequence sampler,
    src/samplers/zerotwosequence.rs)."""
    return van_der_corput(index, scramble_x), sobol_2nd_dim(index, scramble_y)


# ---------------------------------------------------------------------------
# Halton: scrambled radical inverse over prime bases
# (src/core/lowdiscrepancy.rs radical_inverse + pbrt_macros specialization)
# ---------------------------------------------------------------------------

PRIMES = np.array(
    [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
     73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
     157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
     239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311, 313, 317,
     331, 337, 347, 349, 353, 359, 367, 373, 379, 383, 389, 397, 401, 409, 419,
     421, 431, 433, 439, 443, 449, 457, 461, 463, 467, 479, 487, 491, 499, 503,
     509, 521, 523, 541], dtype=np.int64)


def radical_inverse_dyn(base_index, index):
    """Radical inverse with a TRACED base index (per-lane primes).

    The rolled persistent-wavefront bounce loop has per-lane dimensions,
    so the prime base is a traced gather from PRIMES; 32 fixed digit
    iterations cover indices < 2^32 in the worst base (2) and terminate
    early (index hits 0) for larger bases. halton.rs:120-156 continues the
    SAME sequence into all dims — the traced path no longer falls back to
    the (0,2) family."""
    primes_dev = jnp.asarray(PRIMES.astype(np.uint32))
    b = primes_dev[jnp.clip(jnp.asarray(base_index), 0, len(PRIMES) - 1)]
    index = jnp.asarray(index).astype(jnp.uint32)
    bf = b.astype(jnp.float32)
    inv_base = 1.0 / bf
    reversed_digits = jnp.zeros(jnp.broadcast_shapes(index.shape, b.shape), jnp.float32)
    inv_base_n = jnp.ones_like(reversed_digits)
    for _ in range(32):
        next_i = index // b
        digit = index - next_i * b
        has = index > 0
        reversed_digits = jnp.where(has, reversed_digits * bf + digit.astype(jnp.float32), reversed_digits)
        inv_base_n = jnp.where(has, inv_base_n * inv_base, inv_base_n)
        index = next_i
    return jnp.minimum(reversed_digits * inv_base_n, ONE_MINUS_EPS)


def radical_inverse(base_index: int, index):
    """Radical inverse of `index` in PRIMES[base_index] (static base).

    Digit loop length is the static number of digits needed for 2^32 in that
    base, so it unrolls into straight-line vector code.
    """
    b = int(PRIMES[base_index])
    if b == 2:
        return u32_to_float(reverse_bits_32(index))
    index = jnp.asarray(index).astype(jnp.uint32)
    n_digits = int(np.floor(np.log(2.0 ** 32) / np.log(b))) + 1
    inv_base = np.float32(1.0 / b)
    # accumulate in f32: early (low) digits land in the high bits of the
    # result, so f32's 24-bit mantissa loses only bits below output precision
    reversed_digits = jnp.zeros(index.shape, jnp.float32)
    inv_base_n = jnp.ones(index.shape, jnp.float32)
    for _ in range(n_digits):
        next_i = index // b
        digit = index - next_i * b
        has = index > 0
        reversed_digits = jnp.where(has, reversed_digits * b + digit.astype(jnp.float32), reversed_digits)
        inv_base_n = jnp.where(has, inv_base_n * inv_base, inv_base_n)
        index = next_i
    return jnp.minimum(reversed_digits * inv_base_n, ONE_MINUS_EPS)


def scrambled_radical_inverse(base_index: int, index, perm):
    """Scrambled radical inverse: perm is a (base,) int32 digit permutation
    (lowdiscrepancy.rs scrambled_radical_inverse; tests/sampling.rs:23-45)."""
    b = int(PRIMES[base_index])
    index = jnp.asarray(index).astype(jnp.uint32)
    n_digits = int(np.floor(np.log(2.0 ** 32) / np.log(b))) + 1
    inv_base = np.float32(1.0 / b)
    reversed_digits = jnp.zeros(index.shape, jnp.float32)
    inv_base_n = jnp.ones(index.shape, jnp.float32)
    for _ in range(n_digits):
        next_i = index // b
        digit = index - next_i * b
        has = index > 0
        reversed_digits = jnp.where(has, reversed_digits * b + perm[digit].astype(jnp.float32), reversed_digits)
        inv_base_n = jnp.where(has, inv_base_n * inv_base, inv_base_n)
        index = next_i
    # limit term: perm(0) * inv_base_n / (1 - inv_base) accounts for the
    # infinite tail of permuted zero digits
    tail = inv_base_n * perm[0].astype(jnp.float32) * inv_base / (1.0 - inv_base)
    return jnp.minimum(reversed_digits * inv_base_n + tail, ONE_MINUS_EPS)


def faure_permutation(b: int) -> np.ndarray:
    """Deterministic digit permutation (identity-free) — host-side helper."""
    if b == 2:
        return np.array([0, 1], dtype=np.int32)
    if b % 2 == 0:
        h = faure_permutation(b // 2)
        return np.concatenate([2 * h, 2 * h + 1]).astype(np.int32)
    c = (b - 1) // 2
    p = faure_permutation(b - 1)
    p = np.where(p >= c, p + 1, p)
    return np.concatenate([p[:c], [c], p[c:]]).astype(np.int32)
