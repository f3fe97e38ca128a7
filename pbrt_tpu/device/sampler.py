"""Per-ray sample streams for all sampler kinds.

Each sample value is a pure function of (pixel, sample_index, dimension,
seed) — the stateless decomposition of the reference's sampler objects
(src/core/sampler.rs; samplers/{random,stratified,zerotwosequence,halton,
sobol,maxmindist}.rs). Low-discrepancy kinds use the scrambled (0,2)-sequence
for the first dimension pairs and Cranley-Patterson-rotated radical inverses
for higher dimensions; the Halton/Sobol global-index enumeration
(halton.rs:120-156) is kept semantically (deterministic, stratified per
pixel) rather than bit-identically.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from . import rng

F32 = jnp.float32

_LD_KINDS = ("zerotwosequence", "maxmindist", "sobol", "halton", "lowdiscrepancy")


def is_ld(kind: str) -> bool:
    return kind in _LD_KINDS


def sobol_dim(sample_idx, dim: int, scramble):
    """Sobol' sample of dimension `dim` at index `sample_idx`, XOR-scrambled.

    Generator matrices come from core/sobolmat.py (algorithmic equivalent of
    sobolmatrices.rs); the 32 column XORs unroll into pure vector ops.

    Dims >= 1024 (NUM_SOBOL_DIMENSIONS, sobolmatrices.rs) fall back to a
    scramble-hashed uniform — beyond the table the reference has no
    matrices either, and searching new direction numbers for
    arbitrarily-salted NEE dims would blow up host compile time."""
    from ..core.sobolmat import matrix

    if dim >= 1024:
        idxu = jnp.asarray(sample_idx).astype(jnp.uint32)
        return rng.u32_to_float(rng.pcg_hash(jnp.asarray(scramble, jnp.uint32) ^ idxu))
    cols = matrix(dim)
    idxu = jnp.asarray(sample_idx).astype(jnp.uint32)
    res = jnp.broadcast_to(jnp.asarray(scramble, jnp.uint32), idxu.shape)
    for j in range(32):
        c = int(cols[j])
        if c == 0:
            continue
        res = res ^ jnp.where(((idxu >> j) & jnp.uint32(1)) > 0, jnp.uint32(c), jnp.uint32(0))
    return rng.u32_to_float(res)


def sobol_dim_dyn(sample_idx, dim, scramble, max_dim: int = 64):
    """Sobol' sample with a TRACED dimension (per-lane bounce dims in the
    rolled persistent loop): generator-matrix columns for dims < max_dim
    are stacked into a device table and gathered per lane (sobol.rs
    continues the same sequence into all dims)."""
    from ..core.sobolmat import matrix

    global _SOBOL_COLS
    if _SOBOL_COLS is None or _SOBOL_COLS.shape[0] < max_dim:
        _SOBOL_COLS = np.stack([matrix(k) for k in range(max_dim)]).astype(np.uint32)
    cols = jnp.asarray(_SOBOL_COLS)[jnp.clip(jnp.asarray(dim), 0, max_dim - 1)]  # (..., 32)
    idxu = jnp.asarray(sample_idx).astype(jnp.uint32)
    scr = jnp.asarray(scramble, jnp.uint32)
    res = jnp.broadcast_to(scr, jnp.broadcast_shapes(idxu.shape, cols.shape[:-1], scr.shape))
    for j in range(32):
        res = res ^ jnp.where(((idxu >> j) & jnp.uint32(1)) > 0, cols[..., j], jnp.uint32(0))
    return rng.u32_to_float(res)


_SOBOL_COLS = None


# user-declared stratified strata shape (stratified.rs:121-131 spp =
# xsamples * ysamples): render drivers register (xs, ys) before tracing a
# wave so non-square declarations like "8x2" keep their shape instead of the
# floor(sqrt(spp)) fallback. TRACE-TIME capture: the shape is read when a
# wave jits (each render call builds fresh jitted closures, so per-render
# registration is safe); it is consulted only when xs*ys == spp.
_STRATIFIED_SHAPE: tuple[int, int] | None = None
_STRATIFIED_JITTER: bool = True


def set_stratified_shape(xs: int, ys: int, jitter: bool = True) -> None:
    global _STRATIFIED_SHAPE, _STRATIFIED_JITTER
    _STRATIFIED_SHAPE = (max(int(xs), 1), max(int(ys), 1))
    _STRATIFIED_JITTER = bool(jitter)


def stratified_shape(spp: int) -> tuple[int, int]:
    if _STRATIFIED_SHAPE is not None and _STRATIFIED_SHAPE[0] * _STRATIFIED_SHAPE[1] == spp:
        return _STRATIFIED_SHAPE
    import math

    xs = max(int(math.floor(math.sqrt(spp))), 1)
    return xs, max(spp // xs, 1)


def sample_2d(kind: str, seed, pixel, sample_idx, dim, spp: int):
    """One 2D sample. dim may be a static int or a traced int32 (inside the
    rolled persistent bounce loop); traced dims use the SAME Halton/Sobol
    sequences via per-lane base/matrix gathers (halton.rs:120-156 /
    sobol.rs:61-75 continue one global sequence into every dimension)."""
    if kind in ("halton", "sobol") and not isinstance(dim, int):
        if kind == "sobol":
            s1 = rng.hash_combine(seed, pixel, (2 * dim).astype(jnp.uint32))
            s2 = rng.hash_combine(seed, pixel, (2 * dim + 1).astype(jnp.uint32))
            return (sobol_dim_dyn(sample_idx, 2 * dim, s1),
                    sobol_dim_dyn(sample_idx, 2 * dim + 1, s2))
        b0 = jnp.minimum(2 * dim, len(rng.PRIMES) - 2)
        u1 = rng.radical_inverse_dyn(b0, sample_idx)
        u2 = rng.radical_inverse_dyn(b0 + 1, sample_idx)
        r1 = rng.u32_to_float(rng.hash_combine(seed, pixel, (2 * dim).astype(jnp.uint32)))
        r2 = rng.u32_to_float(rng.hash_combine(seed, pixel, (2 * dim + 1).astype(jnp.uint32)))
        u1 = u1 + r1
        u2 = u2 + r2
        return jnp.where(u1 >= 1.0, u1 - 1.0, u1), jnp.where(u2 >= 1.0, u2 - 1.0, u2)
    if kind == "maxmindist" and isinstance(dim, int) and dim == 0:
        return maxmin_2d_dim0(seed, pixel, sample_idx, spp)
    if kind in ("random", "stratified"):
        u1 = rng.uniform_1d(seed, pixel, sample_idx, 2 * dim)
        u2 = rng.uniform_1d(seed, pixel, sample_idx, 2 * dim + 1)
        if kind == "stratified" and isinstance(dim, int):
            # jittered strata on EVERY static dimension pair, not just the
            # film dims (stratified.rs jitters all requested dims; the
            # wavefront sampler decorrelates dims by rotating the stratum
            # order per (pixel, dim) — a valid permutation, so each pixel
            # still covers all spp strata exactly once)
            xs, ys = stratified_shape(spp)
            idx = sample_idx
            if dim != 0:
                rot = rng.hash_combine(seed, pixel, jnp.uint32(7919 * dim))
                idx = (jnp.asarray(sample_idx).astype(jnp.uint32) + rot) % jnp.uint32(max(xs * ys, 1))
            sx = (idx % xs).astype(F32)
            sy = ((idx // xs) % ys).astype(F32)
            if not _STRATIFIED_JITTER:
                # stratified.rs "jitter" false: stratum centers
                u1 = jnp.full_like(u1, 0.5)
                u2 = jnp.full_like(u2, 0.5)
            u1 = (sx + u1) / xs
            u2 = (sy + u2) / ys
        return u1, u2
    if kind == "sobol":
        # true Sobol' dims (2*dim, 2*dim+1) over algorithmically-derived
        # generator matrices (core/sobolmat.py; sobol.rs + sobolmatrices.rs),
        # XOR-scrambled per pixel (Kollig-Keller — preserves the net props)
        s1 = rng.hash_combine(seed, pixel, jnp.uint32(2 * dim))
        s2 = rng.hash_combine(seed, pixel, jnp.uint32(2 * dim + 1))
        return sobol_dim(sample_idx, 2 * dim, s1), sobol_dim(sample_idx, 2 * dim + 1, s2)
    if kind == "halton":
        # Cranley-Patterson rotated Halton: bases (2,3), (5,7), ... per dim pair
        b0 = min(2 * dim, len(rng.PRIMES) - 2)
        b1 = b0 + 1
        u1 = rng.radical_inverse(b0, sample_idx)
        u2 = rng.radical_inverse(b1, sample_idx)
        r1 = rng.u32_to_float(rng.hash_combine(seed, pixel, 2 * dim))
        r2 = rng.u32_to_float(rng.hash_combine(seed, pixel, 2 * dim + 1))
        u1 = u1 + r1
        u2 = u2 + r2
        return jnp.where(u1 >= 1.0, u1 - 1.0, u1), jnp.where(u2 >= 1.0, u2 - 1.0, u2)
    # (0,2)-sequence family: per-(pixel, dim-pair) scramble, index = sample
    s1 = rng.hash_combine(seed, pixel, 2 * dim)
    s2 = rng.hash_combine(seed, pixel, 2 * dim + 1)
    u1, u2 = rng.sample_02(sample_idx, s1, s2)
    return u1, u2


def sample_1d(kind: str, seed, pixel, sample_idx, dim, spp: int):
    if kind in ("halton", "sobol") and not isinstance(dim, int):
        if kind == "sobol":
            s1 = rng.hash_combine(seed, pixel, (2 * dim).astype(jnp.uint32))
            return sobol_dim_dyn(sample_idx, 2 * dim, s1)
        b0 = jnp.minimum(2 * dim, len(rng.PRIMES) - 2)
        u = rng.radical_inverse_dyn(b0, sample_idx) + \
            rng.u32_to_float(rng.hash_combine(seed, pixel, (2 * dim).astype(jnp.uint32)))
        return jnp.where(u >= 1.0, u - 1.0, u)
    if kind == "stratified" and isinstance(dim, int):
        # 1D jittered strata with per-(pixel, dim) stratum rotation
        rot = rng.hash_combine(seed, pixel, jnp.uint32(104729 + 7919 * dim))
        idx = (jnp.asarray(sample_idx).astype(jnp.uint32) + rot) % jnp.uint32(max(spp, 1))
        u = rng.uniform_1d(seed, pixel, sample_idx, 1024 + dim)
        if not _STRATIFIED_JITTER:
            u = jnp.full_like(u, 0.5)
        return (idx.astype(F32) + u) / max(spp, 1)
    if kind in ("random", "stratified"):
        return rng.uniform_1d(seed, pixel, sample_idx, 1024 + dim)
    if kind == "sobol":
        s = rng.hash_combine(seed, pixel, jnp.uint32(4096 + dim))
        return sobol_dim(sample_idx, 512 + dim, s)
    if kind == "halton":
        b = min(dim, len(rng.PRIMES) - 1)
        u = rng.radical_inverse(b, sample_idx)
        r = rng.u32_to_float(rng.hash_combine(seed, pixel, 4096 + dim))
        u = u + r
        return jnp.where(u >= 1.0, u - 1.0, u)
    s = rng.hash_combine(seed, pixel, 4096 + dim)
    return rng.van_der_corput(sample_idx, s)


# ---------------------------------------------------------------------------
# Halton global-index machinery (halton.rs:120-156)
# ---------------------------------------------------------------------------


def _inverse_radical(base: int, exp: int, value: int):
    """Index residue whose base-`base` radical inverse lands on `value`
    (reversed digits; halton.rs inverse_radical_inverse)."""
    inv = np.zeros_like(value)
    v = value.copy()
    for _ in range(exp):
        inv = inv * base + (v % base)
        v //= base
    return inv


def halton_tables(width: int, height: int):
    """Per-pixel first-sample indices + strides for the Halton sampler.

    The image plane is tiled 128x128 (halton.rs K_MAX_RESOLUTION); base
    scales 2^j >= min(W,128), 3^k >= min(H,128); the CRT combines the
    per-dimension residues into the global sample index offset."""
    kmax = 128
    j = 0
    while (1 << j) < min(width, kmax):
        j += 1
    k = 0
    while 3 ** k < min(height, kmax):
        k += 1
    sx = 1 << j
    sy = 3 ** k
    stride = sx * sy

    ys, xs = np.mgrid[0:height, 0:width]
    px = (xs % sx).astype(np.int64).ravel()
    py = (ys % sy).astype(np.int64).ravel()

    def mult_inverse(a, n):
        # extended euclid
        g, x = _ext_gcd(a % n, n)
        return x % n

    off = np.zeros(width * height, np.int64)
    # dim 0: base 2
    dim_off = _inverse_radical(2, j, px)
    off += dim_off * (stride // sx) * mult_inverse(stride // sx, sx)
    # dim 1: base 3
    dim_off = _inverse_radical(3, k, py)
    off += dim_off * (stride // sy) * mult_inverse(stride // sy, sy)
    off %= stride

    return {
        # uint32 index arithmetic: exact up to 2^32 / stride samples per
        # pixel (~138k spp at the 128x243 max tiling) — the reference uses
        # u64 (halton.rs get_index_for_sample); jax x64 is disabled, and
        # renders beyond 138k spp per wave are out of scope
        "offset": jnp.asarray(off.reshape(height, width).ravel().astype(np.uint32)),
        "stride": int(stride),
        "sx": sx,
        "sy": sy,
        "exp_x": j,
        "exp_y": k,
    }


def _ext_gcd(a, b):
    return _ext(a, b)


def _ext(a, b):
    """Returns (g, inverse of a mod b) via iterative extended Euclid."""
    old_r, r = a, b
    old_s, s = 1, 0
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
    return old_r, old_s


def halton_index(aux, pixel_linear, sample_idx):
    """Global Halton index of sample `sample_idx` at a pixel (linear id)."""
    off = aux["offset"][pixel_linear]
    return off + jnp.asarray(sample_idx).astype(jnp.uint32) * jnp.uint32(aux["stride"])


def halton_film_jitter(aux, pixel_linear, sample_idx):
    """In-pixel (jx, jy) of the Halton point for this pixel/sample: the
    fractional parts of ri_2 * 2^j and ri_3 * 3^k (halton.rs dims 0-1)."""
    idx = halton_index(aux, pixel_linear, sample_idx)
    x = rng.radical_inverse(0, idx) * aux["sx"]
    y = rng.radical_inverse(1, idx) * aux["sy"]
    return x - jnp.floor(x), y - jnp.floor(y)


def halton_dim_2d(aux, pixel_linear, sample_idx, dim: int):
    """2D Halton sample at static dimension pair `dim` >= 1 (bases from the
    prime table with Faure-permutation scrambling, lowdiscrepancy.rs)."""
    idx = halton_index(aux, pixel_linear, sample_idx)
    b0 = min(2 * dim, len(rng.PRIMES) - 2)
    b1 = b0 + 1
    p0 = jnp.asarray(rng.faure_permutation(int(rng.PRIMES[b0])))
    p1 = jnp.asarray(rng.faure_permutation(int(rng.PRIMES[b1])))
    return (
        rng.scrambled_radical_inverse(b0, idx, p0),
        rng.scrambled_radical_inverse(b1, idx, p1),
    )


# ---------------------------------------------------------------------------
# Sobol global film enumeration (sobol.rs:61-75 sobol_interval_to_index).
# The reference ships precomputed VdCSobolMatrices (+inverses) as constant
# data; here the (index low bits) -> (pixel x,y bits) GF(2) map is built
# from our algorithmic generator matrices and inverted with Gaussian
# elimination at table-build time.
# ---------------------------------------------------------------------------


def _gf2_invert(cols, n):
    """cols: list of n ints, column j = output bits for input bit j (bit i of
    cols[j] = row i). Returns inverse columns, or None if singular."""
    # build rows as ints over inputs
    rows = [0] * n
    for j in range(n):
        for i in range(n):
            if (cols[j] >> i) & 1:
                rows[i] |= 1 << j
    # augment with identity, eliminate
    aug = [(rows[i], 1 << i) for i in range(n)]
    for c in range(n):
        piv = None
        for r in range(c, n):
            if (aug[r][0] >> c) & 1:
                piv = r
                break
        if piv is None:
            return None
        aug[c], aug[piv] = aug[piv], aug[c]
        for r in range(n):
            if r != c and (aug[r][0] >> c) & 1:
                aug[r] = (aug[r][0] ^ aug[c][0], aug[r][1] ^ aug[c][1])
    inv_rows = [aug[i][1] for i in range(n)]
    inv_cols = [0] * n
    for i in range(n):
        for j in range(n):
            if (inv_rows[i] >> j) & 1:
                inv_cols[j] |= 1 << i
    return inv_cols


def sobol_tables(width: int, height: int, spp: int):
    """Global-Sobol film enumeration tables, or None when the index would
    overflow 32 bits (fallback: per-pixel scrambled sequences)."""
    from ..core.sobolmat import matrix

    m = 0
    while (1 << m) < max(width, height):
        m += 1
    n_frame_bits = max(int(np.ceil(np.log2(max(spp, 1)))), 1) + 2
    if 2 * m + n_frame_bits > 31 or m == 0:
        return None
    cols0 = matrix(0)
    cols1 = matrix(1)

    def outbits(j):
        # concat: x-pixel bits (low m) | y-pixel bits (high m)
        xb = int(cols0[j]) >> (32 - m)
        yb = int(cols1[j]) >> (32 - m)
        return xb | (yb << m)

    a_cols = [outbits(j) for j in range(2 * m)]
    inv = _gf2_invert(a_cols, 2 * m)
    if inv is None:
        return None
    delta_cols = [outbits(2 * m + c) for c in range(n_frame_bits)]
    return {
        "m": m,
        "res": 1 << m,
        "inv_cols": tuple(inv),
        "delta_cols": tuple(delta_cols),
        "n_frame_bits": n_frame_bits,
    }


def sobol_global_index(aux, px, py, sample_idx):
    """Global Sobol index whose dims (0,1) land in pixel (px,py) at frame
    sample_idx (the vectorized sobol_interval_to_index)."""
    m = aux["m"]
    frame = jnp.asarray(sample_idx).astype(jnp.uint32)
    delta = jnp.zeros_like(frame) if frame.ndim else jnp.uint32(0)
    for c in range(aux["n_frame_bits"]):
        delta = delta ^ jnp.where(((frame >> c) & 1) > 0, jnp.uint32(aux["delta_cols"][c]), jnp.uint32(0))
    b = (px.astype(jnp.uint32) | (py.astype(jnp.uint32) << m)) ^ delta
    low = jnp.zeros_like(b)
    for j in range(2 * m):
        low = low ^ jnp.where(((b >> j) & 1) > 0, jnp.uint32(aux["inv_cols"][j]), jnp.uint32(0))
    return (frame << (2 * m)) | low


def sobol_film_jitter(aux, px, py, sample_idx):
    """In-pixel offsets of the global Sobol point for (pixel, frame)."""
    idx = sobol_global_index(aux, px, py, sample_idx)
    res = float(aux["res"])
    x = sobol_dim(idx, 0, 0) * res - px.astype(F32)
    y = sobol_dim(idx, 1, 0) * res - py.astype(F32)
    return jnp.clip(x, 0.0, 1.0 - 1e-6), jnp.clip(y, 0.0, 1.0 - 1e-6)


def sobol_dim_2d(aux, px, py, sample_idx, dim: int):
    """2D sample from the GLOBAL Sobol sequence at static dim pair >= 1."""
    idx = sobol_global_index(aux, px, py, sample_idx)
    return sobol_dim(idx, 2 * dim, 0), sobol_dim(idx, 2 * dim + 1, 0)


# ---------------------------------------------------------------------------
# MaxMinDist sampler (samplers/maxmindist.rs + lowdiscrepancy.rs:220).
# The reference ships 17 precomputed CMaxMinDist generator matrices; here
# equivalent matrices are SEARCHED at build time: random invertible GF(2)
# maps scored by the exact objective (min toroidal point distance of
# (i/n, y(i))), cached per log2(spp).
# ---------------------------------------------------------------------------

import functools as _functools


@_functools.lru_cache(maxsize=None)
def maxmin_matrix(log2spp: int):
    """(log2spp,) uint32 generator columns for the y coordinate."""
    k = max(min(log2spp, 16), 0)
    n = 1 << k
    if k == 0:
        return (np.uint32(0x80000000),)
    rs = np.random.RandomState(0xC0FFEE + k)
    i = np.arange(n)
    x = (i + 0.5) / n

    def points_of(cols):
        y = np.zeros(n, np.uint64)
        for j in range(k):
            y = y ^ np.where((i >> j) & 1 > 0, np.uint64(cols[j]), np.uint64(0))
        return (y.astype(np.float64) / 2**32 + 0.5 / n) % 1.0

    def min_dist(y):
        dx = np.abs(x[:, None] - x[None, :])
        dx = np.minimum(dx, 1.0 - dx)
        dy = np.abs(y[:, None] - y[None, :])
        dy = np.minimum(dy, 1.0 - dy)
        d2 = dx * dx + dy * dy
        np.fill_diagonal(d2, np.inf)
        return float(np.sqrt(d2.min()))

    n_cand = 600 if k <= 6 else (120 if k <= 9 else 24)
    best, best_d = None, -1.0
    for _ in range(n_cand):
        # random invertible k x k bit matrix on the top k output bits
        while True:
            mat = [int(rs.randint(0, n)) for _ in range(k)]
            if _gf2_invert([m_ & (n - 1) for m_ in mat], k) is not None:
                break
        cols = tuple(np.uint32((m_ & (n - 1)) << (32 - k)) for m_ in mat)
        d = min_dist(points_of(cols))
        if d > best_d:
            best, best_d = cols, d
    return best


def maxmin_2d_dim0(seed, pixel, sample_idx, spp: int):
    """Film-dimension pair of the MaxMinDist sampler: x = i/n (Cranley-
    Patterson rotated per pixel), y from the searched generator matrix
    (XOR-scrambled per pixel; both preserve the min-distance structure)."""
    import math

    k = max(int(math.ceil(math.log2(max(spp, 1)))), 0)
    cols = maxmin_matrix(k)
    n = 1 << k
    i = jnp.asarray(sample_idx).astype(jnp.uint32) % jnp.uint32(n)
    y = jnp.zeros_like(i)
    for j in range(len(cols)):
        y = y ^ jnp.where(((i >> j) & 1) > 0, jnp.uint32(int(cols[j])), jnp.uint32(0))
    y = y ^ rng.hash_combine(seed, pixel, jnp.uint32(0x51D))
    u1 = (i.astype(F32) + 0.5) / n + rng.u32_to_float(rng.hash_combine(seed, pixel, jnp.uint32(0xC9)))
    u1 = jnp.where(u1 >= 1.0, u1 - 1.0, u1)
    return u1, rng.u32_to_float(y)
