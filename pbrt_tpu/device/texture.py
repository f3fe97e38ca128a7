"""Device texture evaluation.

The host compiler flattens the named-texture DAG into an ordered program list
(creation order = topological order, see scene/builder.py _TextureRegistry);
this module evaluates every program once per shading wave, producing a stack
of (R, 3) values that material construction gathers from by texture id.

Covers the reference texture plugins (src/textures/*): constant, scale, mix,
bilerp, imagemap (bilinear; MIPMap trilerp/EWA is a later milestone —
src/core/mipmap.rs), uv, checkerboard, dots, and the Perlin-noise family
(fbm, wrinkled, marble, windy; src/core/texture.rs noise machinery).
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..scene.arrays import SceneArrays, TexProgram

F32 = jnp.float32


# --- Perlin noise (texture.rs noise/fbm/turbulence) -------------------------

_NOISE_PERM_SIZE = 256
_rng = np.random.RandomState(1619)
_PERM = _rng.permutation(_NOISE_PERM_SIZE).astype(np.int32)
_NOISE_PERM = np.concatenate([_PERM, _PERM])


def _grad(h, dx, dy, dz):
    h = h & 15
    u = jnp.where(h < 8, dx, dy)
    v = jnp.where(h < 4, dy, jnp.where((h == 12) | (h == 14), dx, dz))
    u = jnp.where(h & 1, -u, u)
    v = jnp.where(h & 2, -v, v)
    return u + v


def _noise_weight(t):
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def perlin_noise(p):
    """Classic Perlin noise at points p (R, 3) -> (R,)."""
    perm = jnp.asarray(_NOISE_PERM)
    pi = jnp.floor(p).astype(jnp.int32)
    pf = p - jnp.floor(p)
    ix = pi[..., 0] & (_NOISE_PERM_SIZE - 1)
    iy = pi[..., 1] & (_NOISE_PERM_SIZE - 1)
    iz = pi[..., 2] & (_NOISE_PERM_SIZE - 1)
    dx, dy, dz = pf[..., 0], pf[..., 1], pf[..., 2]

    def g(ox, oy, oz):
        h = perm[perm[perm[ix + ox] + iy + oy] + iz + oz]
        return _grad(h, dx - ox, dy - oy, dz - oz)

    w000 = g(0, 0, 0)
    w100 = g(1, 0, 0)
    w010 = g(0, 1, 0)
    w110 = g(1, 1, 0)
    w001 = g(0, 0, 1)
    w101 = g(1, 0, 1)
    w011 = g(0, 1, 1)
    w111 = g(1, 1, 1)
    wx = _noise_weight(dx)
    wy = _noise_weight(dy)
    wz = _noise_weight(dz)
    x00 = w000 + wx * (w100 - w000)
    x10 = w010 + wx * (w110 - w010)
    x01 = w001 + wx * (w101 - w001)
    x11 = w011 + wx * (w111 - w011)
    y0 = x00 + wy * (x10 - x00)
    y1 = x01 + wy * (x11 - x01)
    return y0 + wz * (y1 - y0)


def fbm(p, omega, max_octaves):
    s = jnp.zeros(p.shape[:-1], F32)
    lam = 1.0
    o = 1.0
    for _ in range(int(max_octaves)):
        s = s + o * perlin_noise(p * lam)
        lam *= 1.99
        o *= omega
    return s


def turbulence(p, omega, max_octaves):
    s = jnp.zeros(p.shape[:-1], F32)
    lam = 1.0
    o = 1.0
    for _ in range(int(max_octaves)):
        s = s + o * jnp.abs(perlin_noise(p * lam))
        lam *= 1.99
        o *= omega
    return s


# --- image lookup -----------------------------------------------------------


def image_bilinear(img, u, v, wrap="repeat"):
    """Bilinear image lookup, (H, W, 3) image, uv in [0,1) texture space.

    v is flipped (imagemap.rs: st.y -> 1-t as pbrt images are top-down).
    """
    h, w, _ = img.shape
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrap_idx(i, n):
        if wrap == "repeat":
            return jnp.mod(i, n)
        if wrap == "clamp":
            return jnp.clip(i, 0, n - 1)
        return i  # black handled via mask below

    def fetch(xi, yi):
        if wrap == "black":
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            t = img[jnp.clip(yi, 0, h - 1), jnp.clip(xi, 0, w - 1)]
            return jnp.where(inside[..., None], t, 0.0)
        return img[wrap_idx(yi, h), wrap_idx(xi, w)]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


# --- program evaluation -----------------------------------------------------


def _mapping_uv(prog: TexProgram, par, uv, p):
    """2D mapping (texture.rs:114-276)."""
    if prog.mapping == "planar":
        v1 = par[4:7]
        v2 = par[7:10]
        s = par[2] + p[:, 0] * v1[0] + p[:, 1] * v1[1] + p[:, 2] * v1[2]
        t = par[3] + p[:, 0] * v2[0] + p[:, 1] * v2[1] + p[:, 2] * v2[2]
        return s, t
    if prog.mapping == "spherical":
        d = p / jnp.maximum(jnp.linalg.norm(p, axis=-1, keepdims=True), 1e-30)
        theta = jnp.arccos(jnp.clip(d[:, 2], -1, 1))
        phi = jnp.arctan2(d[:, 1], d[:, 0])
        phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
        return theta / jnp.pi, phi / (2 * jnp.pi)
    if prog.mapping == "cylindrical":
        phi = jnp.arctan2(p[:, 1], p[:, 0])
        phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
        return phi / (2 * jnp.pi), p[:, 2]
    # uv mapping with scale/delta
    return par[0] * uv[:, 0] + par[2], par[1] * uv[:, 1] + par[3]


def eval_textures(sa: SceneArrays, programs, uv, p, duvdx=None, duvdy=None):
    """Evaluate all texture programs. Returns (X, R, 3) stacked values.

    duvdx/duvdy: optional (R, 2) texture-footprint derivatives driving the
    MIPMap level selection (None -> finest level, matching the reference's
    width-0 behavior for rays without differentials).
    """
    results = []
    for xi, prog in enumerate(programs):
        par = sa.tex_param[xi]

        def child(idx, const_slice):
            if idx >= 0:
                return results[idx]
            return jnp.broadcast_to(const_slice, (uv.shape[0], 3))

        if prog.kind == "constant":
            val = jnp.broadcast_to(par[10:13], (uv.shape[0], 3))
        elif prog.kind == "scale":
            val = child(prog.tex1, par[10:13]) * child(prog.tex2, par[13:16])
        elif prog.kind == "mix":
            amt = child(prog.amount, par[16:19])
            val = (1.0 - amt) * child(prog.tex1, par[10:13]) + amt * child(prog.tex2, par[13:16])
        elif prog.kind == "imagemap":
            s, t = _mapping_uv(prog, par, uv, p)
            levels = [sa.tex_images[f"{prog.image_key}_l{k}"] for k in range(prog.n_levels)]
            if duvdx is None or prog.n_levels == 1:
                val = image_bilinear(levels[0], s, t, prog.wrap) * par[10]
            else:
                from .mipmap import lookup_ewa, lookup_trilinear

                # mapping scales the footprint (uv mapping only; other
                # mappings fall back to the raw uv derivative scale)
                sc = jnp.asarray([par[0], par[1]]) if prog.mapping == "uv" else jnp.ones(2, F32)
                dx = duvdx * sc
                dy = duvdy * sc
                if prog.trilinear:
                    width = 2.0 * jnp.maximum(
                        jnp.max(jnp.abs(dx), axis=-1), jnp.max(jnp.abs(dy), axis=-1)
                    )
                    val = lookup_trilinear(levels, s, t, width, prog.wrap) * par[10]
                else:
                    val = lookup_ewa(levels, s, t, dx, dy, prog.wrap,
                                     max_anisotropy=prog.max_aniso) * par[10]
        elif prog.kind == "uv":
            s, t = _mapping_uv(prog, par, uv, p)
            val = jnp.stack([s - jnp.floor(s), t - jnp.floor(t), jnp.zeros_like(s)], axis=-1)
        elif prog.kind == "checkerboard":
            if prog.dimension == 2:
                s, t = _mapping_uv(prog, par, uv, p)
                even = (jnp.floor(s) + jnp.floor(t)) % 2 == 0
            else:
                q = jnp.floor(p)
                even = (q[:, 0] + q[:, 1] + q[:, 2]) % 2 == 0
            val = jnp.where(even[:, None], child(prog.tex1, par[10:13]), child(prog.tex2, par[13:16]))
        elif prog.kind == "dots":
            s, t = _mapping_uv(prog, par, uv, p)
            sc = jnp.floor(s + 0.5)
            tc = jnp.floor(t + 0.5)
            # pseudo-random per-cell dot (texture.rs dots: noise-driven)
            cell = jnp.stack([sc + 0.5, tc + 0.5, jnp.zeros_like(sc)], axis=-1)
            has_dot = perlin_noise(cell) > 0
            rx = perlin_noise(cell + jnp.array([1.5, 2.5, 0.0]))
            ry = perlin_noise(cell + jnp.array([4.5, 9.5, 0.0]))
            radius = 0.35
            maxshift = 0.5 - radius
            xc = sc + maxshift * rx
            yc = tc + maxshift * ry
            inside = has_dot & ((s - xc) ** 2 + (t - yc) ** 2 < radius * radius)
            val = jnp.where(inside[:, None], child(prog.tex1, par[10:13]), child(prog.tex2, par[13:16]))
        elif prog.kind in ("fbm", "wrinkled"):
            fn = fbm if prog.kind == "fbm" else turbulence
            v = fn(p, par[10], prog.octaves)
            val = jnp.broadcast_to(v[:, None], (uv.shape[0], 3))
        elif prog.kind == "windy":
            strength = jnp.abs(fbm(0.1 * p, 0.5, 3))
            height = fbm(p, 0.5, 6)
            val = jnp.broadcast_to((strength * height)[:, None], (uv.shape[0], 3))
        elif prog.kind == "marble":
            scale = jnp.where(par[11] > 0, par[11], 1.0)
            variation = jnp.where(par[12] > 0, par[12], 0.2)
            marble = p * scale
            t_m = 0.5 + 0.5 * jnp.sin(marble[:, 0] + variation * fbm(marble, 0.5, prog.octaves))
            # marble color spline (texture.rs marble colors)
            c = np.array(
                [[0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.5, 0.5, 0.5],
                 [0.6, 0.59, 0.58], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.2, 0.2, 0.33],
                 [0.58, 0.58, 0.6]], dtype=np.float32)
            nseg = len(c) - 3
            tt = jnp.clip(t_m, 0.0, 0.9999) * nseg
            first = jnp.floor(tt).astype(jnp.int32)
            ft = (tt - first)[:, None]
            cj = jnp.asarray(c)
            c0 = cj[first]
            c1 = cj[first + 1]
            c2 = cj[first + 2]
            c3 = cj[first + 3]
            s0 = (1 - ft) * c0 + ft * c1
            s1 = (1 - ft) * c1 + ft * c2
            s2 = (1 - ft) * c2 + ft * c3
            s0 = (1 - ft) * s0 + ft * s1
            s1 = (1 - ft) * s1 + ft * s2
            val = 1.5 * ((1 - ft) * s0 + ft * s1)
        elif prog.kind == "bilerp":
            s, t = _mapping_uv(prog, par, uv, p)
            v00 = child(prog.tex1, par[10:13])
            v11 = child(prog.tex2, par[13:16])
            v01 = child(prog.v01, par[16:19])
            v10 = child(prog.v10, par[19:22])
            ss = (s - jnp.floor(s))[:, None]
            tt = (t - jnp.floor(t))[:, None]
            val = (1 - ss) * (1 - tt) * v00 + (1 - ss) * tt * v01 + ss * (1 - tt) * v10 + ss * tt * v11
        else:
            val = jnp.zeros((uv.shape[0], 3), F32)
        results.append(val.astype(F32))
    if not results:
        return jnp.zeros((0, uv.shape[0], 3), F32)
    return jnp.stack(results)


def material_param(sa: SceneArrays, tex_values, mat_ids, slot):
    """Per-ray value of a material parameter slot: constant or texture."""

    const = sa.mat_const[:, slot][mat_ids]  # (R, 3)
    tid = sa.mat_tex[:, slot][mat_ids]  # (R,)
    if tex_values.shape[0] == 0:
        return const
    # texture-id dispatch as a static where-chain: the leading (X,) axis is
    # tiny and static, and a select chain fuses where per-ray advanced
    # indexing into (X, R, 3) would be a gather
    out = const
    for x in range(tex_values.shape[0]):
        out = jnp.where((tid == x)[:, None], tex_values[x], out)
    return out
