"""Spatial (voxel-grid) light sampling distribution.

Array-program redesign of the reference's SpatialLightDistribution
(src/core/lightdistrib.rs:153-339): instead of a lock-free hash table filled
lazily per voxel (CAS claim + spin wait), the WHOLE voxel grid of per-light
CDFs is precomputed in one batched device pass at scene setup — voxels x
lights x point-samples evaluated as a single vectorized sample_li sweep.
Lookups at NEE time become a voxel-index computation plus a row gather.

The per-voxel importance estimate follows lightdistrib.rs:190-229: N point
samples inside the voxel, accumulate luminance(Li / pdf) per light (no
visibility, like the reference), with the reference's min-pmf floor so every
light stays selectable (unbiased).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .lights import sample_li
from .rng import pcg_hash, u32_to_float

F32 = jnp.float32

N_POINT_SAMPLES = 32  # reference uses 128 Halton points; 32 keeps the sweep cheap
MAX_VOXELS = 1 << 15  # cap V so V * L stays device-friendly


def grid_resolution(static, world_lo, world_hi, max_voxels=MAX_VOXELS):
    """Per-axis voxel counts: proportional to the scene extent per axis with
    the longest axis capped (lightdistrib.rs:166-172 uses 64; we scale the
    cap down for scenes with many lights to bound V * L)."""
    diag = np.maximum(np.asarray(world_hi) - np.asarray(world_lo), 1e-6)
    base = int(np.clip((max_voxels / max(static.n_lights, 1)) ** (1.0 / 3.0) * 2.0, 4, 64))
    rel = diag / diag.max()
    res = np.maximum((rel * base).astype(np.int64), 1)
    while int(np.prod(res)) > max_voxels:
        res = np.maximum(res // 2, 1)
    return tuple(int(r) for r in res)


def build_spatial_distribution(sa, static, seed: int = 0):
    """Precompute the voxel-grid CDF table.

    Returns dict {pmf (V, L), cdf (V, L), res (3,), lo (3,), inv_extent (3,)}
    with V = prod(res)."""
    L = static.n_lights
    wc = np.asarray(sa.world_center)
    wr = float(sa.world_radius)
    lo = wc - wr
    hi = wc + wr
    res = grid_resolution(static, lo, hi)
    nx, ny, nz = res
    V = nx * ny * nz

    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    vox0 = np.stack([ix, iy, iz], axis=-1).reshape(V, 3).astype(np.float32)
    extent = (hi - lo).astype(np.float32)
    cell = extent / np.asarray([nx, ny, nz], np.float32)

    @jax.jit
    def sweep(vox0_j):
        def one_sample(s, acc):
            # stratified-ish hashed points inside each voxel, one light at a
            # time masked inside sample_li's typed table
            su = jnp.uint32(seed) * jnp.uint32(7919) + s.astype(jnp.uint32)
            h1 = pcg_hash(jnp.arange(V, dtype=jnp.uint32) * jnp.uint32(0x9E3779B1) + su)
            h2 = pcg_hash(h1 ^ jnp.uint32(0x85EBCA6B))
            h3 = pcg_hash(h2 ^ jnp.uint32(0xC2B2AE35))
            frac = jnp.stack([u32_to_float(h1), u32_to_float(h2), u32_to_float(h3)], axis=-1)
            p = jnp.asarray(lo, F32) + (vox0_j + frac) * jnp.asarray(cell, F32)

            def per_light(li, acc_in):
                lid = jnp.full(V, li, jnp.int32)
                ua = u32_to_float(pcg_hash(h1 + li.astype(jnp.uint32) * jnp.uint32(31)))
                ub = u32_to_float(pcg_hash(h2 + li.astype(jnp.uint32) * jnp.uint32(57)))
                ls = sample_li(sa, static, lid, p, ua, ub)
                lum = jnp.sum(ls["li"] * jnp.asarray([0.212671, 0.71516, 0.072169], F32), axis=-1)
                imp = jnp.where(ls["pdf"] > 0, lum / jnp.maximum(ls["pdf"], 1e-9), 0.0)
                return acc_in.at[:, li].add(imp)

            return jax.lax.fori_loop(0, L, per_light, acc)

        acc = jax.lax.fori_loop(0, N_POINT_SAMPLES, one_sample, jnp.zeros((V, L), F32))
        # min-pmf floor (lightdistrib.rs:222-227): every light selectable
        total = jnp.sum(acc, axis=1, keepdims=True)
        floor = jnp.where(total > 0, total * (0.001 / L), 1.0)
        acc = jnp.maximum(acc, floor)
        pmf = acc / jnp.sum(acc, axis=1, keepdims=True)
        cdf = jnp.cumsum(pmf, axis=1)
        return pmf, cdf

    pmf, cdf = sweep(jnp.asarray(vox0))
    return {
        "pmf": pmf,
        "cdf": cdf,
        "res": jnp.asarray([nx, ny, nz], jnp.int32),
        "lo": jnp.asarray(lo, F32),
        "inv_cell": jnp.asarray(1.0 / np.maximum(cell, 1e-12), F32),
        "n_voxels": V,
    }


def voxel_of(dist, p):
    """(R, 3) world points -> flat voxel ids."""
    res = dist["res"]
    q = (p - dist["lo"]) * dist["inv_cell"]
    ix = jnp.clip(q[:, 0].astype(jnp.int32), 0, res[0] - 1)
    iy = jnp.clip(q[:, 1].astype(jnp.int32), 0, res[1] - 1)
    iz = jnp.clip(q[:, 2].astype(jnp.int32), 0, res[2] - 1)
    return (iz * res[1] + iy) * res[0] + ix


def spatial_select(dist, p, u_sel):
    """Sample a light id per shading point from its voxel's CDF.

    Returns (lid (R,), pmf (R,))."""
    vox = voxel_of(dist, p)
    cdf_rows = dist["cdf"][vox]  # (R, L)
    lid = jnp.sum((u_sel[:, None] > cdf_rows[:, :-1]).astype(jnp.int32), axis=1)
    L = cdf_rows.shape[1]
    lid = jnp.clip(lid, 0, L - 1)
    pmf_rows = dist["pmf"][vox]
    oh = jnp.arange(L)[None, :] == lid[:, None]
    pmf = jnp.sum(jnp.where(oh, pmf_rows, 0.0), axis=1)
    return lid, pmf


def spatial_pmf_of(dist, p, lid):
    """pmf of a specific light at each point's voxel (for MIS weights)."""
    vox = voxel_of(dist, p)
    L = dist["pmf"].shape[1]
    flat = vox * L + jnp.clip(lid, 0, L - 1)
    return dist["pmf"].reshape(-1)[flat]
