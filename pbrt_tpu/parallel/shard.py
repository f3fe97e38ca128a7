"""Multi-chip rendering: shard the pixel/ray axis over a device mesh.

Equivalent of the reference's rayon tile parallelism
(src/core/integrator.rs:276-396), built on EXPLICIT `shard_map` (not GSPMD
propagation): each device traces its own disjoint pixel slice, so every
per-wave sort (ray-coherence Morton ordering, SPPM cell sorts) is
device-local BY CONSTRUCTION — no accidental cross-chip all-to-alls from a
global argsort. Read-only SceneArrays are replicated (closure capture). The
only collectives are the film/photon reductions:

- sampler-integrator family: none during the wave; the film is returned
  sharded along "rays" (the analog of merge_film_tile).
- SPPM: visible points are all-gathered so every device's photon shard can
  deposit on any pixel, then phi/M are psum-reduced (sppm.rs lock-free grid
  + AtomicFloat -> all_gather + psum). For scenes whose VP set exceeds
  replicated HBM the grid itself would need sharding with an all-to-all of
  photons by cell — out of scope until a baseline scene demands it
  (SURVEY.md §2.12).
"""
from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..device.camera import make_camera
from ..render import _one_sample_wave

F32 = jnp.float32


def _round_up(x, m):
    return (x + m - 1) // m * m


def _configs(cs, desc, spp):
    static = cs.static
    icfg = {
        "kind": desc.integrator.kind,
        "max_depth": max(int(desc.integrator.max_depth), 1),
        "rr_threshold": desc.integrator.rr_threshold,
        "strategy": desc.integrator.strategy,
        "light_strategy": desc.integrator.light_strategy,
        "n_samples": desc.integrator.n_samples,
        "cos_sample": desc.integrator.cos_sample,
    }
    if str(desc.integrator.light_strategy) == "spatial" and static.n_lights > 1:
        from ..device.lightdistrib import build_spatial_distribution

        icfg["spatial_distribution"] = build_spatial_distribution(cs.arrays, static)
    scfg = {"kind": desc.sampler.kind, "spp": spp}
    fcfg = {"filter": desc.film.filter_name, "filter_params": dict(desc.film.filter_params),
            "max_sample_luminance": desc.film.max_sample_luminance}
    return icfg, scfg, fcfg


def _pixel_arrays(W, H, n_dev):
    R = W * H
    Rp = _round_up(R, n_dev)
    ys, xs = np.mgrid[0:H, 0:W]
    px = np.zeros(Rp, np.int32)
    py = np.zeros(Rp, np.int32)
    pids = np.zeros(Rp, np.uint32)
    px[:R] = xs.ravel()
    py[:R] = ys.ravel()
    pids[:R] = (ys * W + xs).ravel()
    return px, py, pids, R, Rp


def render_sharded_step(cs, desc, mesh: Mesh, spp: int | None = None, seed: int = 0):
    """One full sharded render pass (all pixels x spp samples).

    Returns the film image (H*W, 3), sharded along "rays"."""
    n_dev = math.prod(mesh.devices.shape)
    W = desc.film.x_resolution
    H = desc.film.y_resolution
    spp = int(spp if spp is not None else desc.sampler.pixel_samples)

    cam = make_camera(desc.camera, desc.film)
    static = cs.static
    icfg, scfg, fcfg = _configs(cs, desc, spp)

    px, py, pids, R, Rp = _pixel_arrays(W, H, n_dev)
    ray_sh = NamedSharding(mesh, P("rays"))
    px = jax.device_put(jnp.asarray(px), ray_sh)
    py = jax.device_put(jnp.asarray(py), ray_sh)
    pids = jax.device_put(jnp.asarray(pids), ray_sh)
    sa = cs.arrays  # replicated by closure capture inside shard_map

    from ..render import make_regen, persistent_eligible

    use_persistent = persistent_eligible(desc, static, cam)

    def local_step(px_l, py_l, pids_l, seed_l):
        # runs per device on its pixel slice; sorts stay device-local
        if use_persistent:
            # per-device persistent wavefront (device/integrator
            # .trace_persistent): each device's lanes regenerate their own
            # pixels' samples in place — no cross-device traffic at all
            from ..device.integrator import trace_persistent

            regen = make_regen(cam, static, scfg, fcfg, px_l, py_l, pids_l, seed_l)
            Lsum, wsum, _nv = trace_persistent(
                sa, static, icfg, scfg, seed_l, pids_l, jnp.uint32(0), spp, regen,
                max_sample_luminance=float(fcfg["max_sample_luminance"]),
            )
            return Lsum / jnp.maximum(wsum, 1e-9)[:, None]

        def one(s, acc):
            Lw, w, _nv = _one_sample_wave(sa, static, icfg, scfg, fcfg, cam, px_l, py_l, pids_l, s.astype(jnp.uint32), seed_l)
            return acc[0] + Lw, acc[1] + w

        acc0 = (jnp.zeros((px_l.shape[0], 3), F32), jnp.zeros((px_l.shape[0],), F32))
        Lsum, wsum = jax.lax.fori_loop(0, spp, one, acc0)
        return Lsum / jnp.maximum(wsum, 1e-9)[:, None]

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(P("rays"), P("rays"), P("rays"), P()),
        out_specs=P("rays"),
        check_vma=False,
    )
    img = jax.jit(sharded)(px, py, pids, jnp.uint32(seed))
    return img[:R]


def _light_cdf_and_possible(sa, static):
    """Power-proportional light CDF + the static lobe-possibility probe —
    shared by every sharded step (must match the single-device drivers in
    device/bdpt.py / device/mlt.py / device/sppm.py exactly)."""
    from ..device.lights import compute_power
    from ..device.materials import make_bsdf

    power = compute_power(sa, static)
    cdf = jnp.cumsum(power)
    cdf = cdf / jnp.maximum(cdf[-1], 1e-12)
    probe = make_bsdf(sa, static, jnp.zeros(1, jnp.int32), jnp.zeros((1, 2), F32), jnp.zeros((1, 3), F32))
    return cdf, probe["possible"]


def render_sppm_sharded_step(cs, desc, mesh: Mesh, n_iters: int = 1, seed: int = 0,
                             n_photons: int | None = None):
    """Sharded SPPM iterations: camera pass sharded over pixels, photon pass
    sharded over photons against all-gathered visible points, phi/M psum.

    Returns the progressive image ((H*W, 3) ndarray)."""
    from ..device import sppm as dsppm

    n_dev = math.prod(mesh.devices.shape)
    sa = cs.arrays
    static = cs.static
    cam = make_camera(desc.camera, desc.film)
    W = desc.film.x_resolution
    H = desc.film.y_resolution
    icfg = {"max_depth": max(int(desc.integrator.max_depth), 1)}
    scfg = {"kind": "zerotwosequence", "spp": max(n_iters, 1)}
    P_ph = int(n_photons if n_photons is not None else _round_up(W * H, n_dev))
    P_ph = _round_up(P_ph, n_dev)

    px, py, pids, R, Rp = _pixel_arrays(W, H, n_dev)
    ray_sh = NamedSharding(mesh, P("rays"))
    px_j = jax.device_put(jnp.asarray(px), ray_sh)
    py_j = jax.device_put(jnp.asarray(py), ray_sh)
    pids_j = jax.device_put(jnp.asarray(pids), ray_sh)

    cdf, vp_possible = _light_cdf_and_possible(sa, static)

    wc = np.asarray(sa.world_center)
    wr = float(sa.world_radius)
    grid_min = jnp.asarray(wc - wr, F32)

    r0 = float(desc.integrator.initial_radius)
    radius0 = jnp.full(Rp, r0, F32)

    def one_iter(it, seed_l, px_l, py_l, pids_l, radius_l):
        # --- camera pass on the local pixel slice ---
        ld_l, vp_l = dsppm._camera_pass(sa, static, icfg, scfg, cam, seed_l, px_l, py_l, pids_l, it)
        # --- gather ALL visible points to every device ---
        vp = {k: jax.lax.all_gather(v, "rays", tiled=True) for k, v in vp_l.items()}
        radius = jax.lax.all_gather(radius_l, "rays", tiled=True)
        # --- grid + local photon shard ---
        # grid capped at 1022^3 cells: the 10-bit/axis key is exact only
        # below 1024 (see device/sppm.py)
        cell = jnp.maximum(jnp.maximum(2.0 * jnp.max(jnp.where(vp["valid"], radius, 0.0)),
                                       2.0 * wr / 1022.0), 1e-6)
        inv_cell = 1.0 / cell
        sc, sv = dsppm._build_grid(vp, radius, grid_min, inv_cell, Rp)
        idx = jax.lax.axis_index("rays")
        ph_seed = seed_l ^ (idx.astype(jnp.uint32) * jnp.uint32(0x9E3779B1))
        phi, m_cnt, _ov = dsppm._photon_pass(
            sa, static, icfg, ph_seed, it, P_ph // n_dev, cdf, vp, radius,
            sc, sv, grid_min, inv_cell, Rp, vp_possible,
        )
        # --- reduce photon deposits across devices, keep local slice ---
        phi = jax.lax.psum(phi, "rays")
        m_cnt = jax.lax.psum(m_cnt, "rays")
        n_loc = radius_l.shape[0]
        start = idx * n_loc
        phi_l = jax.lax.dynamic_slice(phi, (start, 0), (n_loc, 3))
        m_l = jax.lax.dynamic_slice(m_cnt, (start,), (n_loc,))
        return ld_l, vp_l, phi_l, m_l

    def local_loop(px_l, py_l, pids_l, seed_l):
        n_loc = px_l.shape[0]
        radius_l = jnp.full(n_loc, r0, F32)
        n_eff = jnp.zeros(n_loc, F32)
        tau = jnp.zeros((n_loc, 3), F32)
        ld = jnp.zeros((n_loc, 3), F32)
        for it in range(n_iters):
            ld_a, vp_l, phi_l, m_l = one_iter(jnp.uint32(it), seed_l + jnp.uint32(it * 9781), px_l, py_l, pids_l, radius_l)
            ld = ld + jnp.where(jnp.isfinite(ld_a), ld_a, 0.0)
            has = m_l > 0
            n_new = n_eff + dsppm.GAMMA * m_l
            r_new = jnp.where(has, radius_l * jnp.sqrt(n_new / jnp.maximum(n_eff + m_l, 1e-12)), radius_l)
            tau = jnp.where(
                has[:, None],
                (tau + vp_l["beta"] * phi_l) * ((r_new * r_new) / jnp.maximum(radius_l * radius_l, 1e-20))[:, None],
                tau,
            )
            radius_l = jnp.where(has, r_new, radius_l)
            n_eff = jnp.where(has, n_new, n_eff)
        np_total = float(max(n_iters, 1)) * P_ph
        img_l = ld / max(n_iters, 1) + tau / (np_total * jnp.pi * jnp.maximum(radius_l * radius_l, 1e-20))[:, None]
        return img_l

    sharded = shard_map(
        local_loop, mesh=mesh,
        in_specs=(P("rays"), P("rays"), P("rays"), P()),
        out_specs=P("rays"),
        check_vma=False,
    )
    img = jax.jit(sharded)(px_j, py_j, pids_j, jnp.uint32(seed))
    return np.asarray(img[:R])


def render_bdpt_sharded_step(cs, desc, mesh: Mesh, spp: int = 1, seed: int = 0):
    """Sharded BDPT: camera/light subpaths + all (s,t) connections run on
    each device's pixel slice; the t=1 film splats (which can land on ANY
    pixel, bdpt.rs:798-803) are segment-summed locally and psum-reduced —
    the only collective, the analog of the reference's AtomicFloat film.

    Returns the film ((H*W, 3) ndarray, splats included)."""
    from ..device.bdpt import bdpt_wave

    sa = cs.arrays
    static = cs.static
    cam = make_camera(desc.camera, desc.film)
    W = desc.film.x_resolution
    H = desc.film.y_resolution
    n_pix = W * H
    max_depth = max(int(desc.integrator.max_depth), 1)
    n_dev = math.prod(mesh.devices.shape)

    px, py, pids, R, Rp = _pixel_arrays(W, H, n_dev)
    ray_sh = NamedSharding(mesh, P("rays"))
    px_j = jax.device_put(jnp.asarray(px), ray_sh)
    py_j = jax.device_put(jnp.asarray(py), ray_sh)
    pids_j = jax.device_put(jnp.asarray(pids), ray_sh)

    cdf, possible = _light_cdf_and_possible(sa, static)

    # padding lanes duplicate pixel 0 (same pids -> same light subpath);
    # their t=1 splats land on REAL pixels, so they must be masked before
    # the psum or the film gains Rp-R extra copies of pixel 0's subpath
    valid_np = np.zeros(Rp, np.float32)
    valid_np[:R] = 1.0
    valid_j = jax.device_put(jnp.asarray(valid_np), ray_sh)

    def local_step(px_l, py_l, pids_l, valid_l, seed_l):
        acc = jnp.zeros((px_l.shape[0], 3), F32)
        splat = jnp.zeros((n_pix, 3), F32)
        n_loc = px_l.shape[0]
        for s in range(spp):
            L, spx, sval = bdpt_wave(sa, static, possible, cam, cdf, seed_l,
                                     px_l, py_l, pids_l, jnp.uint32(s), max_depth, W, H)
            k_n = sval.shape[0] // max(n_loc, 1)
            vrep = jnp.tile(valid_l, max(k_n, 1))[: sval.shape[0]]
            sval = sval * vrep[:, None]
            fs = jnp.stack(
                [jax.ops.segment_sum(sval[:, ch], spx, num_segments=n_pix + 1)[:n_pix]
                 for ch in range(3)], axis=-1)
            acc = acc + L
            splat = splat + fs
        return acc, jax.lax.psum(splat, "rays")

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(P("rays"), P("rays"), P("rays"), P("rays"), P()),
        out_specs=(P("rays"), P()),
        check_vma=False,
    )
    L, splat = jax.jit(sharded)(px_j, py_j, pids_j, valid_j, jnp.uint32(seed))
    img = np.asarray(L[:R], np.float64) + np.asarray(splat[:R], np.float64)
    return (img / max(spp, 1)).astype(np.float32)


def render_mlt_sharded_step(cs, desc, mesh: Mesh, seed: int = 0, depth: int = 1,
                            n_chains: int | None = None, n_mut: int = 2,
                            n_boot: int | None = None):
    """Sharded MLT for one path depth: the Markov chains (embarrassingly
    parallel, mlt.rs:324-377) are sharded over devices; every mutation's
    film contribution is psum-reduced. Bootstrap runs sharded too, with the
    normalization b computed from the GLOBAL mean (psum) so the estimator
    matches the single-device one; chain seeds use global chain ids, so a
    given chain mutates identically regardless of the mesh shape.

    Returns the depth-d film ((H*W, 3) ndarray, already b-normalized)."""
    from ..device.mlt import NO_COMMAND_BUFFER, _l_fn, mlt_chain_step

    sa = cs.arrays
    static = cs.static
    cam = make_camera(desc.camera, desc.film)
    W = desc.film.x_resolution
    H = desc.film.y_resolution
    n_pix = W * H
    n_dev = math.prod(mesh.devices.shape)
    sigma = float(getattr(desc.integrator, "sigma", 0.0)) or 0.01
    p_large = float(getattr(desc.integrator, "large_step_probability", 0.0)) or 0.3
    n_chains = _round_up(int(n_chains or max(getattr(desc.integrator, "n_chains", 64), n_dev)), n_dev)
    n_boot = _round_up(int(n_boot or max(n_chains * 4, 256)), n_dev)
    D = 160

    cdf, possible = _light_cdf_and_possible(sa, static)

    rstate = np.random.RandomState(seed + 17)
    u_boot = rstate.rand(n_boot, D).astype(np.float32)

    mesh_c = Mesh(mesh.devices, ("chains",))
    chain_sh = NamedSharding(mesh_c, P("chains"))
    u_boot_j = jax.device_put(jnp.asarray(u_boot), chain_sh)
    chain_ids = jax.device_put(jnp.arange(n_chains, dtype=jnp.uint32), chain_sh)

    def boot_local(u_b):
        _, _, _, _, lum = _l_fn(sa, static, possible, cam, cdf, u_b, depth, W, H)
        return jnp.where(jnp.isfinite(lum), lum, 0.0)

    lum = jax.jit(shard_map(boot_local, mesh=mesh_c, in_specs=(P("chains"),),
                            out_specs=P("chains"), check_vma=False),
                  compiler_options=NO_COMMAND_BUFFER)(u_boot_j)
    lum_np = np.asarray(lum, np.float64)
    b_d = lum_np.mean()
    if b_d <= 0:
        return np.zeros((n_pix, 3), np.float32)
    # global bootstrap selection (mlt.rs Distribution1D over ALL samples)
    picks = rstate.choice(n_boot, size=n_chains, p=lum_np / lum_np.sum())
    u_cur = jax.device_put(jnp.asarray(u_boot[picks]), chain_sh)

    def chains_local(u_c, ids):
        cur = _l_fn(sa, static, possible, cam, cdf, u_c, depth, W, H)
        film = jnp.zeros((n_pix, 3), F32)
        for m in range(n_mut):
            key = jnp.uint32(seed * 7919 + depth * 104729 + m)
            u_c, cur, fs = mlt_chain_step(sa, static, possible, cam, cdf, depth,
                                          W, H, sigma, p_large, ids, u_c, cur, key)
            film = film + fs
        return jax.lax.psum(film, "chains")

    film = jax.jit(shard_map(chains_local, mesh=mesh_c,
                             in_specs=(P("chains"), P("chains")),
                             out_specs=P(), check_vma=False),
                   compiler_options=NO_COMMAND_BUFFER)(u_cur, chain_ids)
    out = np.asarray(film, np.float64) * (b_d * n_pix / max(n_mut * n_chains, 1))
    return out.astype(np.float32)
