"""Top-level render driver: SceneDescription -> image.

Replaces the reference's SamplerIntegrator::render tile loop
(src/core/integrator.rs:263-403): instead of 16x16 tiles over threads, whole
sample waves (every pixel x one sample index) are traced per jit call, and
the host loop walks sample indices. Pixel filtering uses filter importance
sampling — the per-sample raster offset is drawn from the reconstruction
filter distribution, which converges to the same filtered image as the
reference's FilmTile filter-weight splatting (film.rs:292-331) with
weight 1 per sample (box/triangle/gaussian), or f/p weights for the
negative-lobed filters (mitchell/sinc).
"""
from __future__ import annotations

import logging
import math
import os
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .device import rng
from .device.camera import make_camera, generate_rays
from .device.integrator import trace_wave
from .device.sampler import sample_1d, sample_2d
from .scene.builder import CompiledScene, compile_scene
from .scene.host import SceneDescription

log = logging.getLogger(__name__)
F32 = jnp.float32

MAX_RAYS_PER_PASS = 1 << 20

# ---------------------------------------------------------------------------
# Filter importance sampling (src/filters/*; film.rs filter table)
# ---------------------------------------------------------------------------


def _erfinv(x):
    # Winitzki approximation — adequate for pixel jitter
    a = 0.147
    ln1 = jnp.log(jnp.maximum(1.0 - x * x, 1e-30))
    t1 = 2.0 / (jnp.pi * a) + ln1 / 2.0
    return jnp.sign(x) * jnp.sqrt(jnp.maximum(jnp.sqrt(t1 * t1 - ln1 / a) - t1, 0.0))


def filter_offset(name: str, params: dict, u1, u2):
    """Map uniform (u1, u2) -> raster offset (dx, dy) and per-sample weight."""
    if name == "triangle":
        r = params.get("xwidth", 2.0)

        def tent(u):
            return jnp.where(u < 0.5, jnp.sqrt(jnp.maximum(2.0 * u, 0.0)) - 1.0, 1.0 - jnp.sqrt(jnp.maximum(2.0 - 2.0 * u, 0.0)))

        return tent(u1) * r, tent(u2) * params.get("ywidth", r), None
    if name == "gaussian":
        r = params.get("xwidth", 2.0)
        ry = params.get("ywidth", r)
        alpha = params.get("alpha", 2.0)
        sigma = 1.0 / math.sqrt(2.0 * alpha)
        # truncated gaussian via inverse-CDF on the untruncated; clip to radius
        dx = jnp.clip(sigma * math.sqrt(2.0) * _erfinv(2.0 * u1 - 1.0), -r, r)
        dy = jnp.clip(sigma * math.sqrt(2.0) * _erfinv(2.0 * u2 - 1.0), -ry, ry)
        return dx, dy, None
    if name in ("mitchell", "sinc", "lanczossinc"):
        r = params.get("xwidth", 2.0 if name == "mitchell" else 4.0)
        ry = params.get("ywidth", r)
        dx = (2.0 * u1 - 1.0) * r
        dy = (2.0 * u2 - 1.0) * ry

        if name == "mitchell":
            b = params.get("B", 1.0 / 3.0)
            c = params.get("C", 1.0 / 3.0)

            def m1d(x, rad):
                x = jnp.abs(2.0 * x / rad)
                return jnp.where(
                    x > 1,
                    ((-b - 6 * c) * x ** 3 + (6 * b + 30 * c) * x * x + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0,
                    ((12 - 9 * b - 6 * c) * x ** 3 + (-18 + 12 * b + 6 * c) * x * x + (6 - 2 * b)) / 6.0,
                )

            w = m1d(dx, r) * m1d(dy, ry) * (4.0 * r * ry)
        else:
            tau = params.get("tau", 3.0)

            def sinc1d(x, rad):
                x = jnp.abs(x)
                lanczos = jnp.where(x < 1e-5, 1.0, jnp.sin(jnp.pi * x / tau) * tau / jnp.maximum(jnp.pi * x, 1e-9))
                s = jnp.where(x < 1e-5, 1.0, jnp.sin(jnp.pi * x) / jnp.maximum(jnp.pi * x, 1e-9))
                return jnp.where(x > rad, 0.0, s * lanczos)

            w = sinc1d(dx, r) * sinc1d(dy, ry) * (4.0 * r * ry)
        return dx, dy, w
    # box (default): uniform in [-r, r]
    r = params.get("xwidth", 0.5)
    ry = params.get("ywidth", r)
    return (2.0 * u1 - 1.0) * r, (2.0 * u2 - 1.0) * ry, None


# ---------------------------------------------------------------------------
# Render driver
# ---------------------------------------------------------------------------


def _one_sample_wave(sa, static, icfg, scfg, fcfg, cam, px_base, py_base, pixel_ids, sample_idx, seed):
    """Trace sample `sample_idx` for every pixel in the wave.

    Returns (L (R,3), w (R,)) — radiance and filter weight.
    """
    kind = scfg["kind"]
    spp = scfg["spp"]
    if kind == "halton" and scfg.get("halton") is not None:
        # true Halton points for the film dims (CRT pixel enumeration)
        from .device.sampler import halton_dim_2d, halton_film_jitter

        aux = scfg["halton"]
        u1, u2 = halton_film_jitter(aux, pixel_ids, sample_idx)
        ul1, ul2 = halton_dim_2d(aux, pixel_ids, sample_idx, 1)
    elif kind == "sobol" and scfg.get("sobol") is not None:
        # global Sobol sequence over the pow2-padded film
        # (sobol.rs:61-75 interval-to-index enumeration)
        from .device.sampler import sobol_dim_2d, sobol_film_jitter

        aux = scfg["sobol"]
        u1, u2 = sobol_film_jitter(aux, px_base, py_base, sample_idx)
        ul1, ul2 = sobol_dim_2d(aux, px_base, py_base, sample_idx, 1)
    else:
        u1, u2 = sample_2d(kind, seed, pixel_ids, sample_idx, 0, spp)
        ul1, ul2 = sample_2d(kind, seed, pixel_ids, sample_idx, 1, spp)
    dx, dy, w = filter_offset(fcfg["filter"], fcfg["filter_params"], u1, u2)
    px = px_base.astype(F32) + 0.5 + dx
    py = py_base.astype(F32) + 0.5 + dy
    # per-ray shutter time (camera.rs CameraSample::time), normalized to the
    # TransformTimes keyframe range for the motion lerp tables
    time_frac = None
    if cam.get("anim") is not None or static.has_motion:
        ut = sample_1d(kind, seed, pixel_ids, sample_idx, 8117, spp)
        so, sc = cam["shutter"]
        ts, te = cam.get("motion_times", (0.0, 1.0))
        t_abs = so + ut * (sc - so)
        time_frac = jnp.clip((t_abs - ts) / max(te - ts, 1e-9), 0.0, 1.0)
    ray_w = None
    if cam.get("realistic") is not None:
        from .device.realistic import realistic_generate_rays

        o, d, ray_w = realistic_generate_rays(cam, cam["realistic"], px, py, ul1, ul2)
    else:
        o, d = generate_rays(cam, px, py, ul1, ul2, time_frac)
    if static.tex_programs and any(p.kind == "imagemap" for p in static.tex_programs):
        from .device.camera import ray_differential_dirs

        diff_dirs = ray_differential_dirs(cam, px, py)
    else:
        diff_dirs = None
    L, n_vertices = trace_wave(sa, static, icfg, scfg, seed, o, d, pixel_ids, sample_idx, diff_dirs, time=time_frac)
    # sanity clamps (integrator.rs:350-368 NaN/negative checks)
    L = jnp.where(jnp.isfinite(L), L, 0.0)
    L = jnp.maximum(L, 0.0)
    if fcfg.get("max_sample_luminance", np.inf) < np.inf:
        y = L[:, 0] * 0.212671 + L[:, 1] * 0.715160 + L[:, 2] * 0.072169
        scale = jnp.where(y > fcfg["max_sample_luminance"], fcfg["max_sample_luminance"] / jnp.maximum(y, 1e-12), 1.0)
        L = L * scale[:, None]
    if w is None:
        w = jnp.ones(L.shape[0], F32)
    if ray_w is not None:
        # realistic-lens vignetting weight (weights the sample, not the
        # filter normalization)
        L = L * ray_w[:, None]
    return L * w[:, None], w, n_vertices


def make_regen(cam, static, scfg, fcfg, px_base, py_base, pixel_ids, seed):
    """Camera-sample regeneration closure for the persistent wavefront.

    regen(sample_idx (R,) u32) -> (o, d, w_filter, dd_x, dd_y), mirroring
    the film/lens-dimension logic of _one_sample_wave exactly so the
    persistent and per-sample paths produce identical samples."""
    kind = scfg["kind"]
    spp = scfg["spp"]
    need_dd = bool(static.tex_programs) and any(p.kind == "imagemap" for p in static.tex_programs)

    def regen(sample_idx):
        if kind == "halton" and scfg.get("halton") is not None:
            from .device.sampler import halton_dim_2d, halton_film_jitter

            aux = scfg["halton"]
            u1, u2 = halton_film_jitter(aux, pixel_ids, sample_idx)
            ul1, ul2 = halton_dim_2d(aux, pixel_ids, sample_idx, 1)
        elif kind == "sobol" and scfg.get("sobol") is not None:
            from .device.sampler import sobol_dim_2d, sobol_film_jitter

            aux = scfg["sobol"]
            u1, u2 = sobol_film_jitter(aux, px_base, py_base, sample_idx)
            ul1, ul2 = sobol_dim_2d(aux, px_base, py_base, sample_idx, 1)
        else:
            u1, u2 = sample_2d(kind, seed, pixel_ids, sample_idx, 0, spp)
            ul1, ul2 = sample_2d(kind, seed, pixel_ids, sample_idx, 1, spp)
        dx, dy, w = filter_offset(fcfg["filter"], fcfg["filter_params"], u1, u2)
        px = px_base.astype(F32) + 0.5 + dx
        py = py_base.astype(F32) + 0.5 + dy
        o, d = generate_rays(cam, px, py, ul1, ul2, None)
        if need_dd:
            from .device.camera import ray_differential_dirs

            dd_x, dd_y = ray_differential_dirs(cam, px, py)
        else:
            dd_x = jnp.zeros_like(o)
            dd_y = jnp.zeros_like(o)
        if w is None:
            w = jnp.ones(o.shape[0], F32)
        return o, d, w, dd_x, dd_y

    return regen


def persistent_eligible(desc, static, cam) -> bool:
    """The persistent wavefront covers the plain path and directlighting
    configs (the flagship, both bench scenes, and the spheres fidelity
    scene — whose 16spp render took 857s through the per-sample wave in
    round 1); everything else uses the per-sample wave."""
    return (
        desc.integrator.kind in ("path", "directlighting")
        and not static.has_motion
        and cam.get("anim") is None
        and cam.get("realistic") is None
        and static.n_media == 0
        and not static.has_sss_media
        and not static.has_tab_sss
        and not static.has_null_material
    )


# Dispatch shapes of the persistent wave: lanes per dispatch and samples per
# pixel per dispatch. The values are carried over unchanged and are untuned
# on the H100; re-sweeping them is ROADMAP A5.
PERSISTENT_SPP_CHUNK = 32
PERSISTENT_SPP_CHUNK_BIG = 2
PERSISTENT_BIG_WAVE = 150_000
PERSISTENT_MAX_RAYS = 1 << 18  # ray chunk of texture-heavy waves


def persistent_dispatch_shape(R: int, textured: bool = False):
    """(rays_cap, spp_chunk) of one persistent-wave dispatch.

    Untextured waves run 512k lanes x 8 spp per dispatch, so the k=8 spp
    interleave (persistent_spp_k) has all 8 samples in flight.
    Texture-heavy waves (per-bounce EWA imagemap lookups) keep smaller
    dispatches.
    """
    if not textured:
        return (1 << 19), 8
    if R >= PERSISTENT_BIG_WAVE:
        return PERSISTENT_MAX_RAYS, PERSISTENT_SPP_CHUNK_BIG
    return PERSISTENT_MAX_RAYS, PERSISTENT_SPP_CHUNK


def persistent_spp_k(tier: str, R: int, n_samples: int) -> int:
    """Concurrent samples-per-pixel for the persistent wave (k-way spp
    interleaving; 1 = classic sequential regeneration).

    Only the sorting BVH tiers benefit: k x more rays in flight densify the
    coherence sort's (origin-cell, octant) bins. Brute and kd-tree tiers
    have nothing to amortize, so k would only multiply lane state. Lane
    state scales with k, so k is capped to keep lanes <= ~4M. k = 8 is
    untuned on the H100 (ROADMAP A5). PBRT_TPU_SPP_K overrides."""
    if tier.endswith("brute") or tier.endswith("kdtree"):
        return 1
    env = os.environ.get("PBRT_TPU_SPP_K", "")
    if env:
        k = max(1, int(env))
    elif jax.default_backend() == "cpu":
        return 1  # keeps CPU test lanes small
    else:
        k = 8
    # lane-state cap: ~35 f32s per lane double-buffered => 4M lanes ~ 1.1GB
    k = min(k, max(1, n_samples), max(1, (1 << 22) // max(R, 1)))
    return k


def _has_imagemaps(static) -> bool:
    return bool(getattr(static, "tex_programs", ())) and any(
        p.kind == "imagemap" for p in static.tex_programs)


# tier label of the most recent make_persistent_fn build: which traversal
# the render executes on the default backend (bench.py and chip_smoke.py
# report it)
LAST_PERSISTENT_TIER = "unbuilt"


def _xla_traversal_tier(static) -> str:
    from .device import bvh_kernel

    if static.use_brute_force:
        return "xla-wavefront/brute"
    if static.accel_kind == "kdtree":
        return "xla-wavefront/kdtree"
    if bvh_kernel.eligible(static) and jax.default_backend() == "gpu":
        return "xla-wavefront/cuda-bvh"
    return "xla-wavefront/packet"


def make_persistent_fn(cs: CompiledScene, cam=None):
    """Build the jitted persistent-wave function: (sa, px, py, pids, s0,
    n_samples, seed) -> (accLw, accW, n_vertices). n_samples is static.

    Sets render.LAST_PERSISTENT_TIER to the traversal tier that executes.
    """
    global LAST_PERSISTENT_TIER
    from .device.integrator import trace_persistent

    desc = cs.description
    if cam is None:
        cam = make_camera(desc.camera, desc.film)
    icfg = {
        "kind": desc.integrator.kind if desc.integrator.kind == "directlighting" else "path",
        "max_depth": max(int(desc.integrator.max_depth), 1),
        "rr_threshold": desc.integrator.rr_threshold,
        "strategy": desc.integrator.strategy,
        "light_strategy": desc.integrator.light_strategy,
    }
    if str(desc.integrator.light_strategy) == "spatial" and cs.static.n_lights > 1:
        from .device.lightdistrib import build_spatial_distribution

        icfg["spatial_distribution"] = build_spatial_distribution(cs.arrays, cs.static)
    scfg = {"kind": desc.sampler.kind, "spp": int(desc.sampler.pixel_samples)}
    if desc.sampler.kind == "halton":
        from .device.sampler import halton_tables

        scfg["halton"] = halton_tables(desc.film.x_resolution, desc.film.y_resolution)
    elif desc.sampler.kind == "sobol":
        from .device.sampler import sobol_tables

        scfg["sobol"] = sobol_tables(desc.film.x_resolution, desc.film.y_resolution, int(desc.sampler.pixel_samples))
    fcfg = {
        "filter": desc.film.filter_name,
        "filter_params": dict(desc.film.filter_params),
        "max_sample_luminance": desc.film.max_sample_luminance,
    }
    static = cs.static

    LAST_PERSISTENT_TIER = _xla_traversal_tier(static)

    @partial(jax.jit, static_argnums=(5, 7))
    def wave_p(sa, px, py, pixel_ids, s0, n_samples, seed, spp_k=1):
        # spp_k > 1: k-way spp interleaving — lanes are tiled k x pixels so
        # k samples per pixel are IN FLIGHT concurrently; the per-bounce
        # coherence sort then packs k x denser (origin-cell, octant) bins.
        # Outputs are folded back to (R_pix,) so callers see the sequential
        # shape.
        k = max(int(spp_k), 1)
        if k > 1:
            R_pix = px.shape[0]
            px_t = jnp.tile(px, k)
            py_t = jnp.tile(py, k)
            pids_t = jnp.tile(pixel_ids, k)
            offs = jnp.repeat(jnp.arange(k, dtype=jnp.uint32), R_pix)
            regen = make_regen(cam, static, scfg, fcfg, px_t, py_t, pids_t, seed)
            accL, accW, nv = trace_persistent(
                sa, static, icfg, scfg, seed, pids_t, s0, n_samples, regen,
                max_sample_luminance=float(fcfg["max_sample_luminance"]),
                s_offsets=offs, s_stride=k,
            )
            return (accL.reshape(k, R_pix, 3).sum(0),
                    accW.reshape(k, R_pix).sum(0),
                    nv.reshape(k, R_pix).sum(0))
        regen = make_regen(cam, static, scfg, fcfg, px, py, pixel_ids, seed)
        return trace_persistent(
            sa, static, icfg, scfg, seed, pixel_ids, s0, n_samples, regen,
            max_sample_luminance=float(fcfg["max_sample_luminance"]),
        )

    return wave_p


def make_wave_fn(cs: CompiledScene, cam=None):
    """Build the jitted per-sample wave function for a compiled scene."""
    desc = cs.description
    if cam is None:
        cam = make_camera(desc.camera, desc.film)
        cam["motion_times"] = (float(getattr(desc, "transform_start_time", 0.0)), float(getattr(desc, "transform_end_time", 1.0)))
    icfg = {
        "kind": desc.integrator.kind,
        "max_depth": max(int(desc.integrator.max_depth), 1),
        "rr_threshold": desc.integrator.rr_threshold,
        "strategy": desc.integrator.strategy,
        "light_strategy": desc.integrator.light_strategy,
        "n_samples": desc.integrator.n_samples,
        "cos_sample": desc.integrator.cos_sample,
    }
    if str(desc.integrator.light_strategy) == "spatial" and cs.static.n_lights > 1:
        # precompute the voxel-grid light distribution once per scene
        # (lightdistrib.rs SpatialLightDistribution; device/lightdistrib.py)
        from .device.lightdistrib import build_spatial_distribution

        icfg["spatial_distribution"] = build_spatial_distribution(cs.arrays, cs.static)
    scfg = {"kind": desc.sampler.kind, "spp": int(desc.sampler.pixel_samples)}
    if desc.sampler.kind == "halton":
        from .device.sampler import halton_tables

        scfg["halton"] = halton_tables(desc.film.x_resolution, desc.film.y_resolution)
    elif desc.sampler.kind == "sobol":
        from .device.sampler import sobol_tables

        scfg["sobol"] = sobol_tables(desc.film.x_resolution, desc.film.y_resolution, int(desc.sampler.pixel_samples))
    fcfg = {
        "filter": desc.film.filter_name,
        "filter_params": dict(desc.film.filter_params),
        "max_sample_luminance": desc.film.max_sample_luminance,
    }
    static = cs.static

    @partial(jax.jit, static_argnums=())
    def wave(sa, px, py, pixel_ids, sample_idx, seed):
        return _one_sample_wave(sa, static, icfg, scfg, fcfg, cam, px, py, pixel_ids, sample_idx, seed)

    return wave


def render(desc: SceneDescription, seed: int = 0, spp: int | None = None, progress=None, **kw):
    """Render a scene description to an (H, W, 3) float32 numpy image."""
    cs = compile_scene(desc)
    return render_compiled(cs, seed=seed, spp=spp, progress=progress, **kw)


# integrator kinds whose reference create() accepts "pixelbounds"
# (ao.rs:120, bdpt.rs:1371, directlighting.rs:129, path.rs:230, volpath,
# whitted; NOT sppm/mlt)
_PIXELBOUNDS_KINDS = frozenset(
    {"ao", "bdpt", "directlighting", "path", "volpath", "whitted"})


def film_pixel_bounds(desc) -> tuple[int, int, int, int]:
    """(x0, x1, y0, y1) camera pixel bounds: the film's crop-window bounds
    (film.rs create_film :385-393) intersected with the integrator's
    "pixelbounds" [x0 x1 y0 y1] when the integrator kind supports it
    (SamplerIntegrator create fns). Degenerate intersections fall back to
    the crop bounds, matching the reference's error-and-ignore."""
    import math as _math

    W = desc.film.x_resolution
    H = desc.film.y_resolution
    cx0, cx1, cy0, cy1 = desc.film.crop_window
    x0 = int(_math.ceil(W * cx0))
    x1 = max(int(_math.ceil(W * cx1)), x0 + 1)
    y0 = int(_math.ceil(H * cy0))
    y1 = max(int(_math.ceil(H * cy1)), y0 + 1)
    pb = getattr(desc.integrator, "pixel_bounds", None)
    if pb is not None and len(pb) == 4 and desc.integrator.kind in _PIXELBOUNDS_KINDS:
        nx0 = max(x0, int(pb[0]))
        nx1 = min(x1, int(pb[1]))
        ny0 = max(y0, int(pb[2]))
        ny1 = min(y1, int(pb[3]))
        if nx1 > nx0 and ny1 > ny0:
            return nx0, nx1, ny0, ny1
        import logging

        logging.getLogger(__name__).error(
            "degenerate \"pixelbounds\" %s ignored", tuple(pb))
    return x0, x1, y0, y1


_WAVE_CACHE: dict = {}


def _cached_wave_fn(cs: CompiledScene):
    # hold the CompiledScene itself so its id can't be recycled by the GC
    cached = _WAVE_CACHE.get("scene")
    if cached is not cs:
        _WAVE_CACHE.clear()  # one scene at a time; avoid leaking jit closures
        _WAVE_CACHE["scene"] = cs
        _WAVE_CACHE["wave"] = make_wave_fn(cs)
    return _WAVE_CACHE["wave"]


def _auto_shard_devices():
    """The devices a render shards over by itself: every visible device,
    when there is more than one and they are not the virtual CPU devices of
    the tests and the dry run (those shard only when asked explicitly)."""
    devs = jax.devices()
    return devs if len(devs) > 1 and jax.default_backend() != "cpu" else None


def render_compiled(cs: CompiledScene, seed: int = 0, spp: int | None = None, progress=None,
                    checkpoint_path: str | None = None, checkpoint_every: int = 0):
    """Render; optionally checkpoint film state every N samples.

    Checkpointing (absent from the reference; for preemptible machines): the film accumulator + weight sum + next sample index
    are plain arrays, snapshotted to an .npz; a matching snapshot on disk is
    resumed automatically.
    """
    desc = cs.description
    if desc.sampler.kind == "stratified":
        # register the user-declared strata layout + jitter flag before any
        # wave traces (stratified.rs:121-131)
        from .device.sampler import set_stratified_shape

        set_stratified_shape(desc.sampler.x_samples, desc.sampler.y_samples,
                             jitter=bool(desc.sampler.jitter))

    # multi-device: shard the pixel/ray axis over every visible device via
    # explicit shard_map (parallel/shard.py; SURVEY.md §2.12 — the rayon
    # tile-pool analog). Auto-enabled for the wavefront family on full-film
    # renders; checkpointing and crop windows stay on the single-device path.
    _devs = _auto_shard_devices()
    if (_devs and checkpoint_path is None
            and desc.film.crop_window in (None, (0.0, 1.0, 0.0, 1.0))
            and desc.integrator.kind in ("path", "volpath", "directlighting", "whitted",
                                         "ao", "sppm", "bdpt", "mlt")):
        from jax.sharding import Mesh

        from .parallel.shard import (
            render_bdpt_sharded_step,
            render_mlt_sharded_step,
            render_sharded_step,
            render_sppm_sharded_step,
        )

        mesh = Mesh(np.array(_devs), ("rays",))
        t0 = time.time()
        kind = desc.integrator.kind
        W, H = desc.film.x_resolution, desc.film.y_resolution
        if kind == "sppm":
            img = np.asarray(render_sppm_sharded_step(
                cs, desc, mesh, seed=seed,
                n_iters=max(int(desc.integrator.num_iterations), 1),
                n_photons=max(int(desc.integrator.photons_per_iteration), 1)))
        elif kind == "bdpt":
            img = np.asarray(render_bdpt_sharded_step(
                cs, desc, mesh, seed=seed,
                spp=int(spp if spp is not None else desc.sampler.pixel_samples)))
        elif kind == "mlt":
            # depth loop mirrors device/mlt.render_mlt: per-depth bootstrap
            # + chains, b-normalized films summed
            max_depth = max(int(desc.integrator.max_depth), 1)
            n_chains = max(int(desc.integrator.n_chains), len(_devs))
            mpp = max(int(desc.integrator.mutations_per_pixel), 1)
            n_mut = int(np.clip((mpp * W * H) // (n_chains * (max_depth + 1)), 1, 8192))
            img = np.zeros((W * H, 3), np.float32)
            for depth in range(max_depth + 1):
                img = img + render_mlt_sharded_step(
                    cs, desc, mesh, seed=seed, depth=depth,
                    n_chains=n_chains, n_mut=n_mut)
        else:
            img = np.asarray(render_sharded_step(cs, desc, mesh, spp=spp, seed=seed))
        log.info("sharded %s render over %d devices in %.2fs", kind, len(_devs), time.time() - t0)
        # film "scale" applies to EVERY output path (film.rs write_image);
        # the early returns here skipped it — caustic-glass (scale 1.5)
        # measured exactly 1.5^(1/2.4) dark in the sRGB-space fidelity fit
        return img.reshape(H, W, 3) * desc.film.scale

    if desc.integrator.kind == "sppm":
        from .device.sppm import render_sppm

        return render_sppm(cs, seed=seed, progress=progress) * desc.film.scale
    if desc.integrator.kind == "bdpt":
        from .device.bdpt import render_bdpt

        return render_bdpt(cs, seed=seed, spp=spp, progress=progress) * desc.film.scale
    if desc.integrator.kind == "mlt":
        from .device.mlt import render_mlt

        return render_mlt(cs, seed=seed, progress=progress) * desc.film.scale
    W = desc.film.x_resolution
    H = desc.film.y_resolution
    spp = int(spp if spp is not None else desc.sampler.pixel_samples)

    # crop window -> pixel bounds (film.rs create_film :385-393),
    # intersected with the integrator's "pixelbounds" (path.rs:230 etc.)
    x0, x1, y0, y1 = film_pixel_bounds(desc)
    ww = x1 - x0
    wh = y1 - y0

    ys, xs = np.mgrid[y0:y1, x0:x1]
    px = jnp.asarray(xs.ravel().astype(np.int32))
    py = jnp.asarray(ys.ravel().astype(np.int32))
    pixel_ids = jnp.asarray((ys * W + xs).ravel().astype(np.uint32))
    R = ww * wh

    sa = cs.arrays

    rays_cap = (PERSISTENT_MAX_RAYS
                if persistent_eligible(desc, cs.static, make_camera(desc.camera, desc.film))
                else MAX_RAYS_PER_PASS)
    n_chunks = max(1, int(math.ceil(R / rays_cap)))
    chunk = int(math.ceil(R / n_chunks))

    acc = np.zeros((R, 3), np.float64)
    wacc = np.zeros((R,), np.float64)
    n_vertices = 0.0

    cam0 = make_camera(desc.camera, desc.film)
    cam0["motion_times"] = (float(getattr(desc, "transform_start_time", 0.0)), float(getattr(desc, "transform_end_time", 1.0)))
    if (persistent_eligible(desc, cs.static, cam0) and checkpoint_path is None
            and not os.environ.get("PBRT_TPU_FORCE_WAVE")):
        # persistent wavefront: lanes regenerate in place, samples chunked
        # for f64 host accumulation (see device/integrator.trace_persistent)
        cached = _WAVE_CACHE.get("pscene")
        if cached is not cs:
            _WAVE_CACHE["pscene"] = cs
            _WAVE_CACHE["pwave"] = make_persistent_fn(cs, cam0)
            # tier pinned per cache entry: the module global is refreshed
            # by ANY make_persistent_fn call (bench/shard probing), so a
            # cache-hit render must not read it
            _WAVE_CACHE["ptier"] = LAST_PERSISTENT_TIER
        wave_p = _WAVE_CACHE["pwave"]
        tier = _WAVE_CACHE["ptier"]
        t0 = time.time()
        t_compile = 0.0
        first_call = True
        s = 0
        # re-chunk for the tier that executes
        rays_cap, spp_chunk = persistent_dispatch_shape(
            R, textured=_has_imagemaps(cs.static))
        n_chunks = max(1, int(math.ceil(R / rays_cap)))
        chunk = int(math.ceil(R / n_chunks))
        spp_k = persistent_spp_k(tier, chunk, spp_chunk)
        while s < spp:
            n_s = min(spp_chunk, spp - s)
            # a short tail chunk shrinks k too (k > n_s lanes start done)
            ex = (min(spp_k, n_s),)
            for c in range(n_chunks):
                sl = slice(c * chunk, min((c + 1) * chunk, R))
                Lw, w, nv = wave_p(sa, px[sl], py[sl], pixel_ids[sl], jnp.uint32(s), n_s, jnp.uint32(seed), *ex)
                if first_call:
                    # block here so the compile cost is split out of the
                    # render-rate log line
                    jax.block_until_ready(Lw)
                    t_compile = time.time() - t0
                    first_call = False
                acc[sl] += np.asarray(Lw, np.float64)
                wacc[sl] += np.asarray(w, np.float64)
                n_vertices += float(np.asarray(jnp.sum(nv)))
            s += n_s
            if progress:
                progress(s, spp)
        dt = time.time() - t0
        log.info(
            "rendered %dx%d @ %dspp (persistent, %s) in %.2fs "
            "(compile+first-chunk %.2fs; %.2f Mrays/s primary, %.2f Mverts/s)",
            ww, wh, spp, tier, dt, t_compile,
            R * spp / max(dt, 1e-9) / 1e6, n_vertices / max(dt, 1e-9) / 1e6,
        )
        render_compiled.last_timing = {"wall_s": dt, "compile_s": t_compile,
                                       "tier": tier, "n_vertices": n_vertices}
        from .scene.arrays import scene_byte_size
        from .utils.stats import STATS

        STATS.counter("Integrator/Camera rays traced", R * spp)
        STATS.counter("Integrator/Path vertices", int(n_vertices))
        STATS.distribution("Integrator/Path length", n_vertices / max(R * spp, 1), R * spp)
        STATS.memory_counter("Memory/Scene arrays", scene_byte_size(cs.arrays))
        img_crop = (acc / np.maximum(wacc, 1e-9)[:, None]).reshape(wh, ww, 3).astype(np.float32)
        img_crop *= desc.film.scale
        if (ww, wh) == (W, H):
            return img_crop
        img = np.zeros((H, W, 3), np.float32)
        img[y0:y1, x0:x1] = img_crop
        return img

    wave = _cached_wave_fn(cs)
    s_start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        try:
            ck = np.load(checkpoint_path)
            if int(ck["spp_total"]) == spp and ck["acc"].shape == acc.shape and int(ck["seed"]) == seed:
                acc = ck["acc"]
                wacc = ck["wacc"]
                s_start = int(ck["next_sample"])
                log.info("resumed checkpoint at sample %d/%d", s_start, spp)
            else:
                log.warning("checkpoint %s does not match this render; ignoring", checkpoint_path)
        except Exception as e:  # corrupt snapshot: start over
            log.warning("checkpoint unreadable (%s); starting fresh", e)
    t0 = time.time()
    for s in range(s_start, spp):
        for c in range(n_chunks):
            sl = slice(c * chunk, min((c + 1) * chunk, R))
            Lw, w, nv = wave(sa, px[sl], py[sl], pixel_ids[sl], jnp.uint32(s), jnp.uint32(seed))
            acc[sl] += np.asarray(Lw, np.float64)
            wacc[sl] += np.asarray(w, np.float64)
            n_vertices += float(np.asarray(jnp.sum(nv)))
        if checkpoint_path and checkpoint_every and (s + 1) % checkpoint_every == 0:
            tmp = checkpoint_path + ".tmp.npz"
            with open(tmp, "wb") as fh:
                np.savez(fh, acc=acc, wacc=wacc, next_sample=s + 1, spp_total=spp, seed=seed)
            os.replace(tmp, checkpoint_path)
        if progress:
            progress(s + 1, spp)
    dt = time.time() - t0
    log.info(
        "rendered %dx%d @ %dspp in %.2fs (%.2f Mrays/s primary, %.2f Mverts/s)",
        ww, wh, spp, dt, R * spp / max(dt, 1e-9) / 1e6, n_vertices / max(dt, 1e-9) / 1e6,
    )

    # stats parity with the reference's counters (src/core/integrator.rs:36,
    # src/integrators/path.rs:24-25, src/core/scene.rs:14-15)
    from .scene.arrays import scene_byte_size
    from .utils.stats import STATS

    STATS.counter("Integrator/Camera rays traced", R * spp)
    STATS.counter("Integrator/Path vertices", int(n_vertices))
    STATS.distribution("Integrator/Path length", n_vertices / max(R * spp, 1), R * spp)
    STATS.memory_counter("Memory/Scene arrays", scene_byte_size(cs.arrays))

    img_crop = (acc / np.maximum(wacc, 1e-9)[:, None]).reshape(wh, ww, 3).astype(np.float32)
    img_crop *= desc.film.scale
    if (ww, wh) == (W, H):
        return img_crop
    img = np.zeros((H, W, 3), np.float32)
    img[y0:y1, x0:x1] = img_crop
    return img
