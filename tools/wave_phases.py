"""Phase-profile the production mesh bounce wave.

Splits one persistent-wave iteration on the 123k-tri bench scene into its
phases and times each as a standalone jitted program on a representative
bounce wave (camera hits -> cosine bounce). Phases:

  sort       ray sort-key + argsort + gather + inverse-perm scatter-back
             (what sort_rays adds around a traversal)
  traverse   extend-ray closest-hit, production config (sorted)
  surfint    surface_interaction (hit -> shading record)
  shade      make_bsdf + NEE math (sample_li/bsdf_f/bsdf_pdf/MIS) + BSDF
             continuation sample + RR arithmetic — everything between the
             two traversals except the shadow query itself
  shadow     NEE shadow any-hit, production config (sorted)
  regen      camera-sample regeneration for a full wave (generate_rays +
             film-dim sampler draws)

XLA fuses across phase boundaries inside the real wave, so the sum of
standalone phases overestimates the whole; the FRACTIONS are the signal.
Times mean something only on the GPU. Prints one JSON line.

Usage: python tools/wave_phases.py [--lanes 262144] [--reps 5]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _med_time(fn, reps):
    fn()  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        import jax

        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=1 << 18)  # production rays_cap
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import _mesh_scene
    from pbrt_tpu.device.bsdf import bsdf_f, bsdf_pdf, bsdf_sample, num_lobes
    from pbrt_tpu.device.camera import generate_rays, make_camera
    from pbrt_tpu.device.integrator import _dot, _offset_ray, _to_local, _to_world, power_heuristic
    from pbrt_tpu.device.intersect import _ray_sort_key, intersect, intersect_p
    from pbrt_tpu.device.lights import sample_li
    from pbrt_tpu.device.materials import make_bsdf
    from pbrt_tpu.device.sampler import sample_1d, sample_2d
    from pbrt_tpu.device.shading import surface_interaction
    from pbrt_tpu.scene.builder import compile_scene

    F32 = jnp.float32
    desc = _mesh_scene()
    cs = compile_scene(desc)
    sa, static = cs.arrays, cs.static
    cam = make_camera(desc.camera, desc.film)
    R = args.lanes
    W, H = 1000, 500
    K = 8  # production spp interleave: lanes tile k x pixels
    n_pix = R // K

    key = jax.random.PRNGKey(7)
    px = jnp.tile(jax.random.uniform(key, (n_pix,)) * W, K)
    py = jnp.tile(jax.random.uniform(jax.random.fold_in(key, 1), (n_pix,)) * H, K)
    pids = (py.astype(jnp.int32) * W + px.astype(jnp.int32)).astype(jnp.uint32)
    sidx = jnp.repeat(jnp.arange(K, dtype=jnp.uint32), n_pix)
    seed = jnp.uint32(0)

    @jax.jit
    def build_wave():
        o0, d0 = generate_rays(cam, px, py, jnp.zeros(R), jnp.zeros(R))
        hit = intersect(sa, static, o0, d0, jnp.full(R, jnp.inf, F32), sort_rays=True)
        si = surface_interaction(sa, hit, o0, d0)
        u1, u2 = sample_2d("zerotwosequence", seed, pids, sidx, 3, 16)
        from pbrt_tpu.device.bsdf import cosine_sample_hemisphere

        wi_l = cosine_sample_hemisphere(u1, u2)
        flip = (_dot(si["wo"], si["ns"]) < 0)[:, None]
        wi = _to_world(si, jnp.where(flip, wi_l * jnp.array([1.0, 1.0, -1.0], F32), wi_l))
        o = _offset_ray(si["p"], si["ng"], wi, si.get("p_err"))
        return o, wi

    o, d = jax.block_until_ready(build_wave())
    t_full = jnp.full(R, jnp.inf, F32)

    # --- phases --------------------------------------------------------
    results = {}

    @jax.jit
    def ph_sort(o, d):
        k = _ray_sort_key(sa, o, d, t_full)
        perm = jnp.argsort(k)
        o_s, d_s = o[perm], d[perm]
        inv = jnp.argsort(perm)
        # representative scatter-back: 5 result columns
        fake = jnp.stack([o_s[:, 0], o_s[:, 1], o_s[:, 2], d_s[:, 0], d_s[:, 1]], axis=1)
        return fake[inv]

    results["sort"] = _med_time(lambda: ph_sort(o, d), args.reps)

    @jax.jit
    def ph_traverse(o, d):
        return intersect(sa, static, o, d, t_full, sort_rays=True)

    results["traverse"] = _med_time(lambda: ph_traverse(o, d), args.reps)

    hit = jax.block_until_ready(ph_traverse(o, d))

    @jax.jit
    def ph_surfint(o, d):
        return surface_interaction(sa, hit, o, d)

    results["surfint"] = _med_time(lambda: ph_surfint(o, d), args.reps)
    si = jax.block_until_ready(jax.jit(lambda: surface_interaction(sa, hit, o, d))())

    @jax.jit
    def ph_shade():
        lobes = make_bsdf(sa, static, si["mat"], si["uv"], si["p"])
        u_sel = sample_1d("zerotwosequence", seed, pids, sidx, 10, 16)
        ua, ub = sample_2d("zerotwosequence", seed, pids, sidx, 11, 16)
        lid = jnp.zeros(R, jnp.int32)
        ls = sample_li(sa, static, lid, si["p"], ua, ub, cone_spheres=static.has_cone_sphere_lights)
        wo_l = _to_local(si, si["wo"])
        wi_l = _to_local(si, ls["wi"])
        refl = _dot(ls["wi"], si["ng"]) * _dot(si["wo"], si["ng"]) > 0
        f_val = bsdf_f(lobes, wo_l, wi_l, refl) * jnp.abs(_dot(ls["wi"], si["ns"]))[:, None]
        p_b = bsdf_pdf(lobes, wo_l, wi_l)
        w_l = jnp.where(ls["delta"], 1.0, power_heuristic(1.0, ls["pdf"], 1.0, p_b))
        nee = f_val * ls["li"] * (w_l / jnp.maximum(ls["pdf"], 1e-30))[:, None]
        u_lo = sample_1d("zerotwosequence", seed, pids, sidx, 12, 16)
        u1b, u2b = sample_2d("zerotwosequence", seed, pids, sidx, 13, 16)
        bs = bsdf_sample(lobes, wo_l, u_lo, u1b, u2b)
        wi_w = _to_world(si, bs["wi"])
        thru = bs["f"] * (jnp.abs(_dot(wi_w, si["ns"])) / jnp.maximum(bs["pdf"], 1e-30))[:, None]
        o_sh = _offset_ray(si["p"], si["ng"], ls["wi"], si.get("p_err"))
        o_n = _offset_ray(si["p"], si["ng"], wi_w, si.get("p_err"))
        u_rr = sample_1d("zerotwosequence", seed, pids, sidx, 14, 16)
        q = jnp.maximum(0.05, 1.0 - jnp.max(thru, axis=-1))
        return nee, thru, o_sh, o_n, wi_w, ls["wi"], ls["dist"], (u_rr < q)

    shade_out = jax.block_until_ready(ph_shade())
    results["shade"] = _med_time(ph_shade, args.reps)
    _nee, _thru, o_sh, _o_n, _wi_w, wi_sh, dist_sh, _kill = shade_out

    @jax.jit
    def ph_shadow():
        return intersect_p(sa, static, o_sh, wi_sh, dist_sh * 0.998, sort_rays=True)

    results["shadow"] = _med_time(ph_shadow, args.reps)

    @jax.jit
    def ph_regen():
        u1, u2 = sample_2d("zerotwosequence", seed, pids, sidx + 1, 0, 16)
        pxf = px + u1
        pyf = py + u2
        ul1, ul2 = sample_2d("zerotwosequence", seed, pids, sidx + 1, 1, 16)
        return generate_rays(cam, pxf, pyf, ul1, ul2)

    results["regen"] = _med_time(ph_regen, args.reps)

    total = sum(results.values())
    trav = results["traverse"] + results["shadow"]
    out = {
        "tool": "wave_phases",
        "lanes": R,
        "tris": int(static.n_tris),
        "backend": jax.default_backend(),
        "ms": {k: round(v * 1e3, 3) for k, v in results.items()},
        "frac": {k: round(v / total, 4) for k, v in results.items()},
        "traversal_frac": round(trav / total, 4),
        "note": "standalone-phase times; fractions are the signal (XLA fuses inside the real wave)",
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
