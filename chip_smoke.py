"""Smoke test of the renderer on NVIDIA GPUs: the quickest proof that the
system starts and renders correctly on the card.

One process holds the card for the whole run. Phases, each printing one
line of numbers beside the card's name and power limit:

  1 environment      JAX version, devices, card, compile-cache directory
  2 traversal        the per-ray BVH kernel vs the XLA traversal on the mesh
                     scene's camera wave (500,000 rays) and one bounce wave
  3 main path        render() of the 123,650-triangle mesh scene at
                     1000x500, 16 spp, path depth 5
  4 parity           the same scene at 100x50, 4 spp, on the card and on
                     the CPU in this process
  5 CLI              pbrt_tpu.main on a written .pbrt scene, EXR read back
  6 integrators      volpath, directlighting, whitted, ao, sppm, bdpt, mlt
  7 four cards       (--cards 4 only, and then the only phase) sharded path
                     and SPPM renders vs the same render on one card

Any failed check raises, and the script exits non-zero. The last line of
standard output is {"ok": true, "device": {...}}.

Usage: python chip_smoke.py [--cards 4]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

MESH_N_SIDE = 248  # 2 * 248^2 terrain triangles + walls = 123,650
INTEGRATORS = ("volpath", "directlighting", "whitted", "ao", "sppm", "bdpt", "mlt")


def card_info() -> str:
    """name and power limit of every visible card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


T0 = time.time()


def emit(phase: str, card: str, **numbers) -> dict:
    rec = {"phase": phase, **numbers, "elapsed_s": time.time() - T0, "card": card}
    print(json.dumps(rec), flush=True)
    return rec


def _wall_ms(fn, *args, reps=3):
    """Best wall time of fn(*args) to block_until_ready, after a warm-up."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best * 1e3


def _film_pixels(W, H):
    import jax.numpy as jnp

    ys, xs = np.mgrid[0:H, 0:W]
    return jnp.asarray(xs.ravel() + 0.5, jnp.float32), jnp.asarray(ys.ravel() + 0.5, jnp.float32)


def traversal_waves(cs, W, H, seed=0):
    """Camera wave at W x H pixel centres, and one bounce wave made from
    cosine-sampled directions at the first hits (misses are dead lanes)."""
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.device.bsdf import cosine_sample_hemisphere
    from pbrt_tpu.device.camera import generate_rays, make_camera
    from pbrt_tpu.device.integrator import _dot, _offset_ray, _to_world
    from pbrt_tpu.device.intersect import _traverse
    from pbrt_tpu.device.shading import surface_interaction

    sa, static = cs.arrays, cs.static
    cam = make_camera(cs.description.camera, cs.description.film)
    px, py = _film_pixels(W, H)
    px = px * (cs.description.film.x_resolution / W)
    py = py * (cs.description.film.y_resolution / H)

    @jax.jit
    def build():
        zero = jnp.zeros_like(px)
        o0, d0 = generate_rays(cam, px, py, zero, zero, None)
        tm = jnp.full(px.shape, jnp.inf, jnp.float32)
        hit, _ = _traverse(sa, static, o0, d0, tm, any_hit=False)
        si = surface_interaction(sa, hit, o0, d0)
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        u1 = jax.random.uniform(k1, px.shape)
        u2 = jax.random.uniform(k2, px.shape)
        wi_l = cosine_sample_hemisphere(u1, u2)
        flip = (_dot(si["wo"], si["ns"]) < 0)[:, None]
        wi = _to_world(si, jnp.where(flip, wi_l * jnp.array([1.0, 1.0, -1.0], jnp.float32), wi_l))
        o1 = _offset_ray(si["p"], si["ng"], wi, si.get("p_err"))
        tm1 = jnp.where(hit["prim"] >= 0, jnp.inf, -1.0).astype(jnp.float32)
        # shadow-style limits for the any-hit query: about half are occluded
        ts = jnp.where(hit["prim"] >= 0,
                       jax.random.uniform(jax.random.PRNGKey(seed + 1), px.shape, minval=0.05, maxval=3.0),
                       -1.0).astype(jnp.float32)
        return o0, d0, tm, o1, wi, tm1, ts

    return jax.block_until_ready(build())


def _closest_agreement(ref, got):
    prim_r, prim_g = np.asarray(ref["prim"]), np.asarray(got["prim"])
    agree = prim_r == prim_g
    both = agree & (prim_r >= 0)
    t_r, t_g = np.asarray(ref["t"])[both], np.asarray(got["t"])[both]
    rel = np.abs(t_g - t_r) / np.maximum(np.abs(t_r), 1e-30)
    return float(agree.mean()), float(rel.max()) if rel.size else 0.0, float((prim_r >= 0).mean())


def phase_traversal(cs, card, W=1000, H=500):
    """The per-ray kernel (bvh_kernel.closest / occluded, the render's own
    entry points) against intersect._traverse / _sorted_traverse, both on
    the default device: prim ids agree on >= 99.99% of rays, t within 1e-4
    relative where they agree, any-hit on >= 99.99%."""
    import jax

    from pbrt_tpu.device import bvh_kernel
    from pbrt_tpu.device.intersect import _kernel_traverse, _sorted_traverse, _traverse

    sa, static = cs.arrays, cs.static
    assert bvh_kernel.eligible(static), "the mesh scene must take the kernel route"
    o0, d0, tm, o1, d1, tm1, ts = traversal_waves(cs, W, H)
    on_gpu = jax.default_backend() == "gpu"

    cases = {
        # camera wave: coherent, unsorted (as the render's first bounce)
        "camera_closest": (
            jax.jit(lambda o, d, t: _kernel_traverse(sa, static, o, d, t, False, False)),
            jax.jit(lambda o, d, t: _traverse(sa, static, o, d, t, any_hit=False)[0]),
            (o0, d0, tm)),
        # bounce wave: incoherent, sorted (as the render's later bounces)
        "bounce_closest": (
            jax.jit(lambda o, d, t: _kernel_traverse(sa, static, o, d, t, False, True)),
            jax.jit(lambda o, d, t: _sorted_traverse(sa, static, o, d, t, False, None)[0]),
            (o1, d1, tm1)),
        "bounce_any": (
            jax.jit(lambda o, d, t: _kernel_traverse(sa, static, o, d, t, True, True)),
            jax.jit(lambda o, d, t: _sorted_traverse(sa, static, o, d, t, True, None)[1]),
            (o1, d1, ts)),
    }
    out = {}
    for name, (kern, ref, args) in cases.items():
        if on_gpu:
            hlo = kern.lower(*args).as_text()
            target = bvh_kernel.ANY_TARGET if name.endswith("any") else bvh_kernel.CLOSEST_TARGET
            assert target in hlo, f"{name}: the kernel is not in the compiled program"
        got, k_ms = _wall_ms(kern, *args)
        want, x_ms = _wall_ms(ref, *args)
        if name.endswith("any"):
            agree = float((np.asarray(got) == np.asarray(want)).mean())
            rec = {"any_agree": agree, "occluded": float(np.asarray(want).mean())}
            assert agree >= 0.9999, (name, agree)
        else:
            agree, t_rel, hit_frac = _closest_agreement(want, got)
            rec = {"prim_agree": agree, "t_max_rel_err": t_rel, "hit_frac": hit_frac}
            assert agree >= 0.9999, (name, agree)
            assert t_rel <= 1e-4, (name, t_rel)
        out[name] = emit(f"2-traversal/{name}", card, rays=int(args[0].shape[0]),
                         kernel_ms=k_ms, xla_ms=x_ms, **rec)
    return out


def phase_main_path(card, n_side=MESH_N_SIDE, W=1000, H=500, spp=16, expect_tier=None):
    """The mesh scene through render_compiled(compile_scene(desc)), which is
    what render(desc) does, twice: the first call compiles, the second
    reuses the compiled wave and gives the steady rate. Each image is finite
    with a non-zero mean."""
    from bench import _mesh_scene
    from pbrt_tpu import render as R
    from pbrt_tpu.scene.builder import compile_scene

    desc = _mesh_scene(n_side=n_side)
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.sampler.pixel_samples = spp
    desc.integrator.max_depth = 5
    t0 = time.time()
    cs = compile_scene(desc)
    build_s = time.time() - t0
    runs = []
    for seed in (0, 1):
        img = R.render_compiled(cs, seed=seed)
        assert img.shape == (H, W, 3)
        assert np.isfinite(img).all(), "non-finite pixels"
        assert float(img.mean()) > 0.0, "black image"
        runs.append(dict(R.render_compiled.last_timing, mean=float(img.mean())))
    first, warm = runs
    if expect_tier is not None:
        assert first["tier"] == expect_tier, first["tier"]
    return emit("3-main-path", card, tier=first["tier"], res=[W, H], spp=spp, depth=5,
                scene_build_s=build_s, first_wall_s=first["wall_s"],
                first_dispatch_s=first["compile_s"], warm_wall_s=warm["wall_s"],
                n_vertices=warm["n_vertices"],
                mverts_per_s=warm["n_vertices"] / warm["wall_s"] / 1e6, mean=first["mean"])


def blurred_mse(a, b, k=5):
    """MSE after a k x k box blur, relative to the mean square of `b`."""
    def blur(x):
        pad = k // 2
        xp = np.pad(x, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        out = np.zeros_like(x)
        for dy in range(k):
            for dx in range(k):
                out += xp[dy:dy + x.shape[0], dx:dx + x.shape[1]]
        return out / (k * k)

    ba, bb = blur(np.asarray(a, np.float64)), blur(np.asarray(b, np.float64))
    return float(np.mean((ba - bb) ** 2) / max(np.mean(bb ** 2), 1e-30))


def phase_parity(card, dev, ref_dev, n_side=MESH_N_SIDE, W=100, H=50, spp=4):
    """The mesh scene on `dev` and on `ref_dev` with the same seed.

    Both renders draw the same (pixel, sample, dimension) streams; they
    differ only by float operation order and transcendental implementations,
    which flip a few path decisions (Russian roulette, shadow-ray grazes).
    Band: means within 1%, and a blurred MSE under a quarter of the blurred
    MSE between two seeds on `ref_dev` (the Monte Carlo noise of one render),
    so a wrong estimator on either device cannot pass while rare flips can.
    """
    import jax

    from bench import _mesh_scene
    from pbrt_tpu.render import render_compiled
    from pbrt_tpu.scene.builder import compile_scene

    def scene(device):
        desc = _mesh_scene(n_side=n_side)
        desc.film.x_resolution, desc.film.y_resolution = W, H
        desc.sampler.pixel_samples = spp
        with jax.default_device(device):
            cs = compile_scene(desc)
        assert cs.arrays.prim_test_data.devices() == {device}
        return cs

    def run(device, cs, seed):
        with jax.default_device(device):
            return render_compiled(cs, seed=seed)

    img = run(dev, scene(dev), 0)
    ref_cs = scene(ref_dev)
    ref = run(ref_dev, ref_cs, 0)
    ref_other_seed = run(ref_dev, ref_cs, 1)
    for im in (img, ref):
        assert np.isfinite(im).all() and float(im.mean()) > 0.0
    ratio = float(img.mean() / ref.mean())
    mse = blurred_mse(img, ref)
    noise = blurred_mse(ref_other_seed, ref)
    assert abs(ratio - 1.0) < 0.01, ratio
    assert mse < 0.25 * noise, (mse, noise)
    return emit("4-parity", card, device=str(dev), ref_device=str(ref_dev), res=[W, H], spp=spp,
                mean_ratio=ratio, blurred_rel_mse=mse, seed_noise_blurred_rel_mse=noise)


def phase_cli(card, W=64, H=32, spp=4):
    """python -m pbrt_tpu.main, in process, on a textured spheres-and-mesh
    .pbrt written here; the EXR it writes is read back."""
    from bench import spheres_pbrt_text
    from pbrt_tpu.core.imageio import read_image
    from pbrt_tpu.main import main as cli_main

    with tempfile.TemporaryDirectory() as d:
        scene = os.path.join(d, "spheres.pbrt")
        with open(scene, "w") as fh:
            fh.write(spheres_pbrt_text(W=W, H=H, spp=spp))
        exr = os.path.join(d, "out.exr")
        t0 = time.time()
        rc = cli_main([scene, "--outfile", exr, "--quiet"])
        dt = time.time() - t0
        assert rc == 0, rc
        img = read_image(exr)
    assert img.shape == (H, W, 3), img.shape
    assert np.isfinite(img).all() and float(img.mean()) > 0.0
    return emit("5-cli", card, res=[W, H], spp=spp, wall_s=dt, mean=float(img.mean()))


def integrator_scene(kind, W=64, H=32):
    """Spheres over a ground quad, distant light; volpath adds fog."""
    from __graft_entry__ import _tiny_scene
    from pbrt_tpu.scene.host import HostMedium

    desc = _tiny_scene(res=(W, H), spp=2, integrator=kind, max_depth=2)
    if kind == "volpath":
        desc.media["fog"] = HostMedium(kind="homogeneous", sigma_a=np.array([0.1, 0.1, 0.1]),
                                       sigma_s=np.array([0.5, 0.5, 0.5]), g=0.2)
        desc.primitives[2].inside_medium = "fog"
    if kind == "sppm":
        desc.integrator.num_iterations = 2
        desc.integrator.photons_per_iteration = 4096
        desc.integrator.initial_radius = 0.25
    if kind == "mlt":
        # every path depth compiles its own bootstrap and chain programs
        desc.integrator.max_depth = 1
        desc.integrator.mutations_per_pixel = 4
        desc.integrator.n_bootstrap = 256
        desc.integrator.n_chains = 64
    return desc


# integrators with their own drivers (no shared wave cache in render.py);
# each compiles for minutes, so they render in worker threads while the
# others render in the calling thread
THREADED = ("sppm", "bdpt", "mlt")


def phase_integrators(card, kinds=INTEGRATORS, W=64, H=32):
    from concurrent.futures import ThreadPoolExecutor

    from pbrt_tpu.render import render

    def one(kind):
        t0 = time.time()
        img = render(integrator_scene(kind, W, H), seed=0)
        dt = time.time() - t0
        assert img.shape == (H, W, 3), (kind, img.shape)
        assert np.isfinite(img).all(), f"{kind}: non-finite pixels"
        assert float(img.mean()) > 0.0, f"{kind}: black image"
        return emit(f"6-integrator/{kind}", card, res=[W, H], wall_s=dt, mean=float(img.mean()))

    threaded = [k for k in kinds if k in THREADED]
    with ThreadPoolExecutor(max_workers=max(len(threaded), 1)) as pool:
        futures = {k: pool.submit(one, k) for k in threaded}
        out = {k: one(k) for k in kinds if k not in threaded}
        out.update({k: f.result() for k, f in futures.items()})
    return out


def phase_sharded(card, devices, n_side=MESH_N_SIDE, W=1000, H=500, spp=16,
                  sppm_res=(128, 64), sppm_iters=2, sppm_photons=1 << 15):
    """render_compiled auto-shards over every device; the one-card reference
    is the same sharded step on a one-device mesh. The four renders compile
    in parallel threads. Path: same sample streams, so means within 1% and
    a blurred MSE under 1e-3 of the image's power. SPPM: photon seeds ride
    the device index, so only the estimator agrees: lit-pixel means within
    5%."""
    from concurrent.futures import ThreadPoolExecutor

    from jax.sharding import Mesh

    from __graft_entry__ import _tiny_scene
    from bench import _mesh_scene
    from pbrt_tpu.parallel.shard import render_sharded_step, render_sppm_sharded_step
    from pbrt_tpu.render import render_compiled
    from pbrt_tpu.scene.builder import compile_scene

    one = Mesh(np.array(devices[:1]), ("rays",))
    desc = _mesh_scene(n_side=n_side)
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.sampler.pixel_samples = spp
    cs = compile_scene(desc)
    sd = _tiny_scene(res=sppm_res, spp=1, integrator="sppm", max_depth=1)
    sd.integrator.initial_radius = 0.1
    sd.integrator.num_iterations = sppm_iters
    sd.integrator.photons_per_iteration = sppm_photons
    scs = compile_scene(sd)
    sW, sH = sppm_res

    jobs = {
        "path_n": lambda: render_compiled(cs, seed=0),
        "path_1": lambda: np.asarray(render_sharded_step(cs, desc, one, spp=spp, seed=0)).reshape(H, W, 3),
        "sppm_n": lambda: render_compiled(scs, seed=0),
        "sppm_1": lambda: np.asarray(render_sppm_sharded_step(
            scs, sd, one, n_iters=sppm_iters, n_photons=sppm_photons, seed=0)).reshape(sH, sW, 3),
    }

    def timed(fn):
        t0 = time.time()
        return fn(), time.time() - t0

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {k: pool.submit(timed, fn) for k, fn in jobs.items()}
        res = {k: f.result() for k, f in futures.items()}

    (img_n, t_n), (img_1, t_1) = res["path_n"], res["path_1"]
    assert np.isfinite(img_n).all() and float(img_n.mean()) > 0.0
    ratio = float(img_n.mean() / img_1.mean())
    mse = blurred_mse(img_n, img_1)
    assert abs(ratio - 1.0) < 0.01, ratio
    assert mse < 1e-3, mse
    emit("7-sharded/path", card, devices=len(devices), res=[W, H], spp=spp,
         wall_s_n_cards=t_n, wall_s_one_card=t_1, mean_ratio=ratio, blurred_rel_mse=mse)

    (s_n, ts_n), (s_1, ts_1) = res["sppm_n"], res["sppm_1"]
    lit = s_1.mean(-1) > 1e-3
    assert lit.sum() > 50
    s_ratio = float(s_n[lit].mean() / s_1[lit].mean())
    assert abs(s_ratio - 1.0) < 0.05, s_ratio
    return emit("7-sharded/sppm", card, devices=len(devices), res=list(sppm_res),
                iterations=sppm_iters, photons=sppm_photons, wall_s_n_cards=ts_n,
                wall_s_one_card=ts_1, lit_mean_ratio=s_ratio)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    import pbrt_tpu
    from pbrt_tpu.scene.builder import compile_scene

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs NVIDIA GPUs; JAX found {devs[0].platform}")
    if len(devs) != args.cards:
        sys.exit(f"expected {args.cards} card(s), JAX sees {len(devs)}")
    card = card_info()

    if args.cards == 4:
        phase_sharded(card, devs)
    else:
        emit("1-environment", card, jax=jax.__version__, python=sys.version.split()[0],
             devices=[str(d) for d in devs], device_kind=devs[0].device_kind,
             compile_cache=jax.config.jax_compilation_cache_dir,
             cache_from_env=bool(os.environ.get("JAX_COMPILATION_CACHE_DIR")),
             default_cache=str(pbrt_tpu.CACHE_DIR))
        from bench import _mesh_scene

        mesh = compile_scene(_mesh_scene(n_side=MESH_N_SIDE))
        assert mesh.static.n_tris == 123_650, mesh.static.n_tris
        phase_traversal(mesh, card)
        phase_main_path(card, expect_tier="xla-wavefront/cuda-bvh")
        phase_parity(card, devs[0], jax.devices("cpu")[0])
        phase_cli(card)
        phase_integrators(card)

    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": devs[0].platform,
                                             "kind": devs[0].device_kind,
                                             "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
