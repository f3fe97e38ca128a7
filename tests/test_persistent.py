"""Persistent-wavefront parity: trace_persistent must reproduce the
per-sample wave exactly (same (pixel, sample, dimension) streams, same
estimator math — only lane scheduling differs)."""
import numpy as np

import jax.numpy as jnp


def _scene():
    from __graft_entry__ import _tiny_scene

    return _tiny_scene(res=(48, 32), spp=4, max_depth=4)


def test_persistent_matches_per_sample_wave():
    from pbrt_tpu.render import (
        make_persistent_fn, make_wave_fn, persistent_eligible,
    )
    from pbrt_tpu.device.camera import make_camera
    from pbrt_tpu.scene.builder import compile_scene

    desc = _scene()
    cs = compile_scene(desc)
    cam = make_camera(desc.camera, desc.film)
    assert persistent_eligible(desc, cs.static, cam)

    W, H = desc.film.x_resolution, desc.film.y_resolution
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel().astype(np.int32))
    py = jnp.asarray(ys.ravel().astype(np.int32))
    pids = jnp.asarray((ys * W + xs).ravel().astype(np.uint32))
    spp = 4

    wave = make_wave_fn(cs)
    acc = np.zeros((W * H, 3))
    wsum = np.zeros(W * H)
    nv_ref = 0.0
    for s in range(spp):
        Lw, w, nv = wave(cs.arrays, px, py, pids, jnp.uint32(s), jnp.uint32(0))
        acc += np.asarray(Lw)
        wsum += np.asarray(w)
        nv_ref += float(np.asarray(jnp.sum(nv)))

    wave_p = make_persistent_fn(cs)
    Lp, wp, nvp = wave_p(cs.arrays, px, py, pids, jnp.uint32(0), spp, jnp.uint32(0))
    Lp = np.asarray(Lp)
    wp = np.asarray(wp)

    np.testing.assert_allclose(wp, wsum, atol=1e-5)
    assert abs(float(np.asarray(jnp.sum(nvp))) - nv_ref) < 1e-3
    np.testing.assert_allclose(Lp, acc, rtol=2e-4, atol=2e-4)


def test_persistent_spp_k_interleave_parity():
    """k-way spp interleaving (spp_k > 1: k samples per pixel in flight,
    stride-k regeneration) must reproduce the sequential persistent result —
    the (pixel, sample, dimension) streams are identical, only lane
    scheduling and fp summation order differ."""
    from pbrt_tpu import render as R_
    from pbrt_tpu.scene.builder import compile_scene

    desc = _scene()
    cs = compile_scene(desc)
    W, H = desc.film.x_resolution, desc.film.y_resolution
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel().astype(np.int32))
    py = jnp.asarray(ys.ravel().astype(np.int32))
    pids = jnp.asarray((ys * W + xs).ravel().astype(np.uint32))

    wave_p = R_.make_persistent_fn(cs)
    assert R_.LAST_PERSISTENT_TIER.startswith("xla-wavefront")
    Ls, ws, nvs = wave_p(cs.arrays, px, py, pids, jnp.uint32(0), 4, jnp.uint32(0))
    for k in (2, 3, 4, 8):  # incl. k > spp and k not dividing spp
        Lk, wk, nvk = wave_p(cs.arrays, px, py, pids, jnp.uint32(0), 4, jnp.uint32(0), k)
        np.testing.assert_allclose(np.asarray(wk), np.asarray(ws), atol=1e-5)
        assert abs(float(np.asarray(jnp.sum(nvk))) - float(np.asarray(jnp.sum(nvs)))) < 1e-3, k
        np.testing.assert_allclose(np.asarray(Lk), np.asarray(Ls), rtol=2e-4, atol=2e-4)


def test_persistent_chunked_resume_is_consistent():
    """Two persistent calls over [0,2) and [2,4) must equal one [0,4) call."""
    from pbrt_tpu.render import make_persistent_fn

    from pbrt_tpu.scene.builder import compile_scene

    desc = _scene()
    cs = compile_scene(desc)
    W, H = desc.film.x_resolution, desc.film.y_resolution
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel().astype(np.int32))
    py = jnp.asarray(ys.ravel().astype(np.int32))
    pids = jnp.asarray((ys * W + xs).ravel().astype(np.uint32))

    wave_p = make_persistent_fn(cs)
    La, wa, _ = wave_p(cs.arrays, px, py, pids, jnp.uint32(0), 4, jnp.uint32(0))
    L1, w1, _ = wave_p(cs.arrays, px, py, pids, jnp.uint32(0), 2, jnp.uint32(0))
    L2, w2, _ = wave_p(cs.arrays, px, py, pids, jnp.uint32(2), 2, jnp.uint32(0))
    np.testing.assert_allclose(np.asarray(L1) + np.asarray(L2), np.asarray(La), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(w1) + np.asarray(w2), np.asarray(wa), atol=1e-6)


def test_persistent_parity_power_strategy_multi_light():
    """Parity must hold across light-selection strategies and light mixes,
    not just the single-distant-light default config."""
    import numpy as np

    from pbrt_tpu.render import make_persistent_fn, make_wave_fn
    from pbrt_tpu.scene.builder import compile_scene
    from pbrt_tpu.scene.host import HostLight

    desc = _scene()
    desc.integrator.light_strategy = "power"
    desc.lights.append(HostLight(kind="point", from_point=np.array([2.0, 3.0, 1.0]),
                                 intensity=np.array([8.0, 4.0, 2.0])))
    desc.lights.append(HostLight(kind="spot", from_point=np.array([-2.0, 4.0, 2.0]),
                                 to_point=np.zeros(3), intensity=np.array([6.0, 6.0, 9.0]),
                                 cone_angle=35.0, cone_delta=8.0))
    cs = compile_scene(desc)
    W, H = desc.film.x_resolution, desc.film.y_resolution
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel().astype(np.int32))
    py = jnp.asarray(ys.ravel().astype(np.int32))
    pids = jnp.asarray((ys * W + xs).ravel().astype(np.uint32))
    spp = 2

    wave = make_wave_fn(cs)
    acc = np.zeros((W * H, 3))
    for s in range(spp):
        Lw, w, _ = wave(cs.arrays, px, py, pids, jnp.uint32(s), jnp.uint32(3))
        acc += np.asarray(Lw)
    wave_p = make_persistent_fn(cs)
    Lp, wp, _ = wave_p(cs.arrays, px, py, pids, jnp.uint32(0), spp, jnp.uint32(3))
    np.testing.assert_allclose(np.asarray(Lp), acc, rtol=2e-4, atol=2e-4)


def test_persistent_directlighting_matches_wave():
    """directlighting through the persistent wavefront must reproduce the
    per-sample wave's estimator (same dims, all-lights NEE, specular-only
    continuation) — the spheres fidelity scene's render path."""
    import numpy as np

    from pbrt_tpu.render import render

    desc = _scene()
    desc.integrator.kind = "directlighting"
    desc.integrator.max_depth = 3
    desc.sampler.pixel_samples = 4
    import os

    img_p = render(desc, spp=4)
    os.environ["PBRT_TPU_FORCE_WAVE"] = "1"
    try:
        img_w = render(desc, spp=4)
    finally:
        os.environ.pop("PBRT_TPU_FORCE_WAVE", None)
    np.testing.assert_allclose(img_p, img_w, rtol=2e-4, atol=2e-5)
