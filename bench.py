"""Benchmark harness: prints ONE JSON line of path-vertex throughput.

Metric: path-vertex samples per second on the production persistent
wavefront (render.make_persistent_fn), dispatched in render_compiled's
chunk shapes. Two configs, both 1000x500, path depth 5, 16 spp, run one
after the other in this process:

- "spheres": pbrt-v3's spheres-differentials-texfilt scene rebuilt in the
  repo (mirror and glass spheres over a ground quad textured with
  assets/lines.png, distant light), brute-force small-scene intersection.
- "mesh": a 123,650-triangle displaced-terrain room lit by an emissive
  ceiling panel, BVH traversal.

Usage: python bench.py   (needs a GPU; exits non-zero without one)
"""
from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
LINES_PNG = os.path.join(REPO, "assets", "lines.png")


def _measure(cs, W, H, icfg_depth=5, n_spp=16, reps=2):
    """Path-vertex throughput of the production render path, dispatched in
    render_compiled's chunk shapes (rays_cap-lane chunks x spp chunks)."""
    import jax
    import jax.numpy as jnp

    from pbrt_tpu import render as R_

    desc = cs.description
    desc.integrator.kind = "path"
    desc.integrator.max_depth = icfg_depth
    desc.sampler.kind = "zerotwosequence"
    desc.sampler.pixel_samples = n_spp
    sa = cs.arrays

    R = W * H
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel().astype(np.int32))
    py = jnp.asarray(ys.ravel().astype(np.int32))
    pids = jnp.asarray((ys * W + xs).ravel().astype(np.uint32))

    wave_p = R_.make_persistent_fn(cs)
    tier = R_.LAST_PERSISTENT_TIER
    rays_cap, spp_chunk = R_.persistent_dispatch_shape(R, textured=R_._has_imagemaps(cs.static))
    n_chunks = max(1, int(math.ceil(R / rays_cap)))
    chunk = int(math.ceil(R / n_chunks))
    spp_k = R_.persistent_spp_k(tier, chunk, spp_chunk)

    def full_pass(seed_base):
        verts = 0.0
        s = 0
        while s < n_spp:
            n_s = min(spp_chunk, n_spp - s)
            for c in range(n_chunks):
                sl = slice(c * chunk, min((c + 1) * chunk, R))
                Lw, w, nv = wave_p(sa, px[sl], py[sl], pids[sl],
                                   jnp.uint32(seed_base + s), n_s, jnp.uint32(0),
                                   min(spp_k, n_s))
                verts += float(jnp.sum(nv))
            s += n_s
        jax.block_until_ready(Lw)
        return verts

    t0 = time.time()
    full_pass(0)  # compile + warm
    compile_s = time.time() - t0
    best = 0.0
    for rep in range(reps):
        t0 = time.time()
        verts = full_pass(100 + rep * n_spp)
        best = max(best, verts / (time.time() - t0))
    return best, compile_s, tier


SPHERES_PBRT = """LookAt 2 2 5  0 -.4 0  0 1 0
Camera "perspective" "float fov" [30]
Film "image" "integer xresolution" [{W}] "integer yresolution" [{H}]
    "string filename" "spheres.exr"
Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [5]
WorldBegin
LightSource "distant" "point from" [0 10 0] "point to" [0 0 0]
    "rgb L" [3.141593 3.141593 3.141593]
AttributeBegin
  Texture "lines" "spectrum" "imagemap" "string filename" "{lines}"
      "float uscale" [8] "float vscale" [8]
  Material "matte" "texture Kd" "lines"
  Shape "trianglemesh" "point P" [-20 -1 -20  20 -1 -20  20 -1 20  -20 -1 20]
      "float uv" [0 0 1 0 1 1 0 1] "integer indices" [0 2 1 0 3 2]
AttributeEnd
AttributeBegin
  Translate -1.3 0 0
  Material "mirror"
  Shape "sphere"
AttributeEnd
AttributeBegin
  Translate 1.3 0 0
  Material "glass"
  Shape "sphere"
AttributeEnd
WorldEnd
"""


def spheres_pbrt_text(W=1000, H=500, spp=16) -> str:
    """The spheres scene as .pbrt text (ground texture: assets/lines.png)."""
    return SPHERES_PBRT.format(W=W, H=H, spp=spp, lines=LINES_PNG)


def _spheres_scene():
    from pbrt_tpu.parser.api import pbrt_parse

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "spheres.pbrt")
        with open(path, "w") as fh:
            fh.write(spheres_pbrt_text())
        desc = pbrt_parse(path)
    desc.integrator.kind = "path"
    desc.integrator.max_depth = 5
    desc.sampler.kind = "zerotwosequence"
    return desc


def _grid_mesh(f, u0, u1, v0, v1, n):
    """Tessellated parametric patch: f(u, v) -> (x, y, z) grids."""
    us = np.linspace(u0, u1, n + 1)
    vs = np.linspace(v0, v1, n + 1)
    gu, gv = np.meshgrid(us, vs)
    verts = np.stack(f(gu, gv), axis=-1).reshape(-1, 3)
    idx = []
    for i in range(n):
        row = i * (n + 1)
        for j in range(n):
            a = row + j
            b = a + 1
            c = a + n + 1
            dd = c + 1
            idx.append([a, c, b])
            idx.append([b, c, dd])
    return verts.astype(np.float64), np.asarray(idx, np.int32)


def _mesh_scene(n_side=248):
    """Enclosed displaced-terrain room: 2*n_side^2 floor triangles (123k at
    248) + tessellated walls/ceiling + an emissive ceiling panel (area
    light). Enclosure means EVERY camera and bounce ray traverses the BVH
    to a surface (no free sky misses), so the reported verts/s measures
    mesh traversal + shading throughput, not empty-lane idling."""
    from pbrt_tpu.core.transform import Transform
    from pbrt_tpu.scene.host import (
        CameraConfig, FilmConfig, HostLight, HostMaterial, HostPrimitive,
        IntegratorConfig, SamplerConfig, SceneDescription, ShapeRecord, TriangleMesh,
    )

    def prim(verts, idx, kd, emit=None):
        mesh = TriangleMesh(p=verts, indices=idx)
        light = None
        if emit is not None:
            # two-sided: the panel's winding faces the ceiling; two-sided
            # emission lights the whole room so every bounce does real NEE
            light = HostLight(kind="area", intensity=np.asarray(emit, np.float64),
                              two_sided=True)
        return HostPrimitive(
            shape=ShapeRecord(mesh=mesh),
            material=HostMaterial(kind="matte", params={"Kd": ("const", np.asarray(kd))}),
            area_light=light,
        )

    terrain = prim(*_grid_mesh(
        lambda x, z: (x, 0.9 * np.sin(1.7 * x) * np.cos(1.3 * z) + 0.25 * np.sin(6.1 * x + 2.0 * z), z),
        -4, 4, -4, 4, n_side), [0.55, 0.45, 0.35])
    y0, y1 = -1.3, 4.0
    walls = [
        prim(*_grid_mesh(lambda u, v: (u, v, np.full_like(u, -4.0)), -4, 4, y0, y1, 8), [0.6, 0.6, 0.6]),
        prim(*_grid_mesh(lambda u, v: (u, v, np.full_like(u, 4.0)), -4, 4, y0, y1, 8), [0.6, 0.6, 0.6]),
        prim(*_grid_mesh(lambda u, v: (np.full_like(u, -4.0), v, u), -4, 4, y0, y1, 8), [0.55, 0.3, 0.3]),
        prim(*_grid_mesh(lambda u, v: (np.full_like(u, 4.0), v, u), -4, 4, y0, y1, 8), [0.3, 0.55, 0.3]),
        prim(*_grid_mesh(lambda u, v: (u, np.full_like(u, y1), v), -4, 4, -4, 4, 8), [0.7, 0.7, 0.7]),
    ]
    panel = prim(*_grid_mesh(lambda u, v: (u, np.full_like(u, y1 - 0.01), v), -1.4, 1.4, -1.4, 1.4, 1),
                 [0.0, 0.0, 0.0], emit=[14.0, 13.5, 12.5])
    return SceneDescription(
        primitives=[terrain] + walls + [panel],
        lights=[],
        camera=CameraConfig(kind="perspective",
                            camera_to_world=Transform.look_at([0, 2.3, 3.3], [0, 0.2, -1.0], [0, 1, 0]),
                            fov=70.0),
        film=FilmConfig(x_resolution=1000, y_resolution=500),
        sampler=SamplerConfig(kind="zerotwosequence", pixel_samples=16),
        integrator=IntegratorConfig(kind="path", max_depth=5, light_strategy="power"),
    )


def main():
    import jax

    from pbrt_tpu.scene.builder import compile_scene

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {jax.devices()[0].platform}")
    dev = jax.devices()[0]
    rec = {"metric": "path_vertex_samples_per_sec", "unit": "vertices/s",
           "device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}
    for name, desc in (("spheres", _spheres_scene()), ("mesh", _mesh_scene())):
        cs = compile_scene(desc)
        vps, compile_s, tier = _measure(cs, 1000, 500)
        rec[name] = {"vps": vps, "tris": int(cs.static.n_tris),
                     "compile_s": compile_s, "tier": tier}
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
