"""Scene builders and the persistent-vs-per-sample parity check shared by
tests/test_wave_parity_*.py.

The persistent wavefront (render.make_persistent_fn, the main render path)
regenerates lanes in place; the per-sample wave (render.make_wave_fn) traces
one sample index per call. Both draw the same (pixel, sample, dimension)
streams and run the same estimator math, so their films must agree to
float tolerance.
"""
import numpy as np

import jax.numpy as jnp

from pbrt_tpu.core.transform import Transform
from pbrt_tpu.render import make_persistent_fn, make_wave_fn
from pbrt_tpu.scene.builder import compile_scene
from pbrt_tpu.scene.host import (
    CameraConfig, FilmConfig, HostLight, HostMaterial, HostPrimitive, HostTexture,
    IntegratorConfig, SamplerConfig, SceneDescription, ShapeRecord, Sphere, TriangleMesh,
)


def grid(f, u0, u1, v0, v1, n):
    us = np.linspace(u0, u1, n + 1)
    vs = np.linspace(v0, v1, n + 1)
    gu, gv = np.meshgrid(us, vs)
    verts = np.stack(f(gu, gv), axis=-1).reshape(-1, 3)
    idx = []
    for i in range(n):
        row = i * (n + 1)
        for j in range(n):
            a = row + j
            idx.append([a, a + n + 1, a + 1])
            idx.append([a + 1, a + n + 1, a + n + 2])
    return verts.astype(np.float64), np.asarray(idx, np.int32)


def room_scene(sampler="zerotwosequence", with_mirror=True, light="area",
               strategy="power", micro=False, sigma=0.0):
    """Enclosed displaced-terrain mini-room (the bench mesh class): ~260
    triangles under the BVH, default UVs, matte walls + emissive panel."""
    def prim(verts, idx, kind="matte", kd=(0.6, 0.6, 0.6), emit=None):
        lightp = None
        if emit is not None:
            lightp = HostLight(kind="area", intensity=np.asarray(emit, np.float64),
                               two_sided=True)
        params = {}
        if kind in ("matte", "plastic"):
            params["Kd"] = ("const", np.asarray(kd))
        if kind == "matte" and sigma:
            params["sigma"] = ("const", sigma)  # Oren-Nayar
        if kind == "plastic":
            params["Ks"] = ("const", np.array([0.4, 0.4, 0.4]))
            params["roughness"] = ("const", 0.15)
        if kind == "metal":
            params["roughness"] = ("const", 0.08)  # default copper eta/k
        return HostPrimitive(shape=ShapeRecord(mesh=TriangleMesh(p=verts, indices=idx)),
                             material=HostMaterial(kind=kind, params=params), area_light=lightp)

    terrain = prim(*grid(lambda x, z: (x, 0.5 * np.sin(1.9 * x) * np.cos(1.3 * z), z),
                         -4, 4, -4, 4, 8), kd=(0.55, 0.45, 0.35),
                   kind="plastic" if micro else "matte")
    y0, y1 = -1.3, 4.0
    walls = [
        prim(*grid(lambda u, v: (u, v, np.full_like(u, -4.0)), -4, 4, y0, y1, 2)),
        prim(*grid(lambda u, v: (u, v, np.full_like(u, 4.0)), -4, 4, y0, y1, 2)),
        prim(*grid(lambda u, v: (np.full_like(u, -4.0), v, u), -4, 4, y0, y1, 2),
             kd=(0.55, 0.3, 0.3)),
        prim(*grid(lambda u, v: (np.full_like(u, 4.0), v, u), -4, 4, y0, y1, 2),
             kind="metal" if micro else ("mirror" if with_mirror else "matte"),
             kd=(0.3, 0.55, 0.3)),
        prim(*grid(lambda u, v: (u, np.full_like(u, y1), v), -4, 4, -4, 4, 2),
             kd=(0.7, 0.7, 0.7)),
    ]
    panel = prim(*grid(lambda u, v: (u, np.full_like(u, y1 - 0.01), v), -1.4, 1.4, -1.4, 1.4, 1),
                 kd=(0.0, 0.0, 0.0), emit=[12.0, 11.0, 10.0])
    lights = []
    if light in ("distant", "both"):
        lights = [HostLight(kind="distant", from_point=np.array([1.0, 10.0, 2.0]),
                            to_point=np.zeros(3), intensity=np.array([2.0, 2.0, 2.0]))]
    if light == "spot":
        # falloff band lands on the terrain so the smoothstep^4 cone is hit
        lights = [HostLight(kind="spot", from_point=np.array([0.0, 3.2, 2.8]),
                            to_point=np.array([0.0, -0.5, -1.0]),
                            intensity=np.array([40.0, 36.0, 33.0]),
                            cone_angle=30.0, cone_delta=18.0)]
    return SceneDescription(
        primitives=[terrain] + walls + [panel],
        lights=lights,
        camera=CameraConfig(kind="perspective",
                            camera_to_world=Transform.look_at([0, 2.3, 3.3], [0, 0.2, -1.0], [0, 1, 0]),
                            fov=70.0),
        film=FilmConfig(x_resolution=48, y_resolution=24),
        sampler=SamplerConfig(kind=sampler, pixel_samples=2),
        integrator=IntegratorConfig(kind="path", max_depth=4, light_strategy=strategy),
    )


def room_config(sampler, light, depth, strategy):
    """One of the room parity configurations (see test_wave_parity_room)."""
    desc = room_scene(sampler=sampler,
                      light="area" if light in ("dof", "gauss", "micro", "sigma") else light,
                      strategy=strategy, micro=light == "micro",
                      sigma=25.0 if light == "sigma" else 0.0)
    desc.integrator.max_depth = depth
    if light == "dof":
        desc.camera.lens_radius = 0.15
        desc.camera.focal_distance = 4.0
    if light == "gauss":
        desc.film.filter_name = "gaussian"
        desc.film.filter_params = {"xwidth": 1.5, "alpha": 2.0}
    return desc


def uv_sphere(center, radius, n_theta=12, n_phi=18):
    """UV-sphere triangle mesh with analytic per-vertex normals."""
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    gt, gp = np.meshgrid(th, ph, indexing="ij")
    norms = np.stack([np.sin(gt) * np.cos(gp), np.cos(gt), np.sin(gt) * np.sin(gp)],
                     axis=-1).reshape(-1, 3)
    verts = center + radius * norms
    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            if i > 0:
                idx.append([a, c, b])
            if i < n_theta - 1:
                idx.append([b, c, d])
    return verts.astype(np.float64), np.asarray(idx, np.int32), norms.astype(np.float64)


def room_variant(name):
    """Room scenes that add one feature each to the base room."""
    desc = room_scene(light="area", with_mirror=name != "sphere_light")
    if name == "mixed_spheres":
        desc.primitives.append(HostPrimitive(
            shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([-1.2, 1.0, 0.0]),
                                            radius=0.8)),
            material=HostMaterial(kind="mirror", params={"Kr": ("const", np.array([0.9, 0.9, 0.9]))})))
        desc.primitives.append(HostPrimitive(
            shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([1.4, 0.9, 0.5]),
                                            radius=0.6)),
            material=HostMaterial(kind="glass", params={})))
    elif name == "sphere_light":
        # emissive full sphere: visible-cone NEE, MIS pickup on direct hits
        desc.primitives.append(HostPrimitive(
            shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([0.8, 1.6, -0.5]),
                                            radius=0.5)),
            material=HostMaterial(kind="matte", params={"Kd": ("const", np.zeros(3))}),
            area_light=HostLight(kind="area", intensity=np.array([18.0, 15.0, 12.0]))))
    elif name == "shading_normals":
        sv, si, sn = uv_sphere(np.array([0.0, 0.9, -0.5]), 1.0)
        desc.primitives.append(HostPrimitive(
            shape=ShapeRecord(mesh=TriangleMesh(p=sv, indices=si, n=sn)),
            material=HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.5, 0.55, 0.7]))})))
    elif name == "checker_uv":
        checker = HostTexture(kind="checkerboard", is_float=False,
                              tex1=("const", np.array([0.725, 0.71, 0.68])),
                              tex2=("const", np.array([0.14, 0.12, 0.35])),
                              uscale=6.0, vscale=6.0, udelta=0.25)
        n = 8
        us = np.linspace(-4.0, 4.0, n + 1)
        gu, gvv = np.meshgrid(us, us)
        p = np.stack([gu, np.zeros_like(gu), gvv], axis=-1).reshape(-1, 3)
        uv = np.stack([(gu + 4.0) / 8.0, (gvv + 4.0) / 8.0], axis=-1).reshape(-1, 2)
        _, idx = grid(lambda u, v: (u, v, v), 0, 1, 0, 1, n)
        desc.primitives[0] = HostPrimitive(
            shape=ShapeRecord(mesh=TriangleMesh(p=p, indices=idx, uv=uv)),
            material=HostMaterial(kind="matte", params={"Kd": ("texture", checker)}))
    elif name == "constant_infinite":
        # OPEN scene under a constant sky: half the rays escape
        terrain = HostPrimitive(
            shape=ShapeRecord(mesh=TriangleMesh(*grid(
                lambda x, z: (x, 0.6 * np.sin(1.3 * x) * np.cos(1.1 * z), z), -6, 6, -6, 6, 10))),
            material=HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.55, 0.45, 0.35]))}))
        desc = SceneDescription(
            primitives=[terrain],
            lights=[HostLight(kind="infinite", intensity=np.array([0.7, 0.8, 1.0])),
                    HostLight(kind="distant", from_point=np.array([2.0, 8.0, 1.0]),
                              to_point=np.zeros(3), intensity=np.array([1.5, 1.4, 1.2]))],
            camera=CameraConfig(kind="perspective",
                                camera_to_world=Transform.look_at([0, 2.5, 6.5], [0, 0.5, 0], [0, 1, 0]),
                                fov=60.0),
            film=FilmConfig(x_resolution=48, y_resolution=24),
            sampler=SamplerConfig(kind="zerotwosequence", pixel_samples=2),
            integrator=IntegratorConfig(kind="path", max_depth=4, light_strategy="power"),
        )
    else:
        raise ValueError(name)
    return desc


def mini_spheres(sampler="zerotwosequence", light="distant", micro=False):
    """Tiny matte/mirror/glass + ground-quad scene (the spheres class, served
    by the brute-force intersection path). micro=True swaps in a plastic
    ground, a copper metal sphere and an Oren-Nayar matte sphere."""
    gparams = {"Kd": ("const", np.array([0.6, 0.5, 0.4]))}
    gkind = "matte"
    if micro:
        gkind = "plastic"
        gparams = {"Kd": ("const", np.array([0.6, 0.5, 0.4])),
                   "Ks": ("const", np.array([0.4, 0.4, 0.4])),
                   "roughness": ("const", 0.2)}
    ground = HostPrimitive(
        shape=ShapeRecord(mesh=TriangleMesh(
            p=np.array([[-20, -1, -20], [20, -1, -20], [20, -1, 20], [-20, -1, 20]], np.float64),
            indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
            uv=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64),
        )),
        material=HostMaterial(kind=gkind, params=gparams),
    )

    def sphere(tx, mat):
        return HostPrimitive(
            shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([tx, 0.0, 0.0]),
                                            radius=1.0)),
            material=mat)

    if micro:
        left = sphere(-1.3, HostMaterial(kind="metal", params={"roughness": ("const", 0.08)}))
        right = sphere(1.3, HostMaterial(kind="matte", params={
            "Kd": ("const", np.array([0.5, 0.55, 0.6])), "sigma": ("const", 20.0)}))
    else:
        left = sphere(-1.3, HostMaterial(kind="mirror", params={"Kr": ("const", np.array([0.9, 0.9, 0.9]))}))
        right = sphere(1.3, HostMaterial(kind="glass", params={}))
    if light == "distant":
        lights = [HostLight(kind="distant", from_point=np.array([0.0, 10.0, 0.0]),
                            to_point=np.zeros(3), intensity=np.array([3.0, 3.0, 3.0]))]
    elif light == "spot":
        lights = [HostLight(kind="spot", from_point=np.array([0.0, 5.0, 3.0]),
                            to_point=np.array([0.0, -1.0, 0.0]),
                            intensity=np.array([55.0, 50.0, 45.0]),
                            cone_angle=25.0, cone_delta=15.0)]
    else:
        lights = [HostLight(kind="point", from_point=np.array([0.0, 4.0, 2.0]),
                            intensity=np.array([30.0, 28.0, 26.0]))]
    return SceneDescription(
        primitives=[ground, left, right],
        lights=lights,
        camera=CameraConfig(kind="perspective",
                            camera_to_world=Transform.look_at([2, 2, 5], [0, -0.4, 0], [0, 1, 0]),
                            fov=30.0),
        film=FilmConfig(x_resolution=64, y_resolution=32),
        sampler=SamplerConfig(kind=sampler, pixel_samples=2),
        integrator=IntegratorConfig(kind="path", max_depth=5),
    )


def assert_persistent_matches_wave(desc, spp=2, seed=0, min_lit=0.3):
    """Film of the persistent wave == accumulated per-sample waves."""
    cs = compile_scene(desc)
    W, H = desc.film.x_resolution, desc.film.y_resolution
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel().astype(np.int32))
    py = jnp.asarray(ys.ravel().astype(np.int32))
    pids = jnp.asarray((ys * W + xs).ravel().astype(np.uint32))

    wave = make_wave_fn(cs)
    acc = np.zeros((W * H, 3))
    wsum = np.zeros(W * H)
    nv_ref = 0.0
    for s in range(spp):
        Lw, w, nv = wave(cs.arrays, px, py, pids, jnp.uint32(s), jnp.uint32(seed))
        acc += np.asarray(Lw)
        wsum += np.asarray(w)
        nv_ref += float(np.asarray(jnp.sum(nv)))

    wave_p = make_persistent_fn(cs)
    Lp, wp, nvp = wave_p(cs.arrays, px, py, pids, jnp.uint32(0), spp, jnp.uint32(seed))
    Lp = np.asarray(Lp)
    # the scene must produce real signal for the comparison to mean anything
    assert (acc.sum(-1) > 1e-4).mean() > min_lit
    np.testing.assert_allclose(np.asarray(wp), wsum, atol=1e-5)
    assert abs(float(np.asarray(jnp.sum(nvp))) - nv_ref) < 1e-3
    np.testing.assert_allclose(Lp, acc, rtol=2e-4, atol=2e-4)
    return cs
