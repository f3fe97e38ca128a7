"""Per-ray BVH traversal kernel (device/bvh_kernel.py, cuda/bvh_traverse.cu).

The CUDA kernel has no interpret mode. Its traversal, `traverse_ray`, is
compiled here a second time by the host C++ compiler as a serial loop and
compared with the XLA reference (`intersect._traverse`): closest hit and
any hit, coherent and incoherent waves, padded ray counts, dead lanes and a
one-leaf tree. The wrapper's routing, build command and CPU lowering are
tested directly; the comparison on the card itself is the `gpu` test at the
end (and chip_smoke.py phase 2).
"""
import ctypes
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pbrt_tpu.device import bvh_kernel
from pbrt_tpu.device.intersect import _sorted_traverse, _traverse
from pbrt_tpu.scene.builder import compile_scene


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("bvh") / "libbvh_host.so"
    subprocess.run(bvh_kernel.host_compile_command(out), check=True)
    lib = ctypes.cdll.LoadLibrary(str(out))
    lib.pbrt_bvh_traverse_host.restype = None
    return lib


def host_traverse(lib, nodes, tris, o, d, t_max, any_hit):
    """Run the kernel's traverse_ray over every ray on the host."""
    def f32(a):
        return np.ascontiguousarray(np.asarray(a, np.float32))

    nodes, tris, o, d = f32(nodes), f32(tris), f32(o), f32(d)
    R = o.shape[0]
    tm = f32(np.broadcast_to(np.asarray(t_max, np.float32), (R,)))
    t = np.zeros(R, np.float32)
    prim = np.zeros(R, np.int32)
    b1 = np.zeros(R, np.float32)
    b2 = np.zeros(R, np.float32)
    hit = np.zeros(R, np.uint8)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.pbrt_bvh_traverse_host(ptr(o), ptr(d), ptr(tm), ptr(nodes), ptr(tris),
                               ctypes.c_int(tris.shape[1]), ctypes.c_int64(R),
                               ctypes.c_int(int(any_hit)), ptr(t), ptr(prim),
                               ptr(b1), ptr(b2), ptr(hit))
    return {"t": t, "prim": prim, "b1": b1, "b2": b2}, hit.astype(bool)


@pytest.fixture(scope="module")
def mesh():
    from bench import _mesh_scene

    desc = _mesh_scene(n_side=24)  # 1,152 terrain triangles + walls
    return compile_scene(desc)


def _camera_rays(cs, W=40, H=20):
    from pbrt_tpu.device.camera import generate_rays, make_camera

    cam = make_camera(cs.description.camera, cs.description.film)
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray((xs.ravel() + 0.5) * cs.description.film.x_resolution / W, jnp.float32)
    py = jnp.asarray((ys.ravel() + 0.5) * cs.description.film.y_resolution / H, jnp.float32)
    z = jnp.zeros_like(px)
    o, d = generate_rays(cam, px, py, z, z, None)
    return np.asarray(o), np.asarray(d)


def _random_rays(R, seed):
    rs = np.random.RandomState(seed)
    o = rs.uniform([-3.5, -0.5, -3.5], [3.5, 3.5, 3.5], (R, 3)).astype(np.float32)
    d = rs.randn(R, 3).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _assert_closest_agree(ref, got, min_agree=0.999):
    prim_r, prim_g = np.asarray(ref["prim"]), np.asarray(got["prim"])
    agree = prim_r == prim_g
    assert agree.mean() >= min_agree, agree.mean()
    hit = agree & (prim_r >= 0)
    assert hit.any()
    t_r, t_g = np.asarray(ref["t"])[hit], np.asarray(got["t"])[hit]
    np.testing.assert_allclose(t_g, t_r, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got["b1"])[hit], np.asarray(ref["b1"])[hit], atol=1e-3)
    np.testing.assert_allclose(np.asarray(got["b2"])[hit], np.asarray(ref["b2"])[hit], atol=1e-3)
    miss = prim_g < 0
    assert np.isinf(np.asarray(got["t"])[miss]).all()


@pytest.mark.parametrize("wave", ["camera", "bounce"])
def test_closest_matches_xla(host_lib, mesh, wave):
    sa, static = mesh.arrays, mesh.static
    if wave == "camera":
        o, d = _camera_rays(mesh)
    else:
        o, d = _random_rays(900, 1)
    tm = np.full(o.shape[0], np.inf, np.float32)
    ref, ref_any = _traverse(sa, static, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), any_hit=False)
    got, got_any = host_traverse(host_lib, sa.bvh_packed, sa.prim_test_data, o, d, tm, False)
    _assert_closest_agree(ref, got)
    assert (np.asarray(ref_any) == got_any).mean() >= 0.999
    assert got_any.mean() > 0.9  # the room is closed: nearly every ray hits


def test_closest_matches_sorted_xla(host_lib, mesh):
    sa, static = mesh.arrays, mesh.static
    o, d = _random_rays(700, 2)
    tm = np.full(700, np.inf, np.float32)
    ref, _ = _sorted_traverse(sa, static, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), False, None)
    got, _ = host_traverse(host_lib, sa.bvh_packed, sa.prim_test_data, o, d, tm, False)
    _assert_closest_agree(ref, got)


@pytest.mark.parametrize("sorted_ref", [False, True])
def test_any_hit_matches_xla(host_lib, mesh, sorted_ref):
    sa, static = mesh.arrays, mesh.static
    o, d = _random_rays(800, 3)
    # shadow rays of random length: about half are occluded
    tm = np.random.RandomState(4).uniform(0.05, 3.0, 800).astype(np.float32)
    args = (sa, static, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    if sorted_ref:
        _, ref = _sorted_traverse(*args, True, None)
    else:
        _, ref = _traverse(*args, any_hit=True)
    _, got = host_traverse(host_lib, sa.bvh_packed, sa.prim_test_data, o, d, tm, True)
    ref = np.asarray(ref)
    assert 0.1 < ref.mean() < 0.9
    assert (ref == got).mean() >= 0.999


@pytest.mark.parametrize("R", [1, 3, 255, 257, 1000])
def test_padded_ray_counts(host_lib, mesh, R):
    """The XLA path pads to whole packets; per-ray results must not care."""
    sa, static = mesh.arrays, mesh.static
    o, d = _random_rays(R, 10 + R)
    tm = np.full(R, np.inf, np.float32)
    ref, _ = _traverse(sa, static, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), any_hit=False)
    got, _ = host_traverse(host_lib, sa.bvh_packed, sa.prim_test_data, o, d, tm, False)
    assert (np.asarray(ref["prim"]) == got["prim"]).mean() >= (R - 1) / R


def test_dead_lanes_never_hit(host_lib, mesh):
    sa, static = mesh.arrays, mesh.static
    o, d = _random_rays(300, 6)
    tm = np.where(np.arange(300) % 2 == 0, -1.0, np.inf).astype(np.float32)
    tm[1::4] = 0.0
    for any_hit in (False, True):
        got, hit = host_traverse(host_lib, sa.bvh_packed, sa.prim_test_data, o, d, tm, any_hit)
        dead = tm <= 0
        assert not hit[dead].any()
        assert (got["prim"][dead] == -1).all() and np.isinf(got["t"][dead]).all()
        assert hit[~dead].mean() > 0.9
    ref, _ = _traverse(sa, static, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), any_hit=False)
    assert (np.asarray(ref["prim"])[tm <= 0] == -1).all()


def test_one_leaf_tree(host_lib):
    """A tree that is a single leaf: the root's prims are tested directly;
    checked against the all-pairs watertight test."""
    from pbrt_tpu.device.intersect import ray_triangle

    rs = np.random.RandomState(7)
    c = rs.uniform(-1, 1, (6, 1, 3))
    tv = (c + 0.8 * rs.randn(6, 3, 3)).astype(np.float32)
    nodes = np.zeros((1, 12), np.float32)  # root = one leaf of all 6 prims
    nodes[0, 0:3], nodes[0, 3:6] = tv.min(axis=(0, 1)), tv.max(axis=(0, 1))
    nodes[0, 6], nodes[0, 7] = 0, 6
    tris = np.zeros((6, 20), np.float32)
    tris[:, 0:9] = tv.reshape(6, 9)
    o = np.tile(np.array([[0.0, 0.0, -5.0]], np.float32), (400, 1))
    tgt = rs.uniform(-1.2, 1.2, (400, 3)).astype(np.float32)
    d = tgt - o
    got, _ = host_traverse(host_lib, nodes, tris, o, d, np.inf, False)
    tvp = tris[:, 0:9].reshape(6, 3, 3)
    h, t, _, _, _ = ray_triangle(jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
                                 tvp[None, :, 0], tvp[None, :, 1], tvp[None, :, 2],
                                 jnp.full((400, 1), np.inf, jnp.float32))
    t = np.where(np.asarray(h), np.asarray(t), np.inf)
    ref_prim = np.where(np.isfinite(t.min(axis=1)), t.argmin(axis=1), -1)
    assert (ref_prim >= 0).mean() > 0.15
    assert (got["prim"] == ref_prim).mean() >= 0.995


def test_route_covers_static_triangle_bvh_scenes(mesh):
    from __graft_entry__ import _tiny_scene

    assert bvh_kernel.eligible(mesh.static)
    assert not bvh_kernel.eligible(compile_scene(_tiny_scene()).static)  # spheres, brute force
    desc = _mesh_scene_with(accelerator="kdtree")
    assert not bvh_kernel.eligible(compile_scene(desc).static)


def _mesh_scene_with(accelerator):
    from bench import _mesh_scene

    desc = _mesh_scene(n_side=8)
    desc.accelerator = accelerator
    return desc


def test_build_command_targets_hopper():
    out = bvh_kernel.BUILD_DIR / "x.so"
    cmd = bvh_kernel.nvcc_command(out)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[cmd.index("-I") + 1] == jax.ffi.include_dir()
    assert cmd[-1] == str(bvh_kernel.SRC) and str(out) in cmd
    lib = bvh_kernel.library_path()
    # built inside the checkout, keyed by the source it was built from
    assert lib.parent == bvh_kernel.BUILD_DIR
    assert bvh_kernel.BUILD_DIR.parts[-2:] == ("build", "cuda")
    assert bvh_kernel._source_tag() in lib.name


def test_cpu_lowering_is_the_xla_traversal(mesh):
    """Off CUDA, closest/occluded lower to the XLA traversal unchanged."""
    sa, static = mesh.arrays, mesh.static
    o, d = _random_rays(300, 8)
    tm = jnp.full(300, 2.0, jnp.float32)
    got = jax.jit(lambda o, d: bvh_kernel.closest(sa, static, o, d, tm))(o, d)
    ref, _ = _traverse(sa, static, jnp.asarray(o), jnp.asarray(d), tm, any_hit=False)
    for k in ("t", "prim", "b1", "b2"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
    occ = jax.jit(lambda o, d: bvh_kernel.occluded(sa, static, o, d, tm))(o, d)
    _, ref_any = _traverse(sa, static, jnp.asarray(o), jnp.asarray(d), tm, any_hit=True)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref_any))


def test_cpu_tier_label(mesh):
    from pbrt_tpu import render

    render.make_persistent_fn(mesh)
    assert render.LAST_PERSISTENT_TIER == "xla-wavefront/packet"


@pytest.mark.gpu
def test_kernel_on_card_matches_xla(gpu_only, mesh):
    """On the card: the FFI kernel against the XLA traversal, compiled for
    the same device (chip_smoke.py phase 2 runs this at full size)."""
    from pbrt_tpu.device.bvh_kernel import _cuda_any, _cuda_closest

    bvh_kernel.ensure_registered()
    sa, static = mesh.arrays, mesh.static
    o, d = _random_rays(4096, 9)
    tm = jnp.full(4096, jnp.inf, jnp.float32)
    got = jax.jit(lambda o, d: _cuda_closest(sa, o, d, tm))(o, d)
    ref, _ = jax.jit(lambda o, d: _traverse(sa, static, o, d, tm, any_hit=False))(o, d)
    _assert_closest_agree(ref, got, min_agree=0.9999)
    ts = jnp.full(4096, 1.5, jnp.float32)
    occ = jax.jit(lambda o, d: _cuda_any(sa, o, d, ts))(o, d)
    _, ref_any = jax.jit(lambda o, d: _traverse(sa, static, o, d, ts, any_hit=True))(o, d)
    assert (np.asarray(occ) == np.asarray(ref_any)).mean() >= 0.9999
