"""Host-side scene description objects.

The API state machine (``pbrt_tpu.parser.api``) produces these; the scene
compiler (``pbrt_tpu.scene.builder``) flattens them into SoA device arrays.
This replaces the reference's trait-object scene graph
(/root/reference/src/core/primitive.rs, shape.rs, light.rs, material.rs) with
plain records: geometry is pre-transformed to world space at build time, just
as the reference pre-transforms triangle meshes (src/shapes/triangle.rs:21-48).
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

import numpy as np

from ..core.transform import Transform

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@dataclass
class TriangleMesh:
    """World-space triangle mesh (reference src/shapes/triangle.rs:21-48)."""

    p: np.ndarray  # (V, 3) world-space positions
    indices: np.ndarray  # (T, 3) int32
    n: np.ndarray | None = None  # (V, 3) shading normals (world space)
    s: np.ndarray | None = None  # (V, 3) shading tangents
    uv: np.ndarray | None = None  # (V, 2)
    alpha_texture: object | None = None  # float HostTexture: 0 => hit ignored
    shadow_alpha_texture: object | None = None  # same, for shadow rays
    reverse_orientation: bool = False
    transform_swaps_handedness: bool = False
    p_end: np.ndarray | None = None  # (V, 3) shutter-close positions (motion blur)
    p_mid: np.ndarray | None = None  # (V, 3) mid-shutter positions (slerp sample:
    # quadratic through (p, p_mid, p_end) follows the rotation arc; None = linear)
    anim: tuple | None = None  # (M0, M1) 4x4 shutter keyframe CTMs — the exact
    # per-ray TRS interpolation source (device/motion.py); p is world at M0


@dataclass
class Sphere:
    """Analytic quadric, kept parametric on device.

    kind selects the shape: "sphere" (src/shapes/sphere.rs), "cylinder"
    (cylinder.rs) or "disk" (disk.rs). height/inner_radius apply to disks
    only; z_min/z_max to spheres and cylinders."""

    object_to_world: Transform
    radius: float = 1.0
    z_min: float = -1.0
    z_max: float = 1.0
    phi_max: float = 2.0 * math.pi  # radians
    reverse_orientation: bool = False
    object_to_world_end: Transform | None = None  # motion blur keyframe
    object_to_world_mid: Transform | None = None  # mid-shutter slerp sample
    anim: tuple | None = None  # (M0, M1) 4x4 shutter keyframe CTMs (exact path)
    kind: str = "sphere"
    height: float = 0.0
    inner_radius: float = 0.0
    # hyperboloid endpoints (hyperboloid.rs): the segment p1->p2 revolved
    # around z
    p1: np.ndarray | None = None
    p2: np.ndarray | None = None


# Shape record: exactly one of mesh/sphere is set.
@dataclass
class ShapeRecord:
    mesh: TriangleMesh | None = None
    sphere: Sphere | None = None


# ---------------------------------------------------------------------------
# Textures (host graph; compiled into a flat table, creation order = topo order)
# ---------------------------------------------------------------------------


@dataclass
class HostTexture:
    """A texture node. `kind` selects the device eval path; children reference
    earlier textures by object (pbrt named textures can only reference
    previously defined ones, so creation order is a topological order)."""

    kind: str  # constant | scale | mix | checkerboard | imagemap | uv | bilerp | dots | fbm | wrinkled | marble | windy
    is_float: bool = False
    value: np.ndarray | None = None  # constant value (3,) rgb or scalar in [0]
    tex1: object = None  # child: HostTexture or ('const', value)
    tex2: object = None
    amount: object = None  # mix amount child
    v01: object = None  # bilerp corners
    v10: object = None
    # 2D mapping (uv | spherical | cylindrical | planar)
    mapping: str = "uv"
    uscale: float = 1.0
    vscale: float = 1.0
    udelta: float = 0.0
    vdelta: float = 0.0
    v1: np.ndarray | None = None  # planar mapping axes
    v2: np.ndarray | None = None
    world_to_texture: Transform | None = None  # 3D mapping / spherical center
    # imagemap
    image: np.ndarray | None = None  # (H, W, 3) float32, linear
    wrap: str = "repeat"
    scale: float = 1.0
    gamma: bool = False
    trilinear: bool = False
    max_aniso: float = 8.0
    # checkerboard
    dimension: int = 2
    aa_mode: str = "closedform"
    # noise-based
    octaves: int = 8
    roughness: float = 0.5
    variation: float = 0.2


def const_tex(value, is_float=False):
    return HostTexture(kind="constant", is_float=is_float, value=np.atleast_1d(np.asarray(value, dtype=np.float64)))


# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------


@dataclass
class HostMaterial:
    """Material = type name + parameter sources.

    Each entry of ``params`` maps a parameter name to either
    ('const', value) or ('texture', HostTexture) — the device-side material
    compiler turns these into the fixed-lobe aggregate BSDF
    (reference: each Material::compute_scattering_functions, src/materials/).
    """

    kind: str  # matte | mirror | glass | plastic | metal | uber | substrate | translucent | fourier | mix | hair | disney | subsurface | kdsubsurface | none
    params: dict = field(default_factory=dict)
    bump_map: object = None  # float texture or None


MATTE_DEFAULT = HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.5, 0.5, 0.5]))})


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------


@dataclass
class HostLight:
    """One light source (reference src/lights/*)."""

    kind: str  # point | spot | distant | goniometric | projection | infinite | area
    light_to_world: Transform = field(default_factory=Transform)
    intensity: np.ndarray | None = None  # I or L (rgb)
    scale: np.ndarray | None = None
    # point / spot
    from_point: np.ndarray | None = None
    to_point: np.ndarray | None = None
    cone_angle: float = 30.0
    cone_delta: float = 5.0
    # infinite
    map_name: str = ""
    image: np.ndarray | None = None  # lat-long env map (H, W, 3)
    n_samples: int = 1
    # area
    two_sided: bool = False
    prim_index: int = -1  # filled in by the builder (first primitive of shape)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


@dataclass
class HostPrimitive:
    """Geometric primitive: shape + material + optional area light
    (reference src/core/primitive.rs:105 GeometricPrimitive)."""

    shape: ShapeRecord
    material: HostMaterial
    area_light: HostLight | None = None
    inside_medium: str = ""
    outside_medium: str = ""
    # instance reuse (primitive.rs:41-103 TransformedPrimitive): when set,
    # the mesh vertices stay in INSTANCE space and are shared between all
    # instances of the prototype; rays are transformed at intersect time
    instance_transform: object = None  # Transform | None


# ---------------------------------------------------------------------------
# Config records (camera / film / sampler / integrator / accelerator)
# ---------------------------------------------------------------------------


@dataclass
class FilmConfig:
    x_resolution: int = 1280
    y_resolution: int = 720
    crop_window: tuple = (0.0, 1.0, 0.0, 1.0)
    filename: str = "pbrt.exr"
    scale: float = 1.0
    diagonal: float = 35.0
    max_sample_luminance: float = float("inf")
    filter_name: str = "box"
    filter_params: dict = field(default_factory=dict)  # xwidth/ywidth/alpha/B/C/tau


@dataclass
class CameraConfig:
    kind: str = "perspective"
    camera_to_world: Transform = field(default_factory=Transform)
    camera_to_world_end: Transform | None = None  # animated camera (motion blur)
    fov: float = 90.0
    lens_radius: float = 0.0
    focal_distance: float = 1e6
    shutter_open: float = 0.0
    shutter_close: float = 1.0
    screen_window: tuple | None = None  # (x0, x1, y0, y1)
    # realistic camera
    lens_file: str = ""
    aperture_diameter: float = 1.0
    focus_distance: float = 10.0
    simple_weighting: bool = True


@dataclass
class SamplerConfig:
    kind: str = "halton"
    pixel_samples: int = 16
    jitter: bool = True
    x_samples: int = 4
    y_samples: int = 4
    # "dimensions": the reference pre-allocates this many sample dims per
    # pixel (stratified.rs/random). STRUCTURALLY UNUSED here: the stateless
    # hash samplers generate any dimension on demand, so there is nothing
    # to size (api.py logs when a non-default value is given).
    sampled_dimensions: int = 4


@dataclass
class IntegratorConfig:
    kind: str = "path"
    max_depth: int = 5
    rr_threshold: float = 1.0
    light_strategy: str = "spatial"  # path/volpath lightsampling
    strategy: str = "all"  # directlighting: all|one
    pixel_bounds: tuple | None = None
    # AO
    cos_sample: bool = True
    n_samples: int = 64
    # SPPM
    num_iterations: int = 64
    photons_per_iteration: int = -1
    initial_radius: float = 1.0
    write_frequency: int = 1 << 31
    # BDPT / MLT
    visualize_strategies: bool = False
    visualize_weights: bool = False
    mutations_per_pixel: int = 100
    large_step_probability: float = 0.3
    sigma: float = 0.01
    n_bootstrap: int = 100000
    n_chains: int = 1000


@dataclass
class HostMedium:
    """Participating medium (reference src/media/{homogeneous,grid}.rs)."""

    kind: str = "homogeneous"  # homogeneous | heterogeneous
    sigma_a: np.ndarray | None = None  # (3,)
    sigma_s: np.ndarray | None = None  # (3,)
    g: float = 0.0
    scale: float = 1.0
    # heterogeneous (grid) media
    nx: int = 1
    ny: int = 1
    nz: int = 1
    density: np.ndarray | None = None  # (nz, ny, nx)
    medium_to_world: Transform = field(default_factory=Transform)
    p0: np.ndarray | None = None  # grid bounds in medium space
    p1: np.ndarray | None = None


@dataclass
class SceneDescription:
    """Everything the renderer needs, as plain host data."""

    primitives: list = field(default_factory=list)  # list[HostPrimitive]
    lights: list = field(default_factory=list)  # list[HostLight] (non-area)
    camera: CameraConfig = field(default_factory=CameraConfig)
    film: FilmConfig = field(default_factory=FilmConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    integrator: IntegratorConfig = field(default_factory=IntegratorConfig)
    accelerator: str = "bvh"
    accelerator_params: dict = field(default_factory=dict)
    media: dict = field(default_factory=dict)  # name -> HostMedium
    camera_medium: str = ""  # medium the camera sits in
    transform_start_time: float = 0.0  # keyframe-0 time (TransformTimes)
    transform_end_time: float = 1.0


# ---------------------------------------------------------------------------
# Host tessellation of quadrics (cylinder/disk/cone/paraboloid/hyperboloid)
# ---------------------------------------------------------------------------
# The reference intersects these analytically (src/shapes/*.rs). Here only
# sphere+triangle kernels run on device; the remaining quadrics tessellate to
# triangle meshes at scene-build time with analytic normals, which preserves
# the visual result at sufficient resolution. (Analytic device quadrics are a
# later optimization; the SoA layout already reserves a geometry-type id.)


def _grid_mesh(fp, fn, nu, nv, u0, u1, v0, v1, o2w: Transform, reverse_orientation):
    us = np.linspace(u0, u1, nu + 1)
    vs = np.linspace(v0, v1, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    p = fp(uu.ravel(), vv.ravel())  # (N,3) object space
    n = fn(uu.ravel(), vv.ravel())
    pw = o2w.xpoint(p)
    nw = o2w.xnormal(n)
    nw = nw / np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
    if reverse_orientation ^ o2w.swaps_handedness():
        nw = -nw
    idx = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            b = (i + 1) * (nv + 1) + j
            idx.append([a, b, b + 1])
            idx.append([a, b + 1, a + 1])
    uvg = np.stack([(uu.ravel() - u0) / max(u1 - u0, 1e-12), (vv.ravel() - v0) / max(v1 - v0, 1e-12)], axis=-1)
    return TriangleMesh(
        p=pw.astype(np.float64),
        indices=np.asarray(idx, dtype=np.int32),
        n=nw,
        uv=uvg,
        reverse_orientation=reverse_orientation,
        transform_swaps_handedness=o2w.swaps_handedness(),
    )


def tessellate_cylinder(o2w, radius, z_min, z_max, phi_max, reverse_orientation, nu=128, nv=8):
    def fp(phi, z):
        return np.stack([radius * np.cos(phi), radius * np.sin(phi), z], axis=-1)

    def fn(phi, z):
        return np.stack([np.cos(phi), np.sin(phi), np.zeros_like(phi)], axis=-1)

    return _grid_mesh(fp, fn, nu, nv, 0.0, phi_max, z_min, z_max, o2w, reverse_orientation)


def tessellate_disk(o2w, height, radius, inner_radius, phi_max, reverse_orientation, nu=128, nv=4):
    def fp(phi, r):
        return np.stack([r * np.cos(phi), r * np.sin(phi), np.full_like(phi, height)], axis=-1)

    def fn(phi, r):
        z = np.ones_like(phi)
        return np.stack([np.zeros_like(phi), np.zeros_like(phi), z], axis=-1)

    return _grid_mesh(fp, fn, nu, nv, 0.0, phi_max, max(inner_radius, 1e-8 * radius), radius, o2w, reverse_orientation)


def tessellate_cone(o2w, height, radius, phi_max, reverse_orientation, nu=128, nv=16):
    def fp(phi, v):
        return np.stack([radius * (1 - v) * np.cos(phi), radius * (1 - v) * np.sin(phi), v * height], axis=-1)

    def fn(phi, v):
        dpdu = np.stack([-radius * (1 - v) * np.sin(phi), radius * (1 - v) * np.cos(phi), np.zeros_like(phi)], axis=-1)
        dpdv = np.stack([-radius * np.cos(phi), -radius * np.sin(phi), np.full_like(phi, height)], axis=-1)
        return np.cross(dpdu, dpdv)

    return _grid_mesh(fp, fn, nu, nv, 0.0, phi_max, 0.0, 1.0 - 1e-6, o2w, reverse_orientation)


def tessellate_paraboloid(o2w, radius, z_min, z_max, phi_max, reverse_orientation, nu=128, nv=32):
    k = z_max / (radius * radius)

    def fp(phi, z):
        r = np.sqrt(np.maximum(z / k, 0.0))
        return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)

    def fn(phi, z):
        r = np.sqrt(np.maximum(z / k, 1e-12))
        dpdu = np.stack([-r * np.sin(phi), r * np.cos(phi), np.zeros_like(phi)], axis=-1)
        drdz = 1.0 / (2.0 * k * r)
        dpdv = np.stack([drdz * np.cos(phi), drdz * np.sin(phi), np.ones_like(phi)], axis=-1)
        return np.cross(dpdu, dpdv)

    return _grid_mesh(fp, fn, nu, nv, 0.0, phi_max, max(z_min, 1e-6 * z_max), z_max, o2w, reverse_orientation)


def tessellate_hyperboloid(o2w, p1, p2, phi_max, reverse_orientation, nu=128, nv=32):
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)

    def fp(phi, v):
        pr = p1[None, :] * (1 - v[..., None]) + p2[None, :] * v[..., None]
        x = pr[..., 0] * np.cos(phi) - pr[..., 1] * np.sin(phi)
        y = pr[..., 0] * np.sin(phi) + pr[..., 1] * np.cos(phi)
        return np.stack([x, y, pr[..., 2]], axis=-1)

    def fn(phi, v):
        eps = 1e-4
        p0 = fp(phi, v)
        du = fp(phi + eps, v) - p0
        dv = fp(phi, v + eps) - p0
        return np.cross(du, dv)

    return _grid_mesh(fp, fn, nu, nv, 0.0, phi_max, 0.0, 1.0, o2w, reverse_orientation)
