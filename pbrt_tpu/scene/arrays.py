"""SceneArrays: the flat SoA device representation of a scene.

This is the array-program replacement of the reference's trait-object scene graph
— every shape, material, light and texture becomes rows of fixed-width arrays
indexed by integer ids, so device kernels are pure batched array programs
(design mandate: SURVEY.md §7; reference inventory: src/core/primitive.rs,
src/core/api.rs RenderOptions::make_scene).

Split into:
- ``SceneArrays``: jnp array leaves, a registered pytree, traced by jit.
- ``SceneStatic``: python-level static config (counts, kinds present, texture
  programs) that shapes the compiled program; passed by closure into jit.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

import jax
import numpy as np

# geometry type ids
GEOM_TRI = 0
GEOM_SPHERE = 1  # any analytic quadric row (see QUADRIC_* for the sub-kind)

# quadric sub-kinds stored in SceneArrays.sph_kind
QUADRIC_SPHERE = 0
QUADRIC_CYLINDER = 1
QUADRIC_DISK = 2
QUADRIC_CONE = 3
QUADRIC_PARABOLOID = 4
QUADRIC_HYPERBOLOID = 5

# material kind ids
MAT_NONE = 0
MAT_MATTE = 1
MAT_MIRROR = 2
MAT_GLASS = 3
MAT_PLASTIC = 4
MAT_METAL = 5
MAT_UBER = 6
MAT_SUBSTRATE = 7
MAT_TRANSLUCENT = 8
MAT_DISNEY = 9
MAT_MIX = 10
MAT_SUBSURFACE = 11
MAT_KDSUBSURFACE = 12
MAT_FOURIER = 13
MAT_HAIR = 14

MAT_IDS = {
    "none": MAT_NONE,
    "matte": MAT_MATTE,
    "mirror": MAT_MIRROR,
    "glass": MAT_GLASS,
    "plastic": MAT_PLASTIC,
    "metal": MAT_METAL,
    "uber": MAT_UBER,
    "substrate": MAT_SUBSTRATE,
    "translucent": MAT_TRANSLUCENT,
    "disney": MAT_DISNEY,
    "mix": MAT_MIX,
    "subsurface": MAT_SUBSURFACE,
    "kdsubsurface": MAT_KDSUBSURFACE,
    "fourier": MAT_FOURIER,
    "hair": MAT_HAIR,
}

# material parameter slots (each a vec3 + texture-id indirection)
P_KD = 0
P_SIGMA = 1
P_KR = 2
P_KT = 3
P_ETA = 4  # scalar dielectric eta in .x, or conductor eta rgb (metal)
P_K = 5  # conductor k rgb
P_KS = 6
P_UROUGH = 7
P_VROUGH = 8
P_OPACITY = 9
P_REFLECT = 10
P_TRANSMIT = 11
P_EXTRA = 12  # mix: (sub1, sub2, -) material row ids; disney: (metallic, clearcoat, gloss)
P_EXTRA2 = 13  # disney: (sheen, spectrans, speculartint); subsurface extras
N_MAT_PARAMS = 14

# light kind ids
LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_INFINITE = 3
LIGHT_AREA = 4
LIGHT_GONIO = 5
LIGHT_PROJECTION = 6

_DELTA_LIGHTS = (LIGHT_POINT, LIGHT_SPOT, LIGHT_DISTANT, LIGHT_GONIO, LIGHT_PROJECTION)


@jax.tree_util.register_dataclass
@dataclass
class SceneArrays:
    # --- triangles (T rows; world space, expanded SoA) ---
    tri_p: jax.Array  # (T, 3, 3) f32 vertex positions
    tri_n: jax.Array  # (T, 3, 3) f32 shading normals (geometric if absent)
    tri_uv: jax.Array  # (T, 3, 2) f32
    # --- spheres (S rows) ---
    sph_o2w: jax.Array  # (S, 3, 4) f32 object-to-world
    sph_w2o: jax.Array  # (S, 3, 4) f32 world-to-object
    sph_param: jax.Array  # (S, 12) f32: sphere/cylinder = radius, zmin, zmax,
    # phimax, thetamin, thetamax; disk = radius, height, inner_r, phimax;
    # hyperboloid (hyperboloid.rs) = rmax, zmin, zmax, phimax, ah, ch,
    # p1(3), p2(3)
    sph_kind: jax.Array  # (S,) i32 QUADRIC_* sub-kind
    # --- primitives (P = T + S rows) ---
    prim_kind: jax.Array  # (P,) i32 GEOM_*
    prim_geom: jax.Array  # (P,) i32 row in tri_* or sph_*
    prim_mat: jax.Array  # (P,) i32 material id
    prim_light: jax.Array  # (P,) i32 area light id or -1
    prim_flags: jax.Array  # (P,) i32 bit0: flip geometric normal (rev ^ swap), bit1: has shading normals, bit2: reverse_orientation
    prim_area: jax.Array  # (P,) f32 surface area (for area light pdfs)
    tri_prim_ids: jax.Array  # (T,) i32 triangle row -> primitive row
    sph_prim_ids: jax.Array  # (S,) i32 sphere row -> primitive row
    # --- BVH ---
    bvh_min: jax.Array  # (N, 3) f32
    bvh_max: jax.Array  # (N, 3) f32
    bvh_off: jax.Array  # (N,) i32
    bvh_n: jax.Array  # (N,) i32
    bvh_axis: jax.Array  # (N,) i32
    bvh_ids: jax.Array  # (P,) i32 (identity after BVH-order prim permutation)
    bvh_packed: jax.Array  # (N, 12) f32: min(3) max(3) off n axis pad(3)
    prim_test_data: jax.Array  # (P, 20|26) f32: tri verts (9) | quadric w2o(12)+params(6)+qkind; cols 19:25 = hyperboloid p1/p2 when a partial-phimax hyperboloid exists
    # --- materials ---
    mat_kind: jax.Array  # (M,) i32
    mat_const: jax.Array  # (M, N_MAT_PARAMS, 3) f32 constant values
    mat_tex: jax.Array  # (M, N_MAT_PARAMS) i32 texture index or -1
    mat_remap: jax.Array  # (M,) i32 remaproughness flag
    # --- lights ---
    light_kind: jax.Array  # (L,) i32
    light_param: jax.Array  # (L, 12) f32 (layout per kind, see builder)
    light_prim: jax.Array  # (L,) i32 prim id for area lights, -1 else
    light_w2l: jax.Array  # (L, 3, 4) f32 world->light (gonio/projection frames)
    # --- media ---
    prim_medium: jax.Array  # (P, 2) i32 inside/outside medium id (-1 vacuum)
    med_param: jax.Array  # (Md, 8) f32: sigma_a(3), sigma_s(3), g, max_density
    med_w2m: jax.Array  # (Md, 3, 4) f32 world -> medium grid space ([0,1]^3)
    # --- world ---
    world_center: jax.Array  # (3,) f32
    world_radius: jax.Array  # () f32
    # --- motion blur (None when the scene is static): shutter-close keyframe
    # tables; device kernels lerp by per-ray time (transform.rs
    # AnimatedTransform -> baked linear vertex motion, see builder) ---
    tri_p_end: jax.Array | None = None  # (T, 3, 3)
    sph_w2o_end: jax.Array | None = None  # (S, 3, 4)
    sph_o2w_end: jax.Array | None = None  # (S, 3, 4)
    prim_test_data_end: jax.Array | None = None  # same layout as prim_test_data
    # --- textures: per-texture image stack entries live in a dict of leaves ---
    tex_images: dict = field(default_factory=dict)  # name "img{i}" -> (H, W, 3) f32
    med_grids: dict = field(default_factory=dict)  # name "med{i}" -> (nz, ny, nx) f32 density
    light_images: dict = field(default_factory=dict)  # "lim{i}" -> (H, W, 3) f32 (gonio/projection maps)
    fourier: dict = field(default_factory=dict)  # stacked FourierBSDF tables (device/fourier.py)
    tex_param: jax.Array | None = None  # (X, 24) f32 per-texture params
    # --- instance reuse (TransformedPrimitive, primitive.rs:41-103) ---
    prim_inst: jax.Array | None = None  # (P,) i32 instance id (0 = identity)
    inst_i2w: jax.Array | None = None  # (I, 3, 4) instance-to-world
    inst_w2i: jax.Array | None = None  # (I, 3, 4) world-to-instance
    # --- tabulated BSSRDF per-material rows (None when no SSS materials);
    # albedo axis folded at compile time (core/bssrdf.py, bssrdf.rs tables) ---
    sss_prof: jax.Array | None = None  # (M, 3, 64) radial profile rows
    sss_cdf: jax.Array | None = None  # (M, 3, 64) radial CDF rows
    sss_rhoeff: jax.Array | None = None  # (M, 3)
    sss_sigma_t: jax.Array | None = None  # (M, 3)
    sss_eta: jax.Array | None = None  # (M,)
    sss_radius: jax.Array | None = None  # (64,) optical radius knots
    # --- infinite light env map machinery (None when constant) ---
    env_image: jax.Array | None = None  # (H, W, 3)
    env_cond_cdf: jax.Array | None = None  # (H, W+1)
    env_marg_cdf: jax.Array | None = None  # (H+1,)
    env_w2l: jax.Array | None = None  # (3, 4) world-to-light rotation
    # --- alpha cutout masks (triangle.rs:29-30): per-prim float texture id
    # into tex_programs, or -1 ---
    prim_alpha_tex: jax.Array | None = None  # (P,) i32
    prim_shadow_alpha_tex: jax.Array | None = None  # (P,) i32
    # --- kd-tree accelerator tables (scene/kdtree.py); None unless
    # static.accel_kind == "kdtree" ---
    kd_flags: jax.Array | None = None  # (N,) i32: 0-2 axis, 3 leaf
    kd_split: jax.Array | None = None  # (N,) f32
    kd_above: jax.Array | None = None  # (N,) i32 above-child / prim offset
    kd_nprims: jax.Array | None = None  # (N,) i32
    kd_prim_ids: jax.Array | None = None  # (M,) i32
    kd_lo: jax.Array | None = None  # (3,)
    kd_hi: jax.Array | None = None  # (3,)
    # per-material bump-map float texture id, -1 = none (material.rs:46-87
    # bump()); only consulted when static.has_bump
    mat_bump: jax.Array | None = None
    # fused per-prim shading row (P, 32): tri verts(0:9) normals(9:18)
    # uv(18:24) kind(24) flags(25) mat(26) light(27) geom(28) — ONE
    # row gather instead of ~8 (see shading.surface_interaction)
    prim_shade_tab: jax.Array | None = None
    # --- quadratic-motion mid-shutter keyframes (parser/api.py slerp
    # sample); None unless a shutter transform ROTATES — linear motion
    # needs only the *_end tables ---
    tri_p_mid: jax.Array | None = None  # (T, 3, 3)
    sph_w2o_mid: jax.Array | None = None  # (S, 3, 4)
    sph_o2w_mid: jax.Array | None = None  # (S, 3, 4)
    prim_test_data_mid: jax.Array | None = None  # ptd-shaped
    # --- exact animated-transform tables (device/motion.py); built only
    # when a shutter transform ROTATES (static.has_rot_motion). Group-
    # decomposed TRS keyframes (transform.rs:1442 decompose, :1493
    # interpolate) + a per-prim affine compose constant:
    # tri -> M0^-1 (p(t) = M(dt) . C . p_world0); quadric -> w2o0 . M0
    # (w2o(t) = C . M(dt)^-1). Group 0 is the identity (static prims). ---
    anim: dict | None = None  # {"q0","q1" (G,4), "t0","t1" (G,3),
    #  "s0","s1" (G,3,3), "theta" (G,)}
    anim_gid: jax.Array | None = None  # (P,) i32 animation group per prim
    anim_c: jax.Array | None = None  # (P, 3, 4) per-prim compose constant


@dataclass
class TexProgram:
    """Static per-texture evaluation recipe (children are earlier indices)."""

    kind: str
    is_float: bool
    mapping: str = "uv"
    image_key: str = ""  # key into SceneArrays.tex_images
    n_levels: int = 1  # MIPMap pyramid levels ("{image_key}_l{k}")
    trilinear: bool = False  # else EWA
    wrap: str = "repeat"
    tex1: int = -1  # child index or -1 (then const in tex_param)
    tex2: int = -1
    amount: int = -1
    v01: int = -1
    v10: int = -1
    dimension: int = 2
    octaves: int = 8
    max_aniso: float = 8.0  # imagemap "maxanisotropy" (EWA eccentricity clamp)


@dataclass
class SceneStatic:
    """Static (python-level) scene configuration that shapes compilation."""

    n_tris: int = 0
    n_spheres: int = 0
    n_prims: int = 0
    n_nodes: int = 0
    n_materials: int = 0
    n_lights: int = 0
    light_n_samples: tuple = ()  # per-light "nsamples" (UniformSampleAll arrays)
    n_delta_lights: int = 0
    max_leaf: int = 4
    mat_kinds_present: tuple = ()
    tex_programs: tuple = ()  # tuple[TexProgram]
    has_infinite: bool = False
    infinite_light_index: int = -1
    has_env_map: bool = False
    has_area_lights: bool = False
    use_brute_force: bool = False  # no-BVH path for tiny scenes
    n_media: int = 0
    media_kinds: tuple = ()  # 'homogeneous' | 'heterogeneous' per medium id
    camera_medium: int = -1
    has_null_material: bool = False  # scene contains medium-boundary prims
    has_sss_media: bool = False
    has_tab_sss: bool = False
    has_instances: bool = False  # implicit subsurface interior media present
    sss_media: tuple = ()  # medium ids that are subsurface interiors
    light_image_keys: tuple = ()  # per light: "lim{i}" key or None
    light_kinds: tuple = ()  # static LIGHT_* per light row
    has_fourier: bool = False  # scene has readable tabulated (fourier) BSDFs
    has_motion: bool = False  # any primitive carries shutter-close keyframes
    has_rot_motion: bool = False  # a shutter transform rotates: device uses
    # the exact per-ray TRS interpolation (device/motion.py) instead of
    # keyframe vertex lerp
    has_beckmann: bool = False  # any material selects the Beckmann distribution
    has_bump: bool = False  # any material carries a bump-map texture
    has_alpha: bool = False  # any prim carries an alpha/shadow-alpha cutout mask
    accel_kind: str = "bvh"  # "bvh" | "kdtree" (Accelerator directive)
    kd_max_leaf: int = 1  # longest kd leaf list (device scan bound)
    has_cone_sphere_lights: bool = False  # any full-sphere area light (cone NEE eligible)


def scene_byte_size(sa: SceneArrays) -> int:
    total = 0
    for f in fields(sa):
        v = getattr(sa, f.name)
        if v is None:
            continue
        if isinstance(v, dict):
            total += sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in v.values())
        elif hasattr(v, "shape"):
            total += int(np.prod(v.shape)) * v.dtype.itemsize
    return total
