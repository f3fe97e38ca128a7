"""Scene compiler: SceneDescription (host records) -> SceneArrays (device SoA).

This is the array-program equivalent of the reference's world_end scene assembly
(/root/reference/src/core/api.rs:1715-1756 + RenderOptions::make_scene :244):
instead of constructing a Primitives enum tree, every shape is flattened into
triangle/sphere rows, materials into fixed-width parameter blocks with texture
indirections, lights into a typed table (mesh area lights expanded to one row
per triangle, matching the reference's one-DiffuseAreaLight-per-triangle
behavior, api.rs:1535-1542), and the BVH into a flat node array.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from ..core.spectrum import y_of_rgb
from .arrays import (
    GEOM_SPHERE,
    QUADRIC_CONE,
    QUADRIC_CYLINDER,
    QUADRIC_DISK,
    QUADRIC_HYPERBOLOID,
    QUADRIC_PARABOLOID,
    QUADRIC_SPHERE,
    LIGHT_GONIO,
    LIGHT_PROJECTION,
    GEOM_TRI,
    LIGHT_AREA,
    LIGHT_DISTANT,
    LIGHT_INFINITE,
    LIGHT_POINT,
    LIGHT_SPOT,
    MAT_IDS,
    MAT_MATTE,
    N_MAT_PARAMS,
    P_ETA,
    P_K,
    P_KD,
    P_KR,
    P_KS,
    P_KT,
    P_OPACITY,
    P_REFLECT,
    P_SIGMA,
    P_TRANSMIT,
    P_UROUGH,
    P_VROUGH,
    SceneArrays,
    SceneStatic,
    TexProgram,
)
from .bvh import build_bvh
from .host import HostLight, HostMaterial, HostTexture, SceneDescription

log = logging.getLogger(__name__)

BRUTE_FORCE_MAX_PRIMS = 64


# flags bits for prim_flags
FLAG_FLIP_GEOM_N = 1
FLAG_HAS_SHADING_N = 2
FLAG_REVERSE_ORIENTATION = 4
FLAG_HAS_UV = 8


class _TextureRegistry:
    """Flattens the host texture DAG into an ordered eval program list.

    Creation order of pbrt named textures is already topological; children are
    registered before parents on demand."""

    def __init__(self):
        self.programs: list[TexProgram] = []
        self.params: list[np.ndarray] = []  # (24,) per texture
        self.images: dict = {}
        self._by_id: dict[int, int] = {}

    def register_source(self, src):
        """src: ('const', value) | ('texture', HostTexture) | None.
        Returns (const_vec3, tex_index)."""
        if src is None:
            return np.zeros(3), -1
        kind, val = src
        if kind == "const":
            v = np.atleast_1d(np.asarray(val, dtype=np.float64)).ravel()
            if v.size == 1:
                v = np.repeat(v, 3)
            return v[:3], -1
        return np.zeros(3), self.register(val)

    def register(self, tex: HostTexture) -> int:
        key = id(tex)
        if key in self._by_id:
            return self._by_id[key]
        prog = TexProgram(kind=tex.kind, is_float=tex.is_float, mapping=tex.mapping, wrap=tex.wrap, dimension=tex.dimension, octaves=tex.octaves)
        par = np.zeros(24, dtype=np.float64)
        # mapping params: uscale, vscale, udelta, vdelta @ 0:4; v1 @ 4:7, v2 @ 7:10
        par[0] = tex.uscale
        par[1] = tex.vscale
        par[2] = tex.udelta
        par[3] = tex.vdelta
        if tex.v1 is not None:
            par[4:7] = tex.v1
        if tex.v2 is not None:
            par[7:10] = tex.v2

        def child(src):
            c, t = self.register_source(src)
            return c, t

        if tex.kind == "constant":
            v = np.atleast_1d(np.asarray(tex.value, dtype=np.float64)).ravel()
            if v.size == 1:
                v = np.repeat(v, 3)
            par[10:13] = v[:3]
        elif tex.kind in ("scale", "mix", "checkerboard", "dots", "bilerp"):
            c1, prog.tex1 = child(tex.tex1)
            c2, prog.tex2 = child(tex.tex2)
            par[10:13] = c1
            par[13:16] = c2
            if tex.kind == "mix":
                ca, prog.amount = child(tex.amount)
                par[16:19] = ca
            if tex.kind == "bilerp":
                c01, prog.v01 = child(tex.v01)
                c10, prog.v10 = child(tex.v10)
                par[16:19] = c01
                par[19:22] = c10
        elif tex.kind == "imagemap":
            from ..device.mipmap import build_pyramid

            key_name = f"img{len([k for k in self.images if k.endswith('_l0')])}"
            pyr = build_pyramid(np.asarray(tex.image, dtype=np.float32))
            for li, level in enumerate(pyr):
                self.images[f"{key_name}_l{li}"] = jnp.asarray(level)
            prog.image_key = key_name
            prog.n_levels = len(pyr)
            prog.trilinear = tex.trilinear
            prog.max_aniso = float(getattr(tex, "max_aniso", 8.0))
            par[10] = tex.scale
        elif tex.kind == "uv":
            pass
        elif tex.kind in ("fbm", "wrinkled", "marble", "windy"):
            par[10] = tex.roughness
            par[11] = tex.scale
            par[12] = tex.variation
            if tex.world_to_texture is not None:
                par[4:16] = tex.world_to_texture.m[:3, :].ravel()[:12]
        idx = len(self.programs)
        self.programs.append(prog)
        self.params.append(par)
        self._by_id[key] = idx
        return idx


@dataclass
class CompiledScene:
    arrays: SceneArrays
    static: SceneStatic
    description: SceneDescription


def _geom_to_prim_map(prim_kind, prim_geom, kind_id, n_geom):
    """geometry-table row -> primitive row (prims are in BVH leaf order)."""
    out = np.zeros(max(n_geom, 0), np.int32)
    for i, (k, g) in enumerate(zip(prim_kind, prim_geom)):
        if k == kind_id:
            out[g] = i
    return out


def _quadric_area(sph, qkind):
    """Analytic surface areas (sphere.rs / cylinder.rs / disk.rs / cone.rs /
    paraboloid.rs area())."""
    if qkind == QUADRIC_DISK:
        return sph.phi_max * 0.5 * (sph.radius ** 2 - sph.inner_radius ** 2)
    if qkind == QUADRIC_CYLINDER:
        return sph.phi_max * sph.radius * abs(sph.z_max - sph.z_min)
    if qkind == QUADRIC_CONE:
        # cone.rs:219-221: r * sqrt(h^2 + r^2) * phimax / 2
        return sph.radius * np.sqrt(sph.height ** 2 + sph.radius ** 2) * sph.phi_max / 2.0
    if qkind == QUADRIC_HYPERBOLOID:
        # Deliberate deviation: the reference's closed form
        # (hyperboloid.rs:275-287, pbrt-v3's known-broken Hyperboloid::Area —
        # it returns 8*pi for a degenerate unit cylinder of true area 4*pi)
        # is replaced by midpoint quadrature of |dp/du x dp/dv| over the
        # parametric surface; the reference never exercises its value
        # (Hyperboloid::sample errors out), while our area-light sampling
        # needs the true area for the 1/A pdf.
        p1 = np.asarray(sph.p1, np.float64)
        p2 = np.asarray(sph.p2, np.float64)
        nv, nu = 256, 64
        v = (np.arange(nv) + 0.5) / nv
        phi = (np.arange(nu) + 0.5) / nu * sph.phi_max
        seg = p1[None, :] + v[:, None] * (p2 - p1)[None, :]  # (nv, 3)
        cph, sph_ = np.cos(phi), np.sin(phi)
        # p(u,v) = Rz(phi) @ seg(v); dpdu = d/dphi * phi_max, dpdv = Rz @ seg'
        x = seg[:, None, 0] * cph[None, :] - seg[:, None, 1] * sph_[None, :]
        y = seg[:, None, 0] * sph_[None, :] + seg[:, None, 1] * cph[None, :]
        dpdu = np.stack([-y, x, np.zeros_like(x)], axis=-1) * sph.phi_max
        dseg = p2 - p1
        dvx = dseg[0] * cph - dseg[1] * sph_
        dvy = dseg[0] * sph_ + dseg[1] * cph
        dpdv = np.stack([np.broadcast_to(dvx, x.shape), np.broadcast_to(dvy, x.shape),
                         np.full_like(x, dseg[2])], axis=-1)
        da = np.linalg.norm(np.cross(dpdu, dpdv), axis=-1)
        return float(da.mean())  # integral over (u, v) in [0,1]^2
    if qkind == QUADRIC_PARABOLOID:
        # paraboloid.rs:221-227
        r2 = sph.radius ** 2
        zmax = max(sph.z_min, sph.z_max)
        zmin = min(sph.z_min, sph.z_max)
        if zmax <= 0:
            return 0.0
        k = 4.0 * zmax / r2
        return (r2 * r2 * sph.phi_max / (12.0 * zmax * zmax)) * (
            (k * zmax + 1.0) ** 1.5 - (k * zmin + 1.0) ** 1.5)
    # sphere: phi_max * radius * (zmax - zmin)
    return sph.phi_max * sph.radius * (np.clip(sph.z_max, -sph.radius, sph.radius) - np.clip(sph.z_min, -sph.radius, sph.radius))


def compile_scene(desc: SceneDescription) -> CompiledScene:
    tri_p, tri_n, tri_uv = [], [], []
    tri_p_e = []  # shutter-close vertices (== tri_p entries when static)
    tri_p_m = []  # mid-shutter vertices (slerp sample; == start when linear)
    sph_w2o_e = []
    sph_o2w_e = []
    sph_w2o_m = []
    sph_o2w_m = []
    any_rot_motion = False
    any_motion = False
    sph_o2w, sph_w2o, sph_param = [], [], []
    sph_kind_l = []
    prim_kind, prim_geom, prim_mat, prim_light, prim_flags, prim_area = [], [], [], [], [], []
    prim_lo, prim_hi = [], []
    prim_medium = []
    prim_alpha, prim_shadow_alpha = [], []  # float texture ids or -1 (cutouts)

    # --- exact animated-transform groups (device/motion.py): one group per
    # distinct (M0, M1) shutter CTM pair; group 0 is the identity ---
    _anim_keys: dict = {}
    anim_group_mats: list = [(np.eye(4), np.eye(4))]
    prim_anim_gid: list = []
    prim_anim_c: list = []
    _IDENT34 = np.eye(4)[:3, :]
    _rot_prims: list = []  # (prim_row, gid, lo0 (3,), hi0 (3,)) for re-bounding

    def _anim_gid(pair) -> int:
        key = (pair[0].tobytes(), pair[1].tobytes())
        g = _anim_keys.get(key)
        if g is None:
            g = len(anim_group_mats)
            _anim_keys[key] = g
            anim_group_mats.append((np.asarray(pair[0], np.float64),
                                    np.asarray(pair[1], np.float64)))
        return g

    # --- media table -----------------------------------------------------------
    med_names = list(desc.media.keys())
    med_ids = {n: i for i, n in enumerate(med_names)}
    med_param_rows = []
    med_w2m_rows = []
    med_grids = {}
    media_kinds = []
    for i, n in enumerate(med_names):
        hm = desc.media[n]
        row = np.zeros(8)
        row[0:3] = hm.sigma_a
        row[3:6] = hm.sigma_s
        row[6] = hm.g
        media_kinds.append(hm.kind)
        if hm.kind == "heterogeneous" and hm.density is not None:
            row[7] = float(hm.density.max())
            med_grids[f"med{i}"] = jnp.asarray(hm.density.astype(np.float32))
            # world -> grid [0,1]^3: inverse(medium_to_world) then p0/p1 scale
            w2m = hm.medium_to_world.inverse().m
            span = np.maximum(hm.p1 - hm.p0, 1e-12)
            norm = np.eye(4)
            norm[:3, :3] = np.diag(1.0 / span)
            norm[:3, 3] = -hm.p0 / span
            med_w2m_rows.append((norm @ w2m)[:3, :])
        else:
            row[7] = 1.0
            med_w2m_rows.append(hm.medium_to_world.inverse().m[:3, :])
        med_param_rows.append(row)

    def add_medium(hm, name):
        mid = len(med_param_rows)
        med_ids[name] = mid
        media_kinds.append(hm.kind)
        row = np.zeros(8)
        row[0:3] = hm.sigma_a
        row[3:6] = hm.sigma_s
        row[6] = hm.g
        row[7] = 1.0
        med_param_rows.append(row)
        med_w2m_rows.append(np.eye(4)[:3, :])
        return mid

    def medium_id(name: str) -> int:
        if not name:
            return -1
        mid = med_ids.get(name)
        if mid is None:
            log.error("medium '%s' not defined", name)
            return -1
        return mid

    tex_reg = _TextureRegistry()
    mat_index: dict[int, int] = {}
    mat_rows: list[tuple] = []  # (kind_id, const (P,3), tex (P,), remap)
    fourier_tables: list[dict] = []
    fourier_ids: dict[str, int] = {}

    def register_fourier(path: str) -> int:
        """Load + densify a SCATFUN table once per path (fourier.rs:16-36)."""
        if path in fourier_ids:
            return fourier_ids[path]
        from ..core.fourierbsdf import read_fourier_table

        tbl = read_fourier_table(path)
        tid = -1 if tbl is None else len(fourier_tables)
        if tbl is not None:
            fourier_tables.append(tbl)
        fourier_ids[path] = tid
        return tid

    def material_id(mat: HostMaterial) -> int:
        key = id(mat)
        if key in mat_index:
            return mat_index[key]
        mid = len(mat_rows)
        mat_rows.append(None)  # reserve the row (mix sub-materials recurse)
        mat_index[key] = mid
        mat_rows[mid] = _compile_material(mat, tex_reg, material_id, register_fourier)
        return mid

    lights: list[tuple] = []  # (kind, params(12,), prim_id, nsamples)

    # --- non-area lights first -------------------------------------------------
    infinite_host: HostLight | None = None
    light_w2l_rows: list = []
    light_images: dict = {}
    light_image_keys: list = []

    def _push_light_frame(hl, has_image):
        light_w2l_rows.append(hl.light_to_world.inverse().m[:3, :])
        if has_image and hl.image is not None:
            key = f"lim{len(light_images)}"
            light_images[key] = jnp.asarray(np.asarray(hl.image, dtype=np.float32))
            light_image_keys.append(key)
        else:
            light_image_keys.append(None)

    for hl in desc.lights:
        if hl.kind == "point":
            p = np.zeros(12)
            p[0:3] = hl.from_point
            p[3:6] = hl.intensity
            lights.append((LIGHT_POINT, p, -1, max(int(getattr(hl, 'n_samples', 1)), 1)))
            _push_light_frame(hl, False)
        elif hl.kind == "goniometric":
            p = np.zeros(12)
            p[0:3] = hl.light_to_world.xpoint(np.zeros(3))
            p[3:6] = hl.intensity
            lights.append((LIGHT_GONIO, p, -1, max(int(getattr(hl, 'n_samples', 1)), 1)))
            _push_light_frame(hl, True)
        elif hl.kind == "projection":
            p = np.zeros(12)
            p[0:3] = hl.light_to_world.xpoint(np.zeros(3))
            p[3:6] = hl.intensity
            # projection.rs: screen from fov; store tan(fov/2) and aspect
            p[9] = np.tan(np.radians(hl.cone_angle) / 2.0)
            aspect = 1.0
            if hl.image is not None and hl.image.shape[0] > 0:
                aspect = hl.image.shape[1] / hl.image.shape[0]
            p[10] = aspect
            lights.append((LIGHT_PROJECTION, p, -1, max(int(getattr(hl, 'n_samples', 1)), 1)))
            _push_light_frame(hl, True)
        elif hl.kind == "spot":
            p = np.zeros(12)
            p[0:3] = hl.from_point
            p[3:6] = hl.intensity
            d = np.asarray(hl.to_point) - np.asarray(hl.from_point)
            d = d / max(np.linalg.norm(d), 1e-12)
            p[6:9] = d
            p[9] = np.cos(np.radians(hl.cone_angle))  # cosTotalWidth
            p[10] = np.cos(np.radians(hl.cone_angle - hl.cone_delta))  # cosFalloffStart
            lights.append((LIGHT_SPOT, p, -1, max(int(getattr(hl, 'n_samples', 1)), 1)))
            _push_light_frame(hl, False)
        elif hl.kind == "distant":
            p = np.zeros(12)
            d = np.asarray(hl.from_point) - np.asarray(hl.to_point)  # direction TO light
            d = d / max(np.linalg.norm(d), 1e-12)
            p[0:3] = d
            p[3:6] = hl.intensity
            lights.append((LIGHT_DISTANT, p, -1, max(int(getattr(hl, 'n_samples', 1)), 1)))
            _push_light_frame(hl, False)
        elif hl.kind == "infinite":
            p = np.zeros(12)
            p[3:6] = hl.intensity
            lights.append((LIGHT_INFINITE, p, -1, max(int(getattr(hl, 'n_samples', 1)), 1)))
            _push_light_frame(hl, False)
            infinite_host = hl
        else:
            log.warning("light kind '%s' dropped", hl.kind)

    # --- primitives ------------------------------------------------------------
    from .host import HostMedium

    _sss_media: dict[int, str] = {}
    _sss_mats: dict[int, HostMaterial] = {}  # material id -> host material

    def _sss_coefficients(mat: HostMaterial):
        """(sigma_a, sigma_s, g, eta) for a subsurface-family material
        (materials/subsurface.rs create / kdsubsurface.rs create). The
        kdsubsurface Kd inversion uses the real beam-diffusion table
        (bssrdf.rs subsurface_from_diffuse)."""
        from ..core.bssrdf import compute_beam_diffusion_table, subsurface_from_diffuse

        def cscalar(nm, default):
            v = mat.params.get(nm)
            if v is not None and v[0] == "const":
                return float(np.atleast_1d(v[1]).ravel()[0])
            return default

        def cvec(nm, default):
            v = mat.params.get(nm)
            if v is not None and v[0] == "const":
                a = np.atleast_1d(np.asarray(v[1], float)).ravel()
                return np.repeat(a, 3)[:3] if a.size == 1 else a[:3]
            return None if default is None else np.asarray(default, float)

        scale = cscalar("scale", 1.0)
        g = cscalar("g", 0.0)
        eta = cscalar("eta", cscalar("index", 1.33))
        if mat.kind == "kdsubsurface":
            kdv = np.clip(cvec("Kd", [0.5, 0.5, 0.5]), 1e-4, 0.999)
            mfp = np.maximum(cvec("mfp", [1.0, 1.0, 1.0]), 1e-6)
            tab = _sss_table_for(g, eta)
            sig_a, sig_s = subsurface_from_diffuse(tab, kdv, mfp)
        else:
            refl = cvec("reflectance", None)
            if refl is not None:
                mfp = np.maximum(cvec("mfp", [1.0, 1.0, 1.0]), 1e-6)
                tab = _sss_table_for(g, eta)
                sig_a, sig_s = subsurface_from_diffuse(tab, np.clip(refl, 1e-4, 0.999), mfp)
            else:
                sig_a = cvec("sigma_a", [0.0011, 0.0024, 0.014]) * scale
                sig_s = cvec("sigma_s", [2.55, 3.21, 3.77]) * scale
        return np.maximum(sig_a, 0.0), np.maximum(sig_s, 0.0), g, eta

    def _inside_medium_id(prim, mid: int) -> int:
        """Inside-medium id, falling back to the material's implicit SSS
        walk medium (populated only under PBRT_TPU_NO_TABSSS=1)."""
        if prim.inside_medium:
            return medium_id(prim.inside_medium)
        name = _sss_media.get(mid)
        return med_ids[name] if name else -1

    _sss_table_cache: dict[tuple, dict] = {}

    def _sss_table_for(g, eta):
        from ..core.bssrdf import compute_beam_diffusion_table

        key = (round(float(g), 4), round(float(eta), 4))
        if key not in _sss_table_cache:
            _sss_table_cache[key] = compute_beam_diffusion_table(g, eta)
        return _sss_table_cache[key]

    # instance transform tables (primitive.rs TransformedPrimitive): row 0 is
    # the identity; instanced mesh prims reference shared geometry rows and
    # carry an instance id, so N instances cost N prim-row sets, not N
    # vertex-table copies
    inst_i2w_rows = [np.eye(4)[:3, :]]
    inst_w2i_rows = [np.eye(4)[:3, :]]
    prim_inst: list[int] = []
    _mesh_rows: dict[int, tuple] = {}  # id(mesh) -> (t0, t, pv, areas, flags)

    for prim in desc.primitives:
        mid = material_id(prim.material)
        if prim.material.kind in ("subsurface", "kdsubsurface"):
            # PBRT_TPU_NO_TABSSS=1 disables the tabulated BSSRDF so the
            # implicit interior medium's volumetric random walk carries ALL
            # subsurface transport — the independent estimator the SSS
            # fidelity cross-validation compares against (tools/fidelity.py)
            if os.environ.get("PBRT_TPU_NO_TABSSS", "") != "1":
                _sss_mats.setdefault(mid, prim.material)
            elif mid not in _sss_media:
                # interior homogeneous medium from the material's
                # (sigma_a, sigma_s, g); the Fresnel+diffuse-transmission
                # interface BSDF (device/materials.py MAT_SUBSURFACE) plus
                # this medium's random walk IS the walk estimator
                sig_a, sig_s, g_m, _eta_m = _sss_coefficients(prim.material)
                hm = HostMedium(kind="homogeneous", sigma_a=np.asarray(sig_a, float),
                                sigma_s=np.asarray(sig_s, float), g=float(g_m))
                name = f"__sss_walk_{mid}"
                add_medium(hm, name)
                _sss_media[mid] = name
        sh = prim.shape
        if sh.mesh is not None:
            mesh = sh.mesh
            inst_t = prim.instance_transform
            cached = _mesh_rows.get(id(mesh)) if inst_t is not None else None
            if cached is None:
                v = np.asarray(mesh.p, dtype=np.float64)
                f = np.asarray(mesh.indices, dtype=np.int64)
                pv = v[f]  # (t, 3, 3)
                if mesh.p_end is not None:
                    pv_end = np.asarray(mesh.p_end, dtype=np.float64)[f]
                    any_motion = True
                    if mesh.p_mid is not None:
                        pv_mid = np.asarray(mesh.p_mid, dtype=np.float64)[f]
                        if not np.allclose(pv_mid, 0.5 * (pv + pv_end), atol=1e-9):
                            any_rot_motion = True
                    else:
                        pv_mid = 0.5 * (pv + pv_end)
                else:
                    pv_end = pv
                    pv_mid = pv
                e1 = pv[:, 1] - pv[:, 0]
                e2 = pv[:, 2] - pv[:, 0]
                gn = np.cross(e1, e2)
                areas = 0.5 * np.linalg.norm(gn, axis=-1)
                flags = 0
                if mesh.reverse_orientation ^ mesh.transform_swaps_handedness:
                    flags |= FLAG_FLIP_GEOM_N
                if mesh.reverse_orientation:
                    flags |= FLAG_REVERSE_ORIENTATION
                if mesh.n is not None:
                    flags |= FLAG_HAS_SHADING_N
                    nv = np.asarray(mesh.n, dtype=np.float64)[f]
                else:
                    gnn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-30)
                    if flags & FLAG_FLIP_GEOM_N:
                        gnn = -gnn
                    nv = np.repeat(gnn[:, None, :], 3, axis=1)
                if mesh.uv is not None:
                    flags |= FLAG_HAS_UV
                    uvv = np.asarray(mesh.uv, dtype=np.float64)[f]
                else:
                    uvv = np.broadcast_to(np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]]), (len(f), 3, 2)).copy()

                t = len(f)
                t0 = sum(len(c) for c in tri_p)
                tri_p.append(pv)
                tri_p_e.append(pv_end)
                tri_p_m.append(pv_mid)
                tri_n.append(nv)
                tri_uv.append(uvv)
                if inst_t is not None:
                    _mesh_rows[id(mesh)] = (t0, t, pv, areas, flags)
            else:
                t0, t, pv, areas, flags = cached

            if inst_t is not None:
                iid = len(inst_i2w_rows)
                inst_i2w_rows.append(inst_t.m[:3, :])
                inst_w2i_rows.append(inst_t.inverse().m[:3, :])
                flags_p = flags ^ (FLAG_FLIP_GEOM_N if inst_t.swaps_handedness() else 0)
                # world bounds: transform the instance-space triangle verts
                pv_w = inst_t.xpoint(pv.reshape(-1, 3)).reshape(-1, 3, 3)
                lo_rows = pv_w.min(axis=1)
                hi_rows = pv_w.max(axis=1)
                if getattr(mesh, "anim", None) is not None:
                    # animated prototype: sweep the exact per-ray motion
                    # path (same interpolation the device evaluates) so
                    # bounds cover the whole shutter, not just t=0
                    from ..core.transform import AnimatedTransform as _ATl, Transform as _Trl

                    m0a = np.asarray(mesh.anim[0], np.float64)
                    at = _ATl(_Trl.from_matrix(m0a), _Trl.from_matrix(np.asarray(mesh.anim[1], np.float64)), 0.0, 1.0)
                    m0inv_l = np.linalg.inv(m0a)
                    NT = 16
                    for i_t in range(NT + 1):
                        Hm = (at.interpolate(i_t / NT).m @ m0inv_l)
                        pw = inst_t.xpoint((pv.reshape(-1, 3) @ Hm[:3, :3].T)
                                           + Hm[:3, 3]).reshape(-1, 3, 3)
                        lo_rows = np.minimum(lo_rows, pw.min(axis=1))
                        hi_rows = np.maximum(hi_rows, pw.max(axis=1))
                    # inter-sample arc pad (see the _rot_prims re-bounding)
                    ext = float(np.linalg.norm(hi_rows.max(axis=0) - lo_rows.min(axis=0)))
                    (_, q0a, _), (_, q1a, _) = at._parts()
                    th_a = float(np.arccos(np.clip(np.dot(q0a, q1a), -1.0, 1.0)))
                    pad_a = ext * (th_a / NT) ** 2 / 8.0 + 1e-6
                    lo_rows = lo_rows - pad_a
                    hi_rows = hi_rows + pad_a
            else:
                iid = 0
                flags_p = flags
                pv_w = pv
                lo_rows = None  # filled below from pv/pv_end

            base_prim = len(prim_kind)
            light_ids = np.full(t, -1, dtype=np.int64)
            if prim.area_light is not None:
                if inst_t is not None:
                    log.warning("area lights on instanced prototypes are not supported (dropped)")
                else:
                    light_ids = np.arange(len(lights), len(lights) + t)
                    lp = np.zeros(12)
                    lp[0:3] = prim.area_light.intensity
                    lp[3] = 1.0 if prim.area_light.two_sided else 0.0
                    for ti in range(t):
                        lights.append((LIGHT_AREA, lp, base_prim + ti, max(int(getattr(prim.area_light, 'n_samples', 1)), 1)))
                        light_w2l_rows.append(np.eye(4)[:3, :])
                        light_image_keys.append(None)
            prim_kind.extend([GEOM_TRI] * t)
            prim_geom.extend(range(t0, t0 + t))
            prim_mat.extend([mid] * t)
            prim_light.extend(light_ids.tolist())
            prim_flags.extend([flags_p] * t)
            prim_area.extend(areas.tolist())
            prim_inst.extend([iid] * t)
            if lo_rows is not None:
                prim_lo.extend(lo_rows)
                prim_hi.extend(hi_rows)
            else:
                pv_end_b = tri_p_e[-1] if len(tri_p_e) else pv
                pv_mid_b = tri_p_m[-1] if len(tri_p_m) else pv
                # the quadratic arc stays inside the hull of its Bezier
                # control points {p0, 2m - (p0+p1)/2, p1}
                ctrl = 2.0 * pv_mid_b - 0.5 * (pv + pv_end_b)
                prim_lo.extend(np.minimum.reduce([pv.min(axis=1), pv_end_b.min(axis=1), ctrl.min(axis=1)]))
                prim_hi.extend(np.maximum.reduce([pv.max(axis=1), pv_end_b.max(axis=1), ctrl.max(axis=1)]))
            prim_medium.extend([[_inside_medium_id(prim, mid), medium_id(prim.outside_medium)]] * t)
            # alpha / shadow-alpha cutout masks (triangle.rs:29-30)
            a_id = tex_reg.register(mesh.alpha_texture) if mesh.alpha_texture is not None else -1
            sa_id = tex_reg.register(mesh.shadow_alpha_texture) if mesh.shadow_alpha_texture is not None else a_id
            prim_alpha.extend([a_id] * t)
            prim_shadow_alpha.extend([sa_id] * t)
            if getattr(mesh, "anim", None) is not None:
                # instanced prototypes compose fine: the ray is brought to
                # instance space first, the exact motion acts in prototype
                # space (same frame the baked keyframes used)
                g = _anim_gid(mesh.anim)
                m0inv = np.linalg.inv(mesh.anim[0])[:3, :]
                prim_anim_gid.extend([g] * t)
                prim_anim_c.extend([m0inv] * t)
                if inst_t is None:
                    lo0 = pv.min(axis=1)
                    hi0 = pv.max(axis=1)
                    _rot_prims.extend((base_prim + ti, g, lo0[ti], hi0[ti])
                                      for ti in range(t))
            else:
                prim_anim_gid.extend([0] * t)
                prim_anim_c.extend([_IDENT34] * t)
        elif sh.sphere is not None:
            sph = sh.sphere
            o2w = sph.object_to_world
            w2o = o2w.inverse()
            si = len(sph_o2w)
            sph_o2w.append(o2w.m[:3, :])
            sph_w2o.append(w2o.m[:3, :])
            if sph.object_to_world_end is not None:
                sph_w2o_e.append(sph.object_to_world_end.inverse().m[:3, :])
                sph_o2w_e.append(sph.object_to_world_end.m[:3, :])
                any_motion = True
                o2w_mid = sph.object_to_world_mid
                if o2w_mid is None:
                    sph_w2o_m.append(0.5 * (w2o.m[:3, :] + sph.object_to_world_end.inverse().m[:3, :]))
                    sph_o2w_m.append(0.5 * (o2w.m[:3, :] + sph.object_to_world_end.m[:3, :]))
                else:
                    sph_w2o_m.append(o2w_mid.inverse().m[:3, :])
                    sph_o2w_m.append(o2w_mid.m[:3, :])
                    any_rot_motion = True
            else:
                sph_w2o_e.append(w2o.m[:3, :])
                sph_o2w_e.append(o2w.m[:3, :])
                sph_w2o_m.append(w2o.m[:3, :])
                sph_o2w_m.append(o2w.m[:3, :])
            qkind = {"sphere": QUADRIC_SPHERE, "cylinder": QUADRIC_CYLINDER,
                     "disk": QUADRIC_DISK, "cone": QUADRIC_CONE,
                     "paraboloid": QUADRIC_PARABOLOID,
                     "hyperboloid": QUADRIC_HYPERBOLOID}[getattr(sph, "kind", "sphere")]
            sph_kind_l.append(qkind)
            pad6 = [0.0] * 6
            if qkind == QUADRIC_SPHERE:
                zmin = np.clip(min(sph.z_min, sph.z_max), -sph.radius, sph.radius)
                zmax = np.clip(max(sph.z_min, sph.z_max), -sph.radius, sph.radius)
                theta_min = np.arccos(np.clip(zmin / sph.radius, -1.0, 1.0))
                theta_max = np.arccos(np.clip(zmax / sph.radius, -1.0, 1.0))
                sph_param.append([sph.radius, zmin, zmax, sph.phi_max, theta_min, theta_max] + pad6)
            elif qkind == QUADRIC_CYLINDER:
                zmin = min(sph.z_min, sph.z_max)
                zmax = max(sph.z_min, sph.z_max)
                sph_param.append([sph.radius, zmin, zmax, sph.phi_max, 0.0, 0.0] + pad6)
            elif qkind == QUADRIC_CONE:
                sph_param.append([sph.radius, sph.height, 0.0, sph.phi_max, 0.0, 0.0] + pad6)
            elif qkind == QUADRIC_PARABOLOID:
                zmin = min(sph.z_min, sph.z_max)
                zmax = max(sph.z_min, sph.z_max)
                sph_param.append([sph.radius, zmin, zmax, sph.phi_max, 0.0, 0.0] + pad6)
            elif qkind == QUADRIC_HYPERBOLOID:
                # implicit coefficients ah, ch (hyperboloid.rs:44-62): walk pp
                # away from p1 along the segment until the system conditions
                p1 = np.asarray(sph.p1, np.float64).copy()
                p2 = np.asarray(sph.p2, np.float64).copy()
                if p2[2] == 0.0:
                    p1, p2 = p2.copy(), p1.copy()
                pp = p1.copy()
                ah = np.inf
                for _ in range(64):
                    pp += 2.0 * (p2 - p1)
                    xy1 = pp[0] * pp[0] + pp[1] * pp[1]
                    xy2 = p2[0] * p2[0] + p2[1] * p2[1]
                    den = 1.0 - (xy2 * pp[2] * pp[2]) / (xy1 * p2[2] * p2[2])
                    ah = (1.0 / xy1 - (pp[2] * pp[2]) / (xy1 * p2[2] * p2[2])) / den
                    ch = (ah * xy2 - 1.0) / (p2[2] * p2[2])
                    if np.isfinite(ah):
                        break
                if not (np.isfinite(ah) and np.isfinite(ch)):
                    # degenerate inputs (e.g. both endpoints at z=0): the
                    # reference spins forever on these (hyperboloid.rs:52
                    # loop); warn and emit a never-hit shape instead
                    log.warning("degenerate hyperboloid p1=%s p2=%s: implicit "
                                "coefficients are non-finite; shape will not render", p1, p2)
                    ah = ch = 0.0
                rmax = max(np.hypot(p1[0], p1[1]), np.hypot(p2[0], p2[1]))
                zmin = min(p1[2], p2[2])
                zmax = max(p1[2], p2[2])
                sph_param.append([rmax, zmin, zmax, sph.phi_max, float(ah), float(ch)] + list(p1) + list(p2))
            else:  # disk (disk.rs): plane z = height, annulus [inner, radius]
                sph_param.append([sph.radius, sph.height, sph.inner_radius, sph.phi_max, 0.0, 0.0] + pad6)
            flags = 0
            if sph.reverse_orientation ^ o2w.swaps_handedness():
                flags |= FLAG_FLIP_GEOM_N
            if sph.reverse_orientation:
                flags |= FLAG_REVERSE_ORIENTATION
            pid = len(prim_kind)
            light_id = -1
            if prim.area_light is not None:
                light_id = len(lights)
                lp = np.zeros(12)
                lp[0:3] = prim.area_light.intensity
                lp[3] = 1.0 if prim.area_light.two_sided else 0.0
                lights.append((LIGHT_AREA, lp, pid, max(int(getattr(prim.area_light, 'n_samples', 1)), 1)))
                light_w2l_rows.append(np.eye(4)[:3, :])
                light_image_keys.append(None)
            prim_kind.append(GEOM_SPHERE)
            prim_inst.append(0)
            prim_geom.append(si)
            prim_mat.append(mid)
            prim_light.append(light_id)
            prim_flags.append(flags)
            prim_area.append(_quadric_area(sph, qkind))
            prim_alpha.append(-1)
            prim_shadow_alpha.append(-1)
            if qkind == QUADRIC_SPHERE:
                obj_lo, obj_hi = [-sph.radius] * 3, [sph.radius] * 3
            elif qkind == QUADRIC_CYLINDER:
                obj_lo = [-sph.radius, -sph.radius, min(sph.z_min, sph.z_max)]
                obj_hi = [sph.radius, sph.radius, max(sph.z_min, sph.z_max)]
            elif qkind == QUADRIC_CONE:
                obj_lo = [-sph.radius, -sph.radius, 0.0]
                obj_hi = [sph.radius, sph.radius, sph.height]
            elif qkind == QUADRIC_PARABOLOID:
                obj_lo = [-sph.radius, -sph.radius, min(sph.z_min, sph.z_max)]
                obj_hi = [sph.radius, sph.radius, max(sph.z_min, sph.z_max)]
            elif qkind == QUADRIC_HYPERBOLOID:
                rmax, zmin, zmax = sph_param[-1][0], sph_param[-1][1], sph_param[-1][2]
                obj_lo = [-rmax, -rmax, zmin]
                obj_hi = [rmax, rmax, zmax]
            else:
                obj_lo = [-sph.radius, -sph.radius, sph.height - 1e-4]
                obj_hi = [sph.radius, sph.radius, sph.height + 1e-4]
            lo, hi = o2w.xbounds(obj_lo, obj_hi)
            if getattr(sph, "anim", None) is not None:
                g = _anim_gid(sph.anim)
                prim_anim_gid.append(g)
                prim_anim_c.append((w2o.m @ np.asarray(sph.anim[0], np.float64))[:3, :])
                _rot_prims.append((pid, g, np.asarray(lo, float), np.asarray(hi, float)))
            else:
                prim_anim_gid.append(0)
                # static quadric under group 0 (M(t) = I): C . M^-1 must
                # still be the quadric's own world-to-object
                prim_anim_c.append(w2o.m[:3, :])
            if sph.object_to_world_end is not None:
                lo2, hi2 = sph.object_to_world_end.xbounds(obj_lo, obj_hi)
                lo, hi = np.minimum(lo, lo2), np.maximum(hi, hi2)
            prim_lo.append(lo)
            prim_hi.append(hi)
            prim_medium.append([_inside_medium_id(prim, mid), medium_id(prim.outside_medium)])

    n_prims = len(prim_kind)
    if n_prims == 0:
        log.warning("scene has no primitives")
        # pad with one degenerate (never-hit) triangle so device gathers
        # always have at least one row
        tri_p.append(np.full((1, 3, 3), 1e30))
        tri_p_e.append(np.full((1, 3, 3), 1e30))
        tri_p_m.append(np.full((1, 3, 3), 1e30))
        tri_n.append(np.tile(np.array([0.0, 0.0, 1.0]), (1, 3, 1)))
        tri_uv.append(np.zeros((1, 3, 2)))
        prim_kind.append(GEOM_TRI)
        prim_inst.append(0)
        prim_geom.append(0)
        prim_mat.append(0)
        prim_light.append(-1)
        prim_flags.append(0)
        prim_area.append(0.0)
        prim_lo.append(np.full(3, 1e30))
        prim_hi.append(np.full(3, 1e30))
        prim_medium.append([-1, -1])
        prim_alpha.append(-1)
        prim_shadow_alpha.append(-1)
        prim_anim_gid.append(0)
        prim_anim_c.append(_IDENT34)
        n_prims = 1

    # --- exact-motion groups: does any group actually rotate? If so, the
    # device uses the per-ray TRS interpolation (device/motion.py) and the
    # baked quadratic hull no longer bounds the trajectory — re-bound the
    # affected prims by dense-sampling the EXACT transform path (host
    # AnimatedTransform on the absolute (M0, M1) pair, matching the device
    # math) plus an inter-sample arc pad.
    _anim_parts = []
    has_rot_motion = False
    from ..core.transform import AnimatedTransform as _AT, Transform as _Tr

    for (m0, m1) in anim_group_mats:
        at = _AT(_Tr.from_matrix(m0), _Tr.from_matrix(m1), 0.0, 1.0)
        (t0_, q0_, s0_), (t1_, q1_, s1_) = at._parts()
        theta = float(np.arccos(np.clip(np.dot(q0_, q1_), -1.0, 1.0)))
        _anim_parts.append((t0_, q0_, s0_, t1_, q1_, s1_, theta))
        if theta > 1e-6:
            has_rot_motion = True
    if has_rot_motion and _rot_prims:
        N_T = 16
        m0inv_by_g = [np.linalg.inv(m0) for (m0, _m1) in anim_group_mats]
        at_by_g = [_AT(_Tr.from_matrix(m0), _Tr.from_matrix(m1), 0.0, 1.0)
                   for (m0, m1) in anim_group_mats]
        H_by_g = [[(at_by_g[g].interpolate(i / N_T).m @ m0inv_by_g[g])[:3, :]
                   for i in range(N_T + 1)] for g in range(len(anim_group_mats))]
        for (row, g, lo0, hi0) in _rot_prims:
            theta = _anim_parts[g][6]
            corners = np.array([[lo0[0], lo0[1], lo0[2]], [hi0[0], lo0[1], lo0[2]],
                                [lo0[0], hi0[1], lo0[2]], [hi0[0], hi0[1], lo0[2]],
                                [lo0[0], lo0[1], hi0[2]], [hi0[0], lo0[1], hi0[2]],
                                [lo0[0], hi0[1], hi0[2]], [hi0[0], hi0[1], hi0[2]]])
            pts = np.concatenate([(H[:, :3] @ corners.T).T + H[:, 3] for H in H_by_g[g]])
            # inter-sample chord deviation of a rotation arc: r * phi^2 / 8
            r = float(np.linalg.norm(hi0 - lo0)) * 0.5 + float(
                np.max(np.linalg.norm(pts - pts.mean(axis=0), axis=1)))
            pad = r * (theta / N_T) ** 2 / 8.0 + 1e-6
            prim_lo[row] = np.minimum(prim_lo[row], pts.min(axis=0) - pad)
            prim_hi[row] = np.maximum(prim_hi[row], pts.max(axis=0) + pad)

    # --- world bounds (exclude the never-hit padding row) ----------------------
    real_lo = [lo for lo in prim_lo if lo[0] < 1e29]
    real_hi = [hi for hi in prim_hi if hi[0] < 1e29]
    if real_lo:
        wlo = np.min(np.asarray(real_lo), axis=0)
        whi = np.max(np.asarray(real_hi), axis=0)
    else:
        wlo = np.zeros(3)
        whi = np.ones(3)
    wc = 0.5 * (wlo + whi)
    wr = float(np.linalg.norm(whi - wc)) + 1e-4

    # --- BVH -------------------------------------------------------------------
    use_brute = n_prims <= BRUTE_FORCE_MAX_PRIMS and len(inst_i2w_rows) == 1
    max_leaf = desc.accelerator_params.get("maxnodeprims", 4)
    split_method = {"sah": "sah", "middle": "middle", "equal": "equal",
                    "equalcounts": "equal", "hlbvh": "hlbvh"}.get(
        str(getattr(desc, "accelerator_params", {}).get("splitmethod", "sah")).lower(), "sah")
    bvh = build_bvh(np.asarray(prim_lo) if n_prims else np.zeros((0, 3)), np.asarray(prim_hi) if n_prims else np.zeros((0, 3)), max_leaf, split_method)

    # permute primitive rows into BVH leaf order so leaf primitive ranges are
    # CONTIGUOUS — packet traversal then reads prim data with uniform slices
    # instead of per-ray gathers (bvh_ids becomes the identity)
    if n_prims:
        perm = np.asarray(bvh.prim_ids, dtype=np.int64)
        inv = np.empty(n_prims, dtype=np.int64)
        inv[perm] = np.arange(n_prims)

        def _perm(lst):
            arr = list(lst)
            return [arr[i] for i in perm]

        prim_kind = _perm(prim_kind)
        prim_geom = _perm(prim_geom)
        prim_mat = _perm(prim_mat)
        prim_light = _perm(prim_light)
        prim_flags = _perm(prim_flags)
        prim_area = _perm(prim_area)
        prim_medium = _perm(prim_medium)
        prim_alpha = _perm(prim_alpha)
        prim_shadow_alpha = _perm(prim_shadow_alpha)
        # keep the AABB lists aligned with the permuted prim rows (the
        # kd-tree build below reads them)
        prim_lo = _perm(prim_lo)
        prim_hi = _perm(prim_hi)
        prim_anim_gid = _perm(prim_anim_gid)
        prim_anim_c = _perm(prim_anim_c)
        # remap prim references held by lights
        lights = [(k, p_, (int(inv[pr]) if pr >= 0 else -1), ns_) for (k, p_, pr, ns_) in lights]
        bvh.prim_ids = np.arange(n_prims, dtype=np.int32)

    # packed tables for the packet traversal kernel:
    # node_data (N, 12): min(3), max(3), off, n_prims, axis, pad(3)
    node_data = np.zeros((len(bvh.n_prims), 12), np.float32)
    node_data[:, 0:3] = bvh.bounds_min
    node_data[:, 3:6] = bvh.bounds_max
    node_data[:, 6] = bvh.offset
    node_data[:, 7] = bvh.n_prims
    node_data[:, 8] = bvh.axis
    # prim_test_data (P, 20): tri -> 9 vertex floats; quadric -> w2o rows
    # (12) + params[0:6] + quadric sub-kind (col 18) + pad. Partial-phimax
    # hyperboloids need params[6:12] (p1/p2 for the twisted phi clip,
    # hyperboloid.rs:96-105) — only then widen to 26 cols (19:25), keeping
    # the hot leaf-gather row narrow for every other scene
    _has_partial_hyp = any(
        k == QUADRIC_HYPERBOLOID and row[3] < 2.0 * np.pi - 1e-6
        for k, row in zip(sph_kind_l, sph_param)
    )
    ptd = np.zeros((max(n_prims, 1), 26 if _has_partial_hyp else 20), np.float32)
    # (filled vectorized below once the concatenated geometry tables exist)

    # --- materials (ensure at least one row) -----------------------------------
    if not mat_rows:
        mat_rows.append(_compile_material(HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.5, 0.5, 0.5]))}), tex_reg, lambda m: 0))

    mat_kind = np.array([r[0] for r in mat_rows], dtype=np.int32)
    mat_const = np.stack([r[1] for r in mat_rows]).astype(np.float32)
    mat_tex = np.stack([r[2] for r in mat_rows]).astype(np.int32)
    mat_remap = np.array([r[3] for r in mat_rows], dtype=np.int32)
    mat_bump = np.array([r[4] for r in mat_rows], dtype=np.int32)

    # --- lights ----------------------------------------------------------------
    n_lights = len(lights)
    if n_lights:
        light_kind = np.array([l[0] for l in lights], dtype=np.int32)
        light_param = np.stack([l[1] for l in lights]).astype(np.float32)
        light_prim = np.array([l[2] for l in lights], dtype=np.int32)
    else:
        light_kind = np.zeros(0, dtype=np.int32)
        light_param = np.zeros((0, 12), dtype=np.float32)
        light_prim = np.zeros(0, dtype=np.int32)

    inf_idx = -1
    has_env = False
    env_image = env_cond = env_marg = env_w2l = None
    for i, (k, _p, _pr, _ns) in enumerate(lights):
        if k == LIGHT_INFINITE:
            inf_idx = i
    if infinite_host is not None and infinite_host.image is not None:
        has_env = True
        scale_inf = (np.asarray(infinite_host.intensity, np.float64)
                     if infinite_host.intensity is not None else np.ones(3))
        img = np.asarray(infinite_host.image, dtype=np.float64) * scale_inf[None, None, :]
        env_image = jnp.asarray(img.astype(np.float32))
        # luminance-weighted 2D distribution with sin(theta) factor
        # (reference src/lights/infinite.rs:81; sampling.rs Distribution2D)
        h, w, _ = img.shape
        lum = y_of_rgb(img)
        theta = (np.arange(h) + 0.5) / h * np.pi
        f = lum * np.sin(theta)[:, None]
        row_sum = f.sum(axis=1)
        cond = np.zeros((h, w + 1))
        cond[:, 1:] = np.cumsum(f, axis=1)
        cond_int = cond[:, -1:].copy()
        cond = np.where(cond_int > 0, cond / np.maximum(cond_int, 1e-30), np.linspace(0, 1, w + 1)[None, :])
        marg = np.zeros(h + 1)
        marg[1:] = np.cumsum(row_sum)
        total = marg[-1]
        marg = marg / max(total, 1e-30)
        env_cond = jnp.asarray(cond.astype(np.float32))
        env_marg = jnp.asarray(marg.astype(np.float32))
        env_w2l = jnp.asarray(infinite_host.light_to_world.m_inv[:3, :].astype(np.float32))
        # replace the table intensity with the mean (used only for power heuristics)
        light_param[inf_idx, 3:6] = img.mean(axis=(0, 1))

    tex_param = np.stack(tex_reg.params).astype(np.float32) if tex_reg.params else np.zeros((1, 24), dtype=np.float32)

    def _cat(chunks, shape):
        if not chunks:
            return np.zeros((0,) + shape, dtype=np.float32)
        return np.concatenate([np.asarray(c, dtype=np.float32).reshape((-1,) + shape) for c in chunks], axis=0)

    tri_p_cat = _cat(tri_p, (3, 3))
    tri_pe_cat = _cat(tri_p_e, (3, 3)) if any_motion else tri_p_cat
    tri_pm_cat = _cat(tri_p_m, (3, 3)) if any_motion else tri_p_cat
    sph_w2o_cat = np.asarray(sph_w2o, dtype=np.float32).reshape(-1, 3, 4)
    sph_w2oe_cat = np.asarray(sph_w2o_e, dtype=np.float32).reshape(-1, 3, 4) if any_motion else sph_w2o_cat
    sph_w2om_cat = np.asarray(sph_w2o_m, dtype=np.float32).reshape(-1, 3, 4) if any_motion else sph_w2o_cat
    sph_param_cat = np.asarray(sph_param, dtype=np.float32).reshape(-1, 12)
    ptd_end = ptd.copy() if any_motion else ptd
    ptd_mid = ptd.copy() if any_rot_motion else ptd_end
    if n_prims:
        pk = np.asarray(prim_kind)
        pg = np.asarray(prim_geom)
        tri_rows = np.where(pk == GEOM_TRI)[0]
        sph_rows = np.where(pk == GEOM_SPHERE)[0]
        if len(tri_rows):
            ptd[tri_rows, 0:9] = tri_p_cat[pg[tri_rows]].reshape(len(tri_rows), 9)
            if any_motion:
                ptd_end[tri_rows, 0:9] = tri_pe_cat[pg[tri_rows]].reshape(len(tri_rows), 9)
            if any_rot_motion:
                ptd_mid[tri_rows, 0:9] = tri_pm_cat[pg[tri_rows]].reshape(len(tri_rows), 9)
        if len(sph_rows):
            sk = np.asarray(sph_kind_l, np.float32) if sph_kind_l else np.zeros(1, np.float32)
            ptd[sph_rows, 0:12] = sph_w2o_cat[pg[sph_rows]].reshape(len(sph_rows), 12)
            ptd[sph_rows, 12:18] = sph_param_cat[pg[sph_rows]][:, 0:6]
            ptd[sph_rows, 18] = sk[pg[sph_rows]]
            if _has_partial_hyp:
                ptd[sph_rows, 19:25] = sph_param_cat[pg[sph_rows]][:, 6:12]
            if any_motion:
                ptd_end[sph_rows, 0:12] = sph_w2oe_cat[pg[sph_rows]].reshape(len(sph_rows), 12)
                ptd_end[sph_rows, 12:18] = sph_param_cat[pg[sph_rows]][:, 0:6]
                ptd_end[sph_rows, 18] = sk[pg[sph_rows]]
                if _has_partial_hyp:
                    ptd_end[sph_rows, 19:25] = sph_param_cat[pg[sph_rows]][:, 6:12]
            if any_rot_motion:
                ptd_mid[sph_rows, 0:12] = sph_w2om_cat[pg[sph_rows]].reshape(len(sph_rows), 12)
                ptd_mid[sph_rows, 12:18] = sph_param_cat[pg[sph_rows]][:, 0:6]
                ptd_mid[sph_rows, 18] = sk[pg[sph_rows]]
                if _has_partial_hyp:
                    ptd_mid[sph_rows, 19:25] = sph_param_cat[pg[sph_rows]][:, 6:12]

    fourier_dev = _stack_fourier_tables(fourier_tables)

    # --- tabulated BSSRDF rows (bssrdf.rs compute_beam_diffusion_bssrdf +
    # TabulatedBSSRDF ctor): fold the albedo spline axis per material channel
    # so the device only interpolates 64-entry radial rows ---
    sss_arrays = {}
    has_tab_sss = bool(_sss_mats)
    if has_tab_sss:
        from ..core.bssrdf import catmull_rom_weights

        M = len(mat_rows)
        s_prof = np.zeros((M, 3, 64), np.float32)
        s_cdf = np.zeros((M, 3, 64), np.float32)
        s_rhoeff = np.zeros((M, 3), np.float32)
        s_sigt = np.zeros((M, 3), np.float32)
        s_eta = np.full((M,), 1.33, np.float32)
        radius_knots = None
        for mid, host_mat in _sss_mats.items():
            sig_a, sig_s, g_m, eta_m = _sss_coefficients(host_mat)
            tab = _sss_table_for(g_m, eta_m)
            radius_knots = tab["radius_samples"]
            sigma_t = sig_a + sig_s
            rho = np.where(sigma_t > 0, sig_s / np.maximum(sigma_t, 1e-12), 0.0)
            s_sigt[mid] = sigma_t
            s_eta[mid] = eta_m
            for ch in range(3):
                off, w = catmull_rom_weights(tab["rho_samples"].astype(np.float64), rho[ch])
                for k in range(4):
                    idx = int(np.clip(off + k, 0, len(tab["rho_samples"]) - 1))
                    s_prof[mid, ch] += np.float32(w[k]) * tab["profile"][idx]
                    s_cdf[mid, ch] += np.float32(w[k]) * tab["profile_cdf"][idx]
                    s_rhoeff[mid, ch] += np.float32(w[k]) * tab["rho_eff"][idx]
        sss_arrays = dict(
            sss_prof=jnp.asarray(s_prof),
            sss_cdf=jnp.asarray(s_cdf),
            sss_rhoeff=jnp.asarray(np.maximum(s_rhoeff, 1e-6)),
            sss_sigma_t=jnp.asarray(s_sigt),
            sss_eta=jnp.asarray(s_eta),
            sss_radius=jnp.asarray(radius_knots),
        )

    # --- kd-tree accelerator (Accelerator "kdtree"; scene/kdtree.py) ------
    accel_kind = str(getattr(desc, "accelerator", "bvh") or "bvh")
    if accel_kind not in ("bvh", "kdtree"):
        log.warning("unknown accelerator '%s'; using bvh", accel_kind)
        accel_kind = "bvh"
    kd = None
    if accel_kind == "kdtree" and len(inst_i2w_rows) > 1:
        log.warning("kd-tree accelerator does not support instancing; using bvh")
        accel_kind = "bvh"
    if accel_kind == "kdtree" and not use_brute and n_prims:
        from .kdtree import build_kdtree

        kd = build_kdtree(np.asarray(prim_lo), np.asarray(prim_hi))
    elif accel_kind == "kdtree":
        accel_kind = "bvh"  # tiny scenes use the brute-force path anyway

    # fused per-prim shading row (P, 32): verts(0:9) normals(9:18) uv(18:24)
    # kind(24) flags(25) mat(26) light(27) geom(28): surface_interaction's
    # ~8 per-hit lookups become ONE row gather. Triangle rows only; quadrics
    # keep their table gathers (tiny counts).
    _np_prim_kind = np.asarray(prim_kind, dtype=np.int32)
    _np_prim_geom = np.asarray(prim_geom, dtype=np.int32)
    shade_tab = np.zeros((max(len(_np_prim_kind), 1), 32), np.float32)
    _tri_rows = np.nonzero(_np_prim_kind == GEOM_TRI)[0]
    _tn_cat = _cat(tri_n, (3, 3))
    _tuv_cat = _cat(tri_uv, (3, 2))
    if len(_tri_rows) and len(tri_p_cat):
        _g = _np_prim_geom[_tri_rows]
        shade_tab[_tri_rows, 0:9] = np.asarray(tri_p_cat, np.float32).reshape(-1, 9)[_g]
        shade_tab[_tri_rows, 9:18] = np.asarray(_tn_cat, np.float32).reshape(-1, 9)[_g]
        shade_tab[_tri_rows, 18:24] = np.asarray(_tuv_cat, np.float32).reshape(-1, 6)[_g]
    shade_tab[:, 24] = _np_prim_kind
    shade_tab[:, 25] = np.asarray(prim_flags, np.float32)
    shade_tab[:, 26] = np.asarray(prim_mat, np.float32)
    shade_tab[:, 27] = np.asarray(prim_light, np.float32)
    shade_tab[:, 28] = _np_prim_geom

    arrays = SceneArrays(
        prim_shade_tab=jnp.asarray(shade_tab),
        tri_p=jnp.asarray(tri_p_cat),
        tri_n=jnp.asarray(_tn_cat),
        tri_uv=jnp.asarray(_tuv_cat),
        sph_o2w=jnp.asarray(np.asarray(sph_o2w, dtype=np.float32).reshape(-1, 3, 4)),
        sph_w2o=jnp.asarray(np.asarray(sph_w2o, dtype=np.float32).reshape(-1, 3, 4)),
        sph_param=jnp.asarray(np.asarray(sph_param, dtype=np.float32).reshape(-1, 12)),
        sph_kind=jnp.asarray(np.asarray(sph_kind_l, dtype=np.int32)),
        prim_kind=jnp.asarray(np.asarray(prim_kind, dtype=np.int32)),
        prim_geom=jnp.asarray(np.asarray(prim_geom, dtype=np.int32)),
        prim_mat=jnp.asarray(np.asarray(prim_mat, dtype=np.int32)),
        prim_light=jnp.asarray(np.asarray(prim_light, dtype=np.int32)),
        prim_flags=jnp.asarray(np.asarray(prim_flags, dtype=np.int32)),
        prim_area=jnp.asarray(np.asarray(prim_area, dtype=np.float32)),
        tri_prim_ids=jnp.asarray(_geom_to_prim_map(prim_kind, prim_geom, GEOM_TRI, len(tri_p_cat))),
        sph_prim_ids=jnp.asarray(_geom_to_prim_map(prim_kind, prim_geom, GEOM_SPHERE, len(sph_o2w))),
        bvh_min=jnp.asarray(bvh.bounds_min),
        bvh_max=jnp.asarray(bvh.bounds_max),
        bvh_off=jnp.asarray(bvh.offset),
        bvh_n=jnp.asarray(bvh.n_prims),
        bvh_axis=jnp.asarray(bvh.axis),
        bvh_ids=jnp.asarray(bvh.prim_ids),
        bvh_packed=jnp.asarray(node_data),
        prim_test_data=jnp.asarray(ptd),
        tri_p_end=jnp.asarray(tri_pe_cat) if any_motion else None,
        sph_w2o_end=jnp.asarray(sph_w2oe_cat) if any_motion else None,
        sph_o2w_end=jnp.asarray(np.asarray(sph_o2w_e, dtype=np.float32).reshape(-1, 3, 4)) if any_motion else None,
        prim_test_data_end=jnp.asarray(ptd_end) if any_motion else None,
        tri_p_mid=jnp.asarray(tri_pm_cat) if any_rot_motion else None,
        sph_w2o_mid=jnp.asarray(sph_w2om_cat) if any_rot_motion else None,
        sph_o2w_mid=jnp.asarray(np.asarray(sph_o2w_m, dtype=np.float32).reshape(-1, 3, 4)) if any_rot_motion else None,
        prim_test_data_mid=jnp.asarray(ptd_mid) if any_rot_motion else None,
        mat_kind=jnp.asarray(mat_kind),
        mat_const=jnp.asarray(mat_const),
        mat_tex=jnp.asarray(mat_tex),
        mat_remap=jnp.asarray(mat_remap),
        mat_bump=jnp.asarray(mat_bump),
        light_kind=jnp.asarray(light_kind),
        light_param=jnp.asarray(light_param),
        light_prim=jnp.asarray(light_prim),
        light_w2l=jnp.asarray(np.asarray(light_w2l_rows, dtype=np.float32).reshape(-1, 3, 4)),
        light_images=light_images,
        prim_medium=jnp.asarray(np.asarray(prim_medium, dtype=np.int32).reshape(-1, 2)),
        med_param=jnp.asarray(np.asarray(med_param_rows, dtype=np.float32).reshape(-1, 8)),
        med_w2m=jnp.asarray(np.asarray(med_w2m_rows, dtype=np.float32).reshape(-1, 3, 4)),
        med_grids=med_grids,
        world_center=jnp.asarray(wc.astype(np.float32)),
        world_radius=jnp.asarray(np.float32(wr)),
        tex_images=tex_reg.images,
        tex_param=jnp.asarray(tex_param),
        env_image=env_image,
        env_cond_cdf=env_cond,
        env_marg_cdf=env_marg,
        env_w2l=env_w2l,
        fourier=fourier_dev,
        kd_flags=jnp.asarray(kd.flags) if kd is not None else None,
        kd_split=jnp.asarray(kd.split) if kd is not None else None,
        kd_above=jnp.asarray(kd.above) if kd is not None else None,
        kd_nprims=jnp.asarray(kd.nprims) if kd is not None else None,
        kd_prim_ids=jnp.asarray(kd.prim_ids) if kd is not None else None,
        kd_lo=jnp.asarray(kd.bounds_lo.astype(np.float32)) if kd is not None else None,
        kd_hi=jnp.asarray(kd.bounds_hi.astype(np.float32)) if kd is not None else None,
        prim_alpha_tex=jnp.asarray(np.asarray(prim_alpha, dtype=np.int32)),
        prim_inst=jnp.asarray(np.asarray(prim_inst, dtype=np.int32)),
        inst_i2w=jnp.asarray(np.asarray(inst_i2w_rows, dtype=np.float32).reshape(-1, 3, 4)),
        inst_w2i=jnp.asarray(np.asarray(inst_w2i_rows, dtype=np.float32).reshape(-1, 3, 4)),
        prim_shadow_alpha_tex=jnp.asarray(np.asarray(prim_shadow_alpha, dtype=np.int32)),
        anim=(dict(
            q0=jnp.asarray(np.stack([p[1] for p in _anim_parts]).astype(np.float32)),
            q1=jnp.asarray(np.stack([p[4] for p in _anim_parts]).astype(np.float32)),
            t0=jnp.asarray(np.stack([p[0] for p in _anim_parts]).astype(np.float32)),
            t1=jnp.asarray(np.stack([p[3] for p in _anim_parts]).astype(np.float32)),
            s0=jnp.asarray(np.stack([p[2] for p in _anim_parts]).astype(np.float32)),
            s1=jnp.asarray(np.stack([p[5] for p in _anim_parts]).astype(np.float32)),
            theta=jnp.asarray(np.asarray([p[6] for p in _anim_parts], np.float32)),
        ) if has_rot_motion else None),
        anim_gid=(jnp.asarray(np.asarray(prim_anim_gid, np.int32))
                  if has_rot_motion else None),
        anim_c=(jnp.asarray(np.stack(prim_anim_c).astype(np.float32))
                if has_rot_motion else None),
        **sss_arrays,
    )
    static = SceneStatic(
        n_tris=len(tri_p_cat),
        n_spheres=len(sph_o2w),
        n_prims=n_prims,
        n_nodes=len(bvh.n_prims),
        n_materials=len(mat_rows),
        n_lights=n_lights,
        light_n_samples=tuple(l[3] for l in lights),
        n_delta_lights=sum(1 for l in lights if l[0] in (LIGHT_POINT, LIGHT_SPOT, LIGHT_DISTANT)),
        max_leaf=max_leaf,
        mat_kinds_present=tuple(sorted(set(int(k) for k in mat_kind))),
        tex_programs=tuple(tex_reg.programs),
        has_infinite=inf_idx >= 0,
        infinite_light_index=inf_idx,
        has_env_map=has_env,
        has_area_lights=any(l[0] == LIGHT_AREA for l in lights),
        has_cone_sphere_lights=any(
            l[0] == LIGHT_AREA
            and prim_kind[l[2]] == GEOM_SPHERE
            and sph_kind_l[prim_geom[l[2]]] == QUADRIC_SPHERE
            and sph_param[prim_geom[l[2]]][1] <= -sph_param[prim_geom[l[2]]][0] * (1 - 1e-6)
            and sph_param[prim_geom[l[2]]][2] >= sph_param[prim_geom[l[2]]][0] * (1 - 1e-6)
            and sph_param[prim_geom[l[2]]][3] >= 2.0 * np.pi - 1e-6
            and (prim_flags[l[2]] & FLAG_REVERSE_ORIENTATION) == 0
            for l in lights
        ),
        use_brute_force=use_brute,
        n_media=len(med_param_rows),
        media_kinds=tuple(media_kinds),
        camera_medium=med_ids.get(desc.camera_medium, -1),
        has_sss_media=bool(_sss_media),
        sss_media=tuple(med_ids[n] for n in _sss_media.values()),
        has_tab_sss=has_tab_sss,
        has_instances=len(inst_i2w_rows) > 1,
        has_null_material=any(int(k) == 0 for k in mat_kind[np.asarray(prim_mat, dtype=np.int64)]) if n_prims else False,
        light_image_keys=tuple(light_image_keys),
        light_kinds=tuple(int(l[0]) for l in lights),
        has_fourier=bool(fourier_dev),
        has_motion=any_motion,
        has_rot_motion=has_rot_motion,
        has_beckmann=bool(np.any((mat_remap & 2) != 0)),
        has_bump=bool(np.any(mat_bump >= 0)),
        has_alpha=any(a >= 0 for a in prim_alpha) or any(a >= 0 for a in prim_shadow_alpha),
        accel_kind=accel_kind if kd is not None else "bvh",
        kd_max_leaf=int(kd.max_leaf) if kd is not None else 1,
    )
    return CompiledScene(arrays=arrays, static=static, description=desc)


def _hair_sigma_a_from_reflectance(c, beta_n):
    """hair.rs sigmaa_from_reflectance :291-306."""
    bn = float(beta_n)
    denom = 5.969 - 0.215 * bn + 2.532 * bn ** 2 - 10.73 * bn ** 3 + 5.574 * bn ** 4 + 0.245 * bn ** 5
    return (np.log(np.clip(np.asarray(c, np.float64), 1e-4, 1.0)) / denom) ** 2


def _hair_sigma_a_from_concentration(ce: float, cp: float):
    """hair.rs sigmaa_from_concentration :279-289 (eumelanin/pheomelanin)."""
    return ce * np.array([0.419, 0.697, 1.37]) + cp * np.array([0.187, 0.4, 1.05])


def _stack_fourier_tables(tables: list[dict]) -> dict:
    """Stack per-path FourierBSDF tables into one padded device block
    (layout consumed by device/fourier.py). Padding rules: mu nodes keep
    strictly increasing past the real range (interval search never selects
    them for in-range cosines), coefficient rows pad with zeros, and cdf
    columns pad with a steep ramp so the sampling inversion can't land in
    padding. Single-table scenes (the common case) get zero padding."""
    if not tables:
        return {}
    nmu_max = max(t["nmu"] for t in tables)
    mcap_max = max(t["m_cap"] for t in tables)
    nt = len(tables)
    mu_s = np.zeros((nt, nmu_max), np.float32)
    a_s = np.zeros((nt, nmu_max * nmu_max, 3 * mcap_max), np.float32)
    a0_s = np.zeros((nt, nmu_max, nmu_max), np.float32)
    cdf_s = np.zeros((nt, nmu_max, nmu_max), np.float32)
    eta_s = np.zeros((nt,), np.float32)
    for ti, t in enumerate(tables):
        n, mc = t["nmu"], t["m_cap"]
        mu_s[ti, :n] = t["mu"]
        if n < nmu_max:
            mu_s[ti, n:] = t["mu"][-1] + 1e-3 * np.arange(1, nmu_max - n + 1, dtype=np.float32)
        grid = np.zeros((nmu_max, nmu_max, 3, mcap_max), np.float32)
        grid[:n, :n, :, :mc] = t["a"].reshape(n, n, 3, mc)  # rows [o, i]
        a_s[ti] = grid.reshape(nmu_max * nmu_max, 3 * mcap_max)
        a0_s[ti, :n, :n] = t["a0"]
        cdf_s[ti, :n, :n] = t["cdf"]
        if n < nmu_max:
            step = max(1.0, float(t["cdf"].max()))
            ramp = t["cdf"][:, -1:] + step * np.arange(1, nmu_max - n + 1, dtype=np.float32)[None, :]
            cdf_s[ti, :n, n:] = ramp
            cdf_s[ti, n:, :] = cdf_s[ti, n - 1 : n, :]
        eta_s[ti] = t["eta"]
    return {
        "mu": jnp.asarray(mu_s),
        "aflat": jnp.asarray(a_s),
        "a0": jnp.asarray(a0_s),
        "cdf": jnp.asarray(cdf_s),
        "eta": jnp.asarray(eta_s),
    }


def _compile_material(mat: HostMaterial, tex_reg: _TextureRegistry, register_material=None, register_fourier=None):
    """HostMaterial -> (kind_id, const (N_MAT_PARAMS,3), tex (N_MAT_PARAMS,), remap)."""
    kind = MAT_IDS.get(mat.kind, None)
    if kind is None:
        kind = MAT_MATTE
    const = np.zeros((N_MAT_PARAMS, 3), dtype=np.float64)
    tex = np.full(N_MAT_PARAMS, -1, dtype=np.int64)
    remap = 1

    # per-kind parameter defaults (reference src/materials/*.rs create_* fns)
    defaults = {
        "matte": {"Kd": 0.5},
        "mirror": {"Kr": 0.9},
        "glass": {"Kr": 1.0, "Kt": 1.0},
        "plastic": {"Kd": 0.25, "Ks": 0.25, "roughness": 0.1},
        "metal": {"roughness": 0.01},
        "uber": {"Kd": 0.25, "Ks": 0.25, "roughness": 0.1},
        "substrate": {"Kd": 0.5, "Ks": 0.5, "uroughness": 0.1, "vroughness": 0.1},
        "translucent": {"Kd": 0.25, "Ks": 0.25, "roughness": 0.1, "reflect": 0.5, "transmit": 0.5},
    }.get(mat.kind, {})
    for name, dv in defaults.items():
        if name not in mat.params:
            mat.params = dict(mat.params)
            mat.params[name] = ("const", np.array([dv, dv, dv]))
    if mat.kind == "metal" and "eta" not in mat.params:
        from ..core.spectrum import copper_eta_k_rgb

        cu_eta, cu_k = copper_eta_k_rgb()
        mat.params = dict(mat.params)
        mat.params["eta"] = ("const", np.asarray(cu_eta))
        mat.params.setdefault("k", ("const", np.asarray(cu_k)))

    def put(slot, name, default=None):
        src = mat.params.get(name)
        if src is None:
            if default is not None:
                const[slot] = default
            return
        if src[0] == "const":
            v = np.atleast_1d(np.asarray(src[1], dtype=np.float64)).ravel()
            const[slot] = np.repeat(v, 3)[:3] if v.size == 1 else v[:3]
        else:
            c, t = tex_reg.register_source(src)
            tex[slot] = t

    put(P_KD, "Kd")
    put(P_SIGMA, "sigma")
    put(P_KR, "Kr")
    put(P_KT, "Kt")
    put(P_KS, "Ks")
    put(P_OPACITY, "opacity", default=[1.0, 1.0, 1.0])
    put(P_REFLECT, "reflect")
    put(P_TRANSMIT, "transmit")

    # eta: scalar (glass/uber) or rgb (metal)
    eta_src = mat.params.get("eta")
    if eta_src is not None:
        if eta_src[0] == "const":
            v = np.atleast_1d(np.asarray(eta_src[1], dtype=np.float64)).ravel()
            const[P_ETA] = np.repeat(v, 3)[:3] if v.size == 1 else v[:3]
        else:
            tex[P_ETA] = tex_reg.register_source(eta_src)[1]
    else:
        const[P_ETA] = 1.5
    put(P_K, "k")

    # roughness: materials with a single 'roughness' use it for both u/v
    # unless uroughness/vroughness are given (reference uber.rs, metal.rs).
    r_src = mat.params.get("roughness")
    u_src = mat.params.get("uroughness")
    v_src = mat.params.get("vroughness")

    def put_src(slot, src):
        if src is None:
            return False
        if src[0] == "const":
            v = np.atleast_1d(np.asarray(src[1], dtype=np.float64)).ravel()
            const[slot] = np.repeat(v, 3)[:3] if v.size == 1 else v[:3]
        else:
            tex[slot] = tex_reg.register_source(src)[1]
        return True

    if not put_src(P_UROUGH, u_src):
        put_src(P_UROUGH, r_src)
    if not put_src(P_VROUGH, v_src):
        put_src(P_VROUGH, r_src)

    dist = mat.params.get("distribution")
    beckmann = dist is not None and str(dist[1]).lower() == "beckmann"
    rm = mat.params.get("remaproughness")
    if rm is not None and rm[0] == "const":
        remap = 1 if rm[1] else 0

    from .arrays import MAT_DISNEY, MAT_FOURIER, MAT_HAIR, MAT_KDSUBSURFACE, MAT_MATTE as _MATTE, MAT_MIX, MAT_SUBSURFACE, P_EXTRA, P_EXTRA2

    if kind == MAT_FOURIER:
        # tabulated BSDF (materials/fourier.rs): load the SCATFUN file at
        # compile time; unreadable tables degrade to matte like the reference
        src = mat.params.get("bsdffile")
        tid = -1
        if register_fourier is not None and src is not None and src[0] == "const":
            tid = register_fourier(str(src[1]))
        if tid < 0:
            kind = _MATTE
        else:
            const[P_EXTRA][0] = tid

    if kind == MAT_MIX:
        # amount texture/const -> P_KD slot; sub-material rows -> P_EXTRA
        put(P_KD, "amount", default=[0.5, 0.5, 0.5])
        m1 = mat.params.get("material1")
        m2 = mat.params.get("material2")
        if register_material is not None and m1 is not None and m2 is not None:
            const[P_EXTRA][0] = register_material(m1[1])
            const[P_EXTRA][1] = register_material(m2[1])
        else:
            kind = MAT_MATTE

    elif kind == MAT_DISNEY:
        # disney.rs parameter layout: color->Kd; metallic/clearcoat/gloss in
        # P_EXTRA; sheen/spectrans/speculartint in P_EXTRA2
        put(P_KD, "color", default=[0.5, 0.5, 0.5])

        def put_scalar(slot, comp, name, default):
            src_p = mat.params.get(name)
            if src_p is not None and src_p[0] == "const":
                v = np.atleast_1d(np.asarray(src_p[1], dtype=np.float64)).ravel()
                const[slot][comp] = v[0]
            else:
                const[slot][comp] = default

        put_scalar(P_EXTRA, 0, "metallic", 0.0)
        put_scalar(P_EXTRA, 1, "clearcoat", 0.0)
        put_scalar(P_EXTRA, 2, "clearcoatgloss", 1.0)
        put_scalar(P_EXTRA2, 0, "sheen", 0.0)
        put_scalar(P_EXTRA2, 1, "spectrans", 0.0)
        put_scalar(P_EXTRA2, 2, "speculartint", 0.0)

    elif kind == MAT_HAIR:
        # materials/hair.rs create_hair_material :604-651: sigma_a > color >
        # melanin precedence; const-value conversions happen here so the
        # device sees final sigma_a whenever possible (mode 0); textured
        # color defers the reflectance inversion to the device (mode 1)
        remap = 0
        if "eta" not in mat.params:
            const[P_ETA] = 1.55
        if not put_src(P_UROUGH, mat.params.get("beta_m")):
            const[P_UROUGH] = 0.3
        if not put_src(P_VROUGH, mat.params.get("beta_n")):
            const[P_VROUGH] = 0.3
        alpha_src = mat.params.get("alpha")
        const[P_EXTRA][0] = float(np.ravel(alpha_src[1])[0]) if alpha_src is not None and alpha_src[0] == "const" else 2.0
        mode = 0.0
        bn_for_conv = const[P_VROUGH][0] if tex[P_VROUGH] < 0 else 0.3
        if "sigma_a" in mat.params:
            put(P_KD, "sigma_a")
        elif "color" in mat.params:
            csrc = mat.params["color"]
            if csrc[0] == "const":
                const[P_KD] = _hair_sigma_a_from_reflectance(np.asarray(csrc[1], np.float64), bn_for_conv)
            else:
                put(P_KD, "color")
                mode = 1.0
        elif "eumelanin" in mat.params or "pheomelanin" in mat.params:
            def _c(nm):
                s = mat.params.get(nm)
                if s is None:
                    return 0.0
                if s[0] != "const":
                    log.warning("hair: textured %s unsupported; using 0", nm)
                    return 0.0
                return max(float(np.ravel(s[1])[0]), 0.0)

            const[P_KD] = _hair_sigma_a_from_concentration(_c("eumelanin"), _c("pheomelanin"))
        else:
            const[P_KD] = _hair_sigma_a_from_concentration(1.3, 0.0)
        const[P_EXTRA][1] = mode

    elif kind in (MAT_SUBSURFACE, MAT_KDSUBSURFACE):
        # surface BSDF part (glass-like interface); BSSRDF tables handled by
        # the subsurface transport stage
        if not np.any(const[P_KR]):
            const[P_KR] = 1.0
        if not np.any(const[P_KT]):
            const[P_KT] = 1.0

    # bump map: float displacement texture (material.rs:46-87 bump(), applied
    # by every material's compute_scattering_functions). A constant source
    # has zero gradient -> no displacement effect, so only real textures
    # register; -1 = un-bumped.
    bump_tid = -1
    bsrc = getattr(mat, "bump_map", None)
    if bsrc is not None and bsrc[0] == "texture":
        bump_tid = tex_reg.register(bsrc[1])

    return kind, const, tex, remap | (2 if beckmann else 0), bump_tid
