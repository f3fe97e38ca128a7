"""Light sampling: sample_li / pdf_li / escaped-ray radiance, batched.

Replaces the reference's Light trait dispatch (src/core/light.rs:47-76,
src/lights/*) with masked evaluation over the typed light table. Area lights
reference their primitive row (one light row per emitting triangle/sphere,
matching the reference's per-shape DiffuseAreaLight creation,
src/core/api.rs:1535-1542).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..scene.arrays import (
    GEOM_SPHERE,
    GEOM_TRI,
    LIGHT_AREA,
    LIGHT_DISTANT,
    LIGHT_GONIO,
    LIGHT_INFINITE,
    LIGHT_POINT,
    LIGHT_PROJECTION,
    LIGHT_SPOT,
    SceneArrays,
    SceneStatic,
)
from .affine import xf_vector, xf_vector_t
from .intersect import _xform_point

F32 = jnp.float32
TWO_PI = 2.0 * jnp.pi
INV_4PI = 1.0 / (4.0 * jnp.pi)


def _norm(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sample_triangle(u1, u2):
    su0 = jnp.sqrt(jnp.maximum(u1, 0.0))
    return 1.0 - su0, u2 * su0


# ---------------------------------------------------------------------------
# Environment map machinery (src/lights/infinite.rs + sampling.rs Distribution2D)
# ---------------------------------------------------------------------------


def _env_dir_to_uv(sa: SceneArrays, d):
    """World direction -> env map (u, v) in [0,1)^2."""
    if sa.env_w2l is not None:
        dl = xf_vector(sa.env_w2l[:3, :3], d)
    else:
        dl = d
    dl = _norm(dl)
    theta = jnp.arccos(jnp.clip(dl[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(dl[..., 1], dl[..., 0])
    phi = jnp.where(phi < 0, phi + TWO_PI, phi)
    return phi / TWO_PI, theta / jnp.pi, theta


def env_le(sa: SceneArrays, static: SceneStatic, d):
    """Escaped-ray radiance from the infinite light (infinite.rs le :120)."""
    if not static.has_infinite:
        return jnp.zeros(d.shape[:-1] + (3,), F32)
    li = sa.light_param[static.infinite_light_index]
    if not static.has_env_map:
        return jnp.broadcast_to(li[3:6], d.shape[:-1] + (3,))
    u, v, _ = _env_dir_to_uv(sa, d)
    img = sa.env_image
    h, w, _c = img.shape
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return img[y, x]


def _env_sample(sa: SceneArrays, u1, u2):
    """Sample direction from the env importance distribution.

    Returns (d_world, li, pdf_solid_angle)."""
    marg = sa.env_marg_cdf  # (H+1,)
    cond = sa.env_cond_cdf  # (H, W+1)
    h = cond.shape[0]
    w = cond.shape[1] - 1
    # sample marginal (row)
    row = jnp.clip(jnp.searchsorted(marg, u1, side="right") - 1, 0, h - 1)
    m0 = marg[row]
    m1 = marg[row + 1]
    dv = jnp.where(m1 > m0, (u1 - m0) / jnp.maximum(m1 - m0, 1e-30), 0.5)
    v = (row.astype(F32) + dv) / h
    pdf_v = (m1 - m0) * h
    # sample conditional (column) — per-row CDF gather
    crow = cond[row]  # (R, W+1)
    col = jnp.clip(_searchsorted_rows(crow, u2) - 1, 0, w - 1)
    r = jnp.arange(col.shape[0])
    c0 = crow[r, col]
    c1 = crow[r, col + 1]
    du = jnp.where(c1 > c0, (u2 - c0) / jnp.maximum(c1 - c0, 1e-30), 0.5)
    u = (col.astype(F32) + du) / w
    pdf_u = (c1 - c0) * w

    theta = v * jnp.pi
    phi = u * TWO_PI
    sin_t = jnp.sin(theta)
    dl = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), jnp.cos(theta)], axis=-1)
    if sa.env_w2l is not None:
        # light-to-world = transpose of the rotation part of w2l
        dw = xf_vector_t(sa.env_w2l[:3, :3], dl)
    else:
        dw = dl
    img = sa.env_image
    hh, ww, _ = img.shape
    x = jnp.clip((u * ww).astype(jnp.int32), 0, ww - 1)
    y = jnp.clip((v * hh).astype(jnp.int32), 0, hh - 1)
    li = img[y, x]
    pdf = jnp.where(sin_t > 1e-7, pdf_u * pdf_v / (2.0 * jnp.pi * jnp.pi * jnp.maximum(sin_t, 1e-7)), 0.0)
    return dw, li, pdf


def _searchsorted_rows(cdf_rows, u):
    """Per-row searchsorted: cdf_rows (R, N), u (R,) -> (R,) index."""
    return jnp.sum(cdf_rows <= u[:, None], axis=-1).astype(jnp.int32)


def env_pdf_li(sa: SceneArrays, static: SceneStatic, d):
    """Solid-angle pdf that _env_sample would produce direction d."""
    if not static.has_env_map:
        return jnp.full(d.shape[:-1], INV_4PI, F32)
    u, v, theta = _env_dir_to_uv(sa, d)
    marg = sa.env_marg_cdf
    cond = sa.env_cond_cdf
    h = cond.shape[0]
    w = cond.shape[1] - 1
    row = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    col = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    pdf_v = (marg[row + 1] - marg[row]) * h
    r_idx = jnp.arange(row.shape[0]) if row.ndim == 1 else None
    crow = cond[row]
    if row.ndim == 1:
        c0 = crow[r_idx, col]
        c1 = crow[r_idx, col + 1]
    else:
        c0 = jnp.take_along_axis(crow, col[..., None], axis=-1)[..., 0]
        c1 = jnp.take_along_axis(crow, col[..., None] + 1, axis=-1)[..., 0]
    pdf_u = (c1 - c0) * w
    sin_t = jnp.sin(theta)
    return jnp.where(sin_t > 1e-7, pdf_u * pdf_v / (2.0 * jnp.pi * jnp.pi * jnp.maximum(sin_t, 1e-7)), 0.0)


def _image_light_scale(sa: SceneArrays, static: SceneStatic, lid, kind, w_from_light, par, fall):
    """Direction-dependent intensity scale for goniometric / projection
    lights (src/lights/goniometric.rs spherical map lookup; projection.rs
    perspective screen lookup within the fov cone)."""
    from .texture import image_bilinear

    for i, key in enumerate(static.light_image_keys):
        if key is None:
            continue
        img = sa.light_images[key]
        w2l = sa.light_w2l[i]
        wl = _norm(xf_vector(w2l[:3, :3], w_from_light))
        is_this = lid == i
        if static.light_kinds[i] == LIGHT_GONIO:
            # spherical (theta, phi) -> (u, v) (goniometric.rs scale())
            theta = jnp.arccos(jnp.clip(wl[:, 2], -1.0, 1.0))
            phi = jnp.arctan2(wl[:, 1], wl[:, 0])
            phi = jnp.where(phi < 0, phi + TWO_PI, phi)
            val = image_bilinear(img, phi / TWO_PI, 1.0 - theta / jnp.pi)
            fall = jnp.where(is_this[:, None], val, fall)
        else:  # projection
            tan_half = par[:, 9]
            aspect = par[:, 10]
            behind = wl[:, 2] < 1e-3
            sx = wl[:, 0] / jnp.maximum(wl[:, 2], 1e-6) / jnp.maximum(tan_half * jnp.maximum(aspect, 1.0), 1e-6)
            sy = wl[:, 1] / jnp.maximum(wl[:, 2], 1e-6) / jnp.maximum(tan_half / jnp.minimum(jnp.maximum(aspect, 1e-6), 1.0), 1e-6)
            inside = ~behind & (jnp.abs(sx) <= 1.0) & (jnp.abs(sy) <= 1.0)
            val = image_bilinear(img, 0.5 * (sx + 1.0), 0.5 * (sy + 1.0))
            fall = jnp.where(is_this[:, None], jnp.where(inside[:, None], val, 0.0), fall)
    return fall


# ---------------------------------------------------------------------------
# Area-light geometry sampling
# ---------------------------------------------------------------------------


def _sample_prim_point(sa: SceneArrays, prim_ids, u1, u2):
    """Uniformly sample a point on the primitive's surface.

    Returns (p, n, area). Triangles: uniform barycentric (sampling.rs:147);
    spheres: uniform area sampling (sphere.rs sample).
    """
    prim = jnp.maximum(prim_ids, 0)
    kind = sa.prim_kind[prim]
    geom = sa.prim_geom[prim]
    flags = sa.prim_flags[prim]
    area = sa.prim_area[prim]
    R = prim.shape[0]
    p = jnp.zeros((R, 3), F32)
    n = jnp.zeros((R, 3), F32)
    is_tri = kind == GEOM_TRI

    if sa.tri_p.shape[0] > 0:
        ti = jnp.where(is_tri, geom, 0)
        tv = sa.tri_p[ti]
        b0, b1 = uniform_sample_triangle(u1, u2)
        pt = b0[:, None] * tv[:, 0] + b1[:, None] * tv[:, 1] + (1.0 - b0 - b1)[:, None] * tv[:, 2]
        e1 = tv[:, 1] - tv[:, 0]
        e2 = tv[:, 2] - tv[:, 0]
        nt = _norm(jnp.cross(e1, e2))
        nt = jnp.where(((flags & 1) != 0)[:, None], -nt, nt)
        p = jnp.where(is_tri[:, None], pt, p)
        n = jnp.where(is_tri[:, None], nt, n)

    if sa.sph_param.shape[0] > 0:
        from ..scene.arrays import (
            QUADRIC_CONE, QUADRIC_CYLINDER, QUADRIC_DISK, QUADRIC_HYPERBOLOID,
            QUADRIC_PARABOLOID,
        )

        si = jnp.where(~is_tri, geom, 0)
        o2w = sa.sph_o2w[si]
        w2o = sa.sph_w2o[si]
        par = sa.sph_param[si]
        qk = sa.sph_kind[si]
        is_cyl = qk == QUADRIC_CYLINDER
        is_disk = qk == QUADRIC_DISK
        is_cone = qk == QUADRIC_CONE
        is_para = qk == QUADRIC_PARABOLOID
        radius = par[:, 0]
        phimax = par[:, 3]
        # sphere: uniform area (sphere.rs sample)
        d = uniform_sample_sphere(u1, u2)
        p_sph = d * radius[:, None]
        n_sph = d
        # cylinder: z = lerp(u1, zmin, zmax), phi = u2 * phimax (cylinder.rs)
        z_c = par[:, 1] + u1 * (par[:, 2] - par[:, 1])
        phi_c = u2 * phimax
        cphi = jnp.cos(phi_c)
        sphi = jnp.sin(phi_c)
        p_cyl = jnp.stack([radius * cphi, radius * sphi, z_c], axis=-1)
        n_cyl = jnp.stack([cphi, sphi, jnp.zeros_like(cphi)], axis=-1)
        # disk: concentric full-disk sample scaled to radius (disk.rs sample)
        from .camera import concentric_sample_disk

        dx, dy = concentric_sample_disk(u1, u2)
        p_dsk = jnp.stack([dx * radius, dy * radius, par[:, 1]], axis=-1)
        n_dsk = jnp.stack([jnp.zeros_like(dx), jnp.zeros_like(dx), jnp.ones_like(dx)], axis=-1)
        # cone: exact uniform area — circumference ~ (1 - v), so
        # v = 1 - sqrt(1 - u1) (the reference's cone errors on sample())
        h_cone = jnp.abs(par[:, 1])
        v_cn = 1.0 - jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
        r_cn = radius * (1.0 - v_cn)
        p_cn = jnp.stack([r_cn * cphi, r_cn * sphi, v_cn * h_cone], axis=-1)
        k_cn = (radius / jnp.maximum(h_cone, 1e-9)) ** 2
        n_cn = jnp.stack([p_cn[:, 0], p_cn[:, 1], k_cn * (h_cone - p_cn[:, 2])], axis=-1)
        n_cn = _norm(n_cn)
        # paraboloid: density ~ r(z) = sqrt(z) (slant factor neglected;
        # the reference errors on sample() entirely)
        zlo = jnp.maximum(par[:, 1], 0.0)
        zhi = jnp.maximum(par[:, 2], 1e-9)
        z15 = zlo ** 1.5 + u1 * (zhi ** 1.5 - zlo ** 1.5)
        z_p = jnp.maximum(z15, 0.0) ** (2.0 / 3.0)
        r_p = radius * jnp.sqrt(z_p / zhi)
        p_pa = jnp.stack([r_p * cphi, r_p * sphi, z_p], axis=-1)
        k_pa = zhi / jnp.maximum(radius * radius, 1e-20)
        n_pa = _norm(jnp.stack([2.0 * k_pa * p_pa[:, 0], 2.0 * k_pa * p_pa[:, 1],
                                -jnp.ones_like(z_p)], axis=-1))
        # hyperboloid: uniform in (v, phi) parameter space (approximate —
        # the reference's Hyperboloid::sample is unimplemented and errors,
        # hyperboloid.rs:289)
        is_hyp = qk == QUADRIC_HYPERBOLOID
        hp1 = par[:, 6:9]
        hp2 = par[:, 9:12]
        seg = hp1 + u1[:, None] * (hp2 - hp1)
        p_hy = jnp.stack([seg[:, 0] * cphi - seg[:, 1] * sphi,
                          seg[:, 0] * sphi + seg[:, 1] * cphi,
                          seg[:, 2]], axis=-1)
        ah_h = par[:, 4]
        ch_h = par[:, 5]
        n_hy = _norm(jnp.stack([ah_h * p_hy[:, 0], ah_h * p_hy[:, 1],
                                -ch_h * p_hy[:, 2]], axis=-1))
        p_obj = jnp.where(is_disk[:, None], p_dsk, jnp.where(is_cyl[:, None], p_cyl, p_sph))
        p_obj = jnp.where(is_cone[:, None], p_cn, jnp.where(is_para[:, None], p_pa, p_obj))
        n_obj = jnp.where(is_disk[:, None], n_dsk, jnp.where(is_cyl[:, None], n_cyl, n_sph))
        n_obj = jnp.where(is_cone[:, None], n_cn, jnp.where(is_para[:, None], n_pa, n_obj))
        p_obj = jnp.where(is_hyp[:, None], p_hy, p_obj)
        n_obj = jnp.where(is_hyp[:, None], n_hy, n_obj)
        ps = _xform_point(o2w, p_obj)
        ns = _norm(xf_vector_t(w2o[:, :, :3], n_obj))
        ns = jnp.where(((flags & 1) != 0)[:, None], -ns, ns)
        p = jnp.where(is_tri[:, None], p, ps)
        n = jnp.where(is_tri[:, None], n, ns)

    return p, n, area


def area_light_emission(sa: SceneArrays, light_ids, n_light, w):
    """L emitted from an area light toward direction w (diffuse.rs l())."""
    li = jnp.maximum(light_ids, 0)
    par = sa.light_param[li]
    lemit = par[:, 0:3]
    two_sided = par[:, 3] > 0
    emits = two_sided | (_dot(n_light, w) > 0)
    return jnp.where((emits & (light_ids >= 0))[:, None], lemit, 0.0)


# ---------------------------------------------------------------------------
# sample_li over the whole light table
# ---------------------------------------------------------------------------


def sample_li(sa: SceneArrays, static: SceneStatic, light_ids, p_ref, u1, u2,
              cone_spheres=False):
    """Sample incident direction from light `light_ids` toward p_ref.

    Returns dict {wi, li, pdf, dist, delta} — pdf in solid angle, dist the
    distance to the light sample (for the shadow ray t_max).

    cone_spheres=True: full-sphere area lights seen from outside sample the
    VISIBLE cone instead of uniform area (sphere.rs sample_interaction) —
    large variance win for small/far sphere lights. Callers must pair it
    with pdf_li_area_hit(cone_spheres=True) so both MIS directions use the
    same density (only the sampler-integrator NEE does; BDPT/SPPM keep the
    uniform-area density their vertex-pdf math assumes).
    """
    R = p_ref.shape[0]
    lid = jnp.maximum(light_ids, 0)
    kind = sa.light_kind[lid] if static.n_lights else jnp.zeros(R, jnp.int32)
    par = sa.light_param[lid] if static.n_lights else jnp.zeros((R, 12), F32)

    wi = jnp.zeros((R, 3), F32)
    li = jnp.zeros((R, 3), F32)
    pdf = jnp.zeros(R, F32)
    dist = jnp.full(R, 1e8, F32)
    delta = jnp.zeros(R, bool)

    world_d = 2.0 * sa.world_radius

    # point-family delta lights (point/spot/goniometric/projection)
    m_pt = (kind == LIGHT_POINT) | (kind == LIGHT_SPOT) | (kind == LIGHT_GONIO) | (kind == LIGHT_PROJECTION)
    to_l = par[:, 0:3] - p_ref
    d2 = jnp.maximum(_dot(to_l, to_l), 1e-12)
    dl = jnp.sqrt(d2)
    wi_pt = to_l / dl[:, None]
    fall = jnp.ones((R, 3), F32)
    m_spot = kind == LIGHT_SPOT
    cos_t = _dot(par[:, 6:9], -wi_pt)
    ctw = par[:, 9]
    cfs = par[:, 10]
    dfall = jnp.clip((cos_t - ctw) / jnp.maximum(cfs - ctw, 1e-9), 0.0, 1.0)
    fall_spot = jnp.where(cos_t < ctw, 0.0, jnp.where(cos_t > cfs, 1.0, dfall ** 4))
    fall = jnp.where(m_spot[:, None], fall_spot[:, None], fall)
    if any(k is not None for k in static.light_image_keys):
        fall = _image_light_scale(sa, static, lid, kind, -wi_pt, par, fall)
    wi = jnp.where(m_pt[:, None], wi_pt, wi)
    li = jnp.where(m_pt[:, None], par[:, 3:6] * fall / d2[:, None], li)
    pdf = jnp.where(m_pt, 1.0, pdf)
    dist = jnp.where(m_pt, dl, dist)
    delta = delta | m_pt

    # distant
    m_dist = kind == LIGHT_DISTANT
    wi = jnp.where(m_dist[:, None], par[:, 0:3], wi)
    li = jnp.where(m_dist[:, None], par[:, 3:6], li)
    pdf = jnp.where(m_dist, 1.0, pdf)
    dist = jnp.where(m_dist, world_d, dist)
    delta = delta | m_dist

    # infinite
    if static.has_infinite:
        m_inf = kind == LIGHT_INFINITE
        if static.has_env_map:
            d_env, li_env, pdf_env = _env_sample(sa, u1, u2)
        else:
            d_env = uniform_sample_sphere(u1, u2)
            li_env = jnp.broadcast_to(par[:, 3:6], (R, 3))
            pdf_env = jnp.full(R, INV_4PI, F32)
        wi = jnp.where(m_inf[:, None], d_env, wi)
        li = jnp.where(m_inf[:, None], li_env, li)
        pdf = jnp.where(m_inf, pdf_env, pdf)
        dist = jnp.where(m_inf, world_d, dist)

    # area
    n_lp = jnp.zeros((R, 3), F32)
    area_out = jnp.ones(R, F32)
    if static.has_area_lights:
        m_area = kind == LIGHT_AREA
        lprim = sa.light_prim[lid]
        ps, ns, area = _sample_prim_point(sa, lprim, u1, u2)
        n_lp = jnp.where(m_area[:, None], ns, n_lp)
        area_out = jnp.where(m_area, area, area_out)
        to_s = ps - p_ref
        d2a = jnp.maximum(_dot(to_s, to_s), 1e-12)
        da = jnp.sqrt(d2a)
        wi_a = to_s / da[:, None]
        cos_l = _dot(ns, -wi_a)
        two_sided = par[:, 3] > 0
        emits = two_sided | (cos_l > 0)
        li_a = jnp.where(emits[:, None], par[:, 0:3], 0.0)
        # area pdf -> solid angle (shape.rs pdf_interaction)
        pdf_a = d2a / jnp.maximum(jnp.abs(cos_l) * area, 1e-12)
        wi = jnp.where(m_area[:, None], wi_a, wi)
        li = jnp.where(m_area[:, None], li_a, li)
        pdf = jnp.where(m_area, jnp.where(jnp.abs(cos_l) > 1e-7, pdf_a, 0.0), pdf)
        dist = jnp.where(m_area, da, dist)

        if cone_spheres and sa.sph_param.shape[0] > 0:
            # visible-solid-angle cone sampling for full-sphere lights seen
            # from outside (sphere.rs sample_interaction w/ reference point)
            from .shading import coordinate_system

            is_sph, c_w, r_w = _sphere_cone_info(sa, lprim)
            to_c = c_w - p_ref
            dc2 = jnp.maximum(_dot(to_c, to_c), 1e-12)
            dc = jnp.sqrt(dc2)
            use_cone = m_area & is_sph & (dc2 > r_w * r_w * 1.0001)
            wc = to_c / dc[:, None]
            vx, vy = coordinate_system(wc)
            sin2_t_max = jnp.clip(r_w * r_w / dc2, 0.0, 1.0)
            cos_t_max = jnp.sqrt(jnp.maximum(1.0 - sin2_t_max, 0.0))
            cos_t = (1.0 - u1) + u1 * cos_t_max
            sin2_t = jnp.maximum(1.0 - cos_t * cos_t, 0.0)
            ds = dc * cos_t - jnp.sqrt(jnp.maximum(r_w * r_w - dc2 * sin2_t, 0.0))
            cos_a = jnp.clip((dc2 + r_w * r_w - ds * ds) / jnp.maximum(2.0 * dc * r_w, 1e-12), -1.0, 1.0)
            sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
            phi_c = 2.0 * jnp.pi * u2
            # outward normal at the sampled point, in the frame looking
            # from the sphere back toward p_ref (pbrt SphericalDirection
            # with -wc as +z)
            n_w = (sin_a * jnp.cos(phi_c))[:, None] * (-vx) + \
                  (sin_a * jnp.sin(phi_c))[:, None] * (-vy) + cos_a[:, None] * (-wc)
            p_s = c_w + r_w[:, None] * n_w
            to_sc = p_s - p_ref
            d2c = jnp.maximum(_dot(to_sc, to_sc), 1e-12)
            dac = jnp.sqrt(d2c)
            wi_c = to_sc / dac[:, None]
            pdf_c = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_t_max), 1e-12)
            # the sampled point always faces p_ref, so emission is
            # unconditional (front face for one-sided spheres)
            wi = jnp.where(use_cone[:, None], wi_c, wi)
            li = jnp.where(use_cone[:, None], par[:, 0:3], li)
            pdf = jnp.where(use_cone, pdf_c, pdf)
            dist = jnp.where(use_cone, dac, dist)
            n_lp = jnp.where(use_cone[:, None], n_w, n_lp)

    return {"wi": wi, "li": li, "pdf": pdf, "dist": dist, "delta": delta, "n": n_lp, "area": area_out}


def _sphere_cone_info(sa: SceneArrays, prim_ids):
    """(is_full_sphere, center_world, radius_world) for light prims — the
    shapes eligible for visible-solid-angle cone sampling
    (sphere.rs sample_interaction)."""
    from ..scene.arrays import GEOM_SPHERE, QUADRIC_SPHERE

    prim = jnp.maximum(prim_ids, 0)
    kind = sa.prim_kind[prim]
    geom = sa.prim_geom[prim]
    if sa.sph_param.shape[0] == 0:
        z = jnp.zeros(prim.shape[0], F32)
        return jnp.zeros(prim.shape[0], bool), jnp.zeros((prim.shape[0], 3), F32), z
    gi = jnp.where(kind == GEOM_SPHERE, geom, 0)
    qk = sa.sph_kind[gi]
    par = sa.sph_param[gi]
    o2w = sa.sph_o2w[gi]
    flags = sa.prim_flags[prim]
    r_o = par[:, 0]
    full = (par[:, 1] <= -r_o + 1e-6 * r_o) & (par[:, 2] >= r_o - 1e-6 * r_o) & \
        (par[:, 3] >= 2.0 * jnp.pi - 1e-6)
    # reverse-oriented spheres emit inward; they keep uniform-area sampling
    not_rev = (flags & 4) == 0  # builder.FLAG_REVERSE_ORIENTATION
    is_sph = (kind == GEOM_SPHERE) & (qk == QUADRIC_SPHERE) & full & not_rev
    center = o2w[:, :, 3]
    # world radius under (assumed uniform) scale: length of column 0
    scale = jnp.linalg.norm(o2w[:, :, 0], axis=-1)
    return is_sph, center, r_o * scale


def pdf_li_area_hit(sa: SceneArrays, p_ref, hit_p, hit_ng, hit_light, prim_area_of_hit,
                    cone_spheres=False):
    """pdf_li for a BSDF-sampled ray that hit area light `hit_light` at hit_p
    with normal hit_ng — used for the MIS weight of the emission pickup.

    cone_spheres mirrors sample_li's visible-solid-angle sphere sampling
    (sphere.rs pdf_interaction): full-sphere lights seen from outside use
    the uniform-cone pdf; everything else stays area->solid-angle."""
    to_s = hit_p - p_ref
    d2 = jnp.maximum(_dot(to_s, to_s), 1e-12)
    wi = to_s / jnp.sqrt(d2)[:, None]
    cos_l = jnp.abs(_dot(hit_ng, -wi))
    pdf = d2 / jnp.maximum(cos_l * prim_area_of_hit, 1e-12)
    pdf = jnp.where(cos_l > 1e-7, pdf, 0.0)
    if cone_spheres and sa.sph_param.shape[0] > 0:
        lprim = sa.light_prim[jnp.maximum(hit_light, 0)]
        is_sph, c_w, r_w = _sphere_cone_info(sa, lprim)
        to_c = c_w - p_ref
        dc2 = jnp.maximum(_dot(to_c, to_c), 1e-12)
        outside = dc2 > r_w * r_w * 1.0001
        sin2_t_max = jnp.clip(r_w * r_w / dc2, 0.0, 1.0)
        cos_t_max = jnp.sqrt(jnp.maximum(1.0 - sin2_t_max, 0.0))
        pdf_cone = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_t_max), 1e-12)
        pdf = jnp.where(is_sph & outside, pdf_cone, pdf)
    return pdf


# ---------------------------------------------------------------------------
# Photon emission sampling (light.rs sample_le; used by SPPM/BDPT)
# ---------------------------------------------------------------------------


def _projection_cos_total(par):
    """cos of the cone circumscribing a projection light's screen window
    (projection.rs:75-79: normalize(inverse-project(screen corner)).z).

    The screen corner direction in light space is
    (xm*tanHalf, ym*tanHalf, 1) with (xm, ym) the screen half-extents
    (aspect, 1) for wide maps / (1, 1/aspect) for tall ones — the same
    convention _image_light_scale uses for the inside test."""
    tan_half = par[:, 9]
    aspect = jnp.maximum(par[:, 10], 1e-6)
    xm = jnp.maximum(aspect, 1.0)
    ym = jnp.maximum(1.0 / aspect, 1.0)
    return 1.0 / jnp.sqrt(1.0 + tan_half * tan_half * (xm * xm + ym * ym))


def compute_power(sa: SceneArrays, static: SceneStatic):
    """Approximate emitted power per light (Light::power), for the photon
    light-selection distribution (integrator.rs:239-246)."""
    if static.n_lights == 0:
        return jnp.ones(1, F32)
    kind = sa.light_kind
    par = sa.light_param
    wr = sa.world_radius
    lum = par[:, 3:6].sum(axis=-1)  # point/spot/distant/infinite store I/L at 3:6
    area_lum = par[:, 0:3].sum(axis=-1)
    power = jnp.where(kind == LIGHT_POINT, 4.0 * jnp.pi * lum, 0.0)
    power = jnp.where(kind == LIGHT_SPOT, 2.0 * jnp.pi * (1.0 - 0.5 * (par[:, 9] + par[:, 10])) * lum, power)
    power = jnp.where(kind == LIGHT_DISTANT, jnp.pi * wr * wr * lum, power)
    power = jnp.where(kind == LIGHT_INFINITE, jnp.pi * wr * wr * lum, power)
    if any(k in (LIGHT_GONIO, LIGHT_PROJECTION) for k in static.light_kinds):
        # gonio: 4pi * sum(I * imgavg) (goniometric.rs power — mipmap
        # width-0.5 lookup ~ image average); projection: cone solid angle
        # 2pi(1 - cosTotalWidth) * sum(I * imgavg) (projection.rs power)
        avg = []
        for i in range(static.n_lights):
            key = static.light_image_keys[i] if i < len(static.light_image_keys) else None
            avg.append(jnp.mean(sa.light_images[key], axis=(0, 1))
                       if key is not None else jnp.ones(3, F32))
        avg = jnp.stack(avg)  # (L, 3)
        ilum = (par[:, 3:6] * avg).sum(axis=-1)
        power = jnp.where(kind == LIGHT_GONIO, 4.0 * jnp.pi * ilum, power)
        cos_total = _projection_cos_total(par)
        power = jnp.where(kind == LIGHT_PROJECTION,
                          2.0 * jnp.pi * (1.0 - cos_total) * ilum, power)
    if static.has_area_lights:
        area = sa.prim_area[jnp.maximum(sa.light_prim, 0)]
        two = 1.0 + (par[:, 3] > 0)
        power = jnp.where(kind == LIGHT_AREA, two * area * jnp.pi * area_lum, power)
    return jnp.maximum(power, 0.0)


def sample_le(sa: SceneArrays, static: SceneStatic, light_ids, u1a, u1b, u2a, u2b):
    """Sample an emitted photon ray from each light.

    Returns dict {o, d, le_over_pdf (R,3)} — radiance already divided by all
    pdfs (position * direction * light-choice handled by caller).
    """
    R = light_ids.shape[0]
    lid = jnp.maximum(light_ids, 0)
    kind = sa.light_kind[lid] if static.n_lights else jnp.zeros(R, jnp.int32)
    par = sa.light_param[lid] if static.n_lights else jnp.zeros((R, 12), F32)
    wc = sa.world_center
    wr = sa.world_radius

    o = jnp.zeros((R, 3), F32)
    d = jnp.zeros((R, 3), F32)
    w = jnp.zeros((R, 3), F32)  # Le/pdf

    # point: uniform sphere; pdf = 1/4pi -> w = I * 4pi
    m = kind == LIGHT_POINT
    d_pt = uniform_sample_sphere(u2a, u2b)
    o = jnp.where(m[:, None], par[:, 0:3], o)
    d = jnp.where(m[:, None], d_pt, d)
    w = jnp.where(m[:, None], par[:, 3:6] * (4.0 * jnp.pi), w)

    # spot: uniform cone around axis; pdf = 1/(2pi(1-cosTotal))
    m = kind == LIGHT_SPOT
    ctw = par[:, 9]
    cos_t = (1.0 - u2a) + u2a * ctw
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * jnp.pi * u2b
    axis = par[:, 6:9]
    from .shading import coordinate_system

    t1, t2 = coordinate_system(axis)
    d_sp = _norm(sin_t[:, None] * (jnp.cos(phi)[:, None] * t1 + jnp.sin(phi)[:, None] * t2) + cos_t[:, None] * axis)
    cfs = par[:, 10]
    dfall = jnp.clip((cos_t - ctw) / jnp.maximum(cfs - ctw, 1e-9), 0.0, 1.0)
    fall = jnp.where(cos_t < ctw, 0.0, jnp.where(cos_t > cfs, 1.0, dfall ** 4))
    pdf_cone = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - ctw), 1e-9)
    o = jnp.where(m[:, None], par[:, 0:3], o)
    d = jnp.where(m[:, None], d_sp, d)
    w = jnp.where(m[:, None], par[:, 3:6] * (fall / pdf_cone)[:, None], w)

    # goniometric: uniform sphere like point, Le modulated by the spherical
    # intensity map (goniometric.rs:105 sample_le: pdf_dir = 1/4pi,
    # Le = I * scale(d)); projection: uniform cone circumscribing the
    # screen window in LIGHT space, transformed to world
    # (projection.rs:137: uniform_sample_cone(cosTotalWidth), Le = I *
    # projection(d) which is zero outside the screen rectangle)
    if any(k in (LIGHT_GONIO, LIGHT_PROJECTION) for k in static.light_kinds):
        m_g = kind == LIGHT_GONIO
        m_pj = kind == LIGHT_PROJECTION
        d_g = uniform_sample_sphere(u2a, u2b)
        # projection cone sample around +z in light space
        cos_total = _projection_cos_total(par)
        cos_t = (1.0 - u2a) + u2a * cos_total
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        phi_p = 2.0 * jnp.pi * u2b
        v_l = jnp.stack([sin_t * jnp.cos(phi_p), sin_t * jnp.sin(phi_p), cos_t], axis=-1)
        # light->world rotation = inverse of the stored world->light 3x3
        # (L is tiny; invert all rows once, gather per lane)
        l2w_rot = jnp.linalg.inv(sa.light_w2l[:, :3, :3])[lid]
        d_pj = _norm(jnp.einsum("rij,rj->ri", l2w_rot, v_l))
        d_gp = jnp.where(m_pj[:, None], d_pj, d_g)
        # image modulation (shared with sample_li); mapless projection
        # still needs the screen inside-test that projection() applies
        scale = jnp.ones((R, 3), F32)
        if any(k is not None for k in static.light_image_keys):
            scale = _image_light_scale(sa, static, lid, kind, d_gp, par, scale)
        tan_half = par[:, 9]
        aspect = jnp.maximum(par[:, 10], 1e-6)
        sx = v_l[:, 0] / jnp.maximum(v_l[:, 2], 1e-6) / jnp.maximum(tan_half * jnp.maximum(aspect, 1.0), 1e-6)
        sy = v_l[:, 1] / jnp.maximum(v_l[:, 2], 1e-6) / jnp.maximum(tan_half * jnp.maximum(1.0 / aspect, 1.0), 1e-6)
        inside = (v_l[:, 2] >= 1e-3) & (jnp.abs(sx) <= 1.0) & (jnp.abs(sy) <= 1.0)
        has_img = jnp.zeros(R, bool)
        for i, key in enumerate(static.light_image_keys):
            if key is not None:
                has_img = has_img | (lid == i)
        scale = jnp.where((m_pj & ~has_img)[:, None],
                          jnp.where(inside[:, None], 1.0, 0.0), scale)
        pdf_cone = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_total), 1e-9)
        m_gp = m_g | m_pj
        o = jnp.where(m_gp[:, None], par[:, 0:3], o)
        d = jnp.where(m_gp[:, None], d_gp, d)
        w_g = par[:, 3:6] * scale * (4.0 * jnp.pi)
        w_pj = par[:, 3:6] * scale / pdf_cone[:, None]
        w = jnp.where(m_g[:, None], w_g, w)
        w = jnp.where(m_pj[:, None], w_pj, w)

    # distant: point on a world-radius disk, direction = -light dir
    m = kind == LIGHT_DISTANT
    wl = par[:, 0:3]  # direction TO the light
    from .camera import concentric_sample_disk

    dx, dy = concentric_sample_disk(u1a, u1b)
    v1, v2 = coordinate_system(wl)
    p_disk = wc + wr * (dx[:, None] * v1 + dy[:, None] * v2) + wl * wr
    o = jnp.where(m[:, None], p_disk, o)
    d = jnp.where(m[:, None], -wl, d)
    # pdf_pos = 1/(pi wr^2); le/pdf = L * pi wr^2
    w = jnp.where(m[:, None], par[:, 3:6] * (jnp.pi * wr * wr), w)

    # infinite: direction from env (or uniform sphere), origin on far disk
    if static.has_infinite:
        m = kind == LIGHT_INFINITE
        if static.has_env_map:
            d_env, li_env, pdf_env = _env_sample(sa, u2a, u2b)
            d_in = -d_env
            le = li_env / jnp.maximum(pdf_env, 1e-12)[:, None]
        else:
            d_env = uniform_sample_sphere(u2a, u2b)
            d_in = -d_env
            le = par[:, 3:6] * (4.0 * jnp.pi)  # L / (1/4pi) direction pdf
        v1, v2 = coordinate_system(d_in)
        dx, dy = concentric_sample_disk(u1a, u1b)
        p_disk = wc + wr * (dx[:, None] * v1 + dy[:, None] * v2) - d_in * wr
        o = jnp.where(m[:, None], p_disk, o)
        d = jnp.where(m[:, None], d_in, d)
        w = jnp.where(m[:, None], le * (jnp.pi * wr * wr), w)

    # area: uniform point on prim, cosine-weighted direction
    n_out = jnp.zeros((R, 3), F32)
    if static.has_area_lights:
        m = kind == LIGHT_AREA
        lprim = sa.light_prim[lid]
        ps, ns, area = _sample_prim_point(sa, lprim, u1a, u1b)
        from .bsdf import cosine_sample_hemisphere

        two_sided = par[:, 3] > 0
        # two-sided: emit from the back hemisphere half the time
        # (diffuse.rs sample_le); remap u2a so both halves stay stratified
        flip = two_sided & (u2a < 0.5)
        u2a_r = jnp.where(
            two_sided, jnp.where(u2a < 0.5, 2.0 * u2a, 2.0 * (u2a - 0.5)), u2a
        )
        w_l = cosine_sample_hemisphere(u2a_r, u2b)
        ns_e = jnp.where(flip[:, None], -ns, ns)
        t1a, t2a = coordinate_system(ns_e)
        d_ar = _norm(w_l[:, 0:1] * t1a + w_l[:, 1:2] * t2a + w_l[:, 2:3] * ns_e)
        # pdf_pos = 1/area; pdf_dir = cos/pi (one-sided) or 0.5*cos/pi
        # (two-sided) -> Le/pdf = L * area * pi * (2 if two-sided)
        w_area = par[:, 0:3] * (area * jnp.pi * jnp.where(two_sided, 2.0, 1.0))[:, None]
        o = jnp.where(m[:, None], ps + ns_e * 1e-3, o)
        d = jnp.where(m[:, None], d_ar, d)
        w = jnp.where(m[:, None], w_area, w)
        n_out = jnp.where(m[:, None], ns, n_out)

    return {"o": o, "d": d, "le_over_pdf": w, "n": n_out}


def area_light_pdf_dir(sa: SceneArrays, light_ids, n, w):
    """Directional emission pdf of a diffuse area light (diffuse.rs pdf_le):
    cos/pi one-sided, 0.5*cos/pi two-sided."""
    par = sa.light_param[jnp.maximum(light_ids, 0)]
    two_sided = par[:, 3] > 0
    cos_l = jnp.abs(_dot(n, w))
    return jnp.where(two_sided, 0.5, 1.0) * jnp.maximum(cos_l, 1e-6) / jnp.pi
