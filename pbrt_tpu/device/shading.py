"""Surface interaction reconstruction from hit records.

Replaces the reference's SurfaceInteraction construction inside the shape
intersect methods (src/shapes/triangle.rs:300-399, sphere.rs) — but computed
once per ray wave from the SoA hit record, as pure batched array math.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..scene.arrays import (
    GEOM_TRI, QUADRIC_CONE, QUADRIC_CYLINDER, QUADRIC_DISK, QUADRIC_HYPERBOLOID,
    QUADRIC_PARABOLOID, SceneArrays,
)
from .affine import xf_point as xf_point_b, xf_vector, xf_vector_t
from .intersect import _xform_point

F32 = jnp.float32

FLAG_FLIP_GEOM_N = 1
FLAG_HAS_SHADING_N = 2
FLAG_REVERSE_ORIENTATION = 4
FLAG_HAS_UV = 8


def _normalize(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


# gamma(n) = n*eps/(1 - n*eps), eps = 2^-24 (pbrt.rs gamma; efloat.rs) —
# the running FP error bounds the reference carries through intersections
_EPS32 = float(2.0 ** -24)


def _gamma(n: int) -> float:
    return n * _EPS32 / (1.0 - n * _EPS32)


def coordinate_system(n):
    """Build an orthonormal basis around n (src/core/geometry/geometry.rs)."""
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], axis=-1)
    bt = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bt


def _shading_frame(ns, dpdu):
    """(ss, ts) tangent frame: dpdu orthogonalized against ns, arbitrary
    fallback for degenerate parameterizations."""
    ss_fb, ts_fb = coordinate_system(ns)
    ss_p = dpdu - ns * jnp.sum(ns * dpdu, axis=-1, keepdims=True)
    ss_len = jnp.linalg.norm(ss_p, axis=-1)
    ok_t = ss_len > 1e-9
    ss = jnp.where(ok_t[:, None], ss_p / jnp.maximum(ss_len, 1e-20)[:, None], ss_fb)
    ts = jnp.where(ok_t[:, None], jnp.cross(ns, ss), ts_fb)
    return ss, ts


def apply_bump(sa: SceneArrays, static, si):
    """Bump-map the shading frame (material.rs:46-87 bump()).

    Finite-difference displacement: evaluate the material's float bump
    texture at uv, uv+(du,0), uv+(0,dv) (hit points shifted along
    dpdu/dpdv so 3D-mapped textures also work), displace
      dpdu' = dpdu + d(disp)/du * ns,   dpdv' = dpdv + d(disp)/dv * ns
    and rebuild ns/ss/ts from the displaced tangents. The dndu/dndv terms
    of the reference are omitted (flat triangles have zero dndu; quadric
    curvature displacement is a second-order effect). No-op (returns si
    unchanged, nothing traced) when the scene has no bump maps.

    Rays without differentials use the reference's du fallback 0.0005
    (material.rs: `if du == 0 { du = 0.0005 }`).
    """
    if not getattr(static, "has_bump", False):
        return si
    from .texture import eval_textures

    tid = sa.mat_bump[jnp.maximum(si["mat"], 0)]
    has = tid >= 0
    du = 0.0005
    dv = 0.0005

    def disp_at(uv, p):
        vals = eval_textures(sa, static.tex_programs, uv, p)
        out = jnp.zeros(uv.shape[0], F32)
        for x in range(vals.shape[0]):
            out = jnp.where(tid == x, vals[x][:, 0], out)
        return out

    uv = si["uv"]
    p = si["p"]
    d0 = disp_at(uv, p)
    d_u = disp_at(uv + jnp.array([du, 0.0], F32), p + du * si["dpdu"])
    d_v = disp_at(uv + jnp.array([0.0, dv], F32), p + dv * si["dpdv"])
    ns = si["ns"]
    dpdu_b = si["dpdu"] + ((d_u - d0) / du)[:, None] * ns
    dpdv_b = si["dpdv"] + ((d_v - d0) / dv)[:, None] * ns
    ns_b = jnp.cross(dpdu_b, dpdv_b)
    nlen = jnp.linalg.norm(ns_b, axis=-1, keepdims=True)
    ns_b = ns_b / jnp.maximum(nlen, 1e-20)
    # keep the displaced normal on the original shading side (the
    # reference's set_shading_geometry orientation handling)
    flip = jnp.sum(ns_b * ns, axis=-1) < 0
    ns_b = jnp.where(flip[:, None], -ns_b, ns_b)
    ok = has & (nlen[:, 0] > 1e-12)
    ns_n = jnp.where(ok[:, None], ns_b, ns)
    ss_b, ts_b = _shading_frame(ns_n, jnp.where(ok[:, None], dpdu_b, si["dpdu"]))
    si = dict(si)
    si["ns"] = ns_n
    si["ss"] = jnp.where(ok[:, None], ss_b, si["ss"])
    si["ts"] = jnp.where(ok[:, None], ts_b, si["ts"])
    return si


def surface_interaction(sa: SceneArrays, hit, o, d, time=None):
    """Build the shading record for each ray.

    hit: dict from intersect(); o, d: (R, 3) ray; time: optional (R,)
    shutter times (motion blur — lerps keyframe geometry tables).
    Returns dict with p, ng (geometric normal), ns (shading normal), uv,
    tangent/bitangent frame (ss, ts), mat (material id), light (area light id),
    valid (R,) mask.
    """
    prim = jnp.maximum(hit["prim"], 0)
    valid = hit["prim"] >= 0
    t = jnp.where(valid, hit["t"], 1.0)
    has_inst0 = sa.prim_inst is not None and sa.inst_i2w is not None and sa.inst_i2w.shape[0] > 1
    # fused fat-row gather: ONE
    # (P, 32) row replaces the ~8 per-hit table gathers (builder
    # prim_shade_tab; motion/instancing keep the per-table path — their
    # keyframe lerps/instance transforms need the raw tables)
    fat = None
    if (getattr(sa, "prim_shade_tab", None) is not None and time is None
            and not has_inst0):
        fat = sa.prim_shade_tab[prim]  # (R, 32)
        kind = fat[:, 24].astype(jnp.int32)
        flags = fat[:, 25].astype(jnp.int32)
        geom = fat[:, 28].astype(jnp.int32)
    else:
        kind = sa.prim_kind[prim]
        geom = sa.prim_geom[prim]
        flags = sa.prim_flags[prim]
    is_tri = kind == GEOM_TRI

    p = o + d * t[..., None]

    R = prim.shape[0]
    ng = jnp.zeros((R, 3), F32)
    ns = jnp.zeros((R, 3), F32)
    uv = jnp.zeros((R, 2), F32)
    dpdu = jnp.zeros((R, 3), F32)
    dpdv = jnp.zeros((R, 3), F32)
    p_err = jnp.full((R, 3), 1e-4, F32)  # fallback bound for odd kinds

    has_inst = has_inst0
    if sa.tri_p.shape[0] > 0 and fat is not None:
        # fused path: slices of the one fat row (no per-table gathers)
        tv = fat[:, 0:9].reshape(-1, 3, 3)
        tn = fat[:, 9:18].reshape(-1, 3, 3)
        tuv = fat[:, 18:24].reshape(-1, 3, 2)
    elif sa.tri_p.shape[0] > 0:
        ti = jnp.where(is_tri, geom, 0)
        tv = sa.tri_p[ti]  # (R, 3, 3)
        if time is not None and sa.anim is not None:
            # exact per-ray TRS interpolation (device/motion.py) — must
            # match the intersect path so p/ng agree with the hit
            from .motion import motion_matrices, xform_point

            G = motion_matrices(sa, prim, time)  # (R, 3, 4)
            tv = xform_point(G[:, None], tv)
        else:
            G = None
            if time is not None and sa.tri_p_end is not None:
                from .intersect import _motion_quad

                tv = _motion_quad(tv, sa.tri_p_end[ti],
                                  sa.tri_p_mid[ti] if sa.tri_p_mid is not None else None,
                                  time[:, None, None])
        tn = sa.tri_n[ti]
        if time is not None and sa.anim is not None and G is not None:
            # normals move by the inverse-transpose of G's linear part
            # (transform.rs xnormal semantics)
            from .motion import _affine_inverse

            Ginv = _affine_inverse(G)  # (R, 3, 4)
            tn = jnp.einsum("rji,rkj->rki", Ginv[:, :3, :3], tn)
        tuv = sa.tri_uv[ti]
        if has_inst:
            # instanced prims store instance-space vertices/normals: bring
            # the shading geometry to world (normals via (w2i)^T)
            iid = sa.prim_inst[prim]
            i2w = sa.inst_i2w[iid]  # (R, 3, 4)
            w2i = sa.inst_w2i[iid]
            tv = jnp.stack([
                xf_point_b(i2w, tv[:, 0]), xf_point_b(i2w, tv[:, 1]), xf_point_b(i2w, tv[:, 2])
            ], axis=1)
            tn = jnp.stack([
                xf_vector_t(w2i[:, :, :3], tn[:, 0]),
                xf_vector_t(w2i[:, :, :3], tn[:, 1]),
                xf_vector_t(w2i[:, :, :3], tn[:, 2]),
            ], axis=1)
    if sa.tri_p.shape[0] > 0:
        b1 = hit["b1"]
        b2 = hit["b2"]
        b0 = 1.0 - b1 - b2
        e1 = tv[:, 1] - tv[:, 0]
        e2 = tv[:, 2] - tv[:, 0]
        ng_t = _normalize(jnp.cross(e1, e2))
        flip = (flags & FLAG_FLIP_GEOM_N) != 0
        ng_t = jnp.where(flip[:, None], -ng_t, ng_t)
        ns_t = _normalize(b0[:, None] * tn[:, 0] + b1[:, None] * tn[:, 1] + b2[:, None] * tn[:, 2])
        # geometric normal flipped toward shading normal (triangle.rs:355-360)
        has_sn = (flags & FLAG_HAS_SHADING_N) != 0
        align = jnp.sum(ng_t * ns_t, axis=-1) < 0
        ng_t = jnp.where((has_sn & align)[:, None], -ng_t, ng_t)
        ns_t = jnp.where(has_sn[:, None], ns_t, ng_t)
        uv_t = b0[:, None] * tuv[:, 0] + b1[:, None] * tuv[:, 1] + b2[:, None] * tuv[:, 2]
        # dpdu/dpdv from the uv parameterization (triangle.rs:300-340)
        duv1 = tuv[:, 1] - tuv[:, 0]  # (R, 2)
        duv2 = tuv[:, 2] - tuv[:, 0]
        det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0), 0.0)
        dpdu_t = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv_det[:, None]
        dpdv_t = (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2) * inv_det[:, None]
        degen = jnp.abs(det) <= 1e-12
        dpdu_t = jnp.where(degen[:, None], e1, dpdu_t)
        dpdv_t = jnp.where(degen[:, None], e2, dpdv_t)
        # hit point by barycentric interpolation (triangle.rs:300): p = o+t*d
        # suffers cancellation error ~|o|*2^-24 that would dwarf the gamma(7)
        # bound below — interpolation keeps the error within the bound
        p_t = b0[:, None] * tv[:, 0] + b1[:, None] * tv[:, 1] + b2[:, None] * tv[:, 2]
        p = jnp.where(is_tri[:, None], p_t, p)
        # triangle hit-point error bound (triangle.rs: gamma(7) * sum |b_i v_i|)
        perr_t = _gamma(7) * (
            jnp.abs(b0)[:, None] * jnp.abs(tv[:, 0])
            + jnp.abs(b1)[:, None] * jnp.abs(tv[:, 1])
            + jnp.abs(b2)[:, None] * jnp.abs(tv[:, 2])
        )
        ng = jnp.where(is_tri[:, None], ng_t, ng)
        ns = jnp.where(is_tri[:, None], ns_t, ns)
        uv = jnp.where(is_tri[:, None], uv_t, uv)
        dpdu = jnp.where(is_tri[:, None], dpdu_t, dpdu)
        dpdv = jnp.where(is_tri[:, None], dpdv_t, dpdv)
        p_err = jnp.where(is_tri[:, None], perr_t, p_err)

    if sa.sph_param.shape[0] > 0:
        si = jnp.where(~is_tri, geom, 0)
        o2w = sa.sph_o2w[si]
        w2o = sa.sph_w2o[si]
        if time is not None and sa.anim is not None:
            from .motion import _affine_inverse, motion_matrices

            w2o = motion_matrices(sa, prim, time, quadric=True)
            o2w = _affine_inverse(w2o)
        elif time is not None and sa.sph_w2o_end is not None:
            from .intersect import _motion_quad

            has_mid = sa.sph_w2o_mid is not None
            w2o = _motion_quad(w2o, sa.sph_w2o_end[si],
                               sa.sph_w2o_mid[si] if has_mid else None,
                               time[:, None, None])
            o2w = _motion_quad(o2w, sa.sph_o2w_end[si],
                               sa.sph_o2w_mid[si] if has_mid else None,
                               time[:, None, None])
        par = sa.sph_param[si]
        qk = sa.sph_kind[si]
        is_cyl = qk == QUADRIC_CYLINDER
        is_disk = qk == QUADRIC_DISK
        is_cone = qk == QUADRIC_CONE
        is_para = qk == QUADRIC_PARABOLOID
        is_hyp = qk == QUADRIC_HYPERBOLOID
        is_sph = ~(is_cyl | is_disk | is_cone | is_para | is_hyp)
        radius = par[:, 0]
        p_obj = _xform_point(w2o, p)
        # re-project to the surface per kind (sphere.rs / cylinder.rs; disks
        # snap z to the plane height; cone/paraboloid keep the raw point)
        r_sph = radius / jnp.maximum(jnp.linalg.norm(p_obj, axis=-1), 1e-30)
        r_cyl = radius / jnp.maximum(jnp.sqrt(p_obj[:, 0] ** 2 + p_obj[:, 1] ** 2), 1e-30)
        scale = jnp.where(is_sph, r_sph, jnp.where(is_cyl, r_cyl, 1.0))  # hyp/cone/para keep the raw point
        z_new = jnp.where(is_disk, par[:, 1], jnp.where(is_sph, p_obj[:, 2] * r_sph, p_obj[:, 2]))
        p_obj = jnp.stack([p_obj[:, 0] * scale, p_obj[:, 1] * scale, z_new], axis=-1)
        # object normal per kind (implicit-surface gradients)
        n_sph = p_obj / radius[:, None]
        zero = jnp.zeros_like(radius)
        one = jnp.ones_like(radius)
        n_cyl = jnp.stack([p_obj[:, 0] / radius, p_obj[:, 1] / radius, zero], axis=-1)
        n_dsk = jnp.stack([zero, zero, one], axis=-1)
        # cone: grad(x^2+y^2-k(z-h)^2) with k=(r/h)^2 -> (x, y, k(h-z))
        k_cone = (radius / jnp.maximum(jnp.abs(par[:, 1]), 1e-12)) ** 2
        n_cone = jnp.stack([p_obj[:, 0], p_obj[:, 1],
                            k_cone * (par[:, 1] - p_obj[:, 2])], axis=-1)
        n_cone = n_cone / jnp.maximum(jnp.linalg.norm(n_cone, axis=-1, keepdims=True), 1e-20)
        # paraboloid: outward = (x, y, -(x^2+y^2)/(2z)) ~ (2kx, 2ky, -1)
        k_para = par[:, 2] / jnp.maximum(radius * radius, 1e-20)
        n_para = jnp.stack([2.0 * k_para * p_obj[:, 0], 2.0 * k_para * p_obj[:, 1],
                            -one], axis=-1)
        n_para = n_para / jnp.maximum(jnp.linalg.norm(n_para, axis=-1, keepdims=True), 1e-20)
        # hyperboloid: grad(ah(x^2+y^2) - ch z^2) = (ah x, ah y, -ch z)
        ah = par[:, 4]
        ch = par[:, 5]
        n_hyp = jnp.stack([ah * p_obj[:, 0], ah * p_obj[:, 1], -ch * p_obj[:, 2]], axis=-1)
        n_hyp = n_hyp / jnp.maximum(jnp.linalg.norm(n_hyp, axis=-1, keepdims=True), 1e-20)
        n_obj = jnp.where(is_disk[:, None], n_dsk, jnp.where(is_cyl[:, None], n_cyl, n_sph))
        n_obj = jnp.where(is_cone[:, None], n_cone, n_obj)
        n_obj = jnp.where(is_para[:, None], n_para, n_obj)
        n_obj = jnp.where(is_hyp[:, None], n_hyp, n_obj)
        ng_s = _normalize(xf_vector_t(w2o[:, :, :3], n_obj))
        flip = (flags & FLAG_FLIP_GEOM_N) != 0
        ng_s = jnp.where(flip[:, None], -ng_s, ng_s)
        # parametric uv per kind (sphere.rs / cylinder.rs / disk.rs)
        phi = jnp.arctan2(p_obj[:, 1], p_obj[:, 0])
        phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
        zc = jnp.clip(p_obj[:, 2] / radius, -1.0, 1.0)
        theta = jnp.arccos(zc)
        phimax = par[:, 3]
        tmin = par[:, 4]
        tmax = par[:, 5]
        u_s = phi / jnp.maximum(phimax, 1e-9)
        v_sph = (theta - tmin) / jnp.maximum(tmax - tmin, 1e-9)
        v_cyl = (p_obj[:, 2] - par[:, 1]) / jnp.maximum(par[:, 2] - par[:, 1], 1e-9)
        r_hit = jnp.sqrt(jnp.maximum(p_obj[:, 0] ** 2 + p_obj[:, 1] ** 2, 1e-20))
        v_dsk = 1.0 - (r_hit - par[:, 2]) / jnp.maximum(radius - par[:, 2], 1e-9)
        v_cone = p_obj[:, 2] / jnp.maximum(jnp.abs(par[:, 1]), 1e-9)  # z / height
        v_para = (p_obj[:, 2] - par[:, 1]) / jnp.maximum(par[:, 2] - par[:, 1], 1e-9)
        # hyperboloid inverse mapping (hyperboloid.rs:134-139): v from z
        # along the p1->p2 segment, phi measured against the TWISTED frame
        # (the lerped segment point pr)
        hp1 = par[:, 6:9]
        hp2 = par[:, 9:12]
        v_hyp = (p_obj[:, 2] - hp1[:, 2]) / jnp.where(
            jnp.abs(hp2[:, 2] - hp1[:, 2]) > 1e-12, hp2[:, 2] - hp1[:, 2], 1.0)
        pr = hp1 + v_hyp[:, None] * (hp2 - hp1)
        phi_hyp = jnp.arctan2(pr[:, 0] * p_obj[:, 1] - p_obj[:, 0] * pr[:, 1],
                              p_obj[:, 0] * pr[:, 0] + p_obj[:, 1] * pr[:, 1])
        phi_hyp = jnp.where(phi_hyp < 0, phi_hyp + 2.0 * jnp.pi, phi_hyp)
        u_s = jnp.where(is_hyp, phi_hyp / jnp.maximum(phimax, 1e-9), u_s)
        v_s = jnp.where(is_disk, v_dsk, jnp.where(is_cyl, v_cyl, v_sph))
        v_s = jnp.where(is_cone, v_cone, jnp.where(is_para, v_para, v_s))
        v_s = jnp.where(is_hyp, v_hyp, v_s)
        uv_s = jnp.stack([u_s, v_s], axis=-1)
        # analytic dpdu/dpdv in object space -> world
        zr = jnp.sqrt(jnp.maximum(p_obj[:, 0] ** 2 + p_obj[:, 1] ** 2, 1e-20))
        dpdu_o = jnp.stack([-phimax * p_obj[:, 1], phimax * p_obj[:, 0], jnp.zeros_like(zr)], axis=-1)
        dtheta = tmax - tmin
        dpdv_sph = jnp.stack(
            [p_obj[:, 2] * p_obj[:, 0] / zr, p_obj[:, 2] * p_obj[:, 1] / zr, -radius * jnp.sin(theta)], axis=-1
        ) * dtheta[:, None]
        dpdv_cyl = jnp.stack([zero, zero, par[:, 2] - par[:, 1]], axis=-1)
        dpdv_dsk = jnp.stack([p_obj[:, 0], p_obj[:, 1], zero], axis=-1) * \
            ((par[:, 2] - radius) / r_hit)[:, None]
        # cone.rs:115 dpdv = (-x/(1-v), -y/(1-v), h)
        omv = jnp.maximum(1.0 - v_cone, 1e-6)
        dpdv_cone = jnp.stack([-p_obj[:, 0] / omv, -p_obj[:, 1] / omv,
                               jnp.abs(par[:, 1]) + zero], axis=-1)
        # paraboloid.rs:116 dpdv = (x/2z, y/2z, 1) * (zmax - zmin)
        z2 = jnp.maximum(2.0 * jnp.abs(p_obj[:, 2]), 1e-9) * jnp.sign(p_obj[:, 2] + 1e-30)
        dpdv_para = jnp.stack([p_obj[:, 0] / z2, p_obj[:, 1] / z2, one], axis=-1) * \
            (par[:, 2] - par[:, 1])[:, None]
        # hyperboloid.rs:148-151 dpdv — rotate the segment direction by phi
        # (the reference's dpdv.y has a sign transcription bug, `-` for `+`;
        # the rotation derivative is used here, matching pbrt-v3)
        cph = jnp.cos(phi_hyp)
        sph_ = jnp.sin(phi_hyp)
        ex = hp2[:, 0] - hp1[:, 0]
        ey = hp2[:, 1] - hp1[:, 1]
        dpdv_hyp = jnp.stack([ex * cph - ey * sph_, ex * sph_ + ey * cph,
                              hp2[:, 2] - hp1[:, 2]], axis=-1)
        dpdv_o = jnp.where(is_disk[:, None], dpdv_dsk, jnp.where(is_cyl[:, None], dpdv_cyl, dpdv_sph))
        dpdv_o = jnp.where(is_cone[:, None], dpdv_cone, dpdv_o)
        dpdv_o = jnp.where(is_para[:, None], dpdv_para, dpdv_o)
        dpdv_o = jnp.where(is_hyp[:, None], dpdv_hyp, dpdv_o)
        dpdu_s = xf_vector(o2w[:, :, :3], dpdu_o)
        dpdv_s = xf_vector(o2w[:, :, :3], dpdv_o)
        # hit point from the REPROJECTED object-space point (sphere.rs
        # refine; keeps p inside the gamma(5) bound rather than o + t*d)
        p_s = xf_point_b(o2w, p_obj)
        p = jnp.where(is_tri[:, None], p, p_s)
        # quadric hit-point error: gamma(5)|p_obj| in object space
        # (sphere.rs etc.), pushed through the affine o2w with the
        # transform_point_error bound (transform.rs:433)
        absA = jnp.abs(o2w[:, :, :3])
        abs_p = jnp.abs(p_obj)
        perr_s = (_gamma(5) + _gamma(3)) * jnp.einsum("rij,rj->ri", absA, abs_p) \
            + _gamma(3) * jnp.abs(o2w[:, :, 3])
        ng = jnp.where(is_tri[:, None], ng, ng_s)
        ns = jnp.where(is_tri[:, None], ns, ng_s)
        uv = jnp.where(is_tri[:, None], uv, uv_s)
        dpdu = jnp.where(is_tri[:, None], dpdu, dpdu_s)
        dpdv = jnp.where(is_tri[:, None], dpdv, dpdv_s)
        p_err = jnp.where(is_tri[:, None], p_err, perr_s)

    # shading frame: tangent from dpdu (reflection.rs BSDF ctor ss =
    # normalize(dpdu)), orthogonalized against the shading normal; falls
    # back to an arbitrary frame for degenerate parameterizations
    ss, ts = _shading_frame(ns, dpdu)
    return {
        "valid": valid,
        "p": p,
        "p_err": p_err,
        "ng": ng,
        "ns": ns,
        "uv": uv,
        "ss": ss,
        "ts": ts,
        "dpdu": dpdu,
        "dpdv": dpdv,
        "mat": jnp.where(valid, fat[:, 26].astype(jnp.int32) if fat is not None
                         else sa.prim_mat[prim], 0),
        "light": jnp.where(valid, fat[:, 27].astype(jnp.int32) if fat is not None
                           else sa.prim_light[prim], -1),
        "prim": hit["prim"],
        "wo": -d,
    }
