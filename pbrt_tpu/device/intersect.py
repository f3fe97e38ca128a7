"""Batched ray-scene intersection: triangle / sphere kernels + BVH traversal.

Array-program replacement of the reference's recursive primitive dispatch:
- watertight ray-triangle test vectorized over (rays x prims) lanes
  (algorithm of src/shapes/triangle.rs:136-399, minus the per-ray EFloat
  bookkeeping — conservative epsilons replace exact error intervals)
- quadric sphere test (src/shapes/sphere.rs) against object-space rays
- flat-BVH traversal (node layout of src/accelerators/bvh.rs:89-95) as a
  `lax.while_loop` over packets that share a short stack, front-to-back
  child ordering by ray direction sign (bvh.rs:705-760); on CUDA, static
  triangle scenes use the per-ray kernel of device/bvh_kernel.py instead
- brute-force all-pairs path for small scenes: pure elementwise work with
  zero divergence.

All functions are batched over a leading ray axis R and jit-compatible.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..scene.arrays import GEOM_SPHERE, GEOM_TRI, SceneArrays, SceneStatic
from . import bvh_kernel

F32 = jnp.float32
INF = float("inf")  # a Python float: no module-level device constant
STACK_DEPTH = 64
# conservative hit-epsilon in lieu of the reference's EFloat error bounds
SHADOW_EPS = 1e-4


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _cross(a, b):
    return jnp.cross(a, b)


# ---------------------------------------------------------------------------
# Triangle intersection (watertight, Woop/Benthin/Wald style as in triangle.rs)
# ---------------------------------------------------------------------------


def ray_triangle(o, d, p0, p1, p2, t_max):
    """Watertight ray-triangle intersection.

    o, d: (..., 3); p0/p1/p2: (..., 3); t_max: (...)
    Returns (hit, t, b0, b1, b2) with barycentrics w.r.t. (p0, p1, p2).
    """
    # translate vertices to ray origin
    p0t = p0 - o
    p1t = p1 - o
    p2t = p2 - o

    # permute so |dz| is max (triangle.rs max_dimension + permute).
    # expressed as where-chains, not take_along_axis
    ad = jnp.abs(d)
    kz = jnp.argmax(ad, axis=-1)
    k0 = kz == 0
    k1 = kz == 1

    def _sel(v, i0, i1, i2):
        # component i of v where i = i0/i1/i2 depending on kz = 0/1/2
        return jnp.where(k0, v[..., i0], jnp.where(k1, v[..., i1], v[..., i2]))

    def permute(v):
        # kx = kz+1 mod 3, ky = kz+2 mod 3
        return jnp.stack([_sel(v, 1, 2, 0), _sel(v, 2, 0, 1), _sel(v, 0, 1, 2)], axis=-1)

    dp = permute(d)
    p0t = permute(p0t)
    p1t = permute(p1t)
    p2t = permute(p2t)

    # shear to align ray with +z
    inv_dz = 1.0 / dp[..., 2]
    sx = -dp[..., 0] * inv_dz
    sy = -dp[..., 1] * inv_dz
    sz = inv_dz

    x0 = p0t[..., 0] + sx * p0t[..., 2]
    y0 = p0t[..., 1] + sy * p0t[..., 2]
    x1 = p1t[..., 0] + sx * p1t[..., 2]
    y1 = p1t[..., 1] + sy * p1t[..., 2]
    x2 = p2t[..., 0] + sx * p2t[..., 2]
    y2 = p2t[..., 1] + sy * p2t[..., 2]

    # edge functions (f32; the reference falls back to f64 on exact-zero edges
    # — we evaluate in f64-equivalent by promoting, which vectorizes freely)
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1

    same_sign = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2

    z0 = sz * p0t[..., 2]
    z1 = sz * p1t[..., 2]
    z2 = sz * p2t[..., 2]
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2

    det_nonzero = det != 0
    inv_det = jnp.where(det_nonzero, 1.0 / jnp.where(det_nonzero, det, 1.0), 0.0)
    t = t_scaled * inv_det

    hit = same_sign & det_nonzero & (t > SHADOW_EPS) & (t < t_max)
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det
    return hit, t, b0, b1, b2


# ---------------------------------------------------------------------------
# Sphere intersection (src/shapes/sphere.rs quadric + clipping)
# ---------------------------------------------------------------------------


from .affine import xf_point as _xform_point, xf_vector as _xform_vector
from . import efloat as efl


def ray_quadric(o, d, w2o, params, qkind, t_max):
    """Analytic quadric intersection in object space.

    w2o: (..., 3, 4); qkind selects the shape (arrays.QUADRIC_*):
    - sphere  (sphere.rs):     params = radius, zmin, zmax, phimax, _, _
    - cylinder (cylinder.rs):  params = radius, zmin, zmax, phimax, _, _
    - disk    (disk.rs):       params = radius, height, inner_r, phimax, _, _
    - cone    (cone.rs):       params = radius, height, _, phimax, _, _
      (with the CORRECT k = (radius/height)^2 — the reference's cone has a
      transcription bug, k = (radius/radius)^2 = 1, at cone.rs:73-75)
    - paraboloid (paraboloid.rs): params = radius, zmin, zmax, phimax, _, _
    - hyperboloid (hyperboloid.rs): params = rmax, zmin, zmax, phimax, ah,
      ch, p1 (3), p2 (3) (implicit ah (x^2+y^2) - ch z^2 = 1; partial-phi
      clips against the TWISTED frame: phi is measured relative to the
      revolved segment point at the hit's v, hyperboloid.rs:96-105)
    Returns (hit, t, p_obj) with p_obj the (re-projected) object-space hit.
    """
    from ..scene.arrays import (
        QUADRIC_CONE, QUADRIC_CYLINDER, QUADRIC_DISK, QUADRIC_HYPERBOLOID,
        QUADRIC_PARABOLOID,
    )

    oo = _xform_point(w2o, o)
    od = _xform_vector(w2o, d)
    radius = params[..., 0]
    p1 = params[..., 1]  # zmin | zmin | height | height | zmin
    p2 = params[..., 2]  # zmax | zmax | inner radius | _ | zmax
    phimax = params[..., 3]
    is_cyl = qkind == QUADRIC_CYLINDER
    is_disk = qkind == QUADRIC_DISK
    is_cone = qkind == QUADRIC_CONE
    is_para = qkind == QUADRIC_PARABOLOID
    is_hyp = qkind == QUADRIC_HYPERBOLOID

    # EFloat interval coefficients (efloat.rs; sphere.rs:72-88 etc.): the
    # transform's FP error seeds the o/d intervals, every product widens
    # them, and root acceptance tests the resulting t BOUNDS — no fixed
    # epsilon anywhere in the accept path
    o_err, d_err = efl.transform_ray_error(w2o, o, d)
    EOx = efl.ef(oo[..., 0], o_err[..., 0])
    EOy = efl.ef(oo[..., 1], o_err[..., 1])
    EOz = efl.ef(oo[..., 2], o_err[..., 2])
    EDx = efl.ef(od[..., 0], d_err[..., 0])
    EDy = efl.ef(od[..., 1], d_err[..., 1])
    EDz = efl.ef(od[..., 2], d_err[..., 2])
    oz_ = oo[..., 2]
    # cone: k = (r/h)^2, apex at z=h (cone.rs with the k fix)
    k_cone = (radius / jnp.maximum(jnp.abs(p1), 1e-12)) ** 2
    # paraboloid: z = k (x^2 + y^2), k = zmax / r^2 (paraboloid.rs:75-78)
    k_para = p2 / jnp.maximum(radius * radius, 1e-20)

    ah = params[..., 4]
    ch = params[..., 5]

    Edxy2 = efl.add(efl.sqr(EDx), efl.sqr(EDy))
    Eoxyd = efl.add(efl.mul(EDx, EOx), efl.mul(EDy, EOy))
    Eoxy2 = efl.add(efl.sqr(EOx), efl.sqr(EOy))
    Edzz = efl.sqr(EDz)
    Eozz = efl.sqr(EOz)
    Eozdz = efl.mul(EOz, EDz)
    Eoz_h = efl.sub(EOz, efl.ef(p1))  # oz - height (cone)
    Er2 = efl.sqr(efl.ef(radius))

    def w3(cond, A, B):
        return tuple(jnp.where(cond, x, y) for x, y in zip(A, B))

    Ea = w3(is_cyl, Edxy2, efl.add(Edxy2, Edzz))
    Ea = w3(is_cone, efl.sub(Edxy2, efl.scale(Edzz, k_cone)), Ea)
    Ea = w3(is_para, efl.scale(Edxy2, k_para), Ea)
    Ea = w3(is_hyp, efl.sub(efl.scale(Edxy2, ah), efl.scale(Edzz, ch)), Ea)
    Eb = efl.scale(w3(is_cyl, Eoxyd, efl.add(Eoxyd, Eozdz)), 2.0)
    Eb = w3(is_cone, efl.scale(efl.sub(Eoxyd, efl.scale(efl.mul(EDz, Eoz_h), k_cone)), 2.0), Eb)
    Eb = w3(is_para, efl.sub(efl.scale(Eoxyd, 2.0 * k_para), EDz), Eb)
    Eb = w3(is_hyp, efl.scale(efl.sub(efl.scale(Eoxyd, ah), efl.scale(Eozdz, ch)), 2.0), Eb)
    Ec = efl.sub(w3(is_cyl, Eoxy2, efl.add(Eoxy2, Eozz)), Er2)
    Ec = w3(is_cone, efl.sub(Eoxy2, efl.scale(efl.sqr(Eoz_h), k_cone)), Ec)
    Ec = w3(is_para, efl.sub(efl.scale(Eoxy2, k_para), EOz), Ec)
    Ec = w3(is_hyp, efl.sub(efl.sub(efl.scale(Eoxy2, ah), efl.scale(Eozz, ch)), efl.ef(jnp.float32(1.0))), Ec)

    has, T0, T1 = efl.quadratic(Ea, Eb, Ec)
    has_root = has & ~is_disk
    tn, tn_lo, tn_hi = T0
    tf, tf_lo, tf_hi = T1

    def clip_ok(t):
        p = oo + od * t[..., None]
        # refine to the surface (sphere.rs / cylinder.rs re-project the hit;
        # cone/paraboloid keep the raw point like the reference)
        r_s = radius / jnp.maximum(jnp.linalg.norm(p, axis=-1), 1e-30)
        r_c = radius / jnp.maximum(jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2), 1e-30)
        scale = jnp.where(is_cyl, r_c, jnp.where(is_cone | is_para | is_hyp, 1.0, r_s))
        zs = jnp.where(is_cyl | is_cone | is_para | is_hyp, p[..., 2], p[..., 2] * scale)
        pn = jnp.stack([p[..., 0] * scale, p[..., 1] * scale, zs], axis=-1)
        z = pn[..., 2]
        phi = jnp.arctan2(pn[..., 1], pn[..., 0])
        if params.shape[-1] >= 12:
            # hyperboloid phi is measured against the twisted frame: the
            # p1->p2 segment point at the hit's v, rotated with the surface
            # (hyperboloid.rs:96-105 pr = lerp(v, p1, p2))
            hp1 = params[..., 6:9]
            hp2 = params[..., 9:12]
            dz_h = hp2[..., 2] - hp1[..., 2]
            v_h = (z - hp1[..., 2]) / jnp.where(jnp.abs(dz_h) > 1e-12, dz_h, 1.0)
            pr = hp1 + v_h[..., None] * (hp2 - hp1)
            phi_h = jnp.arctan2(pr[..., 0] * pn[..., 1] - pn[..., 0] * pr[..., 1],
                                pn[..., 0] * pr[..., 0] + pn[..., 1] * pr[..., 1])
            phi = jnp.where(is_hyp, phi_h, phi)
        phi = jnp.where(phi < 0, phi + 2.0 * jnp.pi, phi)
        zlim = jnp.where(is_cyl, jnp.inf, radius)
        full = (p1 <= -zlim + 1e-7 * radius) & (p2 >= zlim - 1e-7 * radius) & \
            (phimax >= 2.0 * jnp.pi - 1e-6) & ~is_cyl & ~is_cone & ~is_para & ~is_hyp
        zlo = jnp.where(is_cone, 0.0, p1)
        zhi = jnp.where(is_cone, p1, p2)
        ok = full | ((z >= zlo) & (z <= zhi) & (phi <= phimax))
        return ok, pn

    okn, pn_near = clip_ok(tn)
    okf, pn_far = clip_ok(tf)
    # reference acceptance (sphere.rs:91-102): a root is usable iff its
    # error interval is strictly positive and within t_max
    near_valid = has_root & (tn_lo > 0) & (tn_hi < t_max) & okn
    far_valid = has_root & (tf_lo > 0) & (tf_hi < t_max) & okf
    t = jnp.where(near_valid, tn, tf)
    p_obj = jnp.where(near_valid[..., None], pn_near, pn_far)
    hit = near_valid | far_valid

    # disk: plane z = height clipped to the annulus (disk.rs)
    dz = od[..., 2]
    td = (p1 - oo[..., 2]) / jnp.where(jnp.abs(dz) > 1e-12, dz, 1.0)
    pd = oo + od * td[..., None]
    d2 = pd[..., 0] ** 2 + pd[..., 1] ** 2
    phi_d = jnp.arctan2(pd[..., 1], pd[..., 0])
    phi_d = jnp.where(phi_d < 0, phi_d + 2.0 * jnp.pi, phi_d)
    # disk.rs accepts any t in (0, t_max) — self-hits are prevented by the
    # error-bounded origin offsets, not an epsilon
    disk_hit = (jnp.abs(dz) > 1e-12) & (td > 0) & (td < t_max) & \
        (d2 <= radius * radius) & (d2 >= p2 * p2) & (phi_d <= phimax)
    pd = jnp.stack([pd[..., 0], pd[..., 1], jnp.broadcast_to(p1, pd[..., 2].shape)], axis=-1)

    hit = jnp.where(is_disk, disk_hit, hit)
    t = jnp.where(is_disk, td, t)
    p_obj = jnp.where(is_disk[..., None], pd, p_obj)
    return hit, t, p_obj


def ray_sphere(o, d, w2o, params, t_max):
    """Sphere-only wrapper around ray_quadric (kept for tests/back-compat)."""
    return ray_quadric(o, d, w2o, params, jnp.zeros(params.shape[:-1], jnp.int32), t_max)


# ---------------------------------------------------------------------------
# AABB slab test (bvh.rs IntersectP with precomputed inv dir)
# ---------------------------------------------------------------------------


def ray_aabb(o, inv_d, lo, hi, t_max):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    t_near = jnp.max(tn, axis=-1)
    t_far = jnp.min(tf, axis=-1) * 1.0000004  # reference's gamma(3) robustness pad
    return (t_near <= t_far) & (t_far > 0) & (t_near < t_max)


# ---------------------------------------------------------------------------
# Per-primitive test against the scene tables
# ---------------------------------------------------------------------------


class Hit:
    """SoA hit record fields packed as a dict pytree."""

    @staticmethod
    def none(shape):
        return {
            "t": jnp.full(shape, INF, F32),
            "prim": jnp.full(shape, -1, jnp.int32),
            "b1": jnp.zeros(shape, F32),
            "b2": jnp.zeros(shape, F32),
        }


def _test_prims(sa: SceneArrays, o, d, t_max, prim_ids, valid, time=None):
    """Test rays against an aligned batch of primitives.

    o, d: (R, 3); prim_ids: (R, K) primitive ids; valid: (R, K) mask;
    time: optional (R,) shutter times — lerps the shutter-close keyframe
    tables (motion blur).
    Returns (t, b1, b2) each (R, K) with t=inf where missed.
    """
    kind = sa.prim_kind[prim_ids]
    geom = sa.prim_geom[prim_ids]

    o_b = o[:, None, :]
    d_b = d[:, None, :]
    tm_b = jnp.broadcast_to(jnp.asarray(t_max, F32)[..., None], kind.shape) if jnp.ndim(t_max) else jnp.full(kind.shape, t_max, F32)

    # triangles
    if sa.tri_p.shape[0] > 0:
        tri_idx = jnp.where(kind == GEOM_TRI, geom, 0)
        tv = sa.tri_p[tri_idx]  # (R, K, 3, 3)
        if time is not None and sa.anim is not None:
            # exact per-ray TRS interpolation (device/motion.py;
            # transform.rs:1493 interpolate applied per candidate)
            from .motion import motion_matrices, xform_point

            G = motion_matrices(sa, prim_ids, time[:, None])  # (R, K, 3, 4)
            tv = xform_point(G[:, :, None], tv)
        elif time is not None and sa.tri_p_end is not None:
            tv = _motion_quad(tv, sa.tri_p_end[tri_idx],
                              sa.tri_p_mid[tri_idx] if sa.tri_p_mid is not None else None,
                              time[:, None, None, None])
        h_t, t_t, _b0, b1_t, b2_t = ray_triangle(o_b, d_b, tv[..., 0, :], tv[..., 1, :], tv[..., 2, :], tm_b)
    else:
        h_t = jnp.zeros(kind.shape, bool)
        t_t = jnp.full(kind.shape, INF, F32)
        b1_t = b2_t = jnp.zeros(kind.shape, F32)

    # spheres
    if sa.sph_param.shape[0] > 0:
        sph_idx = jnp.where(kind == GEOM_SPHERE, geom, 0)
        w2o = sa.sph_w2o[sph_idx]
        if time is not None and sa.anim is not None:
            from .motion import motion_matrices

            w2o = motion_matrices(sa, prim_ids, time[:, None], quadric=True)
        elif time is not None and sa.sph_w2o_end is not None:
            w2o = _motion_quad(w2o, sa.sph_w2o_end[sph_idx],
                               sa.sph_w2o_mid[sph_idx] if sa.sph_w2o_mid is not None else None,
                               time[:, None, None, None])
        par = sa.sph_param[sph_idx]
        qk = sa.sph_kind[sph_idx]
        h_s, t_s, p_obj = ray_quadric(o_b, d_b, w2o, par, qk, tm_b)
    else:
        h_s = jnp.zeros_like(h_t)
        t_s = jnp.full_like(t_t, INF)
        p_obj = jnp.zeros(t_t.shape + (3,), F32)

    is_tri = kind == GEOM_TRI
    hit = valid & jnp.where(is_tri, h_t, h_s)
    t = jnp.where(hit, jnp.where(is_tri, t_t, t_s), INF)
    # barycentrics for triangles; (phi, z-param) encoded via p_obj for spheres
    b1 = jnp.where(is_tri, b1_t, p_obj[..., 0])
    b2 = jnp.where(is_tri, b2_t, p_obj[..., 1])
    # pack sphere z in b0 slot implicitly: recompute z at shade time from t
    return t, b1, b2


def _reduce_best(t, b1, b2, prim_ids):
    """Across the K axis pick the nearest hit."""
    k = jnp.argmin(t, axis=1)
    r = jnp.arange(t.shape[0])
    tbest = t[r, k]
    return {
        "t": tbest,
        "prim": jnp.where(jnp.isfinite(tbest), prim_ids[r, k], -1),
        "b1": b1[r, k],
        "b2": b2[r, k],
    }


# ---------------------------------------------------------------------------
# Brute force (small scenes): all rays x all prims
# ---------------------------------------------------------------------------


def _brute_all(sa: SceneArrays, static: SceneStatic, o, d, t_max, time=None):
    """All-pairs tests with pure broadcasting — zero gathers.

    Returns (t (R, P), b1, b2) in PRIMITIVE-ROW order (tris then spheres by
    their table positions mapped through tri->prim / sph->prim maps built on
    host in SceneStatic... here we reconstruct by concatenation order).
    """
    R = o.shape[0]
    o_b = o[:, None, :]
    d_b = d[:, None, :]
    parts_t, parts_b1, parts_b2, parts_pid = [], [], [], []

    if sa.tri_p.shape[0] > 0:
        tv = sa.tri_p[None, :, :, :]  # (1, T, 3, 3) broadcast
        if time is not None and sa.anim is not None:
            from .motion import motion_matrices, xform_point

            G = motion_matrices(sa, sa.tri_prim_ids[None, :], time[:, None])
            tv = xform_point(G[:, :, None], tv)  # (R, T, 3, 3)
        elif time is not None and sa.tri_p_end is not None:
            tv = _motion_quad(tv, sa.tri_p_end[None],
                              sa.tri_p_mid[None] if sa.tri_p_mid is not None else None,
                              time[:, None, None, None])
        tm = jnp.asarray(t_max, F32)[:, None]
        h, t_t, _b0, b1, b2 = ray_triangle(o_b, d_b, tv[..., 0, :], tv[..., 1, :], tv[..., 2, :], tm)
        parts_t.append(jnp.where(h, t_t, INF))
        parts_b1.append(b1)
        parts_b2.append(b2)
        parts_pid.append(sa.tri_prim_ids)
    if sa.sph_param.shape[0] > 0:
        w2o = sa.sph_w2o[None, :, :, :]
        if time is not None and sa.anim is not None:
            from .motion import motion_matrices

            w2o = motion_matrices(sa, sa.sph_prim_ids[None, :], time[:, None],
                                  quadric=True)
        elif time is not None and sa.sph_w2o_end is not None:
            w2o = _motion_quad(w2o, sa.sph_w2o_end[None],
                               sa.sph_w2o_mid[None] if sa.sph_w2o_mid is not None else None,
                               time[:, None, None, None])
        par = sa.sph_param[None, :, :]
        qk = sa.sph_kind[None, :]
        tm = jnp.asarray(t_max, F32)[:, None]
        h, t_s, p_obj = ray_quadric(o_b, d_b, w2o, par, qk, tm)
        parts_t.append(jnp.where(h, t_s, INF))
        parts_b1.append(p_obj[..., 0])
        parts_b2.append(p_obj[..., 1])
        parts_pid.append(sa.sph_prim_ids)

    t = jnp.concatenate(parts_t, axis=1)
    b1 = jnp.concatenate(parts_b1, axis=1)
    b2 = jnp.concatenate(parts_b2, axis=1)
    pid = jnp.concatenate(parts_pid)
    return t, b1, b2, pid


def _select_min(t, cols):
    """Row-wise argmin selection of several (R, K) arrays without gathers:
    builds the argmin one-hot by equality and reduces."""
    tbest = jnp.min(t, axis=1)
    is_min = t == tbest[:, None]
    # break ties toward the lowest column index
    first = jnp.cumsum(is_min.astype(jnp.int32), axis=1) == 1
    sel = is_min & first
    outs = [jnp.sum(jnp.where(sel, c, 0), axis=1) for c in cols]
    return tbest, sel, outs


def intersect_brute(sa: SceneArrays, static: SceneStatic, o, d, t_max, time=None):
    t, b1, b2, pid = _brute_all(sa, static, o, d, t_max, time)
    R = t.shape[0]
    pid_b = jnp.broadcast_to(pid[None, :].astype(F32), t.shape)
    tbest, _sel, (b1_s, b2_s, pid_s) = _select_min(t, [b1, b2, pid_b])
    return {
        "t": tbest,
        "prim": jnp.where(jnp.isfinite(tbest), pid_s.astype(jnp.int32), -1),
        "b1": b1_s,
        "b2": b2_s,
    }


def intersect_p_brute(sa: SceneArrays, static: SceneStatic, o, d, t_max, time=None):
    t, _, _, _pid = _brute_all(sa, static, o, d, t_max, time)
    return jnp.any(jnp.isfinite(t), axis=1)


# ---------------------------------------------------------------------------
# BVH packet traversal
# ---------------------------------------------------------------------------

PACKET = 256  # rays per packet (share one traversal stack)


def _traverse(sa: SceneArrays, static: SceneStatic, o, d, t_max, any_hit: bool, time=None):
    """Packet BVH traversal: packets of PACKET rays share ONE stack.

    All node/primitive accesses are small (B,)-shaped gathers (B = number of
    packets), the AABB/primitive tests stay vectorized over lanes, and leaf
    primitive rows are CONTIGUOUS (the builder permutes prims into BVH leaf
    order). A packet descends into a subtree if ANY of its rays wants to;
    coherent waves (camera/shadow) lose little, incoherent bounces pay a
    union-of-paths cost (mitigated by ray sorting). This is the plain
    reference for the per-ray kernel in device/bvh_kernel.py and the path
    for every scene that kernel does not cover.
    """
    R = o.shape[0]
    max_leaf = static.max_leaf
    n_prims = static.n_prims
    B = (R + PACKET - 1) // PACKET
    Rp = B * PACKET
    pad = Rp - R

    def pad_to(x, fill):
        if pad == 0:
            return x
        return jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0)

    o_p = pad_to(o, 0.0).reshape(B, PACKET, 3)
    d_p = pad_to(d, 1.0).reshape(B, PACKET, 3)
    time_p = None if time is None else pad_to(jnp.broadcast_to(jnp.asarray(time, F32), (R,)), 0.0).reshape(B, PACKET)
    t0 = jnp.broadcast_to(jnp.asarray(t_max, F32), (R,))
    tm_p = pad_to(t0, -1.0).reshape(B, PACKET)  # padded lanes: t_max<0 -> never hit

    inv_d = 1.0 / jnp.where(jnp.abs(d_p) < 1e-30, jnp.where(d_p < 0, -1e-30, 1e-30), d_p)

    stack = jnp.zeros((B, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((B,), jnp.int32)  # root pre-pushed
    t_best = tm_p
    prim_best = jnp.full((B, PACKET), -1, jnp.int32)
    b1_best = jnp.zeros((B, PACKET), F32)
    b2_best = jnp.zeros((B, PACKET), F32)
    hit_any = jnp.zeros((B, PACKET), bool)

    rows_b = jnp.arange(B)
    node_tab = sa.bvh_packed  # (N, 12)
    ptd = sa.prim_test_data  # (P, 16)
    pkind = sa.prim_kind

    def cond(state):
        sp = state[0]
        return jnp.any(sp > 0)

    def body(state):
        sp, stack, t_best, prim_best, b1_best, b2_best, hit_any = state
        active = sp > 0
        spm = jnp.maximum(sp - 1, 0)
        node = stack[rows_b, spm]  # (B,) gather — B is small
        sp = jnp.where(active, spm, sp)

        row = node_tab[node]  # (B, 12) gather
        lo = row[:, None, 0:3]
        hi = row[:, None, 3:6]
        box = ray_aabb(o_p, inv_d, lo, hi, t_best) & active[:, None]
        anyb = jnp.any(box, axis=1)  # (B,)

        n_leaf = row[:, 7].astype(jnp.int32)
        is_leaf = n_leaf > 0
        off = row[:, 6].astype(jnp.int32)
        axis = row[:, 8].astype(jnp.int32)

        # --- leaf: prims are contiguous rows [off, off+n) ---
        do_leaf = anyb & is_leaf
        k_ids = jnp.clip(off[:, None] + jnp.arange(max_leaf, dtype=jnp.int32)[None, :], 0, max(n_prims - 1, 0))
        k_valid = do_leaf[:, None] & (jnp.arange(max_leaf)[None, :] < n_leaf[:, None])
        rows16 = ptd[k_ids]  # (B, K, 16) gather of B*K rows
        kk = pkind[k_ids]  # (B, K)
        is_tri = kk == GEOM_TRI

        ob = o_p[:, :, None, :]
        db = d_p[:, :, None, :]
        tb = t_best[:, :, None]
        if static.has_instances:
            # instance reuse (primitive.rs TransformedPrimitive intersect):
            # transform the ray into instance space per leaf prim; id 0 is
            # the identity so non-instanced prims pass through unchanged.
            # t is preserved (affine transform, unnormalized direction).
            w2i_k = sa.inst_w2i[sa.prim_inst[k_ids]]  # (B, K, 3, 4)
            ob = _xform_point(w2i_k[:, None], ob)
            db = _xform_vector(w2i_k[:, None], db)
        w2o_exact = None
        if time_p is not None and sa.anim is not None:
            # exact per-(lane, candidate) TRS interpolation: tables gathered
            # at (B, 1, K), evaluated at (B, PACKET, K) via broadcast
            from .motion import motion_matrices, xform_point

            rows16L = None
            G = motion_matrices(sa, k_ids[:, None, :], time_p[:, :, None])
            v0 = xform_point(G, rows16[:, None, :, 0:3])
            v1 = xform_point(G, rows16[:, None, :, 3:6])
            v2 = xform_point(G, rows16[:, None, :, 6:9])
            if sa.sph_param.shape[0] > 0:
                w2o_exact = motion_matrices(sa, k_ids[:, None, :],
                                            time_p[:, :, None], quadric=True)
        elif time_p is not None and sa.prim_test_data_end is not None:
            # per-lane keyframe lerp: (B, 1, K, 16) -> (B, PACKET, K, 16)
            rows16e = sa.prim_test_data_end[k_ids]
            rows16m = (sa.prim_test_data_mid[k_ids][:, None]
                       if sa.prim_test_data_mid is not None else None)
            rows16L = _motion_quad(rows16[:, None], rows16e[:, None], rows16m,
                                   time_p[:, :, None, None])
            v0 = rows16L[..., 0:3]
            v1 = rows16L[..., 3:6]
            v2 = rows16L[..., 6:9]
        else:
            rows16L = None
            v0 = rows16[:, None, :, 0:3]
            v1 = rows16[:, None, :, 3:6]
            v2 = rows16[:, None, :, 6:9]
        h_t, t_t, _b0, b1_t, b2_t = ray_triangle(ob, db, v0, v1, v2, tb)

        if sa.sph_param.shape[0] > 0:
            if w2o_exact is not None:
                w2o = w2o_exact
                spar = rows16[:, None, :, 12:18]
                if rows16.shape[-1] >= 25:
                    spar = jnp.concatenate([spar, rows16[:, None, :, 19:25]], axis=-1)
                qk = rows16[:, None, :, 18].astype(jnp.int32)
            elif rows16L is not None:
                w2o = rows16L[..., 0:12].reshape(rows16L.shape[0], rows16L.shape[1], rows16L.shape[2], 3, 4)
                spar = rows16L[..., 12:18]
                if rows16L.shape[-1] >= 25:
                    # partial-phimax hyperboloid scenes carry p1/p2 in cols
                    # 19:25 for the twisted phi clip (builder prim_test_data)
                    spar = jnp.concatenate([spar, rows16L[..., 19:25]], axis=-1)
                qk = rows16L[..., 18].astype(jnp.int32)
            else:
                w2o = rows16[:, :, 0:12].reshape(rows16.shape[0], rows16.shape[1], 3, 4)[:, None]
                spar = rows16[:, :, 12:18][:, None]
                if rows16.shape[-1] >= 25:
                    spar = jnp.concatenate([spar, rows16[:, :, 19:25][:, None]], axis=-1)
                qk = rows16[:, :, 18].astype(jnp.int32)[:, None]
            h_s, t_s, p_obj = ray_quadric(ob, db, w2o, spar, qk, tb)
            hit_k = jnp.where(is_tri[:, None, :], h_t, h_s)
            t_k = jnp.where(is_tri[:, None, :], t_t, t_s)
            b1_k = jnp.where(is_tri[:, None, :], b1_t, p_obj[..., 0])
            b2_k = jnp.where(is_tri[:, None, :], b2_t, p_obj[..., 1])
        else:
            hit_k, t_k, b1_k, b2_k = h_t, t_t, b1_t, b2_t

        hit_k = hit_k & k_valid[:, None, :]
        t_k = jnp.where(hit_k, t_k, INF)
        # nearest of the K leaf prims per lane (one-hot select, no gathers)
        t_new = jnp.min(t_k, axis=2)
        sel = (t_k == t_new[:, :, None]) & jnp.isfinite(t_k)
        first = jnp.cumsum(sel.astype(jnp.int32), axis=2) == 1
        sel = sel & first
        better = t_new < t_best
        pid_k = jnp.broadcast_to(k_ids[:, None, :].astype(F32), t_k.shape)
        prim_new = jnp.sum(jnp.where(sel, pid_k, 0.0), axis=2).astype(jnp.int32)
        b1_new = jnp.sum(jnp.where(sel, b1_k, 0.0), axis=2)
        b2_new = jnp.sum(jnp.where(sel, b2_k, 0.0), axis=2)
        t_best = jnp.where(better, t_new, t_best)
        prim_best = jnp.where(better, prim_new, prim_best)
        b1_best = jnp.where(better, b1_new, b1_best)
        b2_best = jnp.where(better, b2_new, b2_best)
        hit_any = hit_any | better

        # --- interior: push children near-to-far by majority direction sign ---
        do_int = anyb & ~is_leaf
        # majority vote over lanes that hit the box
        neg_axis = jnp.sum(
            jnp.where(
                box,
                jnp.where(axis[:, None] == 0, d_p[:, :, 0], jnp.where(axis[:, None] == 1, d_p[:, :, 1], d_p[:, :, 2])) < 0,
                False,
            ),
            axis=1,
        )
        n_box = jnp.maximum(jnp.sum(box, axis=1), 1)
        near_first = neg_axis * 2 < n_box  # most lanes travel +axis
        c_near = jnp.where(near_first, node + 1, off)
        c_far = jnp.where(near_first, off, node + 1)
        sp_far = jnp.clip(sp, 0, STACK_DEPTH - 1)
        stack = stack.at[rows_b, sp_far].set(jnp.where(do_int, c_far, stack[rows_b, sp_far]))
        sp = jnp.where(do_int, jnp.minimum(sp + 1, STACK_DEPTH), sp)
        sp_near = jnp.clip(sp, 0, STACK_DEPTH - 1)
        stack = stack.at[rows_b, sp_near].set(jnp.where(do_int, c_near, stack[rows_b, sp_near]))
        sp = jnp.where(do_int, jnp.minimum(sp + 1, STACK_DEPTH), sp)

        if any_hit:
            # a packet stops once EVERY live lane has found an occluder
            all_done = jnp.all(hit_any | (tm_p <= 0), axis=1)
            sp = jnp.where(all_done, 0, sp)

        return sp, stack, t_best, prim_best, b1_best, b2_best, hit_any

    state = (sp, stack, t_best, prim_best, b1_best, b2_best, hit_any)
    sp, stack, t_best, prim_best, b1_best, b2_best, hit_any = jax.lax.while_loop(cond, body, state)

    t_flat = t_best.reshape(Rp)[:R]
    prim_flat = prim_best.reshape(Rp)[:R]
    b1_flat = b1_best.reshape(Rp)[:R]
    b2_flat = b2_best.reshape(Rp)[:R]
    ha_flat = hit_any.reshape(Rp)[:R]
    return {
        "t": jnp.where(ha_flat, t_flat, INF),
        "prim": jnp.where(ha_flat, prim_flat, -1),
        "b1": b1_flat,
        "b2": b2_flat,
    }, ha_flat


def _motion_quad(base, end, mid_gathered, time_b):
    """Per-ray keyframe interpolation: linear between shutter endpoints,
    plus the quadratic arc term through the mid-shutter slerp sample when
    the motion rotates (transform.rs AnimatedTransform applied per ray by
    primitive.rs TransformedPrimitive; parser/api.py bakes the samples)."""
    out = base + time_b * (end - base)
    if mid_gathered is not None:
        out = out + (time_b * (1.0 - time_b)) * (4.0 * mid_gathered - 2.0 * base - 2.0 * end)
    return out


# rays-per-packet coherence: above this primitive count, sort waves by a
# direction-octant + origin-Morton key before traversal so each packet's
# union-of-node-visits shrinks (SURVEY.md 2.12 wavefront mandate; the
# reference's per-thread rays are naturally coherent per tile)
SORT_MIN_PRIMS = 4096


def _morton3(x, y, z):
    """Interleave 3x10-bit -> 30-bit Morton code (bvh.rs left_shift3)."""

    def spread(v):
        v = v & jnp.uint32(0x3FF)
        v = (v | (v << 16)) & jnp.uint32(0x30000FF)
        v = (v | (v << 8)) & jnp.uint32(0x300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x30C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x9249249)
        return v

    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def _ray_sort_key(sa, o, d, t_max=None):
    """Sort key: dead bit (major), 3-bit direction octant, origin Morton.

    Dead lanes (t_max < 0) sort last so they fill whole packets that
    terminate after a single root visit."""
    wc = sa.world_center
    wr = jnp.maximum(sa.world_radius, 1e-6)
    q = jnp.clip((o - wc) / (2.0 * wr) + 0.5, 0.0, 1.0)
    qi = (q * 1023.0).astype(jnp.uint32)
    m = _morton3(qi[:, 0], qi[:, 1], qi[:, 2])
    oct_ = (
        (d[:, 0] < 0).astype(jnp.uint32)
        | ((d[:, 1] < 0).astype(jnp.uint32) << 1)
        | ((d[:, 2] < 0).astype(jnp.uint32) << 2)
    )
    key = (oct_ << 28) | (m >> 2)
    if t_max is not None:
        key = key | ((jnp.asarray(t_max) < 0).astype(jnp.uint32) << 31)
    return key


def _sorted(fn, sa, o, d, t_max, time):
    """Run fn(o, d, t_max, time) on the wave reordered by _ray_sort_key and
    return its outputs in the caller's order."""
    perm = jnp.argsort(_ray_sort_key(sa, o, d, t_max))
    tm = jnp.broadcast_to(jnp.asarray(t_max, F32), (o.shape[0],))[perm]
    time_s = None if time is None else jnp.broadcast_to(jnp.asarray(time, F32), (o.shape[0],))[perm]
    out = fn(o[perm], d[perm], tm, time_s)
    inv = jnp.argsort(perm)
    return jax.tree_util.tree_map(lambda v: v[inv], out)


def _sorted_traverse(sa, static, o, d, t_max, any_hit, time):
    return _sorted(lambda o, d, tm, ts: _traverse(sa, static, o, d, tm, any_hit=any_hit, time=ts),
                   sa, o, d, t_max, time)


def _kernel_traverse(sa, static, o, d, t_max, any_hit, sort):
    """Per-ray traversal kernel where the platform has one (bvh_kernel)."""
    fn = bvh_kernel.occluded if any_hit else bvh_kernel.closest
    if sort:
        return _sorted(lambda o, d, tm, _ts: fn(sa, static, o, d, tm), sa, o, d, t_max, None)
    return fn(sa, static, o, d, t_max)


def _intersect_once(sa: SceneArrays, static: SceneStatic, o, d, t_max, time=None, sort_rays=False):
    """Single closest-hit pass (no alpha cutout handling)."""
    if not static.has_motion:
        time = None
    if static.n_prims == 0:
        return Hit.none((o.shape[0],))
    if static.use_brute_force:
        return intersect_brute(sa, static, o, d, t_max, time)
    if static.accel_kind == "kdtree":
        hit, _ = _traverse_kd(sa, static, o, d, t_max, any_hit=False, time=time)
        return hit
    sort = sort_rays and static.n_prims >= SORT_MIN_PRIMS
    if bvh_kernel.eligible(static):
        return _kernel_traverse(sa, static, o, d, t_max, False, sort)
    if sort:
        hit, _ = _sorted_traverse(sa, static, o, d, t_max, False, time)
        return hit
    hit, _ = _traverse(sa, static, o, d, t_max, any_hit=False, time=time)
    return hit


def _intersect_p_once(sa: SceneArrays, static: SceneStatic, o, d, t_max, time=None, sort_rays=False):
    """Single any-hit pass (no alpha cutout handling)."""
    if not static.has_motion:
        time = None
    if static.n_prims == 0:
        return jnp.zeros(o.shape[0], bool)
    if static.use_brute_force:
        return intersect_p_brute(sa, static, o, d, t_max, time)
    if static.accel_kind == "kdtree":
        _, hit_any = _traverse_kd(sa, static, o, d, t_max, any_hit=True, time=time)
        return hit_any
    sort = sort_rays and static.n_prims >= SORT_MIN_PRIMS
    if bvh_kernel.eligible(static):
        return _kernel_traverse(sa, static, o, d, t_max, True, sort)
    if sort:
        _, hit_any = _sorted_traverse(sa, static, o, d, t_max, True, time)
        return hit_any
    _, hit_any = _traverse(sa, static, o, d, t_max, any_hit=True, time=time)
    return hit_any


# ---------------------------------------------------------------------------
# Kd-tree packet traversal (kdtreeaccel.rs:411-524 KdToDo stack walk).
# Packets of PACKET rays share one (node, tmin, tmax) stack; the child
# intervals are per-packet conservative (min/max of the per-lane split
# crossings; mixed-direction packets push both children with the full
# interval), so no lane can miss a hit. Chosen by `Accelerator "kdtree"` —
# parity with the reference; the BVH remains the performance default.
# ---------------------------------------------------------------------------

KD_STACK = 96


def _traverse_kd(sa: SceneArrays, static: SceneStatic, o, d, t_max, any_hit: bool, time=None):
    R = o.shape[0]
    K = static.kd_max_leaf
    B = (R + PACKET - 1) // PACKET
    Rp = B * PACKET
    pad = Rp - R

    def pad_to(x, fill):
        if pad == 0:
            return x
        return jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0)

    o_p = pad_to(o, 0.0).reshape(B, PACKET, 3)
    d_p = pad_to(d, 1.0).reshape(B, PACKET, 3)
    tm0 = jnp.broadcast_to(jnp.asarray(t_max, F32), (R,))
    tm_p = pad_to(tm0, -1.0).reshape(B, PACKET)
    time_p = None if time is None else pad_to(jnp.broadcast_to(jnp.asarray(time, F32), (R,)), 0.0).reshape(B, PACKET)
    inv_d = 1.0 / jnp.where(jnp.abs(d_p) < 1e-30, jnp.where(d_p < 0, -1e-30, 1e-30), d_p)

    # root interval per lane, conservative per packet
    lo = jnp.asarray(sa.kd_lo, F32)
    hi = jnp.asarray(sa.kd_hi, F32)
    t0l = (lo[None, None, :] - o_p) * inv_d
    t1l = (hi[None, None, :] - o_p) * inv_d
    tn_l = jnp.max(jnp.minimum(t0l, t1l), axis=-1)
    tf_l = jnp.min(jnp.maximum(t0l, t1l), axis=-1) * 1.0000004
    lane_ok = (tn_l <= tf_l) & (tf_l > 0) & (tm_p > 0)
    root_tmin = jnp.min(jnp.where(lane_ok, jnp.maximum(tn_l, 0.0), jnp.inf), axis=1)
    root_tmax = jnp.max(jnp.where(lane_ok, jnp.minimum(tf_l, tm_p), -jnp.inf), axis=1)
    any_lane = jnp.any(lane_ok, axis=1)

    stack_n = jnp.zeros((B, KD_STACK), jnp.int32)
    stack_lo = jnp.zeros((B, KD_STACK), F32)
    stack_hi = jnp.zeros((B, KD_STACK), F32)
    stack_lo = stack_lo.at[:, 0].set(jnp.where(any_lane, root_tmin, 1.0))
    stack_hi = stack_hi.at[:, 0].set(jnp.where(any_lane, root_tmax, 0.0))
    sp = jnp.where(any_lane, 1, 0)

    t_best = tm_p
    prim_best = jnp.full((B, PACKET), -1, jnp.int32)
    b1_best = jnp.zeros((B, PACKET), F32)
    b2_best = jnp.zeros((B, PACKET), F32)
    hit_any = jnp.zeros((B, PACKET), bool)
    rows_b = jnp.arange(B)

    flags = sa.kd_flags
    split = sa.kd_split
    abv = sa.kd_above
    nprim = sa.kd_nprims
    pids_tab = sa.kd_prim_ids

    def cond(state):
        return jnp.any(state[0] > 0)

    def body(state):
        (sp, stack_n, stack_lo, stack_hi, t_best, prim_best, b1_best, b2_best, hit_any) = state
        active = sp > 0
        spm = jnp.maximum(sp - 1, 0)
        node = stack_n[rows_b, spm]
        tmn = stack_lo[rows_b, spm]
        tmx = stack_hi[rows_b, spm]
        sp = jnp.where(active, spm, sp)

        fl = flags[node]
        is_leaf = fl == 3
        # prune: nothing in this interval can beat any lane's current best
        worth = tmn <= jnp.max(jnp.where(tm_p > 0, t_best, -jnp.inf), axis=1) + 1e-5
        go = active & worth & (tmn <= tmx + 1e-5)

        # --- leaf: test up to K listed prims ---
        do_leaf = go & is_leaf
        off = abv[node]
        n_l = nprim[node]
        kk = jnp.arange(K, dtype=jnp.int32)[None, :]
        ids = pids_tab[jnp.clip(off[:, None] + kk, 0, max(pids_tab.shape[0] - 1, 0))]  # (B, K)
        valid = do_leaf[:, None] & (kk < n_l[:, None])
        ids_f = jnp.broadcast_to(ids[:, None, :], (B, PACKET, K)).reshape(B * PACKET, K)
        val_f = jnp.broadcast_to(valid[:, None, :], (B, PACKET, K)).reshape(B * PACKET, K)
        t_k, b1_k, b2_k = _test_prims(
            sa, o_p.reshape(-1, 3), d_p.reshape(-1, 3), t_best.reshape(-1), ids_f, val_f,
            time=None if time_p is None else time_p.reshape(-1),
        )
        t_k = t_k.reshape(B, PACKET, K)
        b1_k = b1_k.reshape(B, PACKET, K)
        b2_k = b2_k.reshape(B, PACKET, K)
        t_new = jnp.min(t_k, axis=2)
        sel = (t_k == t_new[:, :, None]) & jnp.isfinite(t_k)
        first = jnp.cumsum(sel.astype(jnp.int32), axis=2) == 1
        sel = sel & first
        better = t_new < t_best
        pid_k = jnp.broadcast_to(ids[:, None, :].astype(F32), t_k.shape)
        prim_new = jnp.sum(jnp.where(sel, pid_k, 0.0), axis=2).astype(jnp.int32)
        t_best = jnp.where(better, t_new, t_best)
        prim_best = jnp.where(better, prim_new, prim_best)
        b1_best = jnp.where(better, jnp.sum(jnp.where(sel, b1_k, 0.0), axis=2), b1_best)
        b2_best = jnp.where(better, jnp.sum(jnp.where(sel, b2_k, 0.0), axis=2), b2_best)
        hit_any = hit_any | better

        # --- interior: split-plane crossings ---
        do_int = go & ~is_leaf
        ax = jnp.clip(fl, 0, 2)
        o_a = jnp.take_along_axis(o_p, jnp.broadcast_to(ax[:, None, None], (B, PACKET, 1)), axis=2)[:, :, 0]
        i_a = jnp.take_along_axis(inv_d, jnp.broadcast_to(ax[:, None, None], (B, PACKET, 1)), axis=2)[:, :, 0]
        tp = (split[node][:, None] - o_a) * i_a  # (B, PACKET)
        below_first_l = (o_a < split[node][:, None]) | ((o_a == split[node][:, None]) & (jnp.take_along_axis(d_p, jnp.broadcast_to(ax[:, None, None], (B, PACKET, 1)), axis=2)[:, :, 0] <= 0))
        n_below = jnp.sum(below_first_l & (tm_p > 0), axis=1)
        n_lanes = jnp.maximum(jnp.sum(tm_p > 0, axis=1), 1)
        mixed = (n_below > 0) & (n_below < n_lanes)
        below_first = n_below * 2 >= n_lanes
        tp_lo = jnp.min(jnp.where(tm_p > 0, tp, jnp.inf), axis=1)
        tp_hi = jnp.max(jnp.where(tm_p > 0, tp, -jnp.inf), axis=1)
        # conservative child intervals (full interval when signs are mixed)
        near_hi = jnp.where(mixed, tmx, jnp.minimum(tmx, tp_hi))
        far_lo = jnp.where(mixed, tmn, jnp.maximum(tmn, tp_lo))
        below = jnp.where(below_first, node + 1, abv[node])
        above_c = jnp.where(below_first, abv[node], node + 1)
        # push far then near (near pops first)
        push_far = do_int & (far_lo <= tmx + 1e-5)
        spc = jnp.clip(sp, 0, KD_STACK - 1)
        stack_n = stack_n.at[rows_b, spc].set(jnp.where(push_far, above_c, stack_n[rows_b, spc]))
        stack_lo = stack_lo.at[rows_b, spc].set(jnp.where(push_far, far_lo, stack_lo[rows_b, spc]))
        stack_hi = stack_hi.at[rows_b, spc].set(jnp.where(push_far, tmx, stack_hi[rows_b, spc]))
        sp = jnp.where(push_far, jnp.minimum(sp + 1, KD_STACK), sp)
        push_near = do_int & (tmn <= near_hi + 1e-5)
        spc = jnp.clip(sp, 0, KD_STACK - 1)
        stack_n = stack_n.at[rows_b, spc].set(jnp.where(push_near, below, stack_n[rows_b, spc]))
        stack_lo = stack_lo.at[rows_b, spc].set(jnp.where(push_near, tmn, stack_lo[rows_b, spc]))
        stack_hi = stack_hi.at[rows_b, spc].set(jnp.where(push_near, near_hi, stack_hi[rows_b, spc]))
        sp = jnp.where(push_near, jnp.minimum(sp + 1, KD_STACK), sp)

        if any_hit:
            all_done = jnp.all(hit_any | (tm_p <= 0), axis=1)
            sp = jnp.where(all_done, 0, sp)
        return (sp, stack_n, stack_lo, stack_hi, t_best, prim_best, b1_best, b2_best, hit_any)

    state = (sp, stack_n, stack_lo, stack_hi, t_best, prim_best, b1_best, b2_best, hit_any)
    state = jax.lax.while_loop(cond, body, state)
    (_sp, _sn, _sl, _sh, t_best, prim_best, b1_best, b2_best, hit_any) = state

    t_flat = t_best.reshape(Rp)[:R]
    prim_flat = prim_best.reshape(Rp)[:R]
    ha_flat = hit_any.reshape(Rp)[:R]
    return {
        "t": jnp.where(ha_flat, t_flat, INF),
        "prim": jnp.where(ha_flat, prim_flat, -1),
        "b1": b1_best.reshape(Rp)[:R],
        "b2": b2_best.reshape(Rp)[:R],
    }, ha_flat


# ---------------------------------------------------------------------------
# Alpha cutouts (triangle.rs:29-30 alpha_mask / shadow_alpha_mask): hits on
# prims whose alpha texture evaluates to 0 are ignored. The reference tests
# alpha inside Triangle::intersect; the wavefront equivalent re-casts the
# ray from just past each cut hit, a bounded number of times (cut lanes are
# masked with t_max < 0 in the re-cast, so extra passes are nearly free).
# ---------------------------------------------------------------------------

ALPHA_PASSES = 4


def _alpha_cut_mask(sa: SceneArrays, static: SceneStatic, hit, o, d, shadow: bool):
    """True where the hit lands on a zero-alpha point of a masked prim."""
    prim = jnp.maximum(hit["prim"], 0)
    tex = (sa.prim_shadow_alpha_tex if shadow else sa.prim_alpha_tex)[prim]
    geom = sa.prim_geom[prim]
    is_tri = sa.prim_kind[prim] == GEOM_TRI
    uvv = sa.tri_uv[jnp.where(is_tri, geom, 0)]
    b1 = hit["b1"][:, None]
    b2 = hit["b2"][:, None]
    uv = (1.0 - b1 - b2) * uvv[:, 0] + b1 * uvv[:, 1] + b2 * uvv[:, 2]
    p_hit = o + d * hit["t"][:, None]
    from .texture import eval_textures

    vals = eval_textures(sa, static.tex_programs, uv, p_hit)
    a = jnp.ones(uv.shape[0], F32)
    for xi in range(len(static.tex_programs)):
        a = jnp.where(tex == xi, vals[xi][:, 0], a)
    return (hit["prim"] >= 0) & is_tri & (tex >= 0) & (a == 0.0)


def _intersect_alpha(sa, static, o, d, t_max, time, sort_rays, shadow: bool):
    """Closest non-cut hit. Returns hit dict with t relative to `o`."""
    R = o.shape[0]
    tm0 = jnp.broadcast_to(jnp.asarray(t_max, F32), (R,))
    o_cur = o
    acc = jnp.zeros(R, F32)
    hit = _intersect_once(sa, static, o_cur, d, tm0, time, sort_rays)
    for _ in range(ALPHA_PASSES):
        cut = _alpha_cut_mask(sa, static, hit, o_cur, d, shadow)
        adv = hit["t"] * (1.0 + 1e-4) + 1e-4
        o_cur = jnp.where(cut[:, None], o_cur + d * adv[:, None], o_cur)
        acc = acc + jnp.where(cut, adv, 0.0)
        tq = jnp.where(cut, tm0 - acc, -1.0)
        h2 = _intersect_once(sa, static, o_cur, d, tq, time, sort_rays)
        hit = {k: jnp.where(cut if v.ndim == 1 else cut, h2[k], v) for k, v in hit.items()}
    # residual cut hits after the pass budget: drop (conservative)
    cut = _alpha_cut_mask(sa, static, hit, o_cur, d, shadow)
    t_final = jnp.where(cut, INF, hit["t"]) + acc
    prim = jnp.where(cut | (hit["prim"] < 0), -1, hit["prim"])
    return {
        "t": jnp.where(prim >= 0, t_final, INF),
        "prim": prim,
        "b1": hit["b1"],
        "b2": hit["b2"],
    }


def intersect(sa: SceneArrays, static: SceneStatic, o, d, t_max, time=None, sort_rays=False):
    """Closest-hit query. Returns hit dict {t, prim, b1, b2}.

    sort_rays: opt-in wave reordering for incoherent bounces on big scenes
    (integrator sets it for bounce >= 1)."""
    if getattr(static, "has_alpha", False) and static.n_prims > 0:
        return _intersect_alpha(sa, static, o, d, t_max, time, sort_rays, shadow=False)
    return _intersect_once(sa, static, o, d, t_max, time, sort_rays)


def intersect_p(sa: SceneArrays, static: SceneStatic, o, d, t_max, time=None, sort_rays=False):
    """Any-hit (shadow) query -> bool (R,). (scene.rs intersect_p)"""
    if getattr(static, "has_alpha", False) and static.n_prims > 0:
        hit = _intersect_alpha(sa, static, o, d, t_max, time, sort_rays, shadow=True)
        return hit["prim"] >= 0
    return _intersect_p_once(sa, static, o, d, t_max, time, sort_rays)
