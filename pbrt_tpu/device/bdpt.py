"""Bidirectional path tracing (BDPT).

Array-program redesign of src/integrators/bdpt.rs: the reference's per-pixel
camera/light subpath generation (:861, :896) becomes two batched random
walks filling fixed-width SoA vertex arrays (R, NV, ...); every (s, t)
connection strategy (:1250) runs as a masked batched kernel over the whole
wave; t=1 strategies splat through segment_sum instead of AtomicFloat film
splats (:798-803).

MIS weights use the balance-style remapped pdf-ratio walk of
bdpt.rs mis_weight with the four junction pdf overrides computed on the
fly. Delta-light/endpoint handling follows the reference; pdfs for
infinite/distant endpoints use consistent approximations (the ratio-sum
weight form stays a partition of unity for any consistent positive pdfs,
so the estimator remains unbiased).

Sample streams: BDPT standalone uses the stateless hash samplers; MLT
passes explicit primary-sample arrays through the same `prov` interface.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..scene.arrays import LIGHT_AREA, SceneArrays, SceneStatic
from . import rng
from .bsdf import (
    N_SLOTS,
    _is_specular,
    bsdf_f,
    bsdf_pdf,
    bsdf_sample,
    correct_shading_normal,
    num_lobes,
)
from .camera import camera_sample_wi, generate_rays
from .integrator import _dot, _offset_ray, _to_local, _to_world
from .intersect import intersect, intersect_p
from .lights import (
    area_light_emission,
    compute_power,
    env_le,
    env_pdf_li,
    sample_le,
    sample_li,
)
from .materials import make_bsdf
from .sampler import sample_1d, sample_2d
from .shading import apply_bump, surface_interaction

F32 = jnp.float32

VT_NONE = 0
VT_CAMERA = 1
VT_LIGHT = 2
VT_SURFACE = 3


# ---------------------------------------------------------------------------
# sample providers
# ---------------------------------------------------------------------------


def prov_1d(prov, dim: int):
    if prov[0] == "hash":
        _, seed, pid, sidx = prov
        return sample_1d("zerotwosequence", seed, pid, sidx, dim, 1)
    u = prov[1]
    return u[:, min(dim, u.shape[1] - 1)]


def prov_2d(prov, dim: int):
    if prov[0] == "hash":
        _, seed, pid, sidx = prov
        return sample_2d("zerotwosequence", seed, pid, sidx, dim, 1)
    u = prov[1]
    return u[:, min(2 * dim, u.shape[1] - 1)], u[:, min(2 * dim + 1, u.shape[1] - 1)]


# ---------------------------------------------------------------------------
# vertex SoA helpers
# ---------------------------------------------------------------------------


def _empty_vertices(R, NV):
    return {
        "type": jnp.zeros((R, NV), jnp.int32),
        "p": jnp.zeros((R, NV, 3), F32),
        "ng": jnp.zeros((R, NV, 3), F32),
        "ns": jnp.zeros((R, NV, 3), F32),
        "ss": jnp.zeros((R, NV, 3), F32),
        "ts": jnp.zeros((R, NV, 3), F32),
        "wo": jnp.zeros((R, NV, 3), F32),  # toward previous vertex
        "beta": jnp.zeros((R, NV, 3), F32),
        "pdf_fwd": jnp.zeros((R, NV), F32),
        "pdf_rev": jnp.zeros((R, NV), F32),
        "delta": jnp.zeros((R, NV), bool),
        "light": jnp.full((R, NV), -1, jnp.int32),
        "kind": jnp.zeros((R, NV, N_SLOTS), jnp.int32),
        "data": jnp.zeros((R, NV, N_SLOTS, 14), F32),
    }


def _set_v(v, i, **kw):
    for k, val in kw.items():
        v[k] = v[k].at[:, i].set(val)
    return v


def _gather(v, i):
    # is_delta_light is a per-path (R,) endpoint flag, not a vertex column
    return {k: a[:, i] for k, a in v.items() if k != "is_delta_light"}


def _convert_pdf(pdf_dir, p_from, p_to, ng_to):
    """Solid-angle pdf at p_from -> area pdf at p_to (vertex.rs
    convert_density)."""
    w = p_to - p_from
    d2 = jnp.maximum(_dot(w, w), 1e-20)
    inv_d2 = 1.0 / d2
    cos = jnp.abs(_dot(ng_to, w * jnp.sqrt(inv_d2)[:, None]))
    return pdf_dir * inv_d2 * jnp.where(jnp.any(ng_to != 0, axis=-1), cos, 1.0)


def _si_frames(si):
    return {"ss": si["ss"], "ts": si["ts"], "ns": si["ns"]}


def _vertex_f(vtx, possible, w_to, mode: str = "radiance"):
    """BSDF value at a stored vertex toward direction w_to (vertex.rs f()):
    `bsdf.f(wo, wi, mode) * correct_shading_normal(...)` — light-subpath
    vertices evaluate in importance mode with the shading-normal
    correction (bdpt.rs:356-366)."""
    lob = {"kind": vtx["kind"], "data": vtx["data"], "possible": possible}
    fr = {"ss": vtx["ss"], "ts": vtx["ts"], "ns": vtx["ns"]}
    wo_l = _to_local(fr, vtx["wo"])
    wi_l = _to_local(fr, w_to)
    refl = _dot(w_to, vtx["ng"]) * _dot(vtx["wo"], vtx["ng"]) > 0
    f = bsdf_f(lob, wo_l, wi_l, refl, mode) * jnp.abs(_dot(w_to, vtx["ns"]))[:, None]
    if mode == "importance":
        f = f * correct_shading_normal(vtx["ns"], vtx["ng"], vtx["wo"], w_to)[:, None]
    return f


def _vertex_pdf_dir(vtx, possible, w_prev, w_next):
    """Directional bsdf pdf at a vertex: sample w_next given came-from
    w_prev (vertex.rs pdf())."""
    lob = {"kind": vtx["kind"], "data": vtx["data"], "possible": possible}
    fr = {"ss": vtx["ss"], "ts": vtx["ts"], "ns": vtx["ns"]}
    return bsdf_pdf(lob, _to_local(fr, w_prev), _to_local(fr, w_next))


def _norm(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


# ---------------------------------------------------------------------------
# subpath generation
# ---------------------------------------------------------------------------


def _random_walk(sa, static, possible, prov, dim0, v, start, n_steps, o, d, beta, pdf_dir, alive, mode):
    """Extend a subpath with up to n_steps surface vertices.

    Writes vertices start..start+n_steps-1. Returns (v, n_valid)."""
    R = o.shape[0]
    for i in range(n_steps):
        idx = start + i
        dim = dim0 + i * 3
        hit = intersect(sa, static, o, d, jnp.full(R, jnp.inf, F32))
        si = surface_interaction(sa, hit, o, d)
        si = apply_bump(sa, static, si)
        ok = alive & si["valid"]

        lobes = make_bsdf(sa, static, si["mat"], si["uv"], si["p"])
        pdf_area = _convert_pdf(pdf_dir, o, si["p"], si["ng"])
        v = _set_v(
            v,
            idx,
            type=jnp.where(ok, VT_SURFACE, v["type"][:, idx]),
            p=jnp.where(ok[:, None], si["p"], v["p"][:, idx]),
            ng=jnp.where(ok[:, None], si["ng"], v["ng"][:, idx]),
            ns=jnp.where(ok[:, None], si["ns"], v["ns"][:, idx]),
            ss=jnp.where(ok[:, None], si["ss"], v["ss"][:, idx]),
            ts=jnp.where(ok[:, None], si["ts"], v["ts"][:, idx]),
            wo=jnp.where(ok[:, None], si["wo"], v["wo"][:, idx]),
            beta=jnp.where(ok[:, None], beta, v["beta"][:, idx]),
            pdf_fwd=jnp.where(ok, pdf_area, v["pdf_fwd"][:, idx]),
            light=jnp.where(ok, si["light"], v["light"][:, idx]),
            kind=jnp.where(ok[:, None], lobes["kind"], v["kind"][:, idx]),
            data=jnp.where(ok[:, None, None], lobes["data"], v["data"][:, idx]),
        )

        if i == n_steps - 1:
            alive = ok
            break

        u_lo = prov_1d(prov, dim)
        u1, u2 = prov_2d(prov, dim + 1)
        wo_l = _to_local(si, si["wo"])
        bs = bsdf_sample(lobes, wo_l, u_lo, u1, u2, mode)
        wi_w = _to_world(si, bs["wi"])
        thru = bs["f"] * (jnp.abs(_dot(wi_w, si["ns"])) / jnp.maximum(bs["pdf"], 1e-30))[:, None]
        if mode == "importance":
            # adjoint shading-normal correction on every light-walk scatter
            # (bdpt.rs:1048 "*beta *= correct_shading_normal(...)")
            thru = thru * correct_shading_normal(si["ns"], si["ng"], si["wo"], wi_w)[:, None]
        cont = ok & bs["valid"] & (num_lobes(lobes) > 0) & jnp.any(thru > 0, axis=-1)

        # reverse pdf at THIS vertex's predecessor (vertex.rs pdf fwd/rev)
        pdf_rev_dir = _vertex_pdf_dir(_gather(v, idx), possible, wi_w, si["wo"])
        prev_p = o
        prev_ng = v["ng"][:, idx - 1] if idx > 0 else jnp.zeros((R, 3), F32)
        pdf_rev_area = _convert_pdf(pdf_rev_dir, si["p"], prev_p, prev_ng)
        if idx > 0:
            v["pdf_rev"] = v["pdf_rev"].at[:, idx - 1].set(jnp.where(cont, pdf_rev_area, v["pdf_rev"][:, idx - 1]))
        v["delta"] = v["delta"].at[:, idx].set(bs["specular"] & cont)

        beta = jnp.where(cont[:, None], beta * thru, beta)
        pdf_dir = jnp.where(bs["specular"], 0.0, bs["pdf"])
        o = _offset_ray(si["p"], si["ng"], wi_w, si.get("p_err"))
        d = wi_w
        alive = cont

    n_valid = jnp.sum(v["type"] != VT_NONE, axis=1)
    return v, n_valid


def generate_camera_subpath(sa, static, possible, prov, cam, pxf, pyf, max_t):
    """(bdpt.rs generate_camera_subpath :861): camera vertex + walk.

    pxf/pyf: float raster positions (the caller owns pixel jitter so MLT's
    primary-sample mapping stays measure-preserving)."""
    R = pxf.shape[0]
    NV = max_t
    v = _empty_vertices(R, NV)
    ul1, ul2 = prov_2d(prov, 1)
    o, d = generate_rays(cam, pxf, pyf, ul1, ul2)

    cam_p = jnp.broadcast_to(cam["camera_to_world"][:3, 3], (R, 3))
    v = _set_v(
        v,
        0,
        type=jnp.full(R, VT_CAMERA, jnp.int32),
        p=cam_p,
        beta=jnp.ones((R, 3), F32),
        pdf_fwd=jnp.ones(R, F32),
    )
    from .camera import camera_pdf_we

    _pdf_pos, pdf_dir = camera_pdf_we(cam, d)
    v, _n = _random_walk(
        sa, static, possible, prov, 4, v, 1, max_t - 1, o, d, jnp.ones((R, 3), F32), pdf_dir, jnp.ones(R, bool), "radiance"
    )
    n_cam = jnp.sum(v["type"] != VT_NONE, axis=1)
    return v, n_cam


def _light_emission_pdf_dir(sa, static, lid, n_l, d):
    """Per-kind emission-direction pdf for light `lid` emitting along d
    (the directional half of pdf_le). MUST be used identically by the
    light-walk forward pdf (generate_light_subpath) and every MIS override
    that re-derives a light's emission pdf (connect s==1) — the remapped
    pdf-ratio walk is a partition of unity only when the SAME pdf function
    appears on both sides. Matches sample_le's samplers: area cosine-
    hemisphere, spot/projection uniform cone, point/gonio uniform sphere."""
    kindl = sa.light_kind[lid]
    pdf_dir = jnp.full(lid.shape, 1.0 / (4.0 * jnp.pi), F32)
    if static.has_area_lights:
        from .lights import area_light_pdf_dir

        is_area = kindl == LIGHT_AREA
        pdf_dir = jnp.where(is_area, area_light_pdf_dir(sa, lid, n_l, d), pdf_dir)
    from ..scene.arrays import LIGHT_PROJECTION, LIGHT_SPOT

    if any(k in (LIGHT_SPOT, LIGHT_PROJECTION) for k in static.light_kinds):
        # cone-sampled emitters (spot.rs / projection.rs pdf_le):
        # pdf_dir = 1/(2pi(1-cosTotalWidth)), matching sample_le's sampler
        from .lights import _projection_cos_total

        parl = sa.light_param[lid]
        pdf_dir = jnp.where(
            kindl == LIGHT_SPOT,
            1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - parl[:, 9]), 1e-9), pdf_dir)
        pdf_dir = jnp.where(
            kindl == LIGHT_PROJECTION,
            1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - _projection_cos_total(parl)), 1e-9),
            pdf_dir)
    return pdf_dir


def generate_light_subpath(sa, static, possible, prov, dim0, power_cdf, max_s):
    """(bdpt.rs generate_light_subpath :896): light vertex + walk."""
    if static.n_lights == 0:
        v = _empty_vertices(prov_1d(prov, dim0).shape[0], max_s)
        return v, jnp.zeros(v["type"].shape[0], jnp.int32)
    u_l = prov_1d(prov, dim0)
    R = u_l.shape[0]
    NV = max_s
    v = _empty_vertices(R, NV)
    lid = jnp.clip(jnp.searchsorted(power_cdf, u_l, side="right").astype(jnp.int32), 0, static.n_lights - 1)
    sel_pdf = power_cdf[lid] - jnp.where(lid > 0, power_cdf[lid - 1], 0.0)
    u1a = prov_1d(prov, dim0 + 1)
    u1b = prov_1d(prov, dim0 + 2)
    u2a = prov_1d(prov, dim0 + 3)
    u2b = prov_1d(prov, dim0 + 4)
    em = sample_le(sa, static, lid, u1a, u1b, u2a, u2b)
    beta = em["le_over_pdf"] / jnp.maximum(sel_pdf, 1e-12)[:, None]
    alive = jnp.any(beta > 0, axis=-1)

    # light endpoint vertex: area lights have a real surface point + normal
    kindl = sa.light_kind[lid]
    is_area = kindl == LIGHT_AREA
    n_l = jnp.zeros((R, 3), F32)
    if static.has_area_lights:
        # the sampled point's true surface normal (sample_le returns it);
        # using the emission direction here biased every endpoint pdf
        # conversion (cos(n,d) degenerated to 1)
        n_l = jnp.where(is_area[:, None], em["n"], n_l)
    # origin pdf in area measure (vertex.rs pdf_light_origin): delta lights
    # have a delta position (=sel only); area lights are uniform over area
    pdf_origin = sel_pdf
    if static.has_area_lights:
        area_l = sa.prim_area[jnp.maximum(sa.light_prim[lid], 0)]
        pdf_origin = jnp.where(is_area, sel_pdf / jnp.maximum(area_l, 1e-12), sel_pdf)
    v = _set_v(
        v,
        0,
        type=jnp.where(alive, VT_LIGHT, VT_NONE),
        p=em["o"],
        ng=n_l,
        ns=n_l,
        beta=jnp.where(alive[:, None], beta, 0.0),
        pdf_fwd=pdf_origin,
        light=lid,
    )
    # delta-position lights exclude the s=0 alternative in the MIS walk.
    # The reference (bdpt.rs:1225-1228) consults is_delta_light ONLY for the
    # i==0 term; storing it in the vertex delta flag would also wrongly
    # exclude the i==1 term (the valid s=1 NEE alternative), so it lives in
    # a separate per-path field and delta[0] stays false.
    from ..scene.arrays import _DELTA_LIGHTS

    is_delta_l = jnp.zeros(R, bool)
    for dk in _DELTA_LIGHTS:
        is_delta_l = is_delta_l | (kindl == dk)
    v["is_delta_light"] = is_delta_l
    pdf_dir = _light_emission_pdf_dir(sa, static, lid, n_l, em["d"])
    v, _ = _random_walk(sa, static, possible, prov, dim0 + 5, v, 1, max_s - 1, em["o"], em["d"], beta, pdf_dir, alive, "importance")
    n_light = jnp.sum(v["type"] != VT_NONE, axis=1)
    return v, n_light


# ---------------------------------------------------------------------------
# MIS weight (bdpt.rs mis_weight :1100-1240)
# ---------------------------------------------------------------------------


def _remap0(x):
    return jnp.where(x > 0, x, 1.0)


def _mis_weight(cam_v, light_v, s: int, t: int, overrides):
    """Balance-heuristic weight for strategy (s, t).

    overrides: dict idx->(which_side, value) replacing pdf_rev at the
    junction vertices (the reference's ScopedAssignment edits)."""
    if s + t == 2:
        return jnp.ones(cam_v["type"].shape[0], F32)
    R = cam_v["type"].shape[0]
    sum_ri = jnp.zeros(R, F32)

    def rev_of(side_v, i, side):
        ov = overrides.get((side, i))
        if ov is not None:
            return ov
        return side_v["pdf_rev"][:, i]

    # camera side: strategies using more light vertices
    ri = jnp.ones(R, F32)
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(rev_of(cam_v, i, "cam")) / _remap0(cam_v["pdf_fwd"][:, i])
        d_i = cam_v["delta"][:, i]
        d_prev = cam_v["delta"][:, i - 1] if i - 1 > 0 else jnp.zeros(R, bool)
        sum_ri = sum_ri + jnp.where(~d_i & ~d_prev, ri, 0.0)

    # light side. The i==0 term alone is gated on is_delta_light
    # (bdpt.rs:1225-1228 delta_light_vertex); for i>0 the previous VERTEX
    # delta flag applies (always false at the light endpoint itself, so the
    # s=1 NEE alternative stays counted for point/spot/distant lights).
    is_delta_light = light_v.get("is_delta_light")
    if is_delta_light is None:
        is_delta_light = jnp.zeros(R, bool)
    ri = jnp.ones(R, F32)
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(rev_of(light_v, i, "light")) / _remap0(light_v["pdf_fwd"][:, i])
        d_i = light_v["delta"][:, i]
        d_prev = is_delta_light if i == 0 else light_v["delta"][:, i - 1]
        sum_ri = sum_ri + jnp.where(~d_i & ~d_prev, ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


# ---------------------------------------------------------------------------
# connection strategies (bdpt.rs connect_bdpt :1250)
# ---------------------------------------------------------------------------


def connect_bdpt(sa, static, possible, cam, prov, cam_v, n_cam, light_v, n_light, s: int, t: int, power_cdf, nee_dim):
    """Contribution of strategy (s, t) for every ray lane.

    Returns (L (R,3) MIS-weighted, w (R,) the MIS weight — the debug films
    divide it back out, bdpt.rs:686-709). t >= 2 here; t == 1 handled by
    connect_t1."""
    R = cam_v["type"].shape[0]
    sel_pdf_uniform = 1.0 / max(static.n_lights, 1)
    pt = _gather(cam_v, t - 1)
    pt_ok = (n_cam >= t) & (pt["type"] != VT_NONE)

    if s == 0:
        # camera path alone: pt must lie on a light (bdpt.rs :1270)
        lid = pt["light"]
        emitting = pt_ok & (lid >= 0)
        if not static.has_area_lights:
            return jnp.zeros((R, 3), F32), None
        le = area_light_emission(sa, lid, pt["ng"], pt["wo"])
        L = pt["beta"] * le
        # overrides: pt.pdf_rev <- pdf_light_origin; pt-1.pdf_rev <- pdf_light
        area = sa.prim_area[jnp.maximum(sa.light_prim[jnp.maximum(lid, 0)], 0)]
        pdf_origin = (1.0 / jnp.maximum(area, 1e-12)) * sel_pdf_uniform
        prev = _gather(cam_v, t - 2)
        w_dir = _norm(prev["p"] - pt["p"])
        from .lights import area_light_pdf_dir

        pdf_dir = area_light_pdf_dir(sa, lid, pt["ng"], w_dir)
        pdf_at_prev = _convert_pdf(pdf_dir, pt["p"], prev["p"], prev["ng"])
        w = _mis_weight(cam_v, light_v, s, t, {("cam", t - 1): pdf_origin, ("cam", t - 2): pdf_at_prev})
        return jnp.where((emitting & jnp.any(L > 0, axis=-1))[:, None], L * w[:, None], 0.0), w

    if s == 1:
        # fresh light sample connected to pt (bdpt.rs :1320)
        u_sel = prov_1d(prov, nee_dim)
        ua, ub = prov_2d(prov, nee_dim + 1)
        lid = jnp.minimum((u_sel * static.n_lights).astype(jnp.int32), static.n_lights - 1)
        ls = sample_li(sa, static, lid, pt["p"], ua, ub)
        p_l = ls["pdf"] * sel_pdf_uniform
        f_pt = _vertex_f(pt, possible, ls["wi"])
        L = pt["beta"] * f_pt * ls["li"] / jnp.maximum(p_l, 1e-20)[:, None]
        ok = pt_ok & (p_l > 0) & jnp.any(L > 0, axis=-1) & ~pt["delta"]
        o_sh = _offset_ray(pt["p"], pt["ng"], ls["wi"])
        occ = intersect_p(sa, static, o_sh, ls["wi"], ls["dist"] * 0.998)
        ok = ok & ~occ
        # overrides for MIS (bdpt.rs s==1: sampled vertex replaces light_v[0])
        p_light = pt["p"] + ls["wi"] * ls["dist"][:, None]
        n_light = ls["n"]
        # pt.rev <- light's emission-direction pdf converted to area at pt;
        # MUST be the same per-kind pdf the light walk used as pdf_fwd
        # (spot/projection cone, not a 1/4pi fallback) or the ratio walk
        # loses its partition of unity and every strategy over-counts
        pdf_dir_l = _light_emission_pdf_dir(sa, static, lid, n_light, -ls["wi"])
        pdf_rev_pt = _convert_pdf(pdf_dir_l, p_light, pt["p"], pt["ng"])
        prev = _gather(cam_v, t - 2)
        # pt-1.rev <- pt's bsdf pdf toward prev (given light direction)
        pdf_dir_pt = _vertex_pdf_dir(pt, possible, ls["wi"], _norm(prev["p"] - pt["p"]))
        pdf_rev_prev = _convert_pdf(pdf_dir_pt, pt["p"], prev["p"], prev["ng"])
        # sampled light vertex: fwd = light-origin pdf (area measure);
        # rev <- pt's bsdf pdf toward the light, converted to area
        lv = dict(light_v)
        pdf_origin = jnp.where(ls["delta"], sel_pdf_uniform, sel_pdf_uniform / jnp.maximum(ls["area"], 1e-12))
        pdf_dir_to_l = _vertex_pdf_dir(pt, possible, _norm(prev["p"] - pt["p"]), ls["wi"])
        pdf_rev_light = _convert_pdf(pdf_dir_to_l, pt["p"], p_light, n_light)
        lv["pdf_fwd"] = lv["pdf_fwd"].at[:, 0].set(jnp.maximum(pdf_origin, 1e-20))
        lv["delta"] = lv["delta"].at[:, 0].set(jnp.zeros(R, bool))
        lv["is_delta_light"] = ls["delta"]
        lv["type"] = lv["type"].at[:, 0].set(VT_LIGHT)
        w = _mis_weight(cam_v, lv, s, t, {("cam", t - 1): pdf_rev_pt, ("cam", t - 2): pdf_rev_prev, ("light", 0): pdf_rev_light})
        return jnp.where(ok[:, None], L * w[:, None], 0.0), w

    # general s >= 2, t >= 2 (bdpt.rs :1380)
    qs = _gather(light_v, s - 1)
    qs_ok = (n_light >= s) & (qs["type"] == VT_SURFACE)
    both = pt_ok & qs_ok & ~pt["delta"] & ~qs["delta"]
    w_c = qs["p"] - pt["p"]
    d2 = jnp.maximum(_dot(w_c, w_c), 1e-12)
    wdir = w_c / jnp.sqrt(d2)[:, None]
    f_pt = _vertex_f(pt, possible, wdir)
    f_qs = _vertex_f(qs, possible, -wdir, "importance")
    g = 1.0 / d2  # cosines folded into _vertex_f (|cos ns|)
    L = pt["beta"] * f_pt * f_qs * qs["beta"] * g[:, None]
    ok = both & jnp.any(L > 0, axis=-1)
    # occlusion: offset BOTH endpoints off their surfaces and shave only
    # pbrt's relative ShadowEpsilon (1e-4) — the old 0.5% far-end shave
    # left a blind zone proportional to the connection length (2 cm on a
    # 4-unit connection), which let blockers hugging the far surface pass
    # (caught by the mesh-agreement gate: a panel 1 cm under the ceiling
    # never occluded ceiling->terrain connections, +38% brightness)
    dest = _offset_ray(qs["p"], qs["ng"], -wdir)
    t_sh = jnp.maximum(_dot(dest - _offset_ray(pt["p"], pt["ng"], wdir), wdir), 0.0)
    o_sh = _offset_ray(pt["p"], pt["ng"], wdir)
    occ = intersect_p(sa, static, o_sh, wdir, t_sh * (1.0 - 1e-4))
    ok = ok & ~occ

    prev_c = _gather(cam_v, t - 2)
    prev_l = _gather(light_v, s - 2)
    pdf_qs_dir = _vertex_pdf_dir(qs, possible, wdir * -1.0, jnp.zeros((R, 3), F32)) if False else None
    # junction overrides (vertex.rs pdf calls in mis_weight)
    # pt.rev <- qs.pdf(prev=qs_prev, next=pt)
    pd = _vertex_pdf_dir(qs, possible, _norm(prev_l["p"] - qs["p"]), -wdir)
    ov_pt = _convert_pdf(pd, qs["p"], pt["p"], pt["ng"])
    # pt_prev.rev <- pt.pdf(prev=qs, next=pt_prev)
    pd = _vertex_pdf_dir(pt, possible, wdir, _norm(prev_c["p"] - pt["p"]))
    ov_ptm = _convert_pdf(pd, pt["p"], prev_c["p"], prev_c["ng"])
    # qs.rev <- pt.pdf(prev=pt_prev, next=qs)
    pd = _vertex_pdf_dir(pt, possible, _norm(prev_c["p"] - pt["p"]), wdir)
    ov_qs = _convert_pdf(pd, pt["p"], qs["p"], qs["ng"])
    # qs_prev.rev <- qs.pdf(prev=pt, next=qs_prev)
    pd = _vertex_pdf_dir(qs, possible, -wdir, _norm(prev_l["p"] - qs["p"]))
    ov_qsm = _convert_pdf(pd, qs["p"], prev_l["p"], prev_l["ng"])

    w = _mis_weight(
        cam_v, light_v, s, t,
        {("cam", t - 1): ov_pt, ("cam", t - 2): ov_ptm, ("light", s - 1): ov_qs, ("light", s - 2): ov_qsm},
    )
    return jnp.where(ok[:, None], L * w[:, None], 0.0), w


def connect_t1(sa, static, possible, cam, cam_v, light_v, n_light, s: int, W, H):
    """t=1: connect light-subpath vertex s-1 to the camera; returns a splat
    record {pixel (R,), value (R,3)} (bdpt.rs :798-803)."""
    R = light_v["type"].shape[0]
    qs = _gather(light_v, s - 1)
    ok = (n_light >= s) & (qs["type"] == VT_SURFACE) & ~qs["delta"]
    cw = camera_sample_wi(cam, qs["p"])
    f_qs = _vertex_f(qs, possible, cw["wi"], "importance")
    L = qs["beta"] * f_qs * (cw["we"] / jnp.maximum(cw["pdf"], 1e-20))[:, None]
    ok = ok & cw["valid"] & jnp.any(L > 0, axis=-1)
    # camera endpoint is not geometry: only the origin needs an offset;
    # shave pbrt's ShadowEpsilon, not 0.5% (see connect_bdpt note)
    o_sh = _offset_ray(qs["p"], qs["ng"], cw["wi"])
    occ = intersect_p(sa, static, o_sh, cw["wi"], cw["dist"] * (1.0 - 1e-4))
    ok = ok & ~occ
    # junction overrides: qs.rev <- camera pdf toward qs; qs-1.rev <- qs pdf
    from .camera import camera_pdf_we

    _pp, pdf_dir_cam = camera_pdf_we(cam, -cw["wi"])
    ov_qs = _convert_pdf(pdf_dir_cam, cam["camera_to_world"][:3, 3] * jnp.ones((R, 3), F32), qs["p"], qs["ng"])
    if s >= 2:
        prev_l = _gather(light_v, s - 2)
        pd = _vertex_pdf_dir(qs, possible, cw["wi"], _norm(prev_l["p"] - qs["p"]))
        ov_qsm = _convert_pdf(pd, qs["p"], prev_l["p"], prev_l["ng"])
        overrides = {("light", s - 1): ov_qs, ("light", s - 2): ov_qsm}
    else:
        overrides = {("light", s - 1): ov_qs}
    w = _mis_weight({"type": cam_v["type"], "pdf_fwd": cam_v["pdf_fwd"], "pdf_rev": cam_v["pdf_rev"], "delta": cam_v["delta"]}, light_v, s, 1, overrides)
    val = jnp.where(ok[:, None], L * w[:, None], 0.0)
    px = jnp.clip(cw["px"].astype(jnp.int32), 0, W - 1)
    py = jnp.clip(cw["py"].astype(jnp.int32), 0, H - 1)
    pixel = jnp.where(ok, py * W + px, W * H)
    return {"pixel": pixel, "value": val, "w": w}


# ---------------------------------------------------------------------------
# full estimator for one sample wave
# ---------------------------------------------------------------------------


def bdpt_wave(sa, static, possible, cam, power_cdf, seed, px, py, pids, sample_idx, max_depth, W, H,
              collect_debug: bool = False):
    """One BDPT sample per pixel: all strategies. Returns (L, splat_px,
    splat_val[, dbg]) — dbg (collect_debug=True) maps (s, t) ->
    (weighted c (R,3), weight (R,)) for t >= 2 strategies and
    (pixel, value) for t == 1, feeding the reference's per-strategy
    debug films (bdpt.rs:686-709 visualizestrategies/visualizeweights)."""
    prov_c = ("hash", seed, pids, sample_idx)
    prov_l = ("hash", jnp.asarray(seed, jnp.uint32) ^ jnp.uint32(0xABCD137), pids, sample_idx)
    max_t = max_depth + 2
    max_s = max_depth + 1
    uj1, uj2 = prov_2d(prov_c, 0)
    cam_v, n_cam = generate_camera_subpath(sa, static, possible, prov_c, cam, px.astype(F32) + uj1, py.astype(F32) + uj2, max_t)
    light_v, n_light = generate_light_subpath(sa, static, possible, prov_l, 0, power_cdf, max_s)

    R = px.shape[0]
    L = jnp.zeros((R, 3), F32)
    splat_px = []
    splat_val = []
    dbg = {}
    nee_dim = 100
    for t in range(1, max_t + 1):
        for s in range(0, max_s + 1):
            depth = s + t - 2
            if depth < 0 or depth > max_depth or (s == 1 and t == 1):
                continue
            if t == 1:
                if s < 2:
                    continue  # s<=1,t=1 handled by other strategies / skipped
                sp = connect_t1(sa, static, possible, cam, cam_v, light_v, n_light, s, W, H)
                splat_px.append(sp["pixel"])
                splat_val.append(sp["value"])
                if collect_debug:
                    dbg[(s, t)] = ("splat", sp["pixel"], sp["value"], sp["w"])
            else:
                c, w = connect_bdpt(sa, static, possible, cam, prov_c, cam_v, n_cam, light_v, n_light, s, t, power_cdf, nee_dim + 3 * (s + t))
                L = L + c
                if collect_debug:
                    dbg[(s, t)] = ("film", c, w)
    if splat_px:
        spx = jnp.concatenate(splat_px)
        sval = jnp.concatenate(splat_val)
    else:
        spx = jnp.zeros(0, jnp.int32)
        sval = jnp.zeros((0, 3), F32)
    if collect_debug:
        return L, spx, sval, dbg
    return L, spx, sval


def render_bdpt(cs, seed: int = 0, spp: int | None = None, progress=None):
    """Host loop: accumulate BDPT waves + film splats."""
    import math
    import time

    desc = cs.description
    sa = cs.arrays
    static = cs.static
    from .camera import make_camera

    cam = make_camera(desc.camera, desc.film)
    W = desc.film.x_resolution
    H = desc.film.y_resolution
    R = W * H
    spp = int(spp if spp is not None else desc.sampler.pixel_samples)
    max_depth = max(int(desc.integrator.max_depth), 1)

    # camera pixel bounds: crop window x integrator "pixelbounds"
    # (bdpt.rs:1371). Camera subpaths cover only the bounds; t=1 light
    # splats still land anywhere on the film, like the reference's
    # full-film light image.
    from ..render import film_pixel_bounds

    x0, x1, y0, y1 = film_pixel_bounds(desc)
    ys, xs = np.mgrid[y0:y1, x0:x1]
    px = jnp.asarray(xs.ravel().astype(np.int32))
    py = jnp.asarray(ys.ravel().astype(np.int32))
    pids = jnp.asarray((ys * W + xs).ravel().astype(np.uint32))

    power = compute_power(sa, static)
    cdf = jnp.cumsum(power)
    cdf = cdf / jnp.maximum(cdf[-1], 1e-12)

    _probe = make_bsdf(sa, static, jnp.zeros(1, jnp.int32), jnp.zeros((1, 2), F32), jnp.zeros((1, 3), F32))
    possible = _probe["possible"]

    viz_s = bool(getattr(desc.integrator, "visualize_strategies", False))
    viz_w = bool(getattr(desc.integrator, "visualize_weights", False))
    collect_debug = viz_s or viz_w

    @jax.jit
    def wave(s_idx, seed_j):
        out = bdpt_wave(sa, static, possible, cam, cdf, seed_j, px, py, pids, s_idx, max_depth, W, H,
                        collect_debug=collect_debug)
        L, spx, sval = out[:3]
        # per-channel 1D segment sums ((N, 3) scatters pad rows 42x in HLO
        # temps; see device/sppm.py deposit)
        film_splat = jnp.stack(
            [jax.ops.segment_sum(sval[:, ch], spx, num_segments=R + 1)[:R] for ch in range(3)],
            axis=-1,
        )
        if not collect_debug:
            return L, film_splat
        dbg_out = {}
        for st_key, rec in out[3].items():
            if rec[0] == "splat":
                _, dpx, dval, dw = rec
                dun = jnp.where(dw[:, None] > 0, dval / jnp.maximum(dw[:, None], 1e-30), 0.0)
                film_w = jnp.stack(
                    [jax.ops.segment_sum(dval[:, ch], dpx, num_segments=R + 1)[:R] for ch in range(3)],
                    axis=-1)
                film_u = jnp.stack(
                    [jax.ops.segment_sum(dun[:, ch], dpx, num_segments=R + 1)[:R] for ch in range(3)],
                    axis=-1)
                dbg_out[st_key] = (film_u, film_w)
            else:
                _, c, w = rec
                dbg_out[st_key] = (c, w)
        return L, film_splat, dbg_out

    acc = np.zeros((R, 3), np.float64)  # full film: splats land anywhere
    dbg_acc = {}
    pid_np = np.asarray(pids, np.int64)
    t0 = time.time()
    for s in range(spp):
        out = wave(jnp.uint32(s), jnp.uint32(seed))
        L, fs = out[0], out[1]
        acc += np.asarray(fs, np.float64)
        acc[pid_np] += np.asarray(L, np.float64)
        if collect_debug:
            for st_key, rec in out[2].items():
                ent = dbg_acc.setdefault(st_key, [np.zeros((R, 3), np.float64),
                                                  np.zeros((R, 3), np.float64)])
                if st_key[1] == 1:  # t=1: already full-film (unweighted, weighted)
                    ent[0] += np.asarray(rec[0], np.float64)
                    ent[1] += np.asarray(rec[1], np.float64)
                else:
                    c, w = rec
                    cn = np.asarray(c, np.float64)
                    wn = np.asarray(w, np.float64)[:, None]
                    ent_w = np.zeros((R, 3), np.float64)
                    ent_u = np.zeros((R, 3), np.float64)
                    ent_w[pid_np] = cn
                    ent_u[pid_np] = np.where(wn > 0, cn / np.maximum(wn, 1e-30), 0.0)
                    ent[0] += ent_u
                    ent[1] += ent_w
        if progress:
            progress(s + 1, spp)
    img = (acc / spp).reshape(H, W, 3).astype(np.float32)
    if collect_debug:
        # per-strategy debug films (bdpt.rs:686-709 naming)
        from ..core.imageio import write_exr

        for (s_, t_), (unweighted, weighted) in sorted(dbg_acc.items()):
            d_ = s_ + t_ - 2
            if viz_s:
                write_exr(f"bdpt_d{d_:02d}_s{s_:02d}_t{t_:02d}.exr",
                          (unweighted / spp).reshape(H, W, 3).astype(np.float32))
            if viz_w:
                write_exr(f"bdpt_w_d{d_:02d}_s{s_:02d}_t{t_:02d}.exr",
                          (weighted / spp).reshape(H, W, 3).astype(np.float32))
    import logging

    logging.getLogger(__name__).info("bdpt: %dspp in %.1fs", spp, time.time() - t0)
    return img
