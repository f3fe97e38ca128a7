"""Wavefront integrators: path, directlighting, whitted, ao.

Array-program redesign of the reference's recursive per-pixel integrators
(src/integrators/path.rs li :79-222, directlighting.rs, whitted.rs, ao.rs;
shared NEE/MIS kernel src/core/integrator.rs estimate_direct :109-237):
the per-ray recursion becomes a bounded bounce loop over a whole ray wave
with SoA path state, and the two MIS halves are fused into the single
extend-ray of the next bounce (the emission pickup carries the BSDF-side
MIS weight) — two traversals per bounce (extend + shadow) instead of three.

The bounce loop is a rolled `lax.fori_loop` so the body is traced once;
sampler dimensions derive from the traced bounce index.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..scene.arrays import SceneArrays, SceneStatic
from . import rng as _rng
from .bsdf import bsdf_f, bsdf_pdf, bsdf_sample, num_lobes, _is_specular, cosine_sample_hemisphere
from .intersect import intersect, intersect_p
from .lights import area_light_emission, env_le, env_pdf_li, pdf_li_area_hit, sample_li
from .materials import make_bsdf
from .sampler import sample_1d, sample_2d
from .shading import apply_bump, surface_interaction

F32 = jnp.float32
RAY_EPS = 1e-3


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Power heuristic beta=2 (src/core/sampling.rs:327-330)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return jnp.where(f > 0, f * f / jnp.maximum(f * f + g * g, 1e-30), 0.0)


def _next_float_away(x, direction):
    """Next representable f32 away from zero-crossing in `direction`'s sign;
    unchanged where direction == 0 (pbrt.rs next_float_up/down, batched as
    one signed bit-bump)."""
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    # moving a float's magnitude by one ulp toward +inf (x>=0) or -inf (x<0)
    # is bits+1; toward zero is bits-1. direction>0 wants next-up, <0 down.
    up = direction > 0
    nonneg = x >= 0
    bump = jnp.where(up == nonneg, jnp.uint32(1), jnp.uint32(0xFFFFFFFF))  # +1 or -1
    moved = jax.lax.bitcast_convert_type(bits + bump, F32)
    # zero can't be bit-bumped meaningfully (denormals flush to zero): step
    # to the smallest normal of the right sign instead
    tiny = jnp.float32(1.17549435e-38)
    moved = jnp.where(x == 0.0, jnp.where(up, tiny, -tiny), moved)
    return jnp.where(direction == 0.0, x, moved)


def _offset_ray(p, ng, w, p_err=None):
    """Offset a secondary-ray origin off the surface along the geometric
    normal past the hit point's FP error bound, then round each component
    one ulp away (transform.rs offset_ray_origin :455-475 over the
    efloat.rs error intervals carried by surface_interaction as p_err).

    p_err=None (medium/synthetic points without bounds): a conservative
    magnitude-proportional displacement stands in."""
    if p_err is None:
        s = jnp.sign(_dot(ng, w))[:, None]
        mag = jnp.max(jnp.abs(p), axis=-1, keepdims=True)
        return p + ng * s * (RAY_EPS * (0.1 + 0.05 * mag))
    d = jnp.sum(jnp.abs(ng) * p_err, axis=-1, keepdims=True)
    offset = d * ng
    offset = jnp.where(_dot(w, ng)[:, None] < 0, -offset, offset)
    po = p + offset
    return _next_float_away(po, offset)


def _to_local(si, w):
    return jnp.stack([_dot(w, si["ss"]), _dot(w, si["ts"]), _dot(w, si["ns"])], axis=-1)


def _to_world(si, w):
    return w[..., 0:1] * si["ss"] + w[..., 1:2] * si["ts"] + w[..., 2:3] * si["ns"]


def _light_select_pdf(static: SceneStatic):
    return 1.0 / max(static.n_lights, 1)


def _light_ns(static: SceneStatic, li_idx: int) -> int:
    """Per-light "nsamples" for UniformSampleAll (light.rs nsamples)."""
    ns = getattr(static, "light_n_samples", ())
    return max(int(ns[li_idx]), 1) if li_idx < len(ns) else 1


def _round_ns(kind: str, n: int) -> int:
    """Sampler::round_count — pow2 samplers round the array size up to a
    power of two (sampler.rs; zerotwosequence.rs/maxmindist.rs)."""
    if kind in ("zerotwosequence", "lowdiscrepancy", "maxmindist") and n > 1:
        return 1 << (n - 1).bit_length()
    return max(n, 1)


def _light_selectors(sa, static: SceneStatic, icfg: dict, nee_on: bool, ikind: str):
    """Light-selection distribution closures, shared by the per-sample wave
    and the persistent wave (lightdistrib.rs create_light_sample_
    distribution): "uniform", power-proportional, or the voxel-grid
    "spatial" distribution (precomputed table passed via icfg).

    Returns (_select_light(u, p_at) -> (lid, pmf), _sel_pmf_of(lid, p_at))."""
    sel_pdf = _light_select_pdf(static)
    strategy = str(icfg.get("light_strategy", "uniform"))
    spatial = icfg.get("spatial_distribution") if strategy == "spatial" else None
    use_spatial = spatial is not None and static.n_lights > 1 and nee_on
    use_power = (not use_spatial) and strategy in ("power", "spatial") and static.n_lights > 1 and (nee_on or ikind == "whitted")
    if use_power:
        from .lights import compute_power

        _pw = compute_power(sa, static)
        _pmf = jnp.maximum(_pw / jnp.maximum(_pw.sum(), 1e-20), 1e-6)
        _pmf = _pmf / _pmf.sum()  # every light stays selectable (unbiased)
        _cdf = jnp.cumsum(_pmf)
    if use_spatial:
        from .lightdistrib import spatial_pmf_of, spatial_select

    def _sel_pmf_of(lid, p_at=None):
        """Selection pmf of given light rows (for MIS at emission hits).

        p_at: shading points (required for the spatial strategy — the pmf
        depends on the voxel of the vertex that did NEE, i.e. the PREVIOUS
        path vertex for emission-hit MIS, lightdistrib.rs lookup)."""
        if use_spatial and p_at is not None:
            return spatial_pmf_of(spatial, p_at, lid)
        if not (use_power or use_spatial):
            return jnp.full(lid.shape, sel_pdf, F32)
        if use_spatial:
            # no position context: fall back to uniform (conservative MIS)
            return jnp.full(lid.shape, sel_pdf, F32)
        oh = jnp.arange(static.n_lights)[None, :] == lid[:, None]
        return jnp.sum(jnp.where(oh, _pmf[None, :], 0.0), axis=1)

    def _select_light(u_sel, p_at=None):
        if use_spatial and p_at is not None:
            return spatial_select(spatial, p_at, u_sel)
        if not (use_power or use_spatial):
            lid = jnp.minimum((u_sel * static.n_lights).astype(jnp.int32), static.n_lights - 1)
            return lid, jnp.full(u_sel.shape, sel_pdf, F32)
        if use_spatial:
            lid = jnp.minimum((u_sel * static.n_lights).astype(jnp.int32), static.n_lights - 1)
            return lid, jnp.full(u_sel.shape, sel_pdf, F32)
        lid = jnp.sum((u_sel[:, None] > _cdf[None, :-1]).astype(jnp.int32), axis=1) if static.n_lights > 1 else jnp.zeros(u_sel.shape, jnp.int32)
        lid = jnp.clip(lid, 0, static.n_lights - 1)
        return lid, _sel_pmf_of(lid)

    return _select_light, _sel_pmf_of



def _compute_duv(si, o, d, dd):
    """uv-footprint derivative for the +1px offset ray with direction dd and
    shared origin o (interaction.rs compute_differentials :269)."""
    ng = si["ng"]
    denom = _dot(ng, dd)
    t_off = _dot(ng, si["p"] - o) / jnp.where(jnp.abs(denom) > 1e-9, denom, 1e-9)
    p_off = o + dd * t_off[:, None]
    dp = p_off - si["p"]
    # solve [dpdu dpdv] [du dv]^T = dp over the 2 axes where |ng| is smallest
    an = jnp.abs(ng)
    # drop the dominant axis of ng
    drop = jnp.argmax(an, axis=-1)
    ax0 = jnp.where(drop == 0, 1, 0)
    ax1 = jnp.where(drop == 2, 1, 2)
    r = jnp.arange(dp.shape[0])
    a00 = si["dpdu"][r, ax0]
    a01 = si["dpdv"][r, ax0]
    a10 = si["dpdu"][r, ax1]
    a11 = si["dpdv"][r, ax1]
    b0 = dp[r, ax0]
    b1 = dp[r, ax1]
    det = a00 * a11 - a01 * a10
    ok = jnp.abs(det) > 1e-12
    inv = 1.0 / jnp.where(ok, det, 1.0)
    du = jnp.where(ok, (a11 * b0 - a01 * b1) * inv, 0.0)
    dv = jnp.where(ok, (a00 * b1 - a10 * b0) * inv, 0.0)
    valid = jnp.abs(denom) > 1e-9
    return jnp.where(valid[:, None], jnp.stack([du, dv], axis=-1), 0.0)


def trace_wave(sa: SceneArrays, static: SceneStatic, icfg: dict, scfg: dict, seed, o, d, pixel, sample_idx, diff_dirs=None, time=None):
    """Trace one wave of camera rays to completion. Returns (L, n_vertices).

    icfg: {"kind": path|volpath|directlighting|whitted|ao, "max_depth": int,
           "rr_threshold": float, "strategy": all|one, "n_samples": int,
           "cos_sample": bool}
    scfg: {"kind": sampler name, "spp": int}

    The bounce loop is a rolled `lax.fori_loop` (bounce body traced ONCE —
    the XLA-friendly replacement of the reference's per-bounce recursion,
    path.rs li :79-222 / volpath.rs li :82-232): sampler dimensions derive
    from the traced bounce index; per-ray bounce counters track real
    scattering events so null-material boundary crossings and the final
    emission pickup match the reference's depth semantics.
    """
    R = o.shape[0]
    ikind = icfg["kind"]
    max_depth = int(icfg["max_depth"])

    if not static.has_motion:
        time = None
    if ikind == "ao":
        return _trace_ao(sa, static, icfg, scfg, seed, o, d, pixel, sample_idx, time), jnp.ones(R, F32)

    nee_on = ikind in ("path", "volpath", "directlighting")
    _select_light, _sel_pmf_of = _light_selectors(sa, static, icfg, nee_on, ikind)
    # path handles subsurface interiors too (the volumetric random walk is
    # this build's BSSRDF, replacing the tabulated dipole; path.rs:177-204)
    handle_media = (ikind == "volpath" and static.n_media > 0) or (
        ikind in ("path", "volpath") and static.has_sss_media
    )
    pass_null = static.has_null_material or handle_media
    kind_s = scfg["kind"]
    spp = scfg["spp"]
    DPB = 8  # sample dims per bounce (dims 0-1 = film/lens, consumed by caller)
    extra_iters = (24 if static.has_sss_media else 4) if pass_null else 0

    if handle_media or pass_null:
        from .media import hg_p, hg_sample, medium_sample, transmittance_shadow

    def pickup(state, b=None):
        """Per-iteration head: intersect, medium distance sampling (volpath.rs
        :107-111 — the segment transmittance weight lands on beta BEFORE any
        emission is collected), then escaped-ray env radiance + area-light
        emission with deferred MIS for rays that reached the surface."""
        (o, d, L, beta, alive, prev_specular, prev_pdf, prev_p, eta_scale,
         n_vertices, medium, bounces, dd_x, dd_y) = state
        # dead lanes get t_max < 0: they open no BVH node, so packets whose
        # rays have all terminated cost ~one visit instead of a full walk
        t_query = jnp.where(alive, jnp.inf, -1.0)
        hit = intersect(sa, static, o, d, t_query, time=time, sort_rays=True)
        si = surface_interaction(sa, hit, o, d, time=time)
        si = apply_bump(sa, static, si)
        valid = si["valid"]
        n_vertices = n_vertices + (alive & valid)

        if handle_media:
            t_surf = jnp.where(valid, hit["t"], jnp.full(R, jnp.inf, F32))
            bkey = jnp.uint32(0) if b is None else b.astype(jnp.uint32)
            # per-lane key from the GLOBAL pixel id (shard-invariant: the
            # lane index restarts per shard_map shard, pixel ids don't).
            # sample and bounce are SEPARATE hash words — a packed
            # sample*7+bounce collided across (s, b) pairs with equal sums
            # (s=0,b=7 vs s=1,b=0), replaying delta-tracking streams
            # between adjacent samples at maxdepth > 7. The *2 keeps this
            # stream disjoint from the shadow-transmittance one (*2+1),
            # and the large salt keeps BOTH disjoint from every sampler
            # dimension word (sampler.py uniform_1d uses small dims 2d/2d+1
            # in the same 4-word keyspace — when b == d the raw u32s were
            # bit-identical, decorrelated only by downstream pcg rounds).
            mkey = _rng.hash_combine(seed, pixel,
                                     jnp.asarray(sample_idx, jnp.uint32),
                                     jnp.uint32(0xC0FFEE00) + bkey * jnp.uint32(2))
            ms = medium_sample(sa, static, medium, o, d, t_surf, mkey)
            in_scatter = alive & ms["hit_medium"]
            beta = jnp.where((alive & (medium >= 0))[:, None], beta * ms["weight"], beta)
            p_med = o + d * ms["t"][:, None]
            g_par = sa.med_param[jnp.maximum(medium, 0)][:, 6]
            med_vertex = {"p": p_med, "wo": -d, "g": g_par, "active": in_scatter}
        else:
            in_scatter = jnp.zeros(R, bool)
            med_vertex = None

        if static.has_infinite:
            esc = alive & ~valid & ~in_scatter
            le = env_le(sa, static, d)
            if nee_on:
                env_row = jnp.full(R, max(static.infinite_light_index, 0), jnp.int32)
                p_l = env_pdf_li(sa, static, d) * _sel_pmf_of(env_row, prev_p)
                w = jnp.where(prev_specular, 1.0, power_heuristic(1.0, prev_pdf, 1.0, p_l))
            else:
                w = jnp.ones(R, F32)
            L = L + jnp.where(esc[:, None], beta * le * w[:, None], 0.0)
        alive = alive & (valid | in_scatter)

        if static.has_area_lights:
            lid = si["light"]
            emitting = alive & ~in_scatter & (lid >= 0)
            le = area_light_emission(sa, lid, si["ng"], si["wo"])
            if nee_on:
                area = sa.prim_area[jnp.maximum(si["prim"], 0)]
                p_l = pdf_li_area_hit(sa, prev_p, si["p"], si["ng"], lid, area, cone_spheres=static.has_cone_sphere_lights) * _sel_pmf_of(jnp.maximum(lid, 0), prev_p)
                w = jnp.where(prev_specular, 1.0, power_heuristic(1.0, prev_pdf, 1.0, p_l))
            else:
                w = jnp.ones(R, F32)
            L = L + jnp.where(emitting[:, None], beta * le * w[:, None], 0.0)

        si["duvdx"] = _compute_duv(si, o, d, dd_x)
        si["duvdy"] = _compute_duv(si, o, d, dd_y)
        state = (o, d, L, beta, alive, prev_specular, prev_pdf, prev_p, eta_scale,
                 n_vertices, medium, bounces, dd_x, dd_y)
        return state, si, hit, in_scatter, med_vertex

    def _shadow_visible_tr(p_v, ng_v, wi, dist, medium_v, b, needed=None, p_err=None):
        """Shadow factor: binary visibility, or transmittance when media/null
        boundaries are present (VisibilityTester::unoccluded vs ::tr).

        needed: lanes whose result matters; others get t_max < 0 so the
        shadow traversal skips them."""
        o_sh = _offset_ray(p_v, ng_v, wi, p_err)
        t_sh = dist * (1.0 - 2.0 * RAY_EPS)
        if pass_null:
            # per-lane, pixel-global key (see medium_sample note); sample
            # and bounce are separate hash words, *2+1 disjoint from the
            # medium-sampling stream's *2, same 0xC0FFEE00 salt keeping
            # both clear of the sampler dimension words
            key = _rng.hash_combine(seed, pixel, jnp.asarray(sample_idx, jnp.uint32),
                                    jnp.uint32(0xC0FFEE00) + b.astype(jnp.uint32) * jnp.uint32(2) + jnp.uint32(1))
            return transmittance_shadow(sa, static, o_sh, wi, t_sh, medium_v, key, time=time)
        if needed is not None:
            t_sh = jnp.where(needed, t_sh, -1.0)
        occ = intersect_p(sa, static, o_sh, wi, t_sh, time=time, sort_rays=True)
        return jnp.where(occ[:, None], 0.0, 1.0)

    def _nee_at(si, lobes, alive_m, medium_v, b, dim_base, light_index=None, dim_salt=0,
                medium_vertex=None, array_j=0, array_n=1):
        """NEE supporting both surface (BSDF) and medium (phase) vertices.

        medium_vertex: None for surface-only, else dict {p, wo, g, active}.
        array_j/array_n: UniformSampleAll array samples (sampler.rs
        request_2d_array + stratified.rs array strata).
        """
        if static.n_lights == 0:
            return jnp.zeros((R, 3), F32)
        u_sel = sample_1d(kind_s, seed, pixel, sample_idx, dim_base + 131 * dim_salt, spp)
        u1, u2 = sample_2d(kind_s, seed, pixel, sample_idx, dim_base + 1 + 131 * dim_salt, spp)

        if light_index is None:
            p_sel = si["p"] if medium_vertex is None else jnp.where(
                medium_vertex["active"][:, None], medium_vertex["p"], si["p"])
            lid, spdf = _select_light(u_sel, p_sel)
        else:
            lid = jnp.full(R, light_index, jnp.int32)
            spdf = 1.0
            if array_n > 1:
                from . import rng as _rng

                r1 = _rng.hash_combine(seed, pixel, sample_idx, jnp.uint32(0xA117 + light_index))
                r2 = _rng.hash_combine(seed, pixel, sample_idx, jnp.uint32(0xB229 + light_index))
                p1 = (jnp.uint32(array_j) + r1 % jnp.uint32(array_n)) % jnp.uint32(array_n)
                p2 = (jnp.uint32(array_j) + r2 % jnp.uint32(array_n)) % jnp.uint32(array_n)
                u1 = (p1.astype(F32) + u1) / array_n
                u2 = (p2.astype(F32) + u2) / array_n

        if medium_vertex is None:
            p_v = si["p"]
            ng_v = si["ng"]
        else:
            p_v = jnp.where(medium_vertex["active"][:, None], medium_vertex["p"], si["p"])
            ng_v = si["ng"]

        ls = sample_li(sa, static, lid, p_v, u1, u2, cone_spheres=static.has_cone_sphere_lights)
        wi = ls["wi"]

        # surface: BSDF eval
        wo_l = _to_local(si, si["wo"])
        wi_l = _to_local(si, wi)
        refl = _dot(wi, si["ng"]) * _dot(si["wo"], si["ng"]) > 0
        f_val = bsdf_f(lobes, wo_l, wi_l, refl) * jnp.abs(_dot(wi, si["ns"]))[:, None]
        p_b = bsdf_pdf(lobes, wo_l, wi_l)

        if medium_vertex is not None:
            ph = hg_p(_dot(medium_vertex["wo"], wi), medium_vertex["g"])
            f_val = jnp.where(medium_vertex["active"][:, None], ph[:, None], f_val)
            p_b = jnp.where(medium_vertex["active"], ph, p_b)

        p_l = ls["pdf"] * spdf
        contributes = alive_m & (p_l > 0) & jnp.any(f_val * ls["li"] > 0, axis=-1)

        if medium_vertex is None:
            vis = _shadow_visible_tr(p_v, ng_v, wi, ls["dist"], medium_v, b, needed=contributes,
                                     p_err=si.get("p_err"))
        else:
            # medium points have no normal; offset along wi itself
            ng_sh = jnp.where(medium_vertex["active"][:, None], wi, ng_v)
            vis = _shadow_visible_tr(p_v, ng_sh, wi, ls["dist"], medium_v, b, needed=contributes)

        w_l = jnp.where(ls["delta"], 1.0, power_heuristic(1.0, p_l, 1.0, p_b))
        contrib = f_val * ls["li"] * vis * (w_l / jnp.maximum(p_l, 1e-30))[:, None]
        return jnp.where(contributes[:, None], contrib, 0.0)

    def _sss_event(mask, si, L, new_o, new_d, new_beta, new_alive, new_spec,
                   new_pdf, new_prev_p, medium_v, b, dim_base):
        """Tabulated-BSSRDF exit event (bssrdf.rs sample_s/sample_sp).

        For rays that just crossed a subsurface interface via specular
        transmission: importance-sample an exit point on the same material
        with the beam-diffusion profile (probe-ray chain of K segments),
        weight by Sp/pdf_sp, run NEE at the exit with the Sw adapter lobe,
        then continue with a cosine-sampled direction. Consumes the same
        path-depth step as the interface bounce (path.rs:177-204)."""
        from .bsdf import LOBE_SSS_ADAPTER, cosine_sample_hemisphere
        from .bssrdf import pdf_sp, sample_radial_cdf, sr_eval, sw_factor

        mat = jnp.maximum(si["mat"], 0)
        sigt3 = sa.sss_sigma_t[mat]
        prof3 = sa.sss_prof[mat]
        cdf3 = sa.sss_cdf[mat]
        rhoeff3 = sa.sss_rhoeff[mat]
        eta_m = sa.sss_eta[mat]
        radius = sa.sss_radius
        ssv, tsv, nsv = si["ss"], si["ts"], si["ns"]

        # axis + channel + chain-select from one dimension (bssrdf.rs:339-350)
        u_ax = sample_1d(kind_s, seed, pixel, sample_idx, dim_base + 8, spp)
        u_r, u_phi = sample_2d(kind_s, seed, pixel, sample_idx, dim_base + 9, spp)
        use0 = u_ax < 0.5
        use1 = (~use0) & (u_ax < 0.75)
        vx = jnp.where(use0[:, None], ssv, jnp.where(use1[:, None], tsv, nsv))
        vy = jnp.where(use0[:, None], tsv, jnp.where(use1[:, None], nsv, ssv))
        vz = jnp.where(use0[:, None], nsv, jnp.where(use1[:, None], ssv, tsv))
        u1n = jnp.where(use0, u_ax * 2.0, jnp.where(use1, (u_ax - 0.5) * 4.0, (u_ax - 0.75) * 4.0))
        ch = jnp.clip((u1n * 3.0).astype(jnp.int32), 0, 2)
        u1n = u1n * 3.0 - ch.astype(F32)
        sel3 = (jnp.arange(3, dtype=jnp.int32)[None, :] == ch[:, None]).astype(F32)
        prof_ch = jnp.sum(prof3 * sel3[:, :, None], axis=1)
        cdf_ch = jnp.sum(cdf3 * sel3[:, :, None], axis=1)
        rhoeff_ch = jnp.sum(rhoeff3 * sel3, axis=1)
        sigt_ch = jnp.sum(sigt3 * sel3, axis=1)

        r_opt = sample_radial_cdf(radius, prof_ch, cdf_ch, rhoeff_ch, u_r)
        r_w = r_opt / jnp.maximum(sigt_ch, 1e-9)
        rmax_w = sample_radial_cdf(radius, prof_ch, cdf_ch, rhoeff_ch,
                                   jnp.full(R, 0.999, F32)) / jnp.maximum(sigt_ch, 1e-9)
        ok_r = mask & (sigt_ch > 0) & (r_w < rmax_w)
        l_probe = 2.0 * jnp.sqrt(jnp.maximum(rmax_w * rmax_w - r_w * r_w, 0.0))
        phi = 2.0 * jnp.pi * u_phi
        p0 = si["p"] + r_w[:, None] * (jnp.cos(phi)[:, None] * vx + jnp.sin(phi)[:, None] * vy) \
            - (0.5 * l_probe)[:, None] * vz

        # probe chain: K sequential segments collecting same-material hits
        K_PROBE = 4
        base = p0
        t_rem = jnp.where(ok_r, l_probe, -1.0)
        recs = []
        for _k in range(K_PROBE):
            hk = intersect(sa, static, base, vz, t_rem, sort_rays=True)
            hv = hk["prim"] >= 0
            hmat = sa.prim_mat[jnp.maximum(hk["prim"], 0)]
            match = hv & (hmat == si["mat"])
            recs.append((match, hk, base))
            step = jnp.where(hv, hk["t"] + RAY_EPS, 0.0)
            base = base + vz * step[:, None]
            t_rem = jnp.where(hv, t_rem - step, -1.0)
        nfound = sum(m.astype(jnp.int32) for m, _h, _b in recs)
        found = nfound > 0
        sel_idx = jnp.clip((u1n * nfound.astype(F32)).astype(jnp.int32), 0,
                           jnp.maximum(nfound - 1, 0))
        # pick the sel_idx-th matching record (static K, where-chains)
        run = jnp.zeros(R, jnp.int32)
        hit_sel = {"t": jnp.zeros(R, F32), "prim": jnp.full(R, -1, jnp.int32),
                   "b1": jnp.zeros(R, F32), "b2": jnp.zeros(R, F32)}
        o_sel = p0
        for m, hk, bs_ in recs:
            take = m & (run == sel_idx)
            hit_sel = {kk: jnp.where(take, hk[kk], hit_sel[kk]) for kk in hit_sel}
            o_sel = jnp.where(take[:, None], bs_, o_sel)
            run = run + m.astype(jnp.int32)
        si2 = surface_interaction(sa, hit_sel, o_sel, vz)
        si2["duvdx"] = jnp.zeros((R, 2), F32)
        si2["duvdy"] = jnp.zeros((R, 2), F32)

        act = ok_r & found
        d_vec = si["p"] - si2["p"]
        dist = jnp.linalg.norm(d_vec, axis=-1)
        pdf_v = pdf_sp(radius, prof3, rhoeff3, sigt3, d_vec, si2["ng"], ssv, tsv, nsv)
        pdf_v = pdf_v / jnp.maximum(nfound.astype(F32), 1.0)
        sp = sr_eval(radius, prof3, sigt3, dist)
        w_sp = sp / jnp.maximum(pdf_v, 1e-12)[:, None]
        beta2 = new_beta * jnp.where(act[:, None], w_sp, 1.0)
        act = act & jnp.any(beta2 > 0, axis=-1)

        # NEE at the exit point with the Sw adapter lobe (wo = +ns,
        # bssrdf.rs sample_s tail)
        adapter = {
            "kind": jnp.where(act, LOBE_SSS_ADAPTER, 0)[:, None],
            "data": jnp.concatenate(
                [jnp.zeros((R, 3), F32), eta_m[:, None], jnp.zeros((R, 10), F32)], axis=1
            )[:, None, :],
            "possible": (frozenset({LOBE_SSS_ADAPTER}),),
        }
        si2_nee = dict(si2)
        si2_nee["wo"] = si2["ns"]
        L = L + beta2 * _nee_at(si2_nee, adapter, act, medium_v, b, dim_base, dim_salt=7)

        # continuation: cosine hemisphere about the exit shading normal
        u1d, u2d = sample_2d(kind_s, seed, pixel, sample_idx, dim_base + 10, spp)
        wi_loc = cosine_sample_hemisphere(u1d, u2d)
        wi2 = (wi_loc[:, 0:1] * si2["ss"] + wi_loc[:, 1:2] * si2["ts"]
               + wi_loc[:, 2:3] * si2["ns"])
        cos_z = jnp.maximum(wi_loc[:, 2], 1e-6)
        pdf_dir = cos_z * (1.0 / jnp.pi)
        f_sw = sw_factor(eta_m, cos_z) * eta_m * eta_m
        beta2 = beta2 * (f_sw * jnp.pi)[:, None]  # f * cos / (cos/pi)

        new_o = jnp.where(act[:, None], _offset_ray(si2["p"], si2["ng"], wi2, si2.get("p_err")), new_o)
        new_d = jnp.where(act[:, None], wi2, new_d)
        new_beta = jnp.where(act[:, None], beta2, new_beta)
        new_alive = jnp.where(mask, act & jnp.any(beta2 > 0, axis=-1), new_alive)
        new_spec = jnp.where(mask, False, new_spec)
        new_pdf = jnp.where(act, pdf_dir, new_pdf)
        new_prev_p = jnp.where(act[:, None], si2["p"], new_prev_p)
        return L, new_o, new_d, new_beta, new_alive, new_spec, new_pdf, new_prev_p

    def bounce_body(b, state):
        state, si, hit, in_scatter, med_vertex = pickup(state, b)
        (o, d, L, beta, alive, prev_specular, prev_pdf, prev_p, eta_scale,
         n_vertices, medium, bounces, dd_x, dd_y) = state
        dim_base = 2 + b * DPB
        can_scatter = alive & (bounces < max_depth - 1)
        in_scatter = in_scatter & can_scatter

        on_surface = can_scatter & si["valid"] & ~in_scatter
        # null-material boundary: pass through, swap medium, free of depth
        if pass_null:
            mat_kind_hit = sa.mat_kind[si["mat"]]
            is_null = on_surface & (mat_kind_hit == 0) & (si["light"] < 0)
            on_surface = on_surface & ~is_null
        else:
            is_null = jnp.zeros(R, bool)

        lobes = make_bsdf(sa, static, si["mat"], si["uv"], si["p"], si["duvdx"], si["duvdy"])
        has_lobes = num_lobes(lobes) > 0
        alive_sh = on_surface & has_lobes
        alive_nee = alive_sh | in_scatter

        # --- NEE (uniform_sample_onelight / estimate_direct) ---
        if nee_on and static.n_lights > 0:
            if ikind == "directlighting" and icfg.get("strategy", "all") == "all":
                # UniformSampleAll: light.nsamples stratified array samples
                # per light, averaged (uniform_sample_all_lights)
                for li_idx in range(static.n_lights):
                    ns = _round_ns(kind_s, _light_ns(static, li_idx))
                    acc = jnp.zeros((R, 3), F32)
                    for j in range(ns):
                        acc = acc + _nee_at(si, lobes, alive_sh, medium, b,
                                            dim_base, light_index=li_idx,
                                            dim_salt=1 + li_idx * 1024 + j,
                                            array_j=j, array_n=ns)
                    L = L + beta * acc / ns
            else:
                L = L + beta * _nee_at(si, lobes, alive_nee, medium, b, dim_base, medium_vertex=med_vertex)
        elif ikind == "whitted" and static.n_lights > 0:
            L = L + beta * _nee_at(si, lobes, alive_sh, medium, b, dim_base)

        # --- BSDF / phase sampling for continuation ---
        u_lobe = sample_1d(kind_s, seed, pixel, sample_idx, dim_base + 2, spp)
        u1, u2 = sample_2d(kind_s, seed, pixel, sample_idx, dim_base + 3, spp)
        wo_l = _to_local(si, si["wo"])

        if ikind in ("directlighting", "whitted"):
            from .bsdf import SPECULAR_KINDS

            spec_only = {
                "kind": jnp.where(_is_specular(lobes["kind"]), lobes["kind"], 0),
                "data": lobes["data"],
                "possible": tuple(p & SPECULAR_KINDS for p in lobes["possible"]),
            }
            bs = bsdf_sample(spec_only, wo_l, u_lobe, u1, u2)
        else:
            bs = bsdf_sample(lobes, wo_l, u_lobe, u1, u2)

        wi_w = _to_world(si, bs["wi"])
        cos_term = jnp.abs(_dot(wi_w, si["ns"]))
        thru = bs["f"] * (cos_term / jnp.maximum(bs["pdf"], 1e-30))[:, None]
        surf_cont = alive_sh & bs["valid"] & jnp.any(thru > 0, axis=-1)

        new_alive = surf_cont
        new_beta = jnp.where(surf_cont[:, None], beta * thru, beta)
        new_d = jnp.where(surf_cont[:, None], wi_w, d)
        new_o = jnp.where(surf_cont[:, None], _offset_ray(si["p"], si["ng"], wi_w, si.get("p_err")), o)
        new_spec = bs["specular"] & surf_cont
        new_pdf = jnp.where(surf_cont, jnp.maximum(bs["pdf"], 1e-30), prev_pdf)
        new_prev_p = jnp.where(surf_cont[:, None], si["p"], prev_p)
        eta_scale = jnp.where(surf_cont, eta_scale * bs["eta_scale"], eta_scale)
        # interior SSS scattering is depth-free (matches the reference's
        # BSSRDF not consuming path depth); other medium events count
        scatter_counts = in_scatter
        for _mid in static.sss_media:
            scatter_counts = scatter_counts & (medium != _mid)
        new_bounces = bounces + (surf_cont | scatter_counts)

        # --- tabulated BSSRDF: teleport to a sampled exit point on the
        # same material after a specular transmission through a subsurface
        # interface (path.rs:177-204 BSSRDF hook) ---
        if static.has_tab_sss and ikind in ("path", "volpath"):
            from ..scene.arrays import MAT_KDSUBSURFACE, MAT_SUBSURFACE

            mk_sss = sa.mat_kind[jnp.maximum(si["mat"], 0)]
            is_sss_mat = (mk_sss == MAT_SUBSURFACE) | (mk_sss == MAT_KDSUBSURFACE)
            crossed = _dot(wi_w, si["ng"]) * _dot(si["wo"], si["ng"]) < 0
            do_sss = surf_cont & is_sss_mat & bs["specular"] & crossed
            (L, new_o, new_d, new_beta, new_alive, new_spec, new_pdf,
             new_prev_p) = _sss_event(
                do_sss, si, L, new_o, new_d, new_beta, new_alive, new_spec,
                new_pdf, new_prev_p, medium, b, dim_base)

        # medium transition on transmission through a medium-interface surface
        if handle_media or pass_null:
            pm = sa.prim_medium[jnp.maximum(si["prim"], 0)]
            transition = pm[:, 0] != pm[:, 1]
            crossing_dir = _dot(new_d, si["ng"]) < 0
            crossed_med = jnp.where(crossing_dir, pm[:, 0], pm[:, 1])
            medium = jnp.where((surf_cont | is_null) & transition, crossed_med, medium)

        # --- phase-function continuation for medium vertices ---
        if handle_media:
            u1m, u2m = sample_2d(kind_s, seed, pixel, sample_idx, dim_base + 6, spp)
            # hg_sample measures cos from wo; g>0 peaks at wi ~ -wo = d
            wi_ph, ph_pdf = hg_sample(med_vertex["wo"], med_vertex["g"], u1m, u2m)
            new_alive = new_alive | in_scatter
            new_d = jnp.where(in_scatter[:, None], wi_ph, new_d)
            new_o = jnp.where(in_scatter[:, None], med_vertex["p"], new_o)
            new_spec = jnp.where(in_scatter, False, new_spec)
            new_pdf = jnp.where(in_scatter, jnp.maximum(ph_pdf, 1e-30), new_pdf)
            new_prev_p = jnp.where(in_scatter[:, None], med_vertex["p"], new_prev_p)
            # phase f/pdf = 1: beta unchanged

        # --- null boundary pass-through (keeps prev MIS state, free depth) ---
        if pass_null:
            new_alive = new_alive | is_null
            new_d = jnp.where(is_null[:, None], d, new_d)
            new_o = jnp.where(is_null[:, None], _offset_ray(si["p"], si["ng"], d, si.get("p_err")), new_o)
            new_spec = jnp.where(is_null, prev_specular, new_spec)
            new_pdf = jnp.where(is_null, prev_pdf, new_pdf)
            new_prev_p = jnp.where(is_null[:, None], prev_p, new_prev_p)

        # --- russian roulette (path.rs:206-214) ---
        if ikind in ("path", "volpath"):
            rr_beta = new_beta * eta_scale[:, None]
            max_c = jnp.max(rr_beta, axis=-1)
            q = jnp.maximum(0.05, 1.0 - max_c)
            do_rr = (new_bounces > 3) & (max_c < icfg.get("rr_threshold", 1.0)) & ~is_null
            u_rr = sample_1d(kind_s, seed, pixel, sample_idx, dim_base + 4, spp)
            killed = do_rr & (u_rr < q)
            new_alive = new_alive & ~killed
            new_beta = jnp.where((do_rr & ~killed)[:, None], new_beta / jnp.maximum(1.0 - q, 1e-6)[:, None], new_beta)

        keep_dd = is_null if pass_null else jnp.zeros(R, bool)
        dd_x = jnp.where(keep_dd[:, None], dd_x, 0.0)
        dd_y = jnp.where(keep_dd[:, None], dd_y, 0.0)
        return (new_o, new_d, L, new_beta, new_alive, new_spec, new_pdf, new_prev_p,
                eta_scale, n_vertices, medium, new_bounces, dd_x, dd_y)

    medium0 = jnp.full(R, static.camera_medium, jnp.int32)
    if diff_dirs is not None:
        dd_x0, dd_y0 = diff_dirs
    else:
        dd_x0 = jnp.zeros((R, 3), F32)
        dd_y0 = jnp.zeros((R, 3), F32)
    state = (
        o,
        d,
        jnp.zeros((R, 3), F32),
        jnp.ones((R, 3), F32),
        jnp.ones(R, bool),
        jnp.ones(R, bool),  # bounce-0 emission counts fully
        jnp.ones(R, F32),
        o,
        jnp.ones(R, F32),
        jnp.zeros(R, F32),  # n_vertices (stats.rs path-length counters)
        medium0,
        jnp.zeros(R, jnp.int32),
        dd_x0,
        dd_y0,
    )
    n_iters = max_depth - 1 + extra_iters
    if n_iters > 0:
        import os

        if os.environ.get("PBRT_TPU_UNROLL", "") == "1":
            # straight-line bounce bodies: larger compile, but XLA keeps
            # the fast gather lowering (experimental; see gather.py)
            for _b in range(n_iters):
                state = bounce_body(jnp.int32(_b), state)
        else:
            state = jax.lax.fori_loop(0, n_iters, bounce_body, state)
    state = pickup(state, jnp.int32(n_iters))[0]
    L = state[2]
    n_vertices = state[9]
    return L, n_vertices


def trace_persistent(sa: SceneArrays, static: SceneStatic, icfg: dict, scfg: dict,
                     seed, pixel, s0: int, n_samples: int, regen,
                     max_sample_luminance=float("inf"),
                     s_offsets=None, s_stride: int = 1):
    """Persistent wavefront path tracer with in-place ray regeneration.

    One lane per pixel. Each lane traces its pixel's samples
    ``s0 .. s0+n_samples-1`` SEQUENTIALLY: the moment a lane's path
    terminates, the finished sample's radiance is flushed into per-lane
    accumulators and the lane immediately regenerates the next camera
    sample — no lane ever idles on a dead path. This is the SURVEY §2.12
    "persistent ray queue" wavefront design; the per-sample wave
    (trace_wave) leaves every post-bounce wave mostly dead on low-yield
    scenes. Because a lane's pixel never changes, flushing is pure
    elementwise accumulation — no film scatter is needed.

    Estimator parity: the (pixel, sample, dimension) sample streams and the
    per-sample math are IDENTICAL to trace_wave (path kind) — images match
    to fp tolerance (tests/test_persistent.py).

    Eligibility (caller-enforced): kind == "path", no media / null
    materials / subsurface, no motion blur, pinhole or thin-lens camera.

    regen(sample_idx (R,) u32) -> (o, d, w_filter, dd_x, dd_y): fresh
    camera samples for every lane (the caller builds it from the camera +
    film-dimension sampler; see render.make_regen).

    s_offsets/s_stride: k-way spp interleaving. With lanes tiled k x pixels
    (offsets j in [0, k), stride k), lane (pixel, j) traces samples
    s0+j, s0+j+k, ... — k rays per pixel IN FLIGHT concurrently instead of
    one. The per-bounce coherence sort (intersect sort_rays) then sees k x
    the rays per (origin-cell, direction-octant) bin, so each 256-lane
    packet spans fewer bins and its traversal union shrinks (ROOFLINE.md §3
    "massive spp batching" — the lever measured e2e in round 4). The
    (pixel, sample, dimension) streams are unchanged, so the estimator is
    IDENTICAL to the sequential order; only fp summation order differs.

    Returns (accLw (R, 3), accW (R,), n_vertices (R,)).
    """
    R = pixel.shape[0]
    max_depth = int(icfg["max_depth"])
    kind_s = scfg["kind"]
    spp = scfg["spp"]
    DPB = 8
    ikind = icfg.get("kind", "path")
    direct_all = (ikind == "directlighting"
                  and icfg.get("strategy", "all") == "all" and static.n_lights > 1)
    _select_light, _sel_pmf_of = _light_selectors(sa, static, icfg, True, ikind)

    def _nee(si, lobes, alive_m, dim_base, s_cur, light_index=None, dim_salt=0,
             array_j=0, array_n=1):
        """uniform_sample_onelight / estimate_direct, surface-only form —
        must mirror trace_wave._nee_at with medium_vertex=None.

        array_j/array_n: UniformSampleAll array samples (sampler.rs
        request_2d_array + stratified.rs array strata): sample j of the
        light's n-point shifted-diagonal Latin-hypercube array."""
        if static.n_lights == 0:
            return jnp.zeros((R, 3), F32)
        u_sel = sample_1d(kind_s, seed, pixel, s_cur, dim_base + 131 * dim_salt, spp)
        u1, u2 = sample_2d(kind_s, seed, pixel, s_cur, dim_base + 1 + 131 * dim_salt, spp)
        if light_index is None:
            lid, spdf = _select_light(u_sel, si["p"])
        else:
            lid = jnp.full(R, light_index, jnp.int32)
            spdf = 1.0
            if array_n > 1:
                from . import rng as _rng

                r1 = _rng.hash_combine(seed, pixel, s_cur, jnp.uint32(0xA117 + light_index))
                r2 = _rng.hash_combine(seed, pixel, s_cur, jnp.uint32(0xB229 + light_index))
                p1 = (jnp.uint32(array_j) + r1 % jnp.uint32(array_n)) % jnp.uint32(array_n)
                p2 = (jnp.uint32(array_j) + r2 % jnp.uint32(array_n)) % jnp.uint32(array_n)
                u1 = (p1.astype(F32) + u1) / array_n
                u2 = (p2.astype(F32) + u2) / array_n
        ls = sample_li(sa, static, lid, si["p"], u1, u2, cone_spheres=static.has_cone_sphere_lights)
        wi = ls["wi"]
        wo_l = _to_local(si, si["wo"])
        wi_l = _to_local(si, wi)
        refl = _dot(wi, si["ng"]) * _dot(si["wo"], si["ng"]) > 0
        f_val = bsdf_f(lobes, wo_l, wi_l, refl) * jnp.abs(_dot(wi, si["ns"]))[:, None]
        p_b = bsdf_pdf(lobes, wo_l, wi_l)
        p_l = ls["pdf"] * spdf
        contributes = alive_m & (p_l > 0) & jnp.any(f_val * ls["li"] > 0, axis=-1)
        o_sh = _offset_ray(si["p"], si["ng"], wi, si.get("p_err"))
        t_sh = jnp.where(contributes, ls["dist"] * (1.0 - 2.0 * RAY_EPS), -1.0)
        occ = intersect_p(sa, static, o_sh, wi, t_sh, sort_rays=True)
        vis = jnp.where(occ[:, None], 0.0, 1.0)
        w_l = jnp.where(ls["delta"], 1.0, power_heuristic(1.0, p_l, 1.0, p_b))
        contrib = f_val * ls["li"] * vis * (w_l / jnp.maximum(p_l, 1e-30))[:, None]
        return jnp.where(contributes[:, None], contrib, 0.0)

    def body(st):
        (o, d, L, beta, alive, prev_spec, prev_pdf, prev_p, eta_scale,
         bounces, dd_x, dd_y, s_cur, w_cur, accL, accW, nverts, done, it) = st

        # --- extend: intersect + escaped/emitted pickup (deferred MIS) ---
        t_query = jnp.where(alive, jnp.inf, -1.0)
        hit = intersect(sa, static, o, d, t_query, sort_rays=True)
        si = surface_interaction(sa, hit, o, d)
        si = apply_bump(sa, static, si)
        valid = si["valid"]
        nverts = nverts + (alive & valid)

        if static.has_infinite:
            esc = alive & ~valid
            le = env_le(sa, static, d)
            env_row = jnp.full(R, max(static.infinite_light_index, 0), jnp.int32)
            p_l = env_pdf_li(sa, static, d) * _sel_pmf_of(env_row, prev_p)
            w = jnp.where(prev_spec, 1.0, power_heuristic(1.0, prev_pdf, 1.0, p_l))
            L = L + jnp.where(esc[:, None], beta * le * w[:, None], 0.0)
        alive = alive & valid

        if static.has_area_lights:
            lid = si["light"]
            emitting = alive & (lid >= 0)
            le = area_light_emission(sa, lid, si["ng"], si["wo"])
            area = sa.prim_area[jnp.maximum(si["prim"], 0)]
            p_l = pdf_li_area_hit(sa, prev_p, si["p"], si["ng"], lid, area, cone_spheres=static.has_cone_sphere_lights) * _sel_pmf_of(jnp.maximum(lid, 0), prev_p)
            w = jnp.where(prev_spec, 1.0, power_heuristic(1.0, prev_pdf, 1.0, p_l))
            L = L + jnp.where(emitting[:, None], beta * le * w[:, None], 0.0)

        si["duvdx"] = _compute_duv(si, o, d, dd_x)
        si["duvdy"] = _compute_duv(si, o, d, dd_y)

        # --- shade: NEE + BSDF continuation (per-lane bounce depth) ---
        dim_base = 2 + bounces * DPB
        can_scatter = alive & (bounces < max_depth - 1)
        lobes = make_bsdf(sa, static, si["mat"], si["uv"], si["p"], si["duvdx"], si["duvdy"])
        alive_sh = can_scatter & (num_lobes(lobes) > 0)
        if static.n_lights > 0:
            if direct_all:
                # UniformSampleAll (directlighting.rs strategy=all):
                # light.nsamples stratified array samples per light,
                # averaged (uniform_sample_all_lights; sampler round_count)
                for li_idx in range(static.n_lights):
                    ns = _round_ns(kind_s, _light_ns(static, li_idx))
                    acc = jnp.zeros((R, 3), F32)
                    for j in range(ns):
                        acc = acc + _nee(si, lobes, alive_sh, dim_base, s_cur,
                                         light_index=li_idx,
                                         dim_salt=1 + li_idx * 1024 + j,
                                         array_j=j, array_n=ns)
                    L = L + beta * acc / ns
            else:
                L = L + beta * _nee(si, lobes, alive_sh, dim_base, s_cur)

        u_lobe = sample_1d(kind_s, seed, pixel, s_cur, dim_base + 2, spp)
        u1, u2 = sample_2d(kind_s, seed, pixel, s_cur, dim_base + 3, spp)
        wo_l = _to_local(si, si["wo"])
        if ikind == "directlighting":
            # specular-only continuation (specular_reflect/transmit
            # recursion, integrator.rs:409-520); diffuse vertices retire
            from .bsdf import SPECULAR_KINDS

            spec_only = {
                "kind": jnp.where(_is_specular(lobes["kind"]), lobes["kind"], 0),
                "data": lobes["data"],
                "possible": tuple(p & SPECULAR_KINDS for p in lobes["possible"]),
            }
            bs = bsdf_sample(spec_only, wo_l, u_lobe, u1, u2)
        else:
            bs = bsdf_sample(lobes, wo_l, u_lobe, u1, u2)
        wi_w = _to_world(si, bs["wi"])
        cos_term = jnp.abs(_dot(wi_w, si["ns"]))
        thru = bs["f"] * (cos_term / jnp.maximum(bs["pdf"], 1e-30))[:, None]
        surf_cont = alive_sh & bs["valid"] & jnp.any(thru > 0, axis=-1)

        new_alive = surf_cont
        new_beta = jnp.where(surf_cont[:, None], beta * thru, beta)
        new_d = jnp.where(surf_cont[:, None], wi_w, d)
        new_o = jnp.where(surf_cont[:, None], _offset_ray(si["p"], si["ng"], wi_w, si.get("p_err")), o)
        new_spec = bs["specular"] & surf_cont
        new_pdf = jnp.where(surf_cont, jnp.maximum(bs["pdf"], 1e-30), prev_pdf)
        new_prev_p = jnp.where(surf_cont[:, None], si["p"], prev_p)
        eta_scale = jnp.where(surf_cont, eta_scale * bs["eta_scale"], eta_scale)
        new_bounces = bounces + surf_cont

        if ikind == "path":
            # russian roulette (path.rs:206-214); directlighting's specular
            # chains are depth-capped only
            rr_beta = new_beta * eta_scale[:, None]
            max_c = jnp.max(rr_beta, axis=-1)
            q = jnp.maximum(0.05, 1.0 - max_c)
            do_rr = (new_bounces > 3) & (max_c < icfg.get("rr_threshold", 1.0))
            u_rr = sample_1d(kind_s, seed, pixel, s_cur, dim_base + 4, spp)
            killed = do_rr & (u_rr < q)
            new_alive = new_alive & ~killed
            new_beta = jnp.where((do_rr & ~killed)[:, None], new_beta / jnp.maximum(1.0 - q, 1e-6)[:, None], new_beta)

        # --- flush finished samples, regenerate or retire lanes ---
        die = ~done & ~new_alive
        Lf = jnp.maximum(jnp.where(jnp.isfinite(L), L, 0.0), 0.0)
        if max_sample_luminance < float("inf"):
            y = Lf[:, 0] * 0.212671 + Lf[:, 1] * 0.715160 + Lf[:, 2] * 0.072169
            scale = jnp.where(y > max_sample_luminance, max_sample_luminance / jnp.maximum(y, 1e-12), 1.0)
            Lf = Lf * scale[:, None]
        accL = accL + jnp.where(die[:, None], Lf * w_cur[:, None], 0.0)
        accW = accW + jnp.where(die, w_cur, 0.0)

        s_next = s_cur + jnp.uint32(s_stride)
        more = die & (s_next < jnp.asarray(s0, jnp.uint32) + jnp.uint32(n_samples))
        done = done | (die & ~more)
        o_r, d_r, w_r, ddx_r, ddy_r = regen(jnp.where(more, s_next, s_cur))
        sel = more[:, None]
        new_o = jnp.where(sel, o_r, new_o)
        new_d = jnp.where(sel, d_r, new_d)
        L = jnp.where(sel, 0.0, L)
        new_beta = jnp.where(sel, 1.0, new_beta)
        new_alive = new_alive | more
        new_spec = jnp.where(more, True, new_spec)
        new_pdf = jnp.where(more, 1.0, new_pdf)
        new_prev_p = jnp.where(sel, o_r, new_prev_p)
        eta_scale = jnp.where(more, 1.0, eta_scale)
        new_bounces = jnp.where(more, 0, new_bounces)
        s_cur = jnp.where(more, s_next, s_cur)
        w_cur = jnp.where(more, w_r, w_cur)
        # diff dirs are camera-ray-only (trace_wave zeroes them after bounce 0)
        dd_x = jnp.where(sel, ddx_r, 0.0)
        dd_y = jnp.where(sel, ddy_r, 0.0)

        return (new_o, new_d, L, new_beta, new_alive, new_spec, new_pdf, new_prev_p,
                eta_scale, new_bounces, dd_x, dd_y, s_cur, w_cur, accL, accW, nverts,
                done, it + 1)

    samples_per_lane = -(-n_samples // max(int(s_stride), 1))

    def cond(st):
        done, it = st[17], st[18]
        # each live-lane iteration either deepens a path (<= max_depth) or
        # consumes a sample, so the cap is a safety valve only
        return jnp.any(~done) & (it < samples_per_lane * (max_depth + 2) + 8)

    s_init = jnp.broadcast_to(jnp.asarray(s0, jnp.uint32), (R,))
    if s_offsets is not None:
        s_init = s_init + jnp.asarray(s_offsets, jnp.uint32)
    in_range = s_init < jnp.asarray(s0, jnp.uint32) + jnp.uint32(n_samples)
    o0, d0, w0, ddx0, ddy0 = regen(s_init)
    st = (o0, d0, jnp.zeros((R, 3), F32), jnp.ones((R, 3), F32),
          in_range, jnp.ones(R, bool), jnp.ones(R, F32), o0,
          jnp.ones(R, F32), jnp.zeros(R, jnp.int32), ddx0, ddy0, s_init, w0,
          jnp.zeros((R, 3), F32), jnp.zeros(R, F32), jnp.zeros(R, F32),
          ~in_range, jnp.int32(0))
    st = jax.lax.while_loop(cond, body, st)
    return st[14], st[15], st[16]


def _trace_ao(sa, static, icfg, scfg, seed, o, d, pixel, sample_idx, time=None):
    """Ambient occlusion (src/integrators/ao.rs)."""
    R = o.shape[0]
    hit = intersect(sa, static, o, d, jnp.full(R, jnp.inf, F32), time=time)
    si = surface_interaction(sa, hit, o, d, time=time)
    valid = si["valid"]
    n_samples = int(icfg.get("n_samples", 64))
    cos_sample = bool(icfg.get("cos_sample", True))
    kind = scfg["kind"]
    spp = scfg["spp"]

    # flip normal to the ray side (ao.rs: face-forward to wo)
    ns = jnp.where((_dot(si["ns"], si["wo"]) < 0)[:, None], -si["ns"], si["ns"])
    ng = jnp.where((_dot(si["ng"], si["wo"]) < 0)[:, None], -si["ng"], si["ng"])
    si_f = dict(si, ns=ns, ng=ng)

    def one_sample(s, acc):
        u1, u2 = sample_2d(kind, seed, pixel, sample_idx, 2 + s, spp)
        if cos_sample:
            w_l = cosine_sample_hemisphere(u1, u2)
            pdf = jnp.maximum(w_l[..., 2], 1e-9) / jnp.pi
        else:
            z = u1
            r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
            phi = 2 * jnp.pi * u2
            w_l = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
            pdf = jnp.full(R, 1.0 / (2 * jnp.pi), F32)
        w = w_l[..., 0:1] * si_f["ss"] + w_l[..., 1:2] * si_f["ts"] + w_l[..., 2:3] * ns
        o_sh = _offset_ray(si["p"], ng, w, si.get("p_err"))
        occ = intersect_p(sa, static, o_sh, w, jnp.full(R, jnp.inf, F32), time=time)
        cos_w = _dot(w, ns)
        return acc + jnp.where(valid & ~occ & (cos_w > 0), cos_w / (jnp.pi * pdf), 0.0)

    acc = jax.lax.fori_loop(0, n_samples, one_sample, jnp.zeros(R, F32))
    val = acc / n_samples
    return jnp.broadcast_to(val[:, None], (R, 3))
