"""Batched BSDF layer: fixed-slot lobe sets in the shading frame.

Array-program redesign of the reference's arena-allocated BxDF aggregates
(src/core/reflection.rs:1496-1712 BSDF with <=8 BxDFs): every ray carries a
fixed-width SoA block of up to 8 lobes; construction masks per material kind
(src/materials/*), evaluation/sampling are generic over lobe kind so one
shading kernel serves every material with zero host dispatch.

Each lobes dict carries a STATIC `possible` tuple — per slot, the python-level
set of lobe kinds that can occur there given the scene's material set. Every
evaluation formula is only traced for kinds that can actually appear, so a
matte-only scene compiles to pure Lambertian code.

Lobe data layout (R, S, 14):
  0:3   color/scale (Kd, Ks*..., Kr; Rd for FresnelBlend)
  3     eta (scalar dielectric) — or 3:6 conductor eta rgb
  6:9   conductor k rgb; T color for FRESNEL_SPEC; Rs for FRESNEL_BLEND
  9     alpha_x
  10    alpha_y
  11    fresnel kind: 0 none, 1 dielectric, 2 conductor
  12:14 Oren-Nayar A, B

Local frame convention: z = shading normal; cos_theta(w) = w.z.
"""
from __future__ import annotations

import jax.numpy as jnp

F32 = jnp.float32
N_SLOTS = 8

LOBE_NONE = 0
LOBE_LAMBERT_R = 1
LOBE_LAMBERT_T = 2
LOBE_OREN_NAYAR = 3
LOBE_MICRO_R = 4
LOBE_MICRO_T = 5
LOBE_SPEC_R = 6
LOBE_SPEC_T = 7
LOBE_FRESNEL_SPEC = 8
LOBE_FRESNEL_BLEND = 9
LOBE_DISNEY_DIFF = 10  # Burley diffuse + sheen (disney.rs DisneyDiffuse/Sheen)
LOBE_CLEARCOAT = 11  # GTR1 clearcoat (disney.rs DisneyClearcoat)
LOBE_FOURIER = 12  # tabulated measured BSDF (reflection.rs FourierBSDF); table id in data[12]
LOBE_HAIR = 13  # Marschner fiber model (materials/hair.rs); see device/hair.py for slots
LOBE_SSS_ADAPTER = 14  # BSSRDF exit-point lobe: f = Sw(wi) * eta^2
                       # (bssrdf.rs SeparableBSSRDFAdapter), cosine-sampled

SPECULAR_KINDS = frozenset({LOBE_SPEC_R, LOBE_SPEC_T, LOBE_FRESNEL_SPEC})
TRANS_KINDS = frozenset({LOBE_LAMBERT_T, LOBE_MICRO_T, LOBE_SPEC_T})
INV_PI = 1.0 / jnp.pi


def correct_shading_normal(ns, ng, wo, wi):
    """Adjoint-BSDF shading-normal correction for importance transport:
    |wo.ns||wi.ng| / (|wo.ng||wi.ns|), applied to beta on every
    importance-mode scatter (bdpt.rs:45-57; used at :366 and :1048).
    All vectors world-space. Returns 0 where the denominator vanishes."""
    num = jnp.abs(jnp.sum(wo * ns, axis=-1)) * jnp.abs(jnp.sum(wi * ng, axis=-1))
    denom = jnp.abs(jnp.sum(wo * ng, axis=-1)) * jnp.abs(jnp.sum(wi * ns, axis=-1))
    return jnp.where(denom > 1e-12, num / jnp.maximum(denom, 1e-12), 0.0)


def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0


def _norm(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


def reflect_dir(wo, n):
    return -wo + 2.0 * jnp.sum(wo * n, axis=-1, keepdims=True) * n


def refract_dir(wi, n, eta_ratio):
    """Refract wi about n with eta_ratio = eta_i / eta_t. Returns (ok, wt)."""
    cos_i = jnp.sum(n * wi, axis=-1)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    ok = sin2_t < 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    wt = eta_ratio[..., None] * -wi + (eta_ratio * cos_i - cos_t)[..., None] * n
    return ok, wt


# ---------------------------------------------------------------------------
# Fresnel (reflection.rs:521-609)
# ---------------------------------------------------------------------------


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; handles both sides via sign of cos_i."""
    cos_i = jnp.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    ci = jnp.abs(cos_i)
    sin_t = ei / et * jnp.sqrt(jnp.maximum(0.0, 1.0 - ci * ci))
    tir = sin_t >= 1.0
    ct = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t * sin_t))
    r_parl = (et * ci - ei * ct) / jnp.maximum(et * ci + ei * ct, 1e-30)
    r_perp = (ei * ci - et * ct) / jnp.maximum(ei * ci + et * ct, 1e-30)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return jnp.where(tir, 1.0, f)


def fresnel_conductor(cos_i, eta, k):
    """Conductor Fresnel, rgb eta/k (reflection.rs fr_conductor)."""
    ci = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)[..., None]
    cos2 = ci * ci
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - sin2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * eta2 * k2, 0.0))
    t1 = a2b2 + cos2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-30)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-30)
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_i, f0):
    """Schlick approximation with rgb F0 (disney.rs specular fresnel)."""
    c = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)
    m = (1.0 - c) ** 5
    return f0 + m[..., None] * (1.0 - f0)


def lobe_fresnel(data, cos_i, possible_fresnels=(0, 1, 2, 3)):
    """Per-lobe Fresnel dispatch by data[..., 11]."""
    fk = data[..., 11]
    out = jnp.ones(cos_i.shape + (3,), F32)
    if 1 in possible_fresnels:
        eta = data[..., 3]
        f_d = fresnel_dielectric(cos_i, 1.0, jnp.maximum(eta, 1.0 + 1e-6))[..., None]
        out = jnp.where((fk == 1)[..., None], f_d, out)
    if 2 in possible_fresnels:
        f_c = fresnel_conductor(cos_i, data[..., 3:6], data[..., 6:9])
        out = jnp.where((fk == 2)[..., None], f_c, out)
    if 3 in possible_fresnels:
        f_s = fresnel_schlick(cos_i, data[..., 3:6])
        out = jnp.where((fk == 3)[..., None], f_s, out)
    return out


# ---------------------------------------------------------------------------
# Trowbridge-Reitz / GGX microfacet distribution (src/core/microfacet.rs:318)
# ---------------------------------------------------------------------------


def tr_roughness_to_alpha(rough):
    """TrowbridgeReitz::roughness_to_alpha (microfacet.rs)."""
    r = jnp.maximum(rough, 1e-3)
    x = jnp.log(r)
    return 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3 + 0.000640711 * x ** 4


def ggx_d(wh, ax, ay):
    c2 = wh[..., 2] * wh[..., 2]
    e = jnp.where(
        c2 > 1e-12,
        (wh[..., 0] * wh[..., 0] / jnp.maximum(ax * ax, 1e-12) + wh[..., 1] * wh[..., 1] / jnp.maximum(ay * ay, 1e-12))
        / jnp.maximum(c2, 1e-12),
        0.0,
    )
    denom = jnp.pi * ax * ay * c2 * c2 * (1.0 + e) ** 2
    d = 1.0 / jnp.maximum(denom, 1e-20)
    return jnp.where(c2 > 1e-12, d, 0.0)


def ggx_lambda(w, ax, ay):
    c = w[..., 2]
    c2 = c * c
    a2 = (w[..., 0] * w[..., 0] * ax * ax + w[..., 1] * w[..., 1] * ay * ay)
    alpha2_tan2 = jnp.where(c2 > 1e-12, a2 / jnp.maximum(c2, 1e-12), 1e12)
    lam = 0.5 * (-1.0 + jnp.sqrt(1.0 + alpha2_tan2))
    return jnp.where(jnp.abs(c) > 1e-6, lam, 1e6)


def ggx_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + ggx_lambda(wo, ax, ay) + ggx_lambda(wi, ax, ay))


def ggx_g1(w, ax, ay):
    return 1.0 / (1.0 + ggx_lambda(w, ax, ay))


def ggx_sample_wh(wo, u1, u2, ax, ay):
    """Visible-normal sampling (microfacet.rs trowbridge_reitz_sample)."""
    flip = wo[..., 2] < 0
    wo_f = jnp.where(flip[..., None], -wo, wo)
    wi_s = _norm(jnp.stack([ax * wo_f[..., 0], ay * wo_f[..., 1], wo_f[..., 2]], axis=-1))
    t1 = jnp.where(
        (wi_s[..., 2] < 0.9999)[..., None],
        _norm(jnp.cross(jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], F32), wi_s.shape), wi_s)),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], F32), wi_s.shape),
    )
    t2 = jnp.cross(wi_s, t1)
    a = 1.0 / (1.0 + wi_s[..., 2])
    r = jnp.sqrt(jnp.maximum(u1, 0.0))
    phi = jnp.where(u2 < a, u2 / jnp.maximum(a, 1e-12) * jnp.pi, jnp.pi + (u2 - a) / jnp.maximum(1.0 - a, 1e-12) * jnp.pi)
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi) * jnp.where(u2 < a, 1.0, wi_s[..., 2])
    p3 = jnp.sqrt(jnp.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * wi_s
    wh = _norm(jnp.stack([ax * nh[..., 0], ay * nh[..., 1], jnp.maximum(nh[..., 2], 1e-6)], axis=-1))
    return jnp.where(flip[..., None], -wh, wh)


def ggx_pdf(wo, wh, ax, ay):
    """Visible normal pdf: D(wh) G1(wo) |wo.wh| / |cos wo|."""
    return (
        ggx_d(wh, ax, ay)
        * ggx_g1(wo, ax, ay)
        * jnp.abs(jnp.sum(wo * wh, axis=-1))
        / jnp.maximum(abs_cos_theta(wo), 1e-9)
    )


# ---------------------------------------------------------------------------
# Beckmann distribution (src/core/microfacet.rs:150-316). Selected per lobe
# by data[..., 12] > 0 ("distribution" "beckmann"); sampling uses the full-D
# form (pdf = D |cos wh|) rather than the reference's visible-normal variant
# — a variance-only deviation, pdf-consistent with the sampler below.
# ---------------------------------------------------------------------------


def beckmann_d(wh, ax, ay):
    c2 = wh[..., 2] * wh[..., 2]
    tan2 = jnp.where(
        c2 > 1e-12,
        (wh[..., 0] * wh[..., 0] / jnp.maximum(ax * ax, 1e-12)
         + wh[..., 1] * wh[..., 1] / jnp.maximum(ay * ay, 1e-12)) / jnp.maximum(c2, 1e-12),
        1e12,
    )
    d = jnp.exp(-tan2) / jnp.maximum(jnp.pi * ax * ay * c2 * c2, 1e-20)
    return jnp.where(c2 > 1e-12, d, 0.0)


def beckmann_lambda(w, ax, ay):
    """microfacet.rs BeckmannDistribution::lambda (rational approximation)."""
    c = jnp.abs(w[..., 2])
    sin2 = jnp.maximum(1.0 - c * c, 0.0)
    # alpha along this direction's azimuth
    denom = jnp.maximum(sin2, 1e-12)
    cos2p = jnp.where(sin2 > 1e-12, w[..., 0] * w[..., 0] / denom, 1.0)
    sin2p = jnp.where(sin2 > 1e-12, w[..., 1] * w[..., 1] / denom, 0.0)
    alpha = jnp.sqrt(jnp.maximum(cos2p * ax * ax + sin2p * ay * ay, 1e-12))
    abs_tan = jnp.sqrt(sin2) / jnp.maximum(c, 1e-9)
    a = 1.0 / jnp.maximum(alpha * abs_tan, 1e-12)
    lam = jnp.where(
        a >= 1.6, 0.0,
        (1.0 - 1.259 * a + 0.396 * a * a) / jnp.maximum(3.535 * a + 2.181 * a * a, 1e-12),
    )
    return jnp.where(jnp.abs(w[..., 2]) > 1e-6, lam, 1e6)


def beckmann_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + beckmann_lambda(wo, ax, ay) + beckmann_lambda(wi, ax, ay))


def beckmann_sample_wh(wo, u1, u2, ax, ay):
    """Full-distribution sampling (microfacet.rs beckmann_sample, the
    sample_visible_area=false branch), anisotropic."""
    log_s = jnp.log(jnp.maximum(1.0 - u1, 1e-12))
    iso = jnp.abs(ax - ay) < 1e-7
    phi_i = 2.0 * jnp.pi * u2
    phi_a = jnp.arctan(ay / jnp.maximum(ax, 1e-9) * jnp.tan(2.0 * jnp.pi * u2 + 0.5 * jnp.pi))
    phi_a = jnp.where(u2 > 0.5, phi_a + jnp.pi, phi_a)
    phi = jnp.where(iso, phi_i, phi_a)
    cp = jnp.cos(phi)
    sp = jnp.sin(phi)
    tan2 = jnp.where(
        iso,
        -log_s * ax * ax,
        -log_s / jnp.maximum(cp * cp / jnp.maximum(ax * ax, 1e-12) + sp * sp / jnp.maximum(ay * ay, 1e-12), 1e-12),
    )
    c = 1.0 / jnp.sqrt(1.0 + tan2)
    s = jnp.sqrt(jnp.maximum(1.0 - c * c, 0.0))
    wh = jnp.stack([s * cp, s * sp, c], axis=-1)
    return jnp.where(same_hemisphere(wo, wh)[..., None], wh, -wh)


def beckmann_pdf(wo, wh, ax, ay):
    return beckmann_d(wh, ax, ay) * jnp.abs(wh[..., 2])


def _is_beck(kind, data):
    """Per-lobe Beckmann flag (micro lobes store it in data[..., 12])."""
    return ((kind == LOBE_MICRO_R) | (kind == LOBE_MICRO_T)) & (data[..., 12] > 0)


def micro_d(kind, data, wh, ax, ay, beck: bool):
    if not beck:
        return ggx_d(wh, ax, ay)
    return jnp.where(_is_beck(kind, data), beckmann_d(wh, ax, ay), ggx_d(wh, ax, ay))


def micro_g(kind, data, wo, wi, ax, ay, beck: bool):
    if not beck:
        return ggx_g(wo, wi, ax, ay)
    return jnp.where(_is_beck(kind, data), beckmann_g(wo, wi, ax, ay), ggx_g(wo, wi, ax, ay))


def micro_sample_wh(kind, data, wo, u1, u2, ax, ay, beck: bool):
    if not beck:
        return ggx_sample_wh(wo, u1, u2, ax, ay)
    return jnp.where(
        _is_beck(kind, data)[..., None],
        beckmann_sample_wh(wo, u1, u2, ax, ay),
        ggx_sample_wh(wo, u1, u2, ax, ay),
    )


def micro_pdf_wh(kind, data, wo, wh, ax, ay, beck: bool):
    if not beck:
        return ggx_pdf(wo, wh, ax, ay)
    return jnp.where(_is_beck(kind, data), beckmann_pdf(wo, wh, ax, ay), ggx_pdf(wo, wh, ax, ay))


# ---------------------------------------------------------------------------
# Sampling helpers (src/core/sampling.rs)
# ---------------------------------------------------------------------------


def cosine_sample_hemisphere(u1, u2):
    from .camera import concentric_sample_disk

    dx, dy = concentric_sample_disk(u1, u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - dx * dx - dy * dy))
    return jnp.stack([dx, dy, z], axis=-1)


# ---------------------------------------------------------------------------
# Lobe evaluation (statically pruned by `possible` kind sets)
# ---------------------------------------------------------------------------

_DIFFUSE_LIKE = frozenset({LOBE_LAMBERT_R, LOBE_LAMBERT_T, LOBE_OREN_NAYAR})


def _lobe_f(kind, data, wo, wi, possible: frozenset, fourier_ft=None, beck=False,
            mode: str = "radiance"):
    """f for one lobe slot, vectorized. Non-specular kinds only.

    `mode` is a STATIC transport-mode flag ("radiance" | "importance"):
    radiance transport carries the non-symmetric eta factors on
    transmission (reflection.rs:1087 MicrofacetTransmission factor,
    :1308 Fourier); importance (adjoint) transport omits them."""
    R = wo.shape[0]
    color = data[..., 0:3]
    out = jnp.zeros((R, 3), F32)
    refl_hemi = same_hemisphere(wo, wi)
    abs_ci = abs_cos_theta(wi)
    abs_co = abs_cos_theta(wo)

    if possible & {LOBE_LAMBERT_R, LOBE_LAMBERT_T}:
        f_lam = color * INV_PI
        m = (kind == LOBE_LAMBERT_R) | (kind == LOBE_LAMBERT_T)
        out = jnp.where(m[:, None], f_lam, out)

    if LOBE_SSS_ADAPTER in possible:
        # directional BSSRDF term at the exit point; the eta^2 boost exists
        # only in radiance transport (bssrdf.rs:593-600 mode branch)
        from .bssrdf import sw_factor

        eta_a = jnp.maximum(data[..., 3], 1.0 + 1e-6)
        f_sw = sw_factor(eta_a, cos_theta(wi))
        if mode == "radiance":
            f_sw = f_sw * eta_a * eta_a
        out = jnp.where(((kind == LOBE_SSS_ADAPTER) & refl_hemi)[:, None],
                        f_sw[..., None] * jnp.ones((1, 3), F32), out)

    if LOBE_OREN_NAYAR in possible:
        si = jnp.sqrt(jnp.maximum(1.0 - wi[..., 2] ** 2, 0.0))
        so = jnp.sqrt(jnp.maximum(1.0 - wo[..., 2] ** 2, 0.0))
        cos_phi_i = jnp.where(si > 1e-4, wi[..., 0] / jnp.maximum(si, 1e-12), 1.0)
        sin_phi_i = jnp.where(si > 1e-4, wi[..., 1] / jnp.maximum(si, 1e-12), 0.0)
        cos_phi_o = jnp.where(so > 1e-4, wo[..., 0] / jnp.maximum(so, 1e-12), 1.0)
        sin_phi_o = jnp.where(so > 1e-4, wo[..., 1] / jnp.maximum(so, 1e-12), 0.0)
        max_cos = jnp.maximum(0.0, cos_phi_i * cos_phi_o + sin_phi_i * sin_phi_o)
        sin_alpha = jnp.where(abs_ci > abs_co, so, si)
        tan_beta = jnp.where(abs_ci > abs_co, si / jnp.maximum(abs_ci, 1e-9), so / jnp.maximum(abs_co, 1e-9))
        f_on = color * INV_PI * (data[..., 12] + data[..., 13] * max_cos * sin_alpha * tan_beta)[..., None]
        out = jnp.where((kind == LOBE_OREN_NAYAR)[:, None], f_on, out)

    needs_wh = possible & {LOBE_MICRO_R, LOBE_FRESNEL_BLEND}
    if needs_wh:
        ax = data[..., 9]
        ay = data[..., 10]
        wh = wi + wo
        wh_len = jnp.linalg.norm(wh, axis=-1)
        wh_n = wh / jnp.maximum(wh_len, 1e-30)[..., None]
        d_val = micro_d(kind, data, wh_n, ax, ay, beck)

    if LOBE_MICRO_R in possible:
        fr = lobe_fresnel(data, jnp.sum(wi * jnp.where((wh_n[..., 2] < 0)[..., None], -wh_n, wh_n), axis=-1))
        g_val = micro_g(kind, data, wo, wi, ax, ay, beck)
        denom = 4.0 * abs_co * abs_ci
        f_mr = color * fr * (d_val * g_val / jnp.maximum(denom, 1e-12))[..., None]
        ok_mr = refl_hemi & (wh_len > 1e-12) & (abs_ci > 0) & (abs_co > 0)
        out = jnp.where(((kind == LOBE_MICRO_R) & ok_mr)[:, None], f_mr, out)

    if LOBE_MICRO_T in possible:
        ax = data[..., 9]
        ay = data[..., 10]
        eta = jnp.maximum(data[..., 3], 1.0 + 1e-6)
        eta_t = jnp.where(cos_theta(wo) > 0, eta, 1.0 / eta)
        wh_t = _norm(wo + wi * eta_t[..., None])
        wh_t = jnp.where((wh_t[..., 2] < 0)[..., None], -wh_t, wh_t)
        sqrt_denom = jnp.sum(wo * wh_t, axis=-1) + eta_t * jnp.sum(wi * wh_t, axis=-1)
        fr_t = fresnel_dielectric(jnp.sum(wo * wh_t, axis=-1), 1.0, eta)
        d_t = micro_d(kind, data, wh_t, ax, ay, beck)
        g_t = micro_g(kind, data, wo, wi, ax, ay, beck)
        # radiance mode carries factor^2 = (1/eta)^2 against the eta^2
        # Jacobian term (reflection.rs:1086-1089); importance mode keeps
        # the bare eta^2 (adjoint BSDF is eta^2 larger on transmission)
        factor2 = 1.0 / (eta_t * eta_t) if mode == "radiance" else jnp.ones_like(eta_t)
        f_mt_val = (1.0 - fr_t) * jnp.abs(
            d_t * g_t * eta_t * eta_t * factor2
            * jnp.abs(jnp.sum(wi * wh_t, axis=-1)) * jnp.abs(jnp.sum(wo * wh_t, axis=-1))
            / jnp.maximum(abs_ci * abs_co * sqrt_denom * sqrt_denom, 1e-12)
        )
        same_side = jnp.sum(wo * wh_t, axis=-1) * jnp.sum(wi * wh_t, axis=-1) > 0
        ok_mt = (~refl_hemi) & ~same_side & (abs_ci > 0) & (abs_co > 0)
        out = jnp.where(((kind == LOBE_MICRO_T) & ok_mt)[:, None], color * f_mt_val[..., None], out)

    if LOBE_DISNEY_DIFF in possible:
        # Burley diffuse + sheen (disney.rs DisneyDiffuse :60-90, Sheen)
        # data: color = baseColor*(1-metallic); 12 = roughness; 6:9 sheen color
        rough = data[..., 12]
        pow5 = lambda x: x * x * x * x * x
        fo = pow5(1.0 - abs_co)
        fi = pow5(1.0 - abs_ci)
        wh_d = _norm(wi + wo)
        cos_d = jnp.sum(wi * wh_d, axis=-1)
        fd90 = 0.5 + 2.0 * rough * cos_d * cos_d
        fd = (1.0 + (fd90 - 1.0) * fo) * (1.0 + (fd90 - 1.0) * fi)
        sheen = data[..., 6:9] * pow5(1.0 - jnp.abs(cos_d))[..., None]
        f_dd = color * INV_PI * fd[..., None] + sheen
        out = jnp.where(((kind == LOBE_DISNEY_DIFF) & refl_hemi)[:, None], f_dd, out)

    if LOBE_CLEARCOAT in possible:
        # GTR1 distribution, fixed Fresnel 0.04, smith G alpha 0.25
        # (disney.rs DisneyClearcoat); data[9] = gloss alpha, color = weight
        alpha_c = data[..., 9]
        wh_c = wi + wo
        whl = jnp.linalg.norm(wh_c, axis=-1)
        wh_c = wh_c / jnp.maximum(whl, 1e-30)[..., None]
        a2 = jnp.clip(alpha_c * alpha_c, 1e-6, 1.0 - 1e-4)
        c2h = jnp.clip(wh_c[..., 2] * wh_c[..., 2], 0.0, 1.0)
        d_c = (a2 - 1.0) / (jnp.pi * jnp.log(a2) * (1.0 + (a2 - 1.0) * c2h))
        d_c = jnp.clip(d_c, 0.0, 1e6)
        fr_c = 0.04 + 0.96 * (1.0 - jnp.abs(jnp.sum(wi * wh_c, axis=-1))) ** 5
        g_c = ggx_g(wo, wi, jnp.full_like(alpha_c, 0.25), jnp.full_like(alpha_c, 0.25))
        f_cc = color * (d_c * fr_c * g_c / jnp.maximum(4.0 * abs_co * abs_ci, 1e-12))[..., None]
        ok_cc = refl_hemi & (whl > 1e-12)
        out = jnp.where(((kind == LOBE_CLEARCOAT) & ok_cc)[:, None], f_cc, out)

    if LOBE_FOURIER in possible and fourier_ft is not None:
        from .fourier import fourier_f

        f_fo = fourier_f(fourier_ft, data[..., 12].astype(jnp.int32), wo, wi, mode)
        out = jnp.where((kind == LOBE_FOURIER)[:, None], f_fo, out)

    if LOBE_HAIR in possible:
        from .hair import hair_f

        f_h = hair_f(data, wo, wi)
        out = jnp.where((kind == LOBE_HAIR)[:, None], f_h, out)

    if LOBE_FRESNEL_BLEND in possible:
        rd = color
        rs = data[..., 6:9]
        pow5 = lambda x: x * x * x * x * x
        diffuse = (
            (28.0 / (23.0 * jnp.pi))
            * rd
            * (1.0 - pow5(1.0 - 0.5 * abs_ci))[..., None]
            * (1.0 - pow5(1.0 - 0.5 * abs_co))[..., None]
        ) * (1.0 - rs)
        schlick = rs + pow5(1.0 - jnp.abs(jnp.sum(wi * wh_n, axis=-1)))[..., None] * (1.0 - rs)
        spec = (
            d_val / jnp.maximum(4.0 * jnp.abs(jnp.sum(wi * wh_n, axis=-1)) * jnp.maximum(abs_ci, abs_co), 1e-12)
        )[..., None] * schlick
        f_fb = diffuse + jnp.where((wh_len > 1e-12)[..., None], spec, 0.0)
        out = jnp.where(((kind == LOBE_FRESNEL_BLEND) & refl_hemi)[:, None], f_fb, out)

    return out


def _lobe_matches(kind, refl):
    """Does this lobe contribute for the given geometric reflect/transmit bit?"""
    is_trans = (kind == LOBE_LAMBERT_T) | (kind == LOBE_MICRO_T) | (kind == LOBE_SPEC_T)
    is_both = (kind == LOBE_FRESNEL_SPEC) | (kind == LOBE_FOURIER) | (kind == LOBE_HAIR)
    is_refl = (kind != LOBE_NONE) & ~is_trans & ~is_both
    return jnp.where(refl, is_refl, is_trans) | is_both


def _lobe_pdf(kind, data, wo, wi, possible: frozenset, fourier_ft=None, beck=False):
    """Solid-angle pdf for one lobe (0 for specular kinds)."""
    refl_hemi = same_hemisphere(wo, wi)
    abs_ci = abs_cos_theta(wi)
    pdf = jnp.zeros(wo.shape[0], F32)
    cos_pdf = abs_ci * INV_PI

    if possible & (_DIFFUSE_LIKE | {LOBE_DISNEY_DIFF, LOBE_SSS_ADAPTER}):
        diff_like = (kind == LOBE_LAMBERT_R) | (kind == LOBE_OREN_NAYAR) | (kind == LOBE_DISNEY_DIFF) | (kind == LOBE_SSS_ADAPTER)
        pdf = jnp.where(diff_like & refl_hemi, cos_pdf, pdf)
        pdf = jnp.where((kind == LOBE_LAMBERT_T) & ~refl_hemi, cos_pdf, pdf)

    if LOBE_CLEARCOAT in possible:
        alpha_c = data[..., 9]
        wh_c = _norm(wo + wi)
        a2 = jnp.clip(alpha_c * alpha_c, 1e-6, 1.0 - 1e-4)
        c2h = jnp.clip(wh_c[..., 2] * wh_c[..., 2], 0.0, 1.0)
        d_c = (a2 - 1.0) / (jnp.pi * jnp.log(a2) * (1.0 + (a2 - 1.0) * c2h))
        d_c = jnp.clip(d_c, 0.0, 1e6)
        p_cc = d_c * jnp.abs(wh_c[..., 2]) / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * wh_c, axis=-1)), 1e-12)
        pdf = jnp.where((kind == LOBE_CLEARCOAT) & refl_hemi, p_cc, pdf)

    if possible & {LOBE_MICRO_R, LOBE_FRESNEL_BLEND}:
        ax = data[..., 9]
        ay = data[..., 10]
        wh = _norm(wo + wi)
        p_mr = micro_pdf_wh(kind, data, wo, wh, ax, ay, beck) / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * wh, axis=-1)), 1e-12)
        pdf = jnp.where((kind == LOBE_MICRO_R) & refl_hemi, p_mr, pdf)
        if LOBE_FRESNEL_BLEND in possible:
            p_fb = 0.5 * (cos_pdf + p_mr)
            pdf = jnp.where((kind == LOBE_FRESNEL_BLEND) & refl_hemi, p_fb, pdf)

    if LOBE_MICRO_T in possible:
        ax = data[..., 9]
        ay = data[..., 10]
        eta = jnp.maximum(data[..., 3], 1.0 + 1e-6)
        eta_t = jnp.where(cos_theta(wo) > 0, eta, 1.0 / eta)
        wh_t = _norm(wo + wi * eta_t[..., None])
        sqrt_denom = jnp.sum(wo * wh_t, axis=-1) + eta_t * jnp.sum(wi * wh_t, axis=-1)
        dwh_dwi = jnp.abs(eta_t * eta_t * jnp.sum(wi * wh_t, axis=-1) / jnp.maximum(sqrt_denom * sqrt_denom, 1e-12))
        same_side = jnp.sum(wo * wh_t, axis=-1) * jnp.sum(wi * wh_t, axis=-1) > 0
        p_mt = micro_pdf_wh(kind, data, wo, wh_t, ax, ay, beck) * dwh_dwi
        pdf = jnp.where((kind == LOBE_MICRO_T) & ~refl_hemi & ~same_side, p_mt, pdf)

    if LOBE_FOURIER in possible and fourier_ft is not None:
        from .fourier import fourier_pdf

        p_fo = fourier_pdf(fourier_ft, data[..., 12].astype(jnp.int32), wo, wi)
        pdf = jnp.where(kind == LOBE_FOURIER, p_fo, pdf)

    if LOBE_HAIR in possible:
        from .hair import hair_pdf

        p_h = hair_pdf(data, wo, wi)
        pdf = jnp.where(kind == LOBE_HAIR, p_h, pdf)

    return pdf


def _slot_possible(lobes, s):
    poss = lobes.get("possible")
    if poss is None:
        return frozenset(range(1, 10))
    return poss[s]


def bsdf_f(lobes, wo, wi, refl, mode: str = "radiance"):
    """Sum of lobe f values matching the reflect/transmit geometry bit."""
    kinds = lobes["kind"]
    beck = bool(lobes.get("has_beckmann", False))
    total = jnp.zeros((wo.shape[0], 3), F32)
    for s in range(kinds.shape[1]):
        poss = _slot_possible(lobes, s) - SPECULAR_KINDS
        if not poss:
            continue
        k = kinds[:, s]
        match = _lobe_matches(k, refl) & ~_is_specular(k)
        f_s = _lobe_f(k, lobes["data"][:, s], wo, wi, poss, lobes.get("fourier"), beck, mode)
        total = total + jnp.where(match[:, None], f_s, 0.0)
    return total


def _is_specular(kind):
    return (kind == LOBE_SPEC_R) | (kind == LOBE_SPEC_T) | (kind == LOBE_FRESNEL_SPEC)


def bsdf_pdf(lobes, wo, wi):
    """Average pdf over all active lobes (reflection.rs BSDF::pdf)."""
    kinds = lobes["kind"]
    total = jnp.zeros(wo.shape[0], F32)
    n = jnp.zeros(wo.shape[0], F32)
    for s in range(kinds.shape[1]):
        poss = _slot_possible(lobes, s)
        if not poss:
            continue
        k = kinds[:, s]
        active = k != LOBE_NONE
        if poss - SPECULAR_KINDS:
            total = total + jnp.where(active, _lobe_pdf(k, lobes["data"][:, s], wo, wi, poss, lobes.get("fourier"), bool(lobes.get("has_beckmann", False))), 0.0)
        n = n + active
    return jnp.where(n > 0, total / jnp.maximum(n, 1.0), 0.0)


def num_lobes(lobes):
    return jnp.sum(lobes["kind"] != LOBE_NONE, axis=1)


def all_possible(lobes) -> frozenset:
    poss = lobes.get("possible")
    if poss is None:
        return frozenset(range(1, 10))
    out = frozenset()
    for p in poss:
        out = out | p
    return out


def bsdf_sample(lobes, wo, u_lobe, u1, u2, mode: str = "radiance"):
    """Sample the BSDF: choose a lobe uniformly, sample it, combine.

    Returns dict {wi, f, pdf, specular, valid, eta_scale, abs_cos}.
    Mirrors BSDF::sample_f (reflection.rs:1583-1669): for non-specular chosen
    lobes, f and pdf are recomputed over all lobes.

    `mode` ("radiance" | "importance") is static: radiance transport applies
    the (etaI/etaT)^2 compression on specular transmission
    (reflection.rs:703,777); importance (adjoint) transport — light subpaths,
    photons — omits it. Callers of importance mode must separately apply
    `correct_shading_normal` to their throughput (bdpt.rs:1048).
    """
    kinds = lobes["kind"]
    data = lobes["data"]
    union = all_possible(lobes)
    R, S = kinds.shape
    active = kinds != LOBE_NONE
    n_act = jnp.sum(active, axis=1)
    pick = jnp.minimum((u_lobe * n_act).astype(jnp.int32), jnp.maximum(n_act - 1, 0))
    cum = jnp.cumsum(active, axis=1) - 1
    # one-hot slot selection over the 8 lobe slots
    sel = active & (cum == pick[:, None])
    k = jnp.sum(jnp.where(sel, kinds, 0), axis=1)
    dat = jnp.sum(jnp.where(sel[:, :, None], data, 0.0), axis=1)

    color = dat[:, 0:3]
    eta = jnp.maximum(dat[:, 3], 1.0 + 1e-6)
    ax = dat[:, 9]
    ay = dat[:, 10]
    entering = cos_theta(wo) > 0
    flip_z = jnp.array([1.0, 1.0, -1.0], F32)

    wi = jnp.zeros((R, 3), F32)
    valid = n_act > 0
    specular = _is_specular(k)

    needs_cos = union & {LOBE_LAMBERT_R, LOBE_OREN_NAYAR, LOBE_LAMBERT_T, LOBE_DISNEY_DIFF, LOBE_SSS_ADAPTER}
    if needs_cos:
        wi_cos = cosine_sample_hemisphere(u1, u2)
        wi_diff_r = jnp.where(entering[:, None], wi_cos, wi_cos * flip_z)
        m = (k == LOBE_LAMBERT_R) | (k == LOBE_OREN_NAYAR) | (k == LOBE_DISNEY_DIFF) | (k == LOBE_SSS_ADAPTER)
        wi = jnp.where(m[:, None], wi_diff_r, wi)
        if LOBE_LAMBERT_T in union:
            wi_diff_t = jnp.where(entering[:, None], wi_cos * flip_z, wi_cos)
            wi = jnp.where((k == LOBE_LAMBERT_T)[:, None], wi_diff_t, wi)

    if union & {LOBE_MICRO_R, LOBE_MICRO_T}:
        wh = micro_sample_wh(k, dat, wo, u1, u2, ax, ay, bool(lobes.get("has_beckmann", False)))
        if LOBE_MICRO_R in union:
            wi_mr = reflect_dir(wo, wh)
            m = k == LOBE_MICRO_R
            wi = jnp.where(m[:, None], wi_mr, wi)
            valid = valid & jnp.where(m, same_hemisphere(wo, wi_mr), True)
        if LOBE_MICRO_T in union:
            eta_ratio_m = jnp.where(entering, 1.0 / eta, eta)
            wh_facing = jnp.where((jnp.sum(wo * wh, axis=-1) < 0)[:, None], -wh, wh)
            ok_mt, wi_mt = refract_dir(wo, wh_facing, eta_ratio_m)
            m = k == LOBE_MICRO_T
            wi = jnp.where(m[:, None], wi_mt, wi)
            valid = valid & jnp.where(m, ok_mt & ~same_hemisphere(wo, wi_mt), True)

    n_local = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], F32), wo.shape)
    eta_ratio = jnp.where(entering, 1.0 / eta, eta)
    if union & {LOBE_SPEC_R, LOBE_FRESNEL_SPEC}:
        wi_sr = jnp.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], axis=-1)
        wi = jnp.where((k == LOBE_SPEC_R)[:, None], wi_sr, wi)
    if union & {LOBE_SPEC_T, LOBE_FRESNEL_SPEC}:
        n_facing = jnp.where(entering[:, None], n_local, -n_local)
        ok_st, wi_st = refract_dir(wo, n_facing, eta_ratio)
        m = k == LOBE_SPEC_T
        wi = jnp.where(m[:, None], wi_st, wi)
        valid = valid & jnp.where(m, ok_st, True)

    if LOBE_FRESNEL_SPEC in union:
        fr_s = fresnel_dielectric(cos_theta(wo), 1.0, eta)
        choose_r = u1 < fr_s
        m = k == LOBE_FRESNEL_SPEC
        wi = jnp.where(m[:, None], jnp.where(choose_r[:, None], wi_sr, wi_st), wi)
        valid = valid & jnp.where(m & ~choose_r, ok_st, True)
    else:
        fr_s = jnp.zeros(R, F32)
        choose_r = jnp.zeros(R, bool)

    if LOBE_CLEARCOAT in union:
        # GTR1 wh sampling (disney.rs sample_wh for clearcoat)
        alpha_c = jnp.maximum(ax, 1e-3)
        a2c = alpha_c * alpha_c
        c2 = jnp.where(jnp.abs(a2c - 1.0) > 1e-6, (1.0 - jnp.power(a2c, 1.0 - u1)) / (1.0 - a2c), u1)
        cos_h = jnp.sqrt(jnp.clip(c2, 0.0, 1.0))
        sin_h = jnp.sqrt(jnp.maximum(1.0 - c2, 0.0))
        phi_h = 2.0 * jnp.pi * u2
        wh_cc = jnp.stack([sin_h * jnp.cos(phi_h), sin_h * jnp.sin(phi_h), cos_h], axis=-1)
        wh_cc = jnp.where((wo[:, 2] < 0)[:, None], -wh_cc, wh_cc)
        wi_cc = reflect_dir(wo, wh_cc)
        m = k == LOBE_CLEARCOAT
        wi = jnp.where(m[:, None], wi_cc, wi)
        valid = valid & jnp.where(m, same_hemisphere(wo, wi_cc), True)

    if LOBE_FOURIER in union:
        from .fourier import fourier_sample

        fs = fourier_sample(lobes["fourier"], dat[:, 12].astype(jnp.int32), wo, u1, u2, mode)
        m = k == LOBE_FOURIER
        wi = jnp.where(m[:, None], fs["wi"], wi)
        valid = valid & jnp.where(m, fs["valid"], True)

    if LOBE_HAIR in union:
        from .hair import hair_sample

        hs = hair_sample(dat, wo, u1, u2)
        m = k == LOBE_HAIR
        wi = jnp.where(m[:, None], hs["wi"], wi)
        valid = valid & jnp.where(m, hs["valid"], True)

    if LOBE_FRESNEL_BLEND in union:
        fb_diffuse = u1 < 0.5
        u1_fb = jnp.where(fb_diffuse, jnp.minimum(2.0 * u1, 1.0 - 1e-6), jnp.minimum(2.0 * (u1 - 0.5), 1.0 - 1e-6))
        wi_cos_fb = cosine_sample_hemisphere(u1_fb, u2)
        wi_cos_fb = jnp.where(entering[:, None], wi_cos_fb, wi_cos_fb * flip_z)
        wh_fb = ggx_sample_wh(wo, u1_fb, u2, ax, ay)
        wi_fb = jnp.where(fb_diffuse[:, None], wi_cos_fb, reflect_dir(wo, wh_fb))
        wi = jnp.where((k == LOBE_FRESNEL_BLEND)[:, None], wi_fb, wi)

    wi = _norm(wi)
    abs_ci = abs_cos_theta(wi)

    # --- specular f & pdf (delta lobes evaluated directly) ---
    f_spec = jnp.zeros((R, 3), F32)
    pdf_spec = jnp.zeros(R, F32)
    if union & SPECULAR_KINDS:
        if LOBE_SPEC_R in union:
            fr_cos = lobe_fresnel(dat, cos_theta(wo))
            f_sr = color * fr_cos / jnp.maximum(abs_ci, 1e-9)[:, None]
            f_spec = jnp.where((k == LOBE_SPEC_R)[:, None], f_sr, f_spec)
            pdf_spec = jnp.where(k == LOBE_SPEC_R, 1.0, pdf_spec)
        # (etaI/etaT)^2 radiance compression — radiance transport only
        # (reflection.rs:703,777 "if self.mode == TransportMode::Radiance")
        st_scale = eta_ratio * eta_ratio if mode == "radiance" else jnp.ones_like(eta_ratio)
        if LOBE_SPEC_T in union:
            fr_d = fresnel_dielectric(cos_theta(wo), 1.0, eta)
            f_st_c = color * ((1.0 - fr_d) * st_scale / jnp.maximum(abs_ci, 1e-9))[:, None]
            f_spec = jnp.where((k == LOBE_SPEC_T)[:, None], f_st_c, f_spec)
            pdf_spec = jnp.where(k == LOBE_SPEC_T, 1.0, pdf_spec)
        if LOBE_FRESNEL_SPEC in union:
            f_fs_r = color * (fr_s / jnp.maximum(abs_ci, 1e-9))[:, None]
            f_fs_t = dat[:, 6:9] * ((1.0 - fr_s) * st_scale / jnp.maximum(abs_ci, 1e-9))[:, None]
            m = k == LOBE_FRESNEL_SPEC
            f_spec = jnp.where(m[:, None], jnp.where(choose_r[:, None], f_fs_r, f_fs_t), f_spec)
            pdf_spec = jnp.where(m, jnp.where(choose_r, fr_s, 1.0 - fr_s), pdf_spec)

    # --- non-specular: recompute over all lobes ---
    if union - SPECULAR_KINDS:
        refl = same_hemisphere(wo, wi)
        f_all = bsdf_f(lobes, wo, wi, refl, mode)
        pdf_all = bsdf_pdf(lobes, wo, wi)
    else:
        f_all = jnp.zeros((R, 3), F32)
        pdf_all = jnp.zeros(R, F32)

    n_act_f = jnp.maximum(n_act.astype(F32), 1.0)
    f = jnp.where(specular[:, None], f_spec, f_all)
    pdf = jnp.where(specular, pdf_spec / n_act_f, pdf_all)

    # eta scale for russian roulette (path.rs:166-175)
    crossed = ~same_hemisphere(wo, wi)
    transmissive = (k == LOBE_SPEC_T) | ((k == LOBE_FRESNEL_SPEC) & ~choose_r) | ((k == LOBE_MICRO_T) & crossed)
    eta_sc = jnp.where(transmissive, jnp.where(entering, eta * eta, 1.0 / (eta * eta)), 1.0)

    valid = valid & (pdf > 0)
    return {
        "wi": wi,
        "f": f,
        "pdf": jnp.maximum(pdf, 0.0),
        "specular": specular,
        "valid": valid,
        "eta_scale": eta_sc,
        "abs_cos": abs_ci,
    }
