"""Hair fiber BSDF: the Marschner/d'Eon-style 4-lobe model.

Reference: src/materials/hair.rs (HairBSDF, 650 LoC) — longitudinal
Gaussian-like Mp terms (modified-Bessel form), azimuthal trimmed-logistic
Np terms, Fresnel/absorption attenuation Ap for p = R, TT, TRT plus a
compact residual lobe, and hair-scale tilt via the 2^k-alpha double angles.

Batched shape: everything is a straight-line batched formula over the
wave — the reference's per-p loop is unrolled (PMAX=3 is static), the
angle-wrapping `while` becomes a modulo, and Bessel i0 is a fixed 10-term
series. Local frame convention matches the lobe system (device/bsdf.py):
z = shading normal, x = dpdu = fiber tangent, so sin_theta = w.x and the
azimuth lives in (y, z) — identical to the reference's curve frame.

Data slot layout for LOBE_HAIR rows (see materials.py):
  0:3 sigma_a   3 eta   9 beta_m   10 beta_n   12 alpha_deg   13 h

Known reference deviation: hair.rs pdf() evaluates every lobe's Mp with
v[PMAX] (:478-533) while f() and the sampler use v[p]; that mismatch biases
MIS weights, so we use v[p] everywhere (matching upstream pbrt-v3).
"""
from __future__ import annotations

import jax.numpy as jnp

from .bsdf import fresnel_dielectric

F32 = jnp.float32
PMAX = 3
SQRT_PI_OVER8 = 0.626657069
_LUM = jnp.asarray([0.2126, 0.7152, 0.0722], F32)


def _sqr(x):
    return x * x


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def _safe_asin(x):
    return jnp.arcsin(jnp.clip(x, -1.0, 1.0))


def _i0(x):
    """Modified Bessel I0, 10-term power series (hair.rs:37-52)."""
    x2 = x * x
    val = jnp.ones_like(x)
    term = jnp.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(1, 10):
        ifact *= i
        i4 *= 4.0
        term = term * x2
        val = val + term / (i4 * ifact * ifact)
    return val


def _log_i0(x):
    return jnp.where(
        x > 12.0,
        x + 0.5 * (-jnp.log(2.0 * jnp.pi) + jnp.log(1.0 / jnp.maximum(x, 1e-6)) + 1.0 / (8.0 * jnp.maximum(x, 1e-6))),
        jnp.log(jnp.maximum(_i0(jnp.minimum(x, 12.0)), 1e-30)),
    )


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering lobe (hair.rs:20-34); v is per-ray."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = v <= 0.1
    # v small: exp/log form avoids overflow of sinh(1/v)
    m_small = jnp.exp(_log_i0(a) - b - 1.0 / v + 0.6931 + jnp.log(1.0 / (2.0 * v)))
    v_big = jnp.maximum(v, 0.1)
    m_big = jnp.exp(-b) * _i0(jnp.where(small, 0.0, a)) / (jnp.sinh(1.0 / v_big) * 2.0 * v_big)
    return jnp.where(small, m_small, m_big)


def _logistic(x, s):
    x = jnp.abs(x)
    e = jnp.exp(-x / s)
    return e / (s * _sqr(1.0 + e))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * jnp.log(jnp.maximum(1.0 / jnp.maximum(u * k + _logistic_cdf(a, s), 1e-9) - 1.0, 1e-9))
    return jnp.clip(x, a, b)


def _phi_p(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * jnp.pi


def _np(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_p(p, gamma_o, gamma_t)
    dphi = jnp.mod(dphi + jnp.pi, 2.0 * jnp.pi) - jnp.pi
    return _trimmed_logistic(dphi, s, -jnp.pi, jnp.pi)


def _unpack(data):
    sigma_a = jnp.maximum(data[..., 0:3], 0.0)
    eta = jnp.maximum(data[..., 3], 1.0 + 1e-4)
    beta_m = jnp.clip(data[..., 9], 0.0, 1.0)
    beta_n = jnp.clip(data[..., 10], 1e-3, 1.0)
    alpha = data[..., 12]
    h = jnp.clip(data[..., 13], -1.0 + 1e-5, 1.0 - 1e-5)
    # longitudinal variances per lobe (hair.rs:220-227)
    v0 = _sqr(0.726 * beta_m + 0.812 * _sqr(beta_m) + 3.7 * beta_m ** 20)
    v0 = jnp.maximum(v0, 1e-5)
    v = (v0, 0.25 * v0, 4.0 * v0, 4.0 * v0)
    # azimuthal logistic scale (hair.rs:230)
    s = SQRT_PI_OVER8 * (0.265 * beta_n + 1.194 * _sqr(beta_n) + 5.372 * beta_n ** 22)
    s = jnp.maximum(s, 1e-4)
    # 2^k alpha double angles (hair.rs:233-239)
    a_rad = jnp.radians(alpha)
    s0, c0 = jnp.sin(a_rad), jnp.cos(a_rad)
    s1, c1 = 2.0 * c0 * s0, _sqr(c0) - _sqr(s0)
    s2, c2 = 2.0 * c1 * s1, _sqr(c1) - _sqr(s1)
    return sigma_a, eta, h, v, s, ((s0, c0), (s1, c1), (s2, c2))


def _geo(eta, h, sigma_a, wo):
    """Shared refraction geometry + single-pass transmittance."""
    sin_to = jnp.clip(wo[..., 0], -1.0, 1.0)
    cos_to = _safe_sqrt(1.0 - _sqr(sin_to))
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])
    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - _sqr(sin_tt))
    etap = _safe_sqrt(_sqr(eta) - _sqr(sin_to)) / jnp.maximum(cos_to, 1e-6)
    sin_gt = h / jnp.maximum(etap, 1e-6)
    cos_gt = _safe_sqrt(1.0 - _sqr(sin_gt))
    gamma_t = _safe_asin(sin_gt)
    gamma_o = _safe_asin(h)
    t_span = jnp.exp(-sigma_a * (2.0 * cos_gt / jnp.maximum(cos_tt, 1e-6))[..., None])
    return sin_to, cos_to, phi_o, gamma_o, gamma_t, t_span


def _ap(cos_to, eta, h, t_span):
    """Attenuation per lobe: [R, TT, TRT, residual] each (R, 3)
    (hair.rs:63-84)."""
    cos_go = _safe_sqrt(1.0 - _sqr(h))
    f = fresnel_dielectric(cos_to * cos_go, 1.0, eta)[..., None]
    a0 = jnp.broadcast_to(f, t_span.shape)
    a1 = t_span * _sqr(1.0 - f)
    a2 = a1 * t_span * f
    a3 = a2 * t_span * f / jnp.maximum(1.0 - t_span * f, 1e-4)
    return (a0, a1, a2, a3)


def _tilted(p, sin_to, cos_to, sc):
    """Hair-scale tilt of the wo inclination for lobe p (hair.rs:344-360)."""
    (s0, c0), (s1, c1), (s2, c2) = sc
    if p == 0:
        return sin_to * c1 - cos_to * s1, jnp.abs(cos_to * c1 + sin_to * s1)
    if p == 1:
        return sin_to * c0 + cos_to * s0, jnp.abs(cos_to * c0 - sin_to * s0)
    if p == 2:
        return sin_to * c2 + cos_to * s2, jnp.abs(cos_to * c2 - sin_to * s2)
    return sin_to, cos_to


def hair_f(data, wo, wi):
    """BSDF value (R, 3) (hair.rs f() :310-376)."""
    sigma_a, eta, h, v, s, sc = _unpack(data)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, t_span = _geo(eta, h, sigma_a, wo)
    sin_ti = jnp.clip(wi[..., 0], -1.0, 1.0)
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])
    phi = phi_i - phi_o
    ap = _ap(cos_to, eta, h, t_span)
    fsum = jnp.zeros_like(t_span)
    for p in range(PMAX):
        sin_op, cos_op = _tilted(p, sin_to, cos_to, sc)
        m = _mp(cos_ti, cos_op, sin_ti, sin_op, v[p])
        n = _np(phi, float(p), s, gamma_o, gamma_t)
        fsum = fsum + ap[p] * (m * n)[..., None]
    m_last = _mp(cos_ti, cos_to, sin_ti, sin_to, v[PMAX])
    fsum = fsum + ap[PMAX] * (m_last / (2.0 * jnp.pi))[..., None]
    abs_cos = jnp.abs(wi[..., 2])
    return jnp.where((abs_cos > 1e-6)[..., None], fsum / jnp.maximum(abs_cos, 1e-6)[..., None], fsum)


def _ap_pdf(cos_to, eta, h, t_span):
    ap = _ap(cos_to, eta, h, t_span)
    ys = [jnp.maximum(jnp.einsum("...c,c->...", a, _LUM), 0.0) for a in ap]
    total = jnp.maximum(sum(ys), 1e-9)
    return [y / total for y in ys]


def hair_pdf(data, wo, wi):
    """Solid-angle pdf of hair_sample (hair.rs pdf() :478-533; v[p] fix)."""
    sigma_a, eta, h, v, s, sc = _unpack(data)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, t_span = _geo(eta, h, sigma_a, wo)
    sin_ti = jnp.clip(wi[..., 0], -1.0, 1.0)
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])
    phi = phi_i - phi_o
    apf = _ap_pdf(cos_to, eta, h, t_span)
    pdf = jnp.zeros_like(cos_to)
    for p in range(PMAX):
        sin_op, cos_op = _tilted(p, sin_to, cos_to, sc)
        pdf = pdf + _mp(cos_ti, cos_op, sin_ti, sin_op, v[p]) * apf[p] * _np(phi, float(p), s, gamma_o, gamma_t)
    pdf = pdf + _mp(cos_ti, cos_to, sin_ti, sin_to, v[PMAX]) * apf[PMAX] / (2.0 * jnp.pi)
    return pdf


def _demux(u):
    """Split one uniform into two (12/12 mantissa bits; stands in for the
    reference's Morton demux_float :591-601 — f32 carries ~24 random bits
    either way)."""
    x = u * 4096.0
    hi = jnp.floor(x)
    return hi / 4096.0, jnp.clip(x - hi, 0.0, 1.0 - 1e-6)


def hair_sample(data, wo, u1, u2):
    """Sample the hair BSDF (hair.rs sample_f() :378-476).

    Returns {wi, valid}; f and pdf are recomputed by the generic lobe layer
    (bsdf.py bsdf_sample) via hair_f/hair_pdf, which match this sampler."""
    sigma_a, eta, h, v, s, sc = _unpack(data)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, t_span = _geo(eta, h, sigma_a, wo)
    u00, u01 = _demux(u1)
    u10, u11 = _demux(u2)
    apf = _ap_pdf(cos_to, eta, h, t_span)
    # discrete lobe choice by attenuation weight (cdf walk, vectorized)
    c0 = apf[0]
    c1 = c0 + apf[1]
    c2 = c1 + apf[2]
    p_idx = (u00 >= c0).astype(jnp.int32) + (u00 >= c1).astype(jnp.int32) + (u00 >= c2).astype(jnp.int32)
    # per-lobe tilted angles + variance, one-hot combined
    sin_op = jnp.zeros_like(sin_to)
    cos_op = jnp.zeros_like(cos_to)
    vp = jnp.zeros_like(sin_to)
    for p in range(PMAX + 1):
        so, co = _tilted(p, sin_to, cos_to, sc)
        m = p_idx == p
        sin_op = jnp.where(m, so, sin_op)
        cos_op = jnp.where(m, co, cos_op)
        vp = jnp.where(m, v[p], vp)
    # longitudinal sampling (hair.rs:421-428)
    u10 = jnp.maximum(u10, 1e-5)
    cos_theta = 1.0 + vp * jnp.log(jnp.maximum(u10 + (1.0 - u10) * jnp.exp(-2.0 / vp), 1e-30))
    sin_theta = _safe_sqrt(1.0 - _sqr(cos_theta))
    cos_phi_l = jnp.cos(2.0 * jnp.pi * u11)
    sin_ti = -cos_theta * sin_op + sin_theta * cos_phi_l * cos_op
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))
    # azimuthal sampling (hair.rs:431-439)
    dphi_smooth = _phi_p(p_idx.astype(F32), gamma_o, gamma_t) + _sample_trimmed_logistic(u01, s, -jnp.pi, jnp.pi)
    dphi = jnp.where(p_idx < PMAX, dphi_smooth, 2.0 * jnp.pi * u01)
    phi_i = phi_o + dphi
    wi = jnp.stack([sin_ti, cos_ti * jnp.cos(phi_i), cos_ti * jnp.sin(phi_i)], axis=-1)
    return {"wi": wi, "valid": jnp.ones_like(u1, bool)}
