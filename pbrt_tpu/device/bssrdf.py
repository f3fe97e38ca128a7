"""Device-side tabulated BSSRDF: profile eval, importance sampling, pdfs.

Array-program redesign of the reference's TabulatedBSSRDF
(src/core/bssrdf.rs:271-545). The reference interpolates a 2D
(albedo x optical-radius) Catmull-Rom spline per evaluation; here the
ALBEDO dimension is folded at scene-compile time (each material's
single-scatter albedo rho is a constant), so the device only ever touches
per-material 64-entry radial rows:

    sss_prof    (M, 3, 64)  spline-collapsed profile row per channel
    sss_cdf     (M, 3, 64)  its running integral (radial CDF)
    sss_rhoeff  (M, 3)      cdf[..., -1] (effective albedo)
    sss_sigma_t (M, 3)      extinction per channel
    radius_samples (64,)    shared optical-radius knots

All lookups into the 64-knot axis are masked compares + weighted sums
(elementwise, no gathers). Sampling inverts the radial CDF with a bisection /
Newton hybrid on the containing spline segment, matching the reference's
sample_catmull_rom_2d (interpolation.rs) so pdf_sr is exact for the
sampling distribution.
"""
from __future__ import annotations

import jax.numpy as jnp

F32 = jnp.float32
N_RAD = 64


def fresnel_moment1_dev(eta):
    e = jnp.asarray(eta, F32)
    lo = 0.45966 - 1.73965 * e + 3.37668 * e**2 - 3.904945 * e**3 + 2.49277 * e**4 - 0.68441 * e**5
    hi = -4.61686 + 11.1136 * e - 10.4646 * e**2 + 5.11455 * e**3 - 1.27198 * e**4 + 0.12746 * e**5
    return jnp.where(e < 1.0, lo, hi)


def _fr_dielectric(cos_i, eta):
    cos_i = jnp.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = jnp.where(entering, 1.0, eta)
    et = jnp.where(entering, eta, 1.0)
    ci = jnp.abs(cos_i)
    sin_t = ei / et * jnp.sqrt(jnp.maximum(1.0 - ci * ci, 0.0))
    tir = sin_t >= 1.0
    ct = jnp.sqrt(jnp.maximum(1.0 - sin_t * sin_t, 0.0))
    r_par = (et * ci - ei * ct) / jnp.maximum(et * ci + ei * ct, 1e-12)
    r_perp = (ei * ci - et * ct) / jnp.maximum(ei * ci + et * ct, 1e-12)
    return jnp.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))


def sw_factor(eta, cos_w):
    """Directional term Sw (bssrdf.rs:602-607): (1 - Fr(cos)) / (c pi)."""
    c = 1.0 - 2.0 * fresnel_moment1_dev(1.0 / eta)
    return (1.0 - _fr_dielectric(cos_w, eta)) / jnp.maximum(c * jnp.pi, 1e-6)


# ---------------------------------------------------------------------------
# Radial spline machinery over the shared 64 knots (gather-free)
# ---------------------------------------------------------------------------


def _segment_state(radius, x):
    """Containing segment of x in the knot vector: returns (i, x0, x1, masks
    has_prev/has_next, inside). radius: (64,); x: (R,)."""
    n = radius.shape[0]
    inside = (x >= radius[0]) & (x <= radius[-1])
    # index of the last knot <= x (compare+sum, no searchsorted gather)
    i = jnp.sum((radius[None, :] <= x[:, None]).astype(jnp.int32), axis=1) - 1
    i = jnp.clip(i, 0, n - 2)
    return i, inside


def _knot(radius, i):
    """radius[i] per ray without a gather: one-hot over 64 lanes."""
    n = radius.shape[0]
    oh = (jnp.arange(n, dtype=jnp.int32)[None, :] == i[:, None]).astype(F32)
    return jnp.sum(oh * radius[None, :], axis=1)


def _row_at(rows, i):
    """rows: (R, 64); select column i per ray (one-hot)."""
    n = rows.shape[1]
    oh = (jnp.arange(n, dtype=jnp.int32)[None, :] == i[:, None]).astype(F32)
    return jnp.sum(oh * rows, axis=1)


def _spline_coeffs(radius, rows, i):
    """Spline data of segment i for per-ray value rows (R, 64):
    returns x0, width, f0, f1, d0, d1 (all (R,))."""
    n = radius.shape[0]
    x0 = _knot(radius, i)
    x1 = _knot(radius, i + 1)
    f0 = _row_at(rows, i)
    f1 = _row_at(rows, i + 1)
    width = x1 - x0
    has_prev = i > 0
    has_next = i + 2 < n
    xm1 = _knot(radius, jnp.maximum(i - 1, 0))
    xp2 = _knot(radius, jnp.minimum(i + 2, n - 1))
    fm1 = _row_at(rows, jnp.maximum(i - 1, 0))
    fp2 = _row_at(rows, jnp.minimum(i + 2, n - 1))
    d0 = jnp.where(has_prev, width * (f1 - fm1) / jnp.maximum(x1 - xm1, 1e-30), f1 - f0)
    d1 = jnp.where(has_next, width * (fp2 - f0) / jnp.maximum(xp2 - x0, 1e-30), f1 - f0)
    return x0, width, f0, f1, d0, d1


def _spline_eval(f0, f1, d0, d1, t):
    t2 = t * t
    t3 = t2 * t
    return ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
            + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)


def eval_profile_row(radius, rows, r_optical):
    """Catmull-Rom interpolation of a per-ray radial row at r_optical.

    radius: (64,); rows: (R, 64); r_optical: (R,). Zero outside the knots."""
    i, inside = _segment_state(radius, r_optical)
    x0, width, f0, f1, d0, d1 = _spline_coeffs(radius, rows, i)
    t = (r_optical - x0) / jnp.maximum(width, 1e-30)
    val = _spline_eval(f0, f1, d0, d1, t)
    return jnp.where(inside, val, 0.0)


def sample_radial_cdf(radius, prof_rows, cdf_rows, rho_eff, u):
    """Invert the radial CDF: find r_optical with CDF(r) = u * rho_eff.

    radius: (64,); prof_rows/cdf_rows: (R, 64); rho_eff: (R,); u: (R,).
    Matches interpolation.rs sample_catmull_rom_2d: locate the CDF segment,
    then solve the quartic CDF polynomial (integral of the cubic profile
    spline) by bisection+Newton. Returns r_optical (R,)."""
    target = u * rho_eff
    n = radius.shape[0]
    i = jnp.sum((cdf_rows <= target[:, None]).astype(jnp.int32), axis=1) - 1
    i = jnp.clip(i, 0, n - 2)
    x0, width, f0, f1, d0, d1 = _spline_coeffs(radius, prof_rows, i)
    c0 = _row_at(cdf_rows, i)
    ybar = (target - c0) / jnp.maximum(width, 1e-30)

    def cdf_hat(t):
        # integral of the cubic from 0..t (divided by width)
        t2 = t * t
        t3 = t2 * t
        t4 = t2 * t2
        return (f0 * (t - t3 + 0.5 * t4)  # integral of 2t^3-3t^2+1
                + f1 * (t3 - 0.5 * t4)    # integral of -2t^3+3t^2
                + d0 * (0.25 * t4 / 1.0 - (2.0 / 3.0) * t3 + 0.5 * t2)
                + d1 * (0.25 * t4 - t3 / 3.0))

    def pdf_hat(t):
        return _spline_eval(f0, f1, d0, d1, t)

    a = jnp.zeros_like(ybar)
    b = jnp.ones_like(ybar)
    t = jnp.full_like(ybar, 0.5)
    for _ in range(20):
        fh = cdf_hat(t) - ybar
        too_high = fh > 0
        a = jnp.where(too_high, a, t)
        b = jnp.where(too_high, t, b)
        df = pdf_hat(t)
        tn = t - fh / jnp.where(jnp.abs(df) > 1e-12, df, 1.0)
        ok = (tn > a) & (tn < b) & (jnp.abs(df) > 1e-12)
        t = jnp.where(ok, tn, 0.5 * (a + b))
    return x0 + t * width


def pdf_radial(radius, prof_rows, rho_eff, sigma_t_ch, r_world):
    """pdf of sample_radial in WORLD radius for one channel
    (bssrdf.rs pdf_sr): profile(r_opt)/(2 pi r_opt) * sigma_t^2 / rho_eff."""
    r_opt = r_world * sigma_t_ch
    sr = eval_profile_row(radius, prof_rows, r_opt)
    sr = jnp.where(r_opt > 1e-9, sr / jnp.maximum(2.0 * jnp.pi * r_opt, 1e-12), sr)
    return jnp.maximum(sr * sigma_t_ch * sigma_t_ch / jnp.maximum(rho_eff, 1e-9), 0.0)


def sr_eval(radius, prof_rows3, sigma_t3, r_world):
    """Spatial term Sr(r) per channel (bssrdf.rs sr()): prof_rows3
    (R, 3, 64); sigma_t3 (R, 3); r_world (R,). Returns (R, 3)."""
    outs = []
    for ch in range(3):
        r_opt = r_world * sigma_t3[:, ch]
        sr = eval_profile_row(radius, prof_rows3[:, ch], r_opt)
        sr = jnp.where(r_opt > 1e-9, sr / jnp.maximum(2.0 * jnp.pi * r_opt, 1e-12), sr)
        outs.append(jnp.maximum(sr, 0.0) * sigma_t3[:, ch] * sigma_t3[:, ch])
    return jnp.stack(outs, axis=-1)


def pdf_sp(radius, prof_rows3, rho_eff3, sigma_t3, d_world, n_exit,
           ss, ts, ns):
    """Combined pdf over 3 projection axes x 3 channels
    (bssrdf.rs pdf_sp): d_world = po - pi; n_exit = exit-surface normal;
    (ss, ts, ns) = entry frame. All (R, 3) / (R,). Returns (R,)."""
    dl = jnp.stack([jnp.sum(ss * d_world, -1), jnp.sum(ts * d_world, -1),
                    jnp.sum(ns * d_world, -1)], axis=-1)
    nl = jnp.stack([jnp.sum(ss * n_exit, -1), jnp.sum(ts * n_exit, -1),
                    jnp.sum(ns * n_exit, -1)], axis=-1)
    r_proj = jnp.stack([
        jnp.sqrt(dl[:, 1] ** 2 + dl[:, 2] ** 2),
        jnp.sqrt(dl[:, 2] ** 2 + dl[:, 0] ** 2),
        jnp.sqrt(dl[:, 0] ** 2 + dl[:, 1] ** 2),
    ], axis=-1)
    axis_prob = (0.25, 0.25, 0.5)
    ch_prob = 1.0 / 3.0
    pdf = jnp.zeros(d_world.shape[0], F32)
    for axis in range(3):
        for ch in range(3):
            p = pdf_radial(radius, prof_rows3[:, ch], rho_eff3[:, ch],
                           sigma_t3[:, ch], r_proj[:, axis])
            pdf = pdf + p * jnp.abs(nl[:, axis]) * ch_prob * axis_prob[axis]
    return pdf
