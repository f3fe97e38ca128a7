"""Material evaluation: per-ray material parameter blocks -> BSDF lobe sets.

The reference's Material::compute_scattering_functions implementations
(src/materials/matte.rs, mirror.rs, glass.rs, plastic.rs, metal.rs, uber.rs,
substrate.rs, translucent.rs) become masked writes into the fixed lobe slots
of bsdf.py — one vectorized constructor per material kind present in the
scene (static dispatch list from SceneStatic.mat_kinds_present).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..scene.arrays import (
    MAT_DISNEY,
    MAT_FOURIER,
    MAT_GLASS,
    MAT_HAIR,
    MAT_KDSUBSURFACE,
    MAT_MIX,
    MAT_SUBSURFACE,
    MAT_MATTE,
    MAT_METAL,
    MAT_MIRROR,
    MAT_PLASTIC,
    MAT_SUBSTRATE,
    MAT_TRANSLUCENT,
    MAT_UBER,
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
    P_EXTRA,
    P_EXTRA2,
    P_TRANSMIT,
    P_UROUGH,
    P_VROUGH,
    SceneArrays,
    SceneStatic,
)
from .bsdf import (
    LOBE_CLEARCOAT,
    LOBE_DISNEY_DIFF,
    LOBE_FOURIER,
    LOBE_FRESNEL_BLEND,
    LOBE_HAIR,
    LOBE_FRESNEL_SPEC,
    LOBE_LAMBERT_R,
    LOBE_LAMBERT_T,
    LOBE_MICRO_R,
    LOBE_MICRO_T,
    LOBE_NONE,
    LOBE_OREN_NAYAR,
    LOBE_SPEC_R,
    LOBE_SPEC_T,
    N_SLOTS,
    tr_roughness_to_alpha,
)
from .texture import eval_textures, material_param

F32 = jnp.float32

FR_NONE = 0.0
FR_DIELECTRIC = 1.0
FR_CONDUCTOR = 2.0
FR_SCHLICK = 3.0


def _nonblack(c):
    return jnp.any(c > 0, axis=-1)


class _LobeWriter:
    """Lazy SoA lobe accumulator.

    Perf note: the original formulation updated a materialized
    (R, 8, 14) tensor with `.at[:, slot].set` per put — each update streams
    the full 45 MB block through device memory and XLA does not fuse the
    chains. Instead we keep, per
    slot, 14 lazy (R,) columns updated by cheap `where` selects and stack
    ONCE at finalize; the whole writer then fuses into surrounding code.
    """

    def __init__(self, n_rays):
        self._kind = [None] * N_SLOTS  # lazy (R,) columns; None = all zero
        self._cols = [[None] * 14 for _ in range(N_SLOTS)]
        self.possible = [set() for _ in range(N_SLOTS)]
        self.n = n_rays
        self._mix_scale = None

    def _sel(self, slot, c, mask, value):
        cur = self._cols[slot][c]
        if cur is None:
            cur = jnp.zeros(self.n, F32)
        v = jnp.broadcast_to(jnp.asarray(value, F32), (self.n,))
        self._cols[slot][c] = jnp.where(mask, v, cur)

    def put(self, slot, mask, kind, color, eta=None, k_or_t=None, ax=None, ay=None, fresnel=FR_NONE, ab=None):
        """Masked write of one lobe into `slot`."""
        m = mask
        self.possible[slot].add(int(kind))
        curk = self._kind[slot]
        if curk is None:
            curk = jnp.zeros(self.n, jnp.int32)
        self._kind[slot] = jnp.where(m, kind, curk)
        for c in range(3):
            self._sel(slot, c, m, color[:, c] if jnp.ndim(color) == 2 else color)
        if eta is not None:
            eta = jnp.asarray(eta, F32)
            if jnp.ndim(eta) <= 1:
                self._sel(slot, 3, m, eta)
            else:
                for c in range(3):
                    self._sel(slot, 3 + c, m, eta[:, c])
        if k_or_t is not None:
            for c in range(3):
                self._sel(slot, 6 + c, m, k_or_t[:, c] if jnp.ndim(k_or_t) == 2 else k_or_t)
        if ax is not None:
            self._sel(slot, 9, m, ax)
            self._sel(slot, 10, m, ay)
        self._sel(slot, 11, m, fresnel)
        if ab is not None:
            self._sel(slot, 12, m, ab[0])
            self._sel(slot, 13, m, ab[1])

    def scale_colors(self, mask, scale):
        """Multiply every written lobe's color by `scale` where mask (mix)."""
        for slot in range(N_SLOTS):
            for c in range(3):
                cur = self._cols[slot][c]
                if cur is not None:
                    self._cols[slot][c] = jnp.where(mask, cur * scale[:, c], cur)

    def finalize(self):
        zero = jnp.zeros(self.n, F32)
        zeroi = jnp.zeros(self.n, jnp.int32)
        kind = jnp.stack([k if k is not None else zeroi for k in self._kind], axis=1)
        data = jnp.stack(
            [jnp.stack([c if c is not None else zero for c in cols], axis=1) for cols in self._cols],
            axis=1,
        )
        return kind, data


def make_bsdf(sa: SceneArrays, static: SceneStatic, mat_ids, uv, p, duvdx=None, duvdy=None):
    """Build lobe sets for a wave of shading points.

    mat_ids: (R,) material row ids; uv: (R, 2); p: (R, 3) world hit points;
    duvdx/duvdy: optional texture footprint derivatives (MIPMap filtering).
    Returns the lobes dict for bsdf.py.
    """
    R = mat_ids.shape[0]
    tex_values = eval_textures(sa, static.tex_programs, uv, p, duvdx, duvdy)

    def param(slot):
        return material_param(sa, tex_values, mat_ids, slot)


    kind = sa.mat_kind[mat_ids]

    if MAT_MIX in set(static.mat_kinds_present):
        # stochastic one-sample mixture (mix.rs evaluates both; the
        # single-sample estimator keeps the fixed slot count — unbiased in f)
        from . import rng as _rng

        is_mix = kind == MAT_MIX
        amt = jnp.clip(material_param(sa, tex_values, mat_ids, P_KD), 0.0, 1.0)
        q = jnp.clip(jnp.mean(amt, axis=-1), 0.02, 0.98)
        import jax as _jax

        bx = _jax.lax.bitcast_convert_type(p[:, 0], jnp.uint32)
        by = _jax.lax.bitcast_convert_type(p[:, 1], jnp.uint32)
        bz = _jax.lax.bitcast_convert_type(p[:, 2], jnp.uint32)
        bits = _rng.hash_combine(bx, by, bz, mat_ids.astype(jnp.uint32))
        u_mix = _rng.u32_to_float(bits)
        use1 = u_mix < q
        sub1 = sa.mat_const[:, P_EXTRA, 0][mat_ids].astype(jnp.int32)
        sub2 = sa.mat_const[:, P_EXTRA, 1][mat_ids].astype(jnp.int32)
        mix_scale = jnp.where(use1[:, None], amt / q[:, None], (1.0 - amt) / (1.0 - q)[:, None])
        mat_ids = jnp.where(is_mix, jnp.where(use1, sub1, sub2), mat_ids)
        kind = sa.mat_kind[mat_ids]
    else:
        is_mix = None

    remap_row = sa.mat_remap[mat_ids]
    remap = (remap_row & 1) != 0
    # bit 1 of mat_remap selects the Beckmann microfacet distribution
    # ("distribution" "beckmann", microfacet.rs:150); stored per micro lobe
    # in data slot 12
    beck_f = ((remap_row >> 1) & 1).astype(F32)
    zero_r = jnp.zeros(R, F32)

    kd = jnp.clip(param(P_KD), 0.0, 1.0)
    sigma = param(P_SIGMA)[:, 0]
    kr = jnp.clip(param(P_KR), 0.0, None)
    kt = jnp.clip(param(P_KT), 0.0, None)
    ks = jnp.clip(param(P_KS), 0.0, None)
    eta3 = param(P_ETA)
    eta = jnp.where(eta3[:, 0] > 0, eta3[:, 0], 1.5)
    kcond = param(P_K)
    urough = param(P_UROUGH)[:, 0]
    vrough = param(P_VROUGH)[:, 0]
    opacity = jnp.clip(param(P_OPACITY), 0.0, 1.0)
    refl_c = jnp.clip(param(P_REFLECT), 0.0, None)
    trans_c = jnp.clip(param(P_TRANSMIT), 0.0, None)

    def alpha_of(r):
        a = jnp.where(remap, tr_roughness_to_alpha(r), r)
        return jnp.maximum(a, 1e-3)

    ax = alpha_of(urough)
    ay = alpha_of(vrough)

    w = _LobeWriter(R)
    kinds = set(static.mat_kinds_present) or {MAT_MATTE}

    if MAT_MATTE in kinds:
        m = kind == MAT_MATTE
        has_kd = _nonblack(kd)
        # Oren-Nayar A/B from sigma in degrees (reflection.rs:901)
        sig_rad = jnp.radians(jnp.clip(sigma, 0.0, 90.0))
        s2 = sig_rad * sig_rad
        a_on = 1.0 - s2 / (2.0 * (s2 + 0.33))
        b_on = 0.45 * s2 / (s2 + 0.09)
        use_on = sigma != 0.0
        w.put(0, m & has_kd & ~use_on, LOBE_LAMBERT_R, kd)
        w.put(0, m & has_kd & use_on, LOBE_OREN_NAYAR, kd, ab=(a_on, b_on))

    if MAT_MIRROR in kinds:
        m = kind == MAT_MIRROR
        w.put(4, m & _nonblack(kr), LOBE_SPEC_R, kr, fresnel=FR_NONE)

    if MAT_GLASS in kinds:
        m = kind == MAT_GLASS
        krg = kr
        ktg = kt
        smooth = (urough == 0) & (vrough == 0)
        both = _nonblack(krg) & _nonblack(ktg)
        w.put(4, m & smooth & both, LOBE_FRESNEL_SPEC, krg, eta=eta, k_or_t=ktg)
        w.put(4, m & smooth & ~both & _nonblack(krg), LOBE_SPEC_R, krg, eta=eta, fresnel=FR_DIELECTRIC)
        w.put(5, m & smooth & ~both & _nonblack(ktg), LOBE_SPEC_T, ktg, eta=eta)
        w.put(2, m & ~smooth & _nonblack(krg), LOBE_MICRO_R, krg, eta=eta, ax=ax, ay=ay, fresnel=FR_DIELECTRIC, ab=(beck_f, zero_r))
        w.put(3, m & ~smooth & _nonblack(ktg), LOBE_MICRO_T, ktg, eta=eta, ax=ax, ay=ay, ab=(beck_f, zero_r))

    if MAT_PLASTIC in kinds:
        m = kind == MAT_PLASTIC
        # plastic defaults Kd=0.25 Ks=0.25 rough=0.1 (plastic.rs)
        w.put(0, m & _nonblack(kd), LOBE_LAMBERT_R, kd)
        w.put(2, m & _nonblack(ks), LOBE_MICRO_R, ks, eta=1.5, ax=ax, ay=ay, fresnel=FR_DIELECTRIC, ab=(beck_f, zero_r))

    if MAT_METAL in kinds:
        m = kind == MAT_METAL
        one = jnp.ones((R, 3), F32)
        w.put(2, m, LOBE_MICRO_R, one, eta=eta3, k_or_t=kcond, ax=ax, ay=ay, fresnel=FR_CONDUCTOR, ab=(beck_f, zero_r))

    if MAT_UBER in kinds:
        m = kind == MAT_UBER
        op = opacity
        inv_op = 1.0 - op
        w.put(6, m & _nonblack(inv_op), LOBE_SPEC_T, inv_op, eta=1.0 + 1e-5)
        w.put(0, m & _nonblack(op * kd), LOBE_LAMBERT_R, op * kd)
        w.put(2, m & _nonblack(op * ks), LOBE_MICRO_R, op * ks, eta=eta, ax=ax, ay=ay, fresnel=FR_DIELECTRIC, ab=(beck_f, zero_r))
        w.put(4, m & _nonblack(op * kr), LOBE_SPEC_R, op * kr, eta=eta, fresnel=FR_DIELECTRIC)
        w.put(5, m & _nonblack(op * kt), LOBE_SPEC_T, op * kt, eta=eta)

    if MAT_SUBSTRATE in kinds:
        m = kind == MAT_SUBSTRATE
        w.put(2, m & (_nonblack(kd) | _nonblack(ks)), LOBE_FRESNEL_BLEND, kd, k_or_t=ks, ax=ax, ay=ay)

    if MAT_TRANSLUCENT in kinds:
        m = kind == MAT_TRANSLUCENT
        w.put(0, m & _nonblack(refl_c * kd), LOBE_LAMBERT_R, refl_c * kd)
        w.put(1, m & _nonblack(trans_c * kd), LOBE_LAMBERT_T, trans_c * kd)
        w.put(2, m & _nonblack(refl_c * ks), LOBE_MICRO_R, refl_c * ks, eta=1.5, ax=ax, ay=ay, fresnel=FR_DIELECTRIC, ab=(beck_f, zero_r))
        w.put(3, m & _nonblack(trans_c * ks), LOBE_MICRO_T, trans_c * ks, eta=1.5, ax=ax, ay=ay, ab=(beck_f, zero_r))

    if MAT_DISNEY in kinds:
        m = kind == MAT_DISNEY
        ex = sa.mat_const[:, P_EXTRA][mat_ids]
        ex2 = sa.mat_const[:, P_EXTRA2][mat_ids]
        metallic = ex[:, 0]
        clearcoat = ex[:, 1]
        gloss = ex[:, 2]
        sheen_amt = ex2[:, 0]
        spectrans = ex2[:, 1]
        spec_tint = ex2[:, 2]
        color = kd
        lum = jnp.maximum(jnp.sum(color * jnp.asarray([0.2126, 0.7152, 0.0722]), axis=-1), 1e-6)
        tint = color / lum[:, None]
        # diffuse (Burley) + sheen, weighted by (1-metallic)(1-spectrans)
        dweight = (1.0 - metallic) * (1.0 - spectrans)
        diff_c = color * dweight[:, None]
        sheen_c = sheen_amt[:, None] * dweight[:, None] * tint
        w.put(0, m & (_nonblack(diff_c) | _nonblack(sheen_c)), LOBE_DISNEY_DIFF, diff_c, k_or_t=sheen_c)
        w._sel(0, 12, m, urough)
        # specular GGX with Schlick F0 = lerp(0.08*tint-ish, color, metallic)
        f0 = (1.0 - metallic)[:, None] * 0.08 * ((1.0 - spec_tint)[:, None] + spec_tint[:, None] * tint) + metallic[:, None] * color
        one = jnp.ones((R, 3), F32)
        w.put(2, m, LOBE_MICRO_R, one, eta=f0, ax=ax, ay=ay, fresnel=FR_SCHLICK)
        # clearcoat: alpha from gloss (lerp .1 -> .001)
        cc_alpha = 0.1 * (1.0 - gloss) + 0.001 * gloss
        w.put(6, m & (clearcoat > 0), LOBE_CLEARCOAT, 0.25 * clearcoat[:, None] * one, ax=cc_alpha, ay=cc_alpha)
        # specular transmission
        st_c = jnp.sqrt(jnp.clip(color, 0.0, 1.0)) * spectrans[:, None]
        w.put(3, m & _nonblack(st_c), LOBE_MICRO_T, st_c, eta=eta, ax=ax, ay=ay)

    if MAT_SUBSURFACE in kinds or MAT_KDSUBSURFACE in kinds:
        # interface = Fresnel reflection + DIFFUSE transmission: the diffuse
        # entry/exit stands in for the reference BSSRDF's Sw term
        # (bssrdf.rs sw(): (1-Fr)/(c*pi)) so NEE works at the boundary;
        # interior transport is the implicit medium's random walk
        m = (kind == MAT_SUBSURFACE) | (kind == MAT_KDSUBSURFACE)
        smooth = (urough == 0) & (vrough == 0)
        f0 = ((eta - 1.0) / (eta + 1.0)) ** 2
        trans_w = jnp.clip(kt * (1.0 - f0)[:, None], 0.0, 1.0)
        w.put(4, m & smooth, LOBE_SPEC_R, kr, eta=eta, fresnel=FR_DIELECTRIC)
        w.put(2, m & ~smooth, LOBE_MICRO_R, kr, eta=eta, ax=ax, ay=ay, fresnel=FR_DIELECTRIC)
        w.put(1, m, LOBE_LAMBERT_T, trans_w)

    if MAT_FOURIER in kinds and static.has_fourier:
        # tabulated measured BSDF (materials/fourier.rs; reflection.rs
        # FourierBSDF): table id rides in data[12], tables in lobes["fourier"]
        m = kind == MAT_FOURIER
        ex = sa.mat_const[:, P_EXTRA][mat_ids]
        w.put(5, m, LOBE_FOURIER, jnp.ones((R, 3), F32), ab=(ex[:, 0], jnp.zeros(R, F32)))

    if MAT_HAIR in kinds:
        # Marschner fiber BSDF (materials/hair.rs; device/hair.py). P_KD
        # carries sigma_a directly (mode 0) or a reflectance color that is
        # inverted here per-pixel with beta_n (mode 1, textured color);
        # h = -1 + 2*v across the tessellated ribbon width (hair.rs:188)
        m = kind == MAT_HAIR
        ex = sa.mat_const[:, P_EXTRA][mat_ids]
        alpha_deg = ex[:, 0]
        kd_raw = jnp.clip(param(P_KD), 0.0, None)  # sigma_a is unbounded above
        bn = jnp.clip(vrough, 1e-3, 1.0)
        denom = 5.969 - 0.215 * bn + 2.532 * bn ** 2 - 10.73 * bn ** 3 + 5.574 * bn ** 4 + 0.245 * bn ** 5
        sig_conv = (jnp.log(jnp.clip(kd_raw, 1e-4, 1.0)) / denom[:, None]) ** 2
        sig = jnp.where((ex[:, 1] > 0.5)[:, None], sig_conv, kd_raw)
        h = -1.0 + 2.0 * uv[:, 1]
        w.put(0, m, LOBE_HAIR, sig, eta=eta, ax=jnp.clip(urough, 0.0, 1.0), ay=bn, ab=(alpha_deg, h))

    if is_mix is not None:
        # apply the mixture color scale to every written lobe
        w.scale_colors(is_mix, mix_scale)

    kind_arr, data_arr = w.finalize()
    out = {"kind": kind_arr, "data": data_arr, "possible": tuple(frozenset(p) for p in w.possible)}
    if getattr(static, "has_beckmann", False):
        out["has_beckmann"] = True
    if static.has_fourier:
        out["fourier"] = sa.fourier
    return out
