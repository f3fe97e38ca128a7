"""Stochastic progressive photon mapping (SPPM).

Array-program redesign of src/integrators/sppm.rs: the reference's three
parallel passes per iteration map to three batched device programs —

- camera pass (:124-256): the wavefront machinery traced to the first
  diffuse vertex; per-pixel visible points (position, throughput, full lobe
  set) in SoA arrays; direct lighting accumulated with NEE+MIS
- grid build (:259-335): instead of lock-free atomic hash chains, visible
  points are keyed into a fixed-size hashed voxel grid and SORTED by cell —
  photon lookup walks the sorted run via searchsorted (sort+segment
  replaces atomics, SURVEY.md §2.12 mapping)
- photon pass (:341-464): wavefront from sample_le over the light power
  distribution; deposits use bounded per-cell scans + segment_sum instead
  of AtomicFloat phi
- radius/tau update (:470-502): pure elementwise (gamma = 2/3)

Progressive image: L = Ld/iters + tau/(Np * pi * r^2)  (:504-528).
"""
from __future__ import annotations

import logging
import math
import time

import numpy as np

import jax
import jax.numpy as jnp

from ..scene.arrays import SceneArrays, SceneStatic
from . import rng
from .bsdf import N_SLOTS, _is_specular, bsdf_f, bsdf_sample, num_lobes
from .camera import generate_rays
from .integrator import _light_select_pdf, _offset_ray, _to_local, _to_world, _dot, power_heuristic
from .intersect import intersect, intersect_p
from .lights import area_light_emission, compute_power, env_le, env_pdf_li, pdf_li_area_hit, sample_le, sample_li
from .materials import make_bsdf
from .sampler import sample_1d, sample_2d
from .shading import apply_bump, surface_interaction

log = logging.getLogger(__name__)
F32 = jnp.float32

KMAX = 64  # visible points examined per photon deposit chunk
N_CHUNKS = 16  # chunks scanned per cell run (cap = KMAX * N_CHUNKS = 1024).
# Chunks beyond the longest outstanding run are lax.cond-skipped, so the
# cap costs runtime only where runs are genuinely long — exactly where the
# 384-entry cap was measured dropping 260-570k photon-VP pairs per
# caustic-glass iteration (systematic caustic-energy loss, round-3 log)
GAMMA = 2.0 / 3.0


# sorted-run cell key: EXACT packed voxel coordinates (10 bits/axis,
# power-of-2 wraparound), not a hash — hashing merged unrelated voxels into
# one sorted run, overflowing the KMAX scan cap and dropping energy.
# Wraparound aliases only voxels exactly 1024 cells apart; the distance
# filter rejects any such far pair.
KEY_SENTINEL = jnp.uint32(1 << 30)


def _cell_key(ix, iy, iz):
    return (
        (ix.astype(jnp.uint32) & jnp.uint32(1023))
        | ((iy.astype(jnp.uint32) & jnp.uint32(1023)) << 10)
        | ((iz.astype(jnp.uint32) & jnp.uint32(1023)) << 20)
    )


def _camera_pass(sa, static, icfg, scfg, cam, seed, px, py, pids, it):
    """Trace camera rays to the first diffuse vertex.

    Returns (ld_add (R,3), vp dict).
    """
    R = px.shape[0]
    kind_s = scfg["kind"]
    spp = scfg["spp"]
    max_depth = icfg["max_depth"]
    sel_pdf = _light_select_pdf(static)

    u1, u2 = sample_2d(kind_s, seed, pids, it, 0, spp)
    pxf = px.astype(F32) + u1
    pyf = py.astype(F32) + u2
    ul1, ul2 = sample_2d(kind_s, seed, pids, it, 1, spp)
    o, d = generate_rays(cam, pxf, pyf, ul1, ul2)

    ld = jnp.zeros((R, 3), F32)
    beta = jnp.ones((R, 3), F32)
    alive = jnp.ones(R, bool)
    prev_spec = jnp.ones(R, bool)
    prev_pdf = jnp.ones(R, F32)
    prev_p = o
    # lanes that recorded their visible point but still owe the
    # BSDF-sampled half of the direct-light MIS pair: without it, every
    # non-delta light (env map, area) is underestimated by the missing
    # MIS share — measured 1.62x low on constant-env scenes, the
    # caustic-glass brightness deficit (integrator.rs estimate_direct's
    # second term; the path integrators get it from the next bounce's
    # deferred pickup, but SPPM camera paths STOP at the diffuse vertex)
    mis_tail = jnp.zeros(R, bool)

    vp_valid = jnp.zeros(R, bool)
    vp_p = jnp.zeros((R, 3), F32)
    vp_beta = jnp.zeros((R, 3), F32)
    vp_wo = jnp.zeros((R, 3), F32)
    vp_kind = jnp.zeros((R, N_SLOTS), jnp.int32)
    vp_data = jnp.zeros((R, N_SLOTS, 14), F32)
    vp_ns = jnp.zeros((R, 3), F32)
    vp_ss = jnp.zeros((R, 3), F32)
    vp_ts = jnp.zeros((R, 3), F32)
    vp_ng = jnp.zeros((R, 3), F32)

    for b in range(max_depth + 1):
        dim = 2 + b * 6
        hit = intersect(sa, static, o, d, jnp.full(R, jnp.inf, F32))
        si = surface_interaction(sa, hit, o, d)
        si = apply_bump(sa, static, si)
        valid = si["valid"]

        if static.has_infinite:
            esc = (alive | mis_tail) & ~valid
            le = env_le(sa, static, d)
            p_l = env_pdf_li(sa, static, d) * sel_pdf
            w = jnp.where(prev_spec, 1.0, power_heuristic(1.0, prev_pdf, 1.0, p_l))
            ld = ld + jnp.where(esc[:, None], beta * le * w[:, None], 0.0)
        if static.has_area_lights:
            lid = si["light"]
            emitting = (alive | mis_tail) & valid & (lid >= 0)
            le = area_light_emission(sa, lid, si["ng"], si["wo"])
            area = sa.prim_area[jnp.maximum(si["prim"], 0)]
            p_l = pdf_li_area_hit(sa, prev_p, si["p"], si["ng"], lid, area) * sel_pdf
            w = jnp.where(prev_spec, 1.0, power_heuristic(1.0, prev_pdf, 1.0, p_l))
            ld = ld + jnp.where(emitting[:, None], beta * le * w[:, None], 0.0)
        alive = alive & valid
        mis_tail = jnp.zeros(R, bool)  # the owed pickup is consumed
        if b == max_depth:
            break

        lobes = make_bsdf(sa, static, si["mat"], si["uv"], si["p"])
        has_any = num_lobes(lobes) > 0
        alive_sh = alive & has_any

        # NEE (sppm.rs camera pass accumulates direct light at the vertex)
        if static.n_lights > 0:
            u_sel = sample_1d(kind_s, seed, pids, it, dim, spp)
            ua, ub = sample_2d(kind_s, seed, pids, it, dim + 1, spp)
            lid_s = jnp.minimum((u_sel * static.n_lights).astype(jnp.int32), static.n_lights - 1)
            ls = sample_li(sa, static, lid_s, si["p"], ua, ub)
            wo_l = _to_local(si, si["wo"])
            wi_l = _to_local(si, ls["wi"])
            refl = _dot(ls["wi"], si["ng"]) * _dot(si["wo"], si["ng"]) > 0
            f_v = bsdf_f(lobes, wo_l, wi_l, refl) * jnp.abs(_dot(ls["wi"], si["ns"]))[:, None]
            from .bsdf import bsdf_pdf

            p_b = bsdf_pdf(lobes, wo_l, wi_l)
            p_l = ls["pdf"] * sel_pdf
            o_sh = _offset_ray(si["p"], si["ng"], ls["wi"], si.get("p_err"))
            occ = intersect_p(sa, static, o_sh, ls["wi"], ls["dist"] * 0.998)
            ok = alive_sh & (p_l > 0) & ~occ
            w_l = jnp.where(ls["delta"], 1.0, power_heuristic(1.0, p_l, 1.0, p_b))
            ld = ld + jnp.where(ok[:, None], beta * f_v * ls["li"] * (w_l / jnp.maximum(p_l, 1e-30))[:, None], 0.0)

        # stop at diffuse (or any non-specular-only vertex at the last bounce)
        any_nonspec = jnp.sum((lobes["kind"] != 0) & ~_is_specular(lobes["kind"]), axis=1) > 0
        record = alive_sh & any_nonspec & ~vp_valid
        vp_valid = vp_valid | record
        vp_p = jnp.where(record[:, None], si["p"], vp_p)
        vp_beta = jnp.where(record[:, None], beta, vp_beta)
        vp_wo = jnp.where(record[:, None], si["wo"], vp_wo)
        vp_kind = jnp.where(record[:, None], lobes["kind"], vp_kind)
        vp_data = jnp.where(record[:, None, None], lobes["data"], vp_data)
        vp_ns = jnp.where(record[:, None], si["ns"], vp_ns)
        vp_ss = jnp.where(record[:, None], si["ss"], vp_ss)
        vp_ts = jnp.where(record[:, None], si["ts"], vp_ts)
        vp_ng = jnp.where(record[:, None], si["ng"], vp_ng)
        alive = alive_sh & ~record  # specular-only vertices continue

        u_lo = sample_1d(kind_s, seed, pids, it, dim + 2, spp)
        ua, ub = sample_2d(kind_s, seed, pids, it, dim + 3, spp)
        wo_l = _to_local(si, si["wo"])
        bs = bsdf_sample(lobes, wo_l, u_lo, ua, ub)
        wi_w = _to_world(si, bs["wi"])
        thru = bs["f"] * (jnp.abs(_dot(wi_w, si["ns"])) / jnp.maximum(bs["pdf"], 1e-30))[:, None]
        ok_bs = bs["valid"] & jnp.any(thru > 0, axis=-1)
        # recorded lanes continue ONE segment for the owed MIS pickup
        mis_tail = record & ok_bs
        if b == max_depth - 1:
            alive = jnp.zeros(R, bool)  # depth limit: tails only
        else:
            alive = alive & ok_bs
        cont = alive | mis_tail
        beta = jnp.where(cont[:, None], beta * thru, beta)
        prev_spec = bs["specular"]
        prev_pdf = jnp.maximum(bs["pdf"], 1e-30)
        prev_p = si["p"]
        o = jnp.where(cont[:, None], _offset_ray(si["p"], si["ng"], wi_w, si.get("p_err")), o)
        d = jnp.where(cont[:, None], wi_w, d)

    vp = {
        "valid": vp_valid, "p": vp_p, "beta": vp_beta, "wo": vp_wo,
        "kind": vp_kind, "data": vp_data, "ns": vp_ns, "ss": vp_ss, "ts": vp_ts, "ng": vp_ng,
    }
    return ld, vp


def _build_grid(vp, radius, grid_min, inv_cell, n_cells):
    """Sort visible points by exact voxel cell key.

    Each VP registers the up-to-8 cells its radius-ball overlaps.
    Returns (sorted_cells (8R,), sorted_vp (8R,)).
    """
    R = radius.shape[0]
    lo = (vp["p"] - radius[:, None] - grid_min) * inv_cell
    hi = (vp["p"] + radius[:, None] - grid_min) * inv_cell
    lo_i = jnp.floor(lo).astype(jnp.int32)
    hi_i = jnp.floor(hi).astype(jnp.int32)
    cells = []
    vps = []
    vp_idx = jnp.arange(R, dtype=jnp.int32)
    for cz in range(2):
        for cy in range(2):
            for cx in range(2):
                ix = jnp.where(cx == 0, lo_i[:, 0], hi_i[:, 0])
                iy = jnp.where(cy == 0, lo_i[:, 1], hi_i[:, 1])
                iz = jnp.where(cz == 0, lo_i[:, 2], hi_i[:, 2])
                c = _cell_key(ix, iy, iz)
                # dedupe: only the first occurrence of a cell registers
                dup = jnp.zeros(R, bool)
                for pz in range(cz + 1):
                    for py_ in range(2 if pz < cz else cy + 1):
                        for px_ in range(2 if (pz < cz or py_ < cy) else cx):
                            jx = jnp.where(px_ == 0, lo_i[:, 0], hi_i[:, 0])
                            jy = jnp.where(py_ == 0, lo_i[:, 1], hi_i[:, 1])
                            jz = jnp.where(pz == 0, lo_i[:, 2], hi_i[:, 2])
                            dup = dup | (_cell_key(jx, jy, jz) == c)
                c = jnp.where(vp["valid"] & ~dup, c, KEY_SENTINEL)
                cells.append(c)
                vps.append(vp_idx)
    cells = jnp.concatenate(cells)
    vps = jnp.concatenate(vps)
    order = jnp.argsort(cells)
    return cells[order], vps[order]


def _photon_pass(sa, static, icfg, seed, it, n_photons, power_cdf, vp, radius,
                 sorted_cells, sorted_vp, grid_min, inv_cell, n_cells, vp_possible=None,
                 pid0=0):
    """Trace photons and deposit phi/m on visible points.

    pid0: photon-id base — lets the driver split one iteration's photon
    budget into bounded-memory slices with disjoint sample streams."""
    R = radius.shape[0]
    P = n_photons
    max_depth = icfg["max_depth"]
    pid = jnp.asarray(pid0, jnp.uint32) + jnp.arange(P, dtype=jnp.uint32)
    phseed = jnp.asarray(seed, jnp.uint32) ^ jnp.uint32(0xC0FFEE)

    def ph_u1(dim):
        return rng.uniform_1d(phseed, pid, it, dim)

    # light selection by power (halton-indexed in the reference :349)
    u_l = ph_u1(0)
    lid = jnp.clip(jnp.searchsorted(power_cdf, u_l, side="right").astype(jnp.int32), 0, static.n_lights - 1)
    sel_pdf_arr = power_cdf[lid] - jnp.where(lid > 0, power_cdf[lid - 1], 0.0)
    em = sample_le(sa, static, lid, ph_u1(1), ph_u1(2), ph_u1(3), ph_u1(4))
    beta = em["le_over_pdf"] / jnp.maximum(sel_pdf_arr, 1e-12)[:, None]
    o = em["o"]
    d = em["d"]
    alive = jnp.any(beta > 0, axis=-1)

    phi = jnp.zeros((R, 3), F32)
    m_cnt = jnp.zeros(R, F32)
    overflow = jnp.zeros((), jnp.int32)  # VP slots dropped by the KMAX cap
    r2 = radius * radius

    for b in range(max_depth):
        dim = 5 + b * 4
        hit = intersect(sa, static, o, d, jnp.full(P, jnp.inf, F32))
        si = surface_interaction(sa, hit, o, d)
        si = apply_bump(sa, static, si)
        alive = alive & si["valid"]

        if b > 0:
            # deposit at this vertex (sppm.rs: photons skip the first hit)
            pg = (si["p"] - grid_min) * inv_cell
            c = _cell_key(jnp.floor(pg[:, 0]).astype(jnp.int32), jnp.floor(pg[:, 1]).astype(jnp.int32), jnp.floor(pg[:, 2]).astype(jnp.int32))
            lo_k = jnp.searchsorted(sorted_cells, c, side="left")
            hi_k = jnp.searchsorted(sorted_cells, c, side="right")
            overflow = overflow + jnp.sum(
                jnp.where(alive, jnp.maximum(hi_k - lo_k - KMAX * N_CHUNKS, 0), 0)
            )
            wi_ph = -d

            def _deposit_chunk(c_idx, carry):
                """Scan entries [c_idx*KMAX, (c_idx+1)*KMAX) of every
                photon's cell run. Dense floor regions hold ~hundreds of
                VPs per cell (each floor point is covered by ~60 VP radius
                balls at caustic-glass settings), so a single KMAX window
                drops most of the caustic energy; chunks beyond the longest
                outstanding run are skipped via lax.cond."""
                phi_c, m_c = carry
                base = c_idx * KMAX

                def _one_k(_, k):
                    # traced ONCE (lax.scan): an unrolled python loop here
                    # costs ~0.5s of TRACING per k (full bsdf_f graph copy)
                    # x KMAX x N_CHUNKS — measured 192s for the whole pass
                    slot = jnp.clip(lo_k + base + k, 0, sorted_vp.shape[0] - 1)
                    in_run = alive & (lo_k + base + k < hi_k)
                    v = sorted_vp[slot]
                    dist2 = jnp.sum((vp["p"][v] - si["p"]) ** 2, axis=-1)
                    close = in_run & vp["valid"][v] & (dist2 <= r2[v])
                    # f at the VP: f(wo_vp, wi_photon = -d)
                    vlob = {"kind": vp["kind"][v], "data": vp["data"][v], "possible": vp_possible}
                    svp = {"ss": vp["ss"][v], "ts": vp["ts"][v], "ns": vp["ns"][v]}
                    wo_l = _to_local(svp, vp["wo"][v])
                    wi_l = _to_local(svp, wi_ph)
                    refl = _dot(wi_ph, vp["ng"][v]) * _dot(vp["wo"][v], vp["ng"][v]) > 0
                    f_v = bsdf_f(vlob, wo_l, wi_l, refl)
                    return None, (jnp.where(close, v, R),
                                  jnp.where(close[:, None], f_v * beta, 0.0),
                                  close)

                _, (idx_k, phi_k, m_k) = jax.lax.scan(
                    _one_k, None, jnp.arange(KMAX, dtype=jnp.int32))
                idx = idx_k.reshape(-1)
                phv = phi_k.reshape(-1, 3)
                phv = jnp.where(jnp.isfinite(phv), phv, 0.0)
                mv = m_k.reshape(-1)
                # per-channel 1D segment sums: an (N, 3) scatter pads each
                # row to the 128-lane tile in HLO temps (~42x memory)
                phi_c = phi_c + jnp.stack(
                    [jax.ops.segment_sum(phv[:, ch], idx, num_segments=R + 1)[:R] for ch in range(3)],
                    axis=-1,
                )
                m_c = m_c + jax.ops.segment_sum(mv.astype(F32), idx, num_segments=R + 1)[:R]
                return phi_c, m_c

            max_run = jnp.max(jnp.where(alive, hi_k - lo_k, 0))
            acc = (phi, m_cnt)
            for c_idx in range(N_CHUNKS):
                acc = jax.lax.cond(
                    max_run > c_idx * KMAX,
                    lambda a, ci=c_idx: _deposit_chunk(ci, a),
                    lambda a: a,
                    acc,
                )
            phi, m_cnt = acc

        if b == max_depth - 1:
            break
        # photon continuation: full BSDF sample + RR (sppm.rs :430-460)
        lobes = make_bsdf(sa, static, si["mat"], si["uv"], si["p"])
        alive = alive & (num_lobes(lobes) > 0)
        wo_l = _to_local(si, si["wo"])
        # photon scattering runs in importance (adjoint) mode: no eta^2
        # radiance compression on transmission (sppm.rs:431
        # TransportMode::Importance). The reference applies NO shading-normal
        # correction here (sppm.rs:455) — that factor is BDPT-only — so
        # neither do we.
        bs = bsdf_sample(lobes, wo_l, ph_u1(dim), ph_u1(dim + 1), ph_u1(dim + 2), "importance")
        wi_w = _to_world(si, bs["wi"])
        bnew = beta * bs["f"] * (jnp.abs(_dot(wi_w, si["ns"])) / jnp.maximum(bs["pdf"], 1e-30))[:, None]
        alive = alive & bs["valid"] & jnp.any(bnew > 0, axis=-1)
        # RR on beta ratio (sppm.rs :450)
        q = jnp.maximum(0.0, 1.0 - jnp.max(bnew, axis=-1) / jnp.maximum(jnp.max(beta, axis=-1), 1e-12))
        u_rr = ph_u1(dim + 3)
        killed = u_rr < q
        alive = alive & ~killed
        beta = jnp.where(alive[:, None], bnew / jnp.maximum(1.0 - q, 1e-6)[:, None], beta)
        o = _offset_ray(si["p"], si["ng"], wi_w, si.get("p_err"))
        d = wi_w

    return phi, m_cnt, overflow


def render_sppm(cs, seed: int = 0, progress=None):
    """Full SPPM render loop (host-driven iterations)."""
    desc = cs.description
    sa = cs.arrays
    static = cs.static
    from .camera import make_camera

    cam = make_camera(desc.camera, desc.film)
    W = desc.film.x_resolution
    H = desc.film.y_resolution
    R = W * H
    icfg = {"max_depth": max(int(desc.integrator.max_depth), 1)}
    n_iters = int(desc.integrator.num_iterations)
    n_photons = int(desc.integrator.photons_per_iteration)
    if n_photons <= 0:
        n_photons = R
    scfg = {"kind": "zerotwosequence", "spp": n_iters}

    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel().astype(np.int32))
    py = jnp.asarray(ys.ravel().astype(np.int32))
    pids = jnp.asarray((ys * W + xs).ravel().astype(np.uint32))

    # initial radius (sppm.rs :89; param "radius")
    r0 = float(desc.integrator.initial_radius)
    radius = jnp.full(R, r0, F32)
    n_eff = jnp.zeros(R, F32)
    tau = jnp.zeros((R, 3), F32)
    ld = jnp.zeros((R, 3), F32)

    power = compute_power(sa, static)
    cdf = jnp.cumsum(power)
    cdf = cdf / jnp.maximum(cdf[-1], 1e-12)

    n_cells = 1 << max(int(math.ceil(math.log2(max(R, 2)))), 10)
    wc = np.asarray(sa.world_center)
    wr = float(sa.world_radius)
    grid_min = jnp.asarray(wc - wr, F32)

    camera_jit = jax.jit(lambda it, r_seed: _camera_pass(sa, static, icfg, scfg, cam, r_seed, px, py, pids, it))

    # static per-slot lobe-kind sets for the photon gather (same for any ray)
    _probe = make_bsdf(sa, static, jnp.zeros(1, jnp.int32), jnp.zeros((1, 2), F32), jnp.zeros((1, 3), F32))
    vp_possible = _probe["possible"]

    # photon budget per device pass: the 6x64-entry deposit scan keeps
    # ~KMAX*P-row contribution buffers alive per chunk, so one monolithic
    # 2^18-photon pass exhausts worker HBM on full-size films — slice the
    # iteration's photons and accumulate (disjoint pid ranges keep the
    # sample streams identical to the unsliced pass)
    PHOTON_SLICE = 1 << 16
    n_slices = max(1, -(-n_photons // PHOTON_SLICE))
    n_slice = -(-n_photons // n_slices)
    n_photons = n_slice * n_slices  # actual traced count (>= requested);
    # the tau normalization below uses this value, keeping the estimator
    # unbiased when the request doesn't divide evenly
    photon_jit = jax.jit(
        lambda it, r_seed, vp, radius, sc, sv, inv_cell, pid0: _photon_pass(
            sa, static, icfg, r_seed, it, n_slice, cdf, vp, radius, sc, sv, grid_min, inv_cell, n_cells, vp_possible,
            pid0=pid0,
        )
    )
    grid_jit = jax.jit(lambda vp, radius, inv_cell: _build_grid(vp, radius, grid_min, inv_cell, n_cells))

    t0 = time.time()
    for it in range(n_iters):
        it_j = jnp.uint32(it)
        seed_j = jnp.uint32(seed + it * 9781)
        ld_add, vp = camera_jit(it_j, jnp.uint32(seed))
        ld = ld + jnp.where(jnp.isfinite(ld_add), ld_add, 0.0)
        vp["beta"] = jnp.where(jnp.isfinite(vp["beta"]), vp["beta"], 0.0)

        max_r = float(jnp.max(jnp.where(vp["valid"], radius, 0.0)))
        # cell >= diameter AND grid <= 1022^3: the packed 10-bit/axis cell
        # key is exact only below 1024 cells per axis — beyond that, keys
        # alias and unrelated voxels merge into one sorted run, wasting the
        # deposit scan budget on false neighbors
        cell = max(2.0 * max_r, 2.0 * wr / 1022.0, 1e-6)
        inv_cell = jnp.float32(1.0 / cell)
        sc, sv = grid_jit(vp, radius, inv_cell)
        phi = jnp.zeros((R, 3), F32)
        m_cnt = jnp.zeros(R, F32)
        ov = 0
        for s_i in range(n_slices):
            p0 = s_i * n_slice
            phi_s, m_s, overflow = photon_jit(it_j, seed_j, vp, radius, sc, sv, inv_cell,
                                              jnp.uint32(p0))
            phi = phi + phi_s
            m_cnt = m_cnt + m_s
            ov += int(overflow)
        if ov > 0:
            log.warning("sppm iter %d: %d photon-VP pairs dropped by the %d-entry scan cap", it, ov, KMAX * N_CHUNKS)

        # radius/tau update (sppm.rs :470-502)
        has = m_cnt > 0
        n_new = n_eff + GAMMA * m_cnt
        r_new = jnp.where(has, radius * jnp.sqrt(n_new / jnp.maximum(n_eff + m_cnt, 1e-12)), radius)
        tau = jnp.where(
            has[:, None],
            (tau + vp["beta"] * phi) * ((r_new * r_new) / jnp.maximum(radius * radius, 1e-20))[:, None],
            tau,
        )
        radius = jnp.where(has, r_new, radius)
        n_eff = jnp.where(has, n_new, n_eff)
        if progress:
            progress(it + 1, n_iters)
        # progressive image writes every "imagewritefrequency" iterations
        # (sppm.rs:505-528) to the film's own filename
        wf = int(getattr(desc.integrator, "write_frequency", 1 << 31))
        if wf < n_iters and (it + 1) % wf == 0 and (it + 1) < n_iters:
            np_sofar = float(it + 1) * n_photons
            prog_img = ld / (it + 1) + tau / (
                np_sofar * jnp.pi * jnp.maximum(radius * radius, 1e-20))[:, None]
            prog_img = np.asarray(prog_img, np.float32).reshape(H, W, 3)
            name = getattr(desc.film, "filename", "pbrt.exr") or "pbrt.exr"
            try:
                if name.lower().endswith(".exr"):
                    from ..core.imageio import write_exr

                    write_exr(name, prog_img * desc.film.scale)
                else:
                    from ..core.imageio import write_image

                    write_image(name, prog_img * desc.film.scale)
                log.info("sppm: progressive image -> %s (iter %d)", name, it + 1)
            except Exception as e:  # progressive writes must never kill a render
                log.warning("sppm: progressive write failed: %s", e)

    np_total = float(n_iters) * n_photons
    img = ld / n_iters + tau / (np_total * jnp.pi * jnp.maximum(radius * radius, 1e-20))[:, None]
    img = np.asarray(img, np.float32).reshape(H, W, 3)
    log.info("sppm: %d iters x %d photons in %.1fs", n_iters, n_photons, time.time() - t0)
    return img
