"""Realistic camera: full lens-system ray tracing.

Array-program port of src/cameras/realistic.rs: lens element interfaces come
from a lens description file (rows of curvature-radius / thickness / eta /
aperture-diameter in mm, front element first); rays start on the film,
refract through every element (a STATIC python loop — element count is
fixed per camera, so the whole trace unrolls into straight-line vectorized
code), and exit into the scene. Focusing uses the thick-lens equations
(realistic.rs focus_thick_lens); the exit pupil is precomputed per radial
bucket (:48-...) so film samples aim only at directions with a chance of
making it through.
"""
from __future__ import annotations

import logging
import math

import numpy as np

import jax.numpy as jnp

log = logging.getLogger(__name__)
F32 = jnp.float32

# fallback 4-element double-gauss-ish lens (public pbrt-style rows:
# curvature radius, thickness, eta, aperture diameter — in mm)
DEFAULT_LENS = [
    [35.98738, 1.21638, 1.54, 23.716],
    [11.69718, 9.9957, 1.0, 17.996],
    [13.08714, 5.12622, 1.772, 12.364],
    [-22.63294, 1.76924, 1.617, 9.812],
    [71.05802, 0.8184, 1.0, 9.152],
    [0.0, 2.27766, 0.0, 8.756],  # aperture stop
    [-9.58584, 2.43254, 1.617, 8.184],
    [-11.28864, 0.11506, 1.0, 9.152],
    [-166.7765, 3.09606, 1.713, 10.648],
    [-7.5911, 1.32682, 1.805, 11.44],
    [-16.7662, 3.98068, 1.0, 12.276],
    [-7.70286, 1.21638, 1.617, 13.42],
    [-11.97328, 0.0, 1.0, 17.996],
]


def load_lens_file(path: str):
    """Whitespace/#-comment float file, 4 columns per element (floatfile.rs)."""
    rows = []
    with open(path) as fh:
        vals = []
        for line in fh:
            line = line.split("#")[0].strip()
            if not line:
                continue
            vals.extend(float(t) for t in line.split())
    if len(vals) % 4:
        raise ValueError(f"lens file {path}: count {len(vals)} not a multiple of 4")
    for i in range(0, len(vals), 4):
        rows.append(vals[i : i + 4])
    return rows


class LensSystem:
    """Host-side lens description + focusing (all lengths in meters)."""

    def __init__(self, rows, aperture_diameter_mm: float):
        # rows: front-first. Convert mm -> m; aperture row (radius 0) gets
        # the requested aperture diameter (realistic.rs ctor).
        self.curvature = []
        self.thickness = []
        self.eta = []
        self.aperture_r = []
        for cr, th, eta, ap in rows:
            if cr == 0.0 and aperture_diameter_mm > 0:
                ap = min(ap, aperture_diameter_mm)
            self.curvature.append(cr * 1e-3)
            self.thickness.append(th * 1e-3)
            self.eta.append(eta)
            self.aperture_r.append(ap * 1e-3 / 2.0)
        self.n = len(rows)

    def rear_z(self):
        return self.thickness[-1]

    def focus_offset(self, focus_distance: float) -> float:
        """Film-to-rear-element distance producing focus at focus_distance.

        Numerical autofocus: bisect the film offset so that rays from a
        point at the focus distance converge on the film center (replaces
        the closed-form focus_thick_lens which needs cardinal points)."""
        import numpy as _np

        def blur(delta):
            # trace a fan of near-axis rays from the in-focus point through
            # the lens toward the film shifted by delta; return spot radius
            spot = []
            for h in (0.2, 0.35, 0.5):
                # keep probes paraxial: within the smallest aperture (the
                # stop may be closed down to ~1mm by "aperturediameter")
                r = min(self.aperture_r) * h
                ok, o, d = self._trace_from_scene(
                    _np.array([0.0, 0.0, -focus_distance]), _np.array([r, 0.0, 0.0])
                )
                if not ok or abs(d[2]) < 1e-9:
                    continue
                # film plane sits near z=0 (thickness[-1] is the flange
                # distance, already accumulated); delta shifts it
                t = (delta - o[2]) / d[2]
                spot.append(abs(o[0] + t * d[0]))
            return sum(spot) / max(len(spot), 1) if spot else 1e9

        best, best_b = 0.0, 1e18
        for delta in _np.linspace(-5e-3, 60e-3, 1300):
            b = blur(delta)
            if b < best_b:
                best_b = b
                best = delta
        return float(best)

    def _trace_from_scene(self, p_scene, p_front):
        """Scalar (numpy) trace scene->film for autofocus. Returns
        (ok, o, d) with the ray leaving the rear element."""
        total = sum(self.thickness)
        z = -total
        o = np.asarray(p_scene, float)
        d = np.asarray(p_front, float) + np.array([0, 0, z]) - o
        d = d / np.linalg.norm(d)
        eta_prev = 1.0
        for i in range(self.n):
            r = self.curvature[i]
            eta_next = self.eta[i] if self.eta[i] != 0 else 1.0
            if r == 0:
                t = (z - o[2]) / d[2]
            else:
                zc = z + r
                oc = o - np.array([0, 0, zc])
                b = np.dot(oc, d)
                c = np.dot(oc, oc) - r * r
                disc = b * b - c
                if disc < 0:
                    return False, o, d
                sq = math.sqrt(disc)
                # closer sheet when travel dir and curvature agree
                # (realistic.rs intersect_spherical_element)
                closer = (d[2] > 0) != (r < 0)
                t = (-b - sq) if closer else (-b + sq)
                if t < 1e-9:
                    return False, o, d
            p = o + t * d
            if p[0] ** 2 + p[1] ** 2 > self.aperture_r[i] ** 2:
                return False, o, d
            if r != 0:
                n = (p - np.array([0, 0, z + r])) / abs(r)
                n = n if np.dot(n, d) < 0 else -n
                eta_ratio = eta_prev / eta_next
                cos_i = -np.dot(n, d)
                sin2t = eta_ratio * eta_ratio * (1 - cos_i * cos_i)
                if sin2t >= 1:
                    return False, o, d
                cos_t = math.sqrt(1 - sin2t)
                d = eta_ratio * d + (eta_ratio * cos_i - cos_t) * n
                d = d / np.linalg.norm(d)
            o = p
            eta_prev = eta_next
            z += self.thickness[i]
        return True, o, d


def make_realistic(cfg, film):
    """Build the realistic-camera parameter dict."""
    rows = None
    if cfg.lens_file:
        try:
            rows = load_lens_file(cfg.lens_file)
        except (OSError, ValueError) as e:
            log.warning("lens file '%s' unreadable (%s); using built-in double gauss", cfg.lens_file, e)
    if rows is None:
        rows = DEFAULT_LENS
    lens = LensSystem(rows, cfg.aperture_diameter)
    film_delta = lens.focus_offset(max(cfg.focus_distance, 0.1))
    film_z = film_delta

    # physical film extent from the diagonal (film.rs create_film)
    aspect = film.x_resolution / film.y_resolution
    diag = film.diagonal * 1e-3
    fy = math.sqrt(diag * diag / (1 + aspect * aspect))
    fx = aspect * fy

    total = sum(lens.thickness)
    elem_z = []
    z = -total
    for th in lens.thickness:
        elem_z.append(z)
        z += th

    rcam = {
        "curvature": tuple(float(c) for c in lens.curvature),
        "elem_z": tuple(float(z_) for z_ in elem_z),
        "eta": tuple(float(e) if e != 0 else 1.0 for e in lens.eta),
        "aperture_r": tuple(float(a) for a in lens.aperture_r),
        "n_elements": lens.n,
        "film_z": float(film_z),
        "rear_r": float(lens.aperture_r[-1]),
        "rear_z": float(lens.rear_z()),
        "film_extent": (fx, fy),
    }
    # 64 radial buckets like realistic.rs:91 (was 16 through round 3 —
    # coarse buckets over-covered the pupil at wide apertures, wasting
    # samples on vignetted rays and flattening the area-weight profile)
    rcam["pupil_bounds"] = compute_exit_pupil(rcam, (fx, fy), n_buckets=64)
    return rcam


def trace_film_to_scene(rcam, o, d):
    """Walk rays (film side, travelling -z) through all elements.

    o, d: (R, 3) in lens space. Returns (ok, o, d) with the exiting ray at
    the front element. Element parameters are static python floats, so the
    walk unrolls into straight-line vectorized code."""
    R = o.shape[0]
    ok = jnp.ones(R, bool)
    n = rcam["n_elements"]
    for i in range(n - 1, -1, -1):
        r = rcam["curvature"][i]
        zs = rcam["elem_z"][i]
        ap2 = rcam["aperture_r"][i] ** 2
        if r == 0.0:
            t = (zs - o[:, 2]) / jnp.where(jnp.abs(d[:, 2]) > 1e-9, d[:, 2], 1e-9)
            good = t > 0
            p = o + d * t[:, None]
            good = good & (p[:, 0] ** 2 + p[:, 1] ** 2 <= ap2)
            o = p
            ok = ok & good
            continue
        zc = zs + r
        ocz = o - jnp.asarray([0.0, 0.0, zc], F32)
        b = jnp.sum(ocz * d, axis=-1)
        c = jnp.sum(ocz * ocz, axis=-1) - r * r
        disc = b * b - c
        has = disc >= 0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        use_closer = (d[:, 2] > 0) != (r < 0)
        t = jnp.where(use_closer, -b - sq, -b + sq)
        good = has & (t > 1e-9)
        p = o + d * t[:, None]
        good = good & (p[:, 0] ** 2 + p[:, 1] ** 2 <= ap2)

        eta_here = rcam["eta"][i]
        eta_next = rcam["eta"][i - 1] if i > 0 else 1.0
        nrm = (p - jnp.asarray([0.0, 0.0, zc], F32)) / abs(r)
        nrm = jnp.where((jnp.sum(nrm * d, axis=-1) > 0)[:, None], -nrm, nrm)
        eta_ratio = eta_here / max(eta_next, 1e-6)
        cos_i = -jnp.sum(nrm * d, axis=-1)
        sin2t = eta_ratio * eta_ratio * (1.0 - cos_i * cos_i)
        tir = sin2t >= 1.0
        cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2t, 0.0))
        d_ref = eta_ratio * d + (eta_ratio * cos_i - cos_t)[:, None] * nrm
        d_ref = d_ref / jnp.maximum(jnp.linalg.norm(d_ref, axis=-1, keepdims=True), 1e-30)
        d = jnp.where(tir[:, None], d, d_ref)
        good = good & ~tir
        o = p
        ok = ok & good
    return ok, o, d


def compute_exit_pupil(rcam, film_extent, n_buckets: int = 16, grid: int = 32):
    """Per film-radius bucket, the bounding rect of rear-element points that
    reach the scene (realistic.rs exit pupil precompute)."""
    fx, fy = film_extent
    film_diag_half = 0.5 * math.hypot(fx, fy)
    rr = rcam["rear_r"] * 1.5
    xs = np.linspace(-rr, rr, grid)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    n = grid * grid
    rear = np.stack([gx.ravel(), gy.ravel(), np.full(n, rcam["elem_z"][-1])], axis=-1).astype(np.float32)
    bounds = np.zeros((n_buckets, 4), np.float32)
    for b in range(n_buckets):
        r_film = (b + 0.5) / n_buckets * film_diag_half
        o = np.broadcast_to(np.array([r_film, 0.0, rcam["film_z"]], np.float32), (n, 3)).copy()
        d = rear - o
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        ok, _, _ = trace_film_to_scene(rcam, jnp.asarray(o), jnp.asarray(d))
        okn = np.asarray(ok)
        if okn.any():
            pxs = rear[okn]
            pad = 2 * rr / grid
            bounds[b] = [pxs[:, 0].min() - pad, pxs[:, 0].max() + pad, pxs[:, 1].min() - pad, pxs[:, 1].max() + pad]
        else:
            bounds[b] = [-rcam["rear_r"], rcam["rear_r"], -rcam["rear_r"], rcam["rear_r"]]
    return jnp.asarray(bounds)


def realistic_generate_rays(cam, rcam, p_film_x, p_film_y, u1, u2):
    """Film raster samples -> world rays through the lens stack.

    Returns (o, d, weight) — weight 0 for rays vignetted by the lens."""
    W, H = cam["resolution"]
    fx, fy = rcam["film_extent"]
    # film point (film flipped: realistic.rs p_film)
    x = (0.5 - p_film_x / W) * fx
    y = (p_film_y / H - 0.5) * fy
    R = p_film_x.shape[0]
    o = jnp.stack([x, y, jnp.full(R, rcam["film_z"], F32)], axis=-1)

    # sample the exit pupil for this film radius (realistic.rs
    # sample_exit_pupil), rotated to the film azimuth
    pupil = rcam["pupil_bounds"]  # (NB, 4)
    film_diag_half = 0.5 * math.hypot(fx, fy)
    r_film = jnp.sqrt(x * x + y * y)
    nb = pupil.shape[0]
    bidx = jnp.clip((r_film / film_diag_half * nb).astype(jnp.int32), 0, nb - 1)
    bb = pupil[bidx]  # (R, 4)
    px_r = bb[:, 0] + u1 * (bb[:, 1] - bb[:, 0])
    py_r = bb[:, 2] + u2 * (bb[:, 3] - bb[:, 2])
    inv_r = jnp.where(r_film > 1e-9, 1.0 / jnp.maximum(r_film, 1e-9), 0.0)
    cs = jnp.where(r_film > 1e-9, x * inv_r, 1.0)
    sn = jnp.where(r_film > 1e-9, y * inv_r, 0.0)
    p_rear = jnp.stack(
        [cs * px_r - sn * py_r, sn * px_r + cs * py_r, jnp.full(R, rcam["elem_z"][-1], F32)], axis=-1
    )
    d = p_rear - o
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    cos0 = jnp.abs(d[:, 2])

    ok, o, d = trace_film_to_scene(rcam, o, d)

    # exiting rays travel toward -z (lens space); flip into the pinhole
    # camera convention (+z forward) and transform to world
    c2w = cam["camera_to_world"]
    d_cam = jnp.stack([d[:, 0], d[:, 1], -d[:, 2]], axis=-1)
    d_cam = jnp.where(ok[:, None], d_cam, jnp.asarray([0.0, 0.0, 1.0], F32))
    o_cam = jnp.stack([o[:, 0], o[:, 1], -o[:, 2]], axis=-1)
    from .affine import xf_vector
    o_w = xf_vector(c2w[:3, :3], o_cam) + c2w[:3, 3]
    d_w = xf_vector(c2w[:3, :3], d_cam)
    d_w = d_w / jnp.maximum(jnp.linalg.norm(d_w, axis=-1, keepdims=True), 1e-30)
    # simple_weighting (realistic.rs:494): cos^4 scaled by the sampled
    # pupil bucket's area relative to the on-axis bucket — wider film
    # radii see a different (usually smaller) exit pupil, and the weight
    # must track the per-bucket sampling density or vignetting is biased
    area = (bb[:, 1] - bb[:, 0]) * (bb[:, 3] - bb[:, 2])
    area0 = jnp.maximum((pupil[0, 1] - pupil[0, 0]) * (pupil[0, 3] - pupil[0, 2]), 1e-12)
    weight = jnp.where(ok, cos0 ** 4 * area / area0, 0.0)
    return o_w, d_w, weight
