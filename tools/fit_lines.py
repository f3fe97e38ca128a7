"""Fit the reconstructed `textures/lines.png` stand-in against the golden.

The spheres golden (rendered_scenes/spheres.png) was produced WITH a
lines.png the reference repo no longer ships; the fidelity gate renders
with a reconstructed stand-in, so its residual is dominated by how well
the stand-in matches the original (round-3 decomposition: 54% of the
4x-blur MSE sits in the ground region, and the mirror/glass spheres
reflect the same texture).

This sweep renders the scene ONCE-compiled and swaps the texture pyramid
in-place between candidates (same 128x128 shape -> jit cache hit), so
each candidate costs one render, not one compile. Scores are the gate's
own metric (tools/fidelity.compare, 4x blur, fitted scale).

Usage: python tools/fit_lines.py
       PBRT_TPU_FIT_SPP=4 to change sweep spp (default 4)
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fidelity import STAGE, _stage_spheres_scene, compare, srgb  # noqa: E402


def gen_tex(n_lines: int, width: int, line_v: float, base_v: float,
            phase: int = 0, n: int = 128) -> np.ndarray:
    tex = np.full((n, n, 3), base_v, np.float32)
    step = n // n_lines
    for k in range(n_lines):
        a = (k * step + phase) % n
        tex[a:a + width, :, :] = line_v
        tex[:, a:a + width, :] = line_v
    return tex


def main():
    import jax.numpy as jnp

    from pbrt_tpu.core.imageio import read_image
    from pbrt_tpu.device.mipmap import build_pyramid
    from pbrt_tpu.parser.api import pbrt_parse
    from pbrt_tpu.render import render_compiled
    from pbrt_tpu.scene.builder import compile_scene

    spp = int(os.environ.get("PBRT_TPU_FIT_SPP", "4"))
    desc = pbrt_parse(_stage_spheres_scene())
    cs = compile_scene(desc)
    key = next(k[: -len("_l0")] for k in cs.arrays.tex_images if k.endswith("_l0"))
    n_levels = len([k for k in cs.arrays.tex_images if k.startswith(key + "_l")])
    gold = (srgb(read_image("/root/reference/rendered_scenes/spheres.png")) * 255).astype(np.uint8)

    cands = []
    for n_lines in (8, 10, 12, 16):
        for width, line_v in ((1, 0.0), (1, 0.25), (2, 0.25), (2, 0.5)):
            cands.append(dict(n_lines=n_lines, width=width, line_v=line_v, base_v=1.0))
    # current production reconstruction first (12 thin black lines)
    cands.insert(0, dict(n_lines=12, width=1, line_v=0.0, base_v=1.0))

    results = []
    for i, c in enumerate(cands):
        tex = gen_tex(**c)
        pyr = build_pyramid(tex)
        assert len(pyr) == n_levels
        for li, level in enumerate(pyr):
            cs.arrays.tex_images[f"{key}_l{li}"] = jnp.asarray(level)
        img = np.asarray(render_compiled(cs, spp=spp))
        m = compare(img, gold, blur=4)
        m.update(c, mean_tex=round(float(tex.mean()), 4))
        results.append(m)
        print(f"[{i + 1}/{len(cands)}] {json.dumps(m)}", flush=True)

    results.sort(key=lambda r: r["blurred_mse"])
    print("\nBEST:", json.dumps(results[0]))
    with open(os.path.join(STAGE, "fit_lines.json"), "w") as fh:
        json.dump(results, fh, indent=1)


if __name__ == "__main__":
    main()
