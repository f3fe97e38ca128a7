"""A/B of the BVH traversal on the card, end to end and per operation.

1. End to end: path-vertex throughput of the mesh scene (123,650
   triangles, 1000x500, --spp samples, depth 5) through bench._measure — the
   production dispatch shapes — with the per-ray CUDA kernel and with the
   XLA packet traversal (bvh_kernel.eligible patched off), in turns
   kernel, xla, xla, kernel in this one process.
2. The spheres scene (the small-scene class) on the XLA wave.
3. Table lookups: a plain gather against the one-hot matmul it replaced,
   for a 1,024-row table and 4M lanes.

Prints one JSON line per measurement, each with the card's name and power
limit. GPU only.

Usage: python tools/traversal_ab.py [--n-side 248] [--spp 4] [--reps 1]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _gather_ab(card, rows=1024, cols=14, lanes=1 << 22, reps=5):
    import jax
    import jax.numpy as jnp

    table = jax.random.normal(jax.random.PRNGKey(0), (rows, cols), jnp.float32)
    ids = jax.random.randint(jax.random.PRNGKey(1), (lanes,), 0, rows)

    plain = jax.jit(lambda t, i: t[i])

    @jax.jit
    def one_hot(t, i):
        oh = (i[:, None] == jnp.arange(rows, dtype=i.dtype)[None, :]).astype(jnp.float32)
        return jnp.dot(oh, t, precision=jax.lax.Precision.HIGHEST)

    out = {}
    for name, fn in (("plain_gather", plain), ("one_hot_matmul", one_hot)):
        jax.block_until_ready(fn(table, ids))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(table, ids))
            best = min(best, time.perf_counter() - t0)
        out[name + "_ms"] = best * 1e3
    print(json.dumps({"tool": "traversal_ab", "what": "gather", "rows": rows, "cols": cols,
                      "lanes": lanes, **out, "card": card}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-side", type=int, default=248)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--spp", type=int, default=4)
    args = ap.parse_args()

    import jax

    import bench
    from chip_smoke import card_info
    from pbrt_tpu.device import bvh_kernel
    from pbrt_tpu.scene.builder import compile_scene

    if jax.default_backend() != "gpu":
        sys.exit("traversal_ab.py needs a GPU")
    card = card_info()
    eligible = bvh_kernel.eligible

    def run(which):
        bvh_kernel.eligible = eligible if which == "kernel" else (lambda static: False)
        try:
            cs = compile_scene(bench._mesh_scene(n_side=args.n_side))
            vps, compile_s, tier = bench._measure(cs, 1000, 500, n_spp=args.spp, reps=args.reps)
        finally:
            bvh_kernel.eligible = eligible
        print(json.dumps({"tool": "traversal_ab", "what": "mesh", "traversal": which,
                          "tier": tier, "tris": int(cs.static.n_tris), "spp": args.spp,
                          "mverts_per_s": vps / 1e6,
                          "compile_plus_warm_pass_s": compile_s, "card": card}), flush=True)

    for which in ("kernel", "xla", "xla", "kernel"):
        run(which)

    cs = compile_scene(bench._spheres_scene())
    vps, compile_s, tier = bench._measure(cs, 1000, 500, n_spp=args.spp, reps=args.reps)
    print(json.dumps({"tool": "traversal_ab", "what": "spheres", "tier": tier, "spp": args.spp,
                      "mverts_per_s": vps / 1e6, "compile_plus_warm_pass_s": compile_s,
                      "card": card}), flush=True)
    _gather_ab(card)


if __name__ == "__main__":
    main()
