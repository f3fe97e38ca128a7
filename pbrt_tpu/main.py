"""CLI driver — flag-compatible with the reference binary (src/main.rs:12-54).

Usage: python -m pbrt_tpu.main [options] <scene.pbrt>
"""
from __future__ import annotations

import argparse
import logging
import sys
import time


def build_arg_parser():
    p = argparse.ArgumentParser(prog="pbrt_tpu", description="pbrt renderer on JAX")
    p.add_argument("scene", help=".pbrt scene file")
    p.add_argument("--nthreads", "-t", type=int, default=0, help="accepted for compatibility; device parallelism is automatic")
    p.add_argument("--outfile", "-o", default="", help="output image path (overrides scene Film filename)")
    p.add_argument("--cropwindow", "-w", nargs=4, type=float, default=None, metavar=("X0", "X1", "Y0", "Y1"))
    p.add_argument("--quick", "-q", action="store_true", help="quarter resolution, 1/4 spp")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--cat", action="store_true", help="print the parsed scene directives and exit")
    p.add_argument("--toply", action="store_true", help="print scene with meshes converted to PLY references")
    p.add_argument("--logtostderr", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spp", type=int, default=None, help="override sampler pixel samples")
    p.add_argument("--checkpoint", default="", help="checkpoint file for resumable renders")
    p.add_argument("--checkpoint-every", type=int, default=32, help="samples between checkpoints")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="write a jax.profiler device trace of the render to DIR "
                        "(view with tensorboard/xprof; the ProfilePhase equivalent, "
                        "SURVEY.md section 5)")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    level = logging.DEBUG if args.verbose else (logging.ERROR if args.quiet else logging.INFO)
    logging.basicConfig(level=level, format="%(levelname).1s %(name)s: %(message)s")
    log = logging.getLogger("pbrt_tpu")

    from .core.options import Options
    from .parser.api import pbrt_parse

    opts = Options(
        quick_render=args.quick,
        quiet=args.quiet,
        cat=args.cat,
        to_ply=args.toply,
        image_file=args.outfile,
        crop_window=tuple(args.cropwindow) if args.cropwindow else None,
    )

    if args.cat or args.toply:
        # formatted .pbrt re-emission (main.rs --cat/--toply; api.rs printers)
        from .parser.catprint import cat_scene
        from .parser.parser import parse_file

        cat_scene(parse_file(args.scene), to_ply=args.toply)
        return 0

    t0 = time.time()
    desc = pbrt_parse(args.scene, opts)
    log.info("scene parsed+built in %.2fs", time.time() - t0)

    from .render import render

    def progress(done, total):
        if not args.quiet:
            sys.stderr.write(f"\r[{done}/{total} spp]")
            sys.stderr.flush()

    import contextlib

    prof_ctx = contextlib.nullcontext()
    if args.profile:
        import jax

        prof_ctx = jax.profiler.trace(args.profile, create_perfetto_trace=True)
    with prof_ctx:
        img = render(
            desc,
            seed=args.seed,
            spp=args.spp,
            progress=progress,
            checkpoint_path=args.checkpoint or None,
            checkpoint_every=args.checkpoint_every,
        )
    if args.profile:
        log.info("profiler trace written to %s", args.profile)
    if not args.quiet:
        sys.stderr.write("\n")

    out = args.outfile or desc.film.filename
    from .core.imageio import write_image

    write_image(out, img)
    log.info("wrote %s", out)
    if not args.quiet:
        # categorized stats dump at end of render (api.rs:1758-1762)
        from .utils.stats import print_stats

        print_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
