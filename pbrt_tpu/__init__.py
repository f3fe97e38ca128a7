"""pbrt_tpu: a physically based renderer written as JAX array programs.

A ground-up JAX/XLA re-design of the pbrt-v3 feature set (reference:
alexmeli100/pbrt-rust): the .pbrt scene language, integrators, BSDFs,
lights, shapes, samplers and filters — with the device path expressed as
batched wavefront array programs over flat SoA scene tables.

Public entry points:
    pbrt_tpu.parser.api.pbrt_parse(path)  ->  SceneDescription
    pbrt_tpu.render.render(desc)          ->  (H, W, 3) float32 image
    python -m pbrt_tpu.main scene.pbrt    ->  CLI (reference main.rs flags)
"""

__version__ = "0.1.0"

# Geometry correctness requires true f32 matmuls. Reduced-precision matmul
# modes (TF32 on NVIDIA tensor cores, bf16 passes elsewhere) round einsum/dot
# inputs to ~3 decimal digits, which puts sphere hit points up to 1.5% off
# the surface (ring-shaped self-intersection acne through the 1e-3 ray-offset
# epsilon). "float32" keeps every dot in full f32 on the GPU and the CPU;
# anything that deliberately wants less must opt down per-op with
# precision=jax.lax.Precision.DEFAULT.
import os as _os
from pathlib import Path as _Path

import jax as _jax

_jax.config.update("jax_default_matmul_precision", "float32")

# Persistent compilation cache: the unrolled bounce pipelines take minutes to
# compile, and caching them across processes makes reruns start in seconds.
# JAX_COMPILATION_CACHE_DIR, when set, is honoured as JAX reads it; otherwise
# the cache lives at a fixed path inside the checkout (the path is part of
# the cache key, so it must not move between runs).
CACHE_DIR = _Path(__file__).resolve().parent.parent / ".jax_cache"
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

__all__ = ["render", "parser", "scene", "device", "core", "utils", "parallel"]
