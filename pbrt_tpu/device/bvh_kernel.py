"""Per-ray BVH traversal kernel for NVIDIA GPUs, called through `jax.ffi`.

The XLA traversal (`intersect._traverse`) walks the tree as a data-dependent
`lax.while_loop` that pops one node per packet of PACKET rays per
iteration; on the H100 that loop is hundreds of times slower per wave than
this kernel (PERF.md). `cuda/bvh_traverse.cu` gives every ray one thread
and its own 64-entry stack, reads node and triangle rows through the cache,
and lets an any-hit ray stop at its first occluder.

It serves static triangle-only BVH scenes (`eligible`). The kernel is chosen
per lowering platform with `lax.platform_dependent`: on CUDA the FFI call,
on every other platform the XLA traversal, so one jitted render runs on the
GPU and on the CPU alike.

The shared library is compiled from the repo's source with `nvcc` for
sm_90a on first use, into `<checkout>/build/cuda/` (git-ignored), keyed by a
hash of the source. `python -m pbrt_tpu.device.bvh_kernel` builds it ahead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp

F32 = jnp.float32

SRC = Path(__file__).with_name("cuda") / "bvh_traverse.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
CLOSEST_TARGET = "pbrt_bvh_closest"
ANY_TARGET = "pbrt_bvh_any"

_registered = False


def eligible(static) -> bool:
    """Scenes the kernel covers: static triangle meshes under the BVH.

    Quadrics, instances, motion, the kd-tree and the brute-force path keep
    the XLA code."""
    return (static.n_prims > 0 and static.n_spheres == 0
            and not static.use_brute_force and static.accel_kind == "bvh"
            and not static.has_instances and not static.has_motion)


def _source_tag() -> str:
    return hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libpbrt_bvh_{_source_tag()}.so"


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                 "bin", "nvcc")


def nvcc_command(out: Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
        "-o", str(out), str(SRC),
    ]


def host_compile_command(out: Path) -> list[str]:
    """The same traversal as a serial host function (tests only)."""
    return ["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
            "-o", str(out), str(SRC)]


def build() -> Path:
    """Compile the CUDA library unless this source's build already exists."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(nvcc_command(tmp), check=True)
        os.replace(tmp, out)
    return out


def ensure_registered() -> None:
    """Build the library and register its two FFI targets for CUDA."""
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(CLOSEST_TARGET, jax.ffi.pycapsule(lib.PbrtBvhClosest),
                                platform="CUDA")
    jax.ffi.register_ffi_target(ANY_TARGET, jax.ffi.pycapsule(lib.PbrtBvhAny),
                                platform="CUDA")
    _registered = True


def _operands(sa, o, d, t_max):
    return (o.astype(F32), d.astype(F32), t_max, sa.bvh_packed, sa.prim_test_data)


def _cuda_closest(sa, o, d, t_max):
    R = o.shape[0]
    f = jax.ShapeDtypeStruct((R,), F32)
    t, prim, b1, b2 = jax.ffi.ffi_call(
        CLOSEST_TARGET, (f, jax.ShapeDtypeStruct((R,), jnp.int32), f, f))(
        *_operands(sa, o, d, t_max))
    return {"t": t, "prim": prim, "b1": b1, "b2": b2}


def _cuda_any(sa, o, d, t_max):
    return jax.ffi.ffi_call(ANY_TARGET, jax.ShapeDtypeStruct((o.shape[0],), jnp.bool_))(
        *_operands(sa, o, d, t_max))


def _register_if_gpu():
    # The FFI target has to exist before XLA compiles for CUDA; a process
    # without a GPU backend never lowers the CUDA branch.
    if jax.default_backend() == "gpu":
        ensure_registered()


def closest(sa, static, o, d, t_max):
    """Closest hit {t, prim, b1, b2}: the kernel on CUDA, XLA elsewhere."""
    from .intersect import _traverse

    _register_if_gpu()
    t_max = jnp.broadcast_to(jnp.asarray(t_max, F32), (o.shape[0],))

    def xla(o, d, t_max):
        return _traverse(sa, static, o, d, t_max, any_hit=False)[0]

    return jax.lax.platform_dependent(
        o, d, t_max, cuda=lambda o, d, t_max: _cuda_closest(sa, o, d, t_max), default=xla)


def occluded(sa, static, o, d, t_max):
    """Any hit (R,) bool: the kernel on CUDA, XLA elsewhere."""
    from .intersect import _traverse

    _register_if_gpu()
    t_max = jnp.broadcast_to(jnp.asarray(t_max, F32), (o.shape[0],))

    def xla(o, d, t_max):
        return _traverse(sa, static, o, d, t_max, any_hit=True)[1]

    return jax.lax.platform_dependent(
        o, d, t_max, cuda=lambda o, d, t_max: _cuda_any(sa, o, d, t_max), default=xla)


if __name__ == "__main__":
    print(build())
