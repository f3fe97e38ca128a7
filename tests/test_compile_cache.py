"""One persistent compile cache: JAX_COMPILATION_CACHE_DIR when set,
otherwise a fixed directory inside the checkout."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = "import jax, pbrt_tpu; print(jax.config.jax_compilation_cache_dir)"


def _cache_dir(env_extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_env_var_is_honoured(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)


def test_default_is_inside_the_checkout(tmp_path):
    # independent of HOME, TMPDIR and the working directory
    got = _cache_dir({"HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert got == os.path.join(ROOT, ".jax_cache")


def test_package_exposes_the_default():
    import pbrt_tpu

    assert str(pbrt_tpu.CACHE_DIR) == os.path.join(ROOT, ".jax_cache")
