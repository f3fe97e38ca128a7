"""Test configuration: the CPU with an 8-device virtual mesh, unless the run
selects only the GPU tests (`pytest -m gpu`, on a machine with a card).

Device code is tested on the CPU backend; multi-device sharding tests use
the 8 virtual host devices. Tests that need an NVIDIA GPU carry the `gpu`
marker and skip on the CPU (see the `gpu_only` fixture).
"""
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU; skips on the CPU")
    if config.getoption("markexpr") == "gpu":
        return  # JAX picks the card
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"


@pytest.fixture
def gpu_only():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run `python -m pytest -m gpu tests/` on the card")
