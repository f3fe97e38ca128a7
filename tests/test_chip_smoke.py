"""chip_smoke.py's phases at tiny size on the CPU, and its refusal to run
without a GPU. On the card the same functions run at full size."""
import numpy as np
import pytest

import jax

import chip_smoke
from pbrt_tpu.scene.builder import compile_scene

CARD = "test card, 0 W"


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_four_card_option_is_the_only_extra_argument():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--cards", "2"])


@pytest.fixture(scope="module")
def small_mesh():
    from bench import _mesh_scene

    return compile_scene(_mesh_scene(n_side=10))


def test_phase_traversal_small(small_mesh, capsys):
    out = chip_smoke.phase_traversal(small_mesh, CARD, W=40, H=20)
    assert set(out) == {"camera_closest", "bounce_closest", "bounce_any"}
    assert out["camera_closest"]["rays"] == 800
    assert out["camera_closest"]["hit_frac"] > 0.9
    assert 0.05 < out["bounce_any"]["occluded"] < 0.95
    line = capsys.readouterr().out.splitlines()[0]
    assert CARD in line and "kernel_ms" in line


def test_phase_main_path_small():
    rec = chip_smoke.phase_main_path(CARD, n_side=8, W=32, H=16, spp=2,
                                     expect_tier="xla-wavefront/packet")
    assert rec["n_vertices"] > 32 * 16 * 2
    assert rec["mverts_per_s"] > 0


def test_phase_parity_small():
    cpu = jax.devices("cpu")
    rec = chip_smoke.phase_parity(CARD, cpu[1], cpu[0], n_side=8, W=24, H=12, spp=2)
    assert rec["mean_ratio"] == pytest.approx(1.0, abs=1e-5)
    assert rec["blurred_rel_mse"] < 1e-8 < rec["seed_noise_blurred_rel_mse"]


def test_phase_cli_small():
    rec = chip_smoke.phase_cli(CARD, W=32, H=16, spp=2)
    assert rec["mean"] > 0


def test_phase_sharded_small(monkeypatch):
    """The four-card phase on four virtual CPU devices, through the same
    auto-sharding branch of render_compiled that runs on the cards."""
    from pbrt_tpu import render

    monkeypatch.setattr(render, "_auto_shard_devices", lambda: jax.devices()[:4])
    rec = chip_smoke.phase_sharded(CARD, jax.devices()[:4], n_side=8, W=32, H=16, spp=2,
                                   sppm_res=(32, 16), sppm_iters=2, sppm_photons=4096)
    assert rec["devices"] == 4
    assert abs(rec["lit_mean_ratio"] - 1.0) < 0.05


def test_blurred_mse():
    rs = np.random.RandomState(0)
    a = rs.rand(20, 30, 3)
    assert chip_smoke.blurred_mse(a, a) == 0.0
    # blurring averages pixel noise away: 5x5 box cuts white-noise MSE ~25x
    b = a + 0.1 * rs.randn(20, 30, 3)
    raw = np.mean((a - b) ** 2) / np.mean(b ** 2)
    assert chip_smoke.blurred_mse(a, b) < 0.2 * raw
