"""Persistent wave vs per-sample wave on the small spheres class (brute-force
intersection): samplers, point/spot/distant lights, microfacet lobes, the
directlighting estimator and a grayscale imagemap."""
import numpy as np
import pytest

from pbrt_tpu.scene.host import HostMaterial, HostTexture, IntegratorConfig
from scenes_parity import assert_persistent_matches_wave, mini_spheres


@pytest.mark.parametrize("sampler,light", [
    ("zerotwosequence", "distant"), ("random", "point"), ("stratified", "distant"),
    ("zerotwosequence", "spot"),
    # GGX metal/plastic + Oren-Nayar
    ("zerotwosequence", "micro"), ("random", "micro"),
])
def test_spheres_persistent_matches_wave(sampler, light):
    desc = mini_spheres(sampler, "point" if light == "micro" else light, micro=light == "micro")
    cs = assert_persistent_matches_wave(desc)
    assert cs.static.use_brute_force


def test_spheres_directlighting_matches_wave():
    """NEE at every vertex, specular-only continuation, no RR."""
    desc = mini_spheres("zerotwosequence", "distant")
    desc.integrator = IntegratorConfig(kind="directlighting", max_depth=5)
    assert_persistent_matches_wave(desc)


def test_spheres_imagemap_kd_matches_wave():
    """Grayscale imagemap Kd (EWA with camera ray differentials)."""
    desc = mini_spheres("zerotwosequence", "distant")
    g = np.linspace(0.2, 0.9, 16, dtype=np.float32)
    img = np.repeat(((g[None, :] + g[:, None]) * 0.5)[:, :, None], 3, axis=2)
    tex = HostTexture(kind="imagemap", image=img, uscale=8.0, vscale=8.0)
    desc.primitives[0].material = HostMaterial(kind="matte", params={"Kd": ("texture", tex)})
    desc.integrator = IntegratorConfig(kind="directlighting", max_depth=4)
    desc.film.x_resolution, desc.film.y_resolution = 32, 16
    assert_persistent_matches_wave(desc)
