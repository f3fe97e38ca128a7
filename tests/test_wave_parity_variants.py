"""Persistent wave vs per-sample wave on mini-room variants: quadrics among
the triangles, an emissive sphere, smooth shading normals, a UV checker
texture and a constant infinite light."""
import pytest

from scenes_parity import assert_persistent_matches_wave, room_variant


@pytest.mark.parametrize("variant", [
    "mixed_spheres", "sphere_light", "shading_normals", "checker_uv", "constant_infinite",
])
def test_room_variant_persistent_matches_wave(variant):
    cs = assert_persistent_matches_wave(room_variant(variant), min_lit=0.5)
    assert not cs.static.use_brute_force
    if variant == "sphere_light":
        assert cs.static.has_cone_sphere_lights
    if variant == "constant_infinite":
        assert cs.static.has_infinite and not cs.static.has_env_map
