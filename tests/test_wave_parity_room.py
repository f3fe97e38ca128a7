"""Persistent wave vs per-sample wave on the mesh mini-room, under the BVH
traversal the mesh scenes use: samplers, lights, light selection, filters,
lens, Russian roulette and microfacet / Oren-Nayar lobes."""
import pytest

from scenes_parity import assert_persistent_matches_wave, room_config


@pytest.mark.parametrize("sampler,light,depth,strategy", [
    ("zerotwosequence", "area", 4, "power"),
    ("random", "distant", 4, "power"),
    # depth 7 exercises Russian roulette (kicks in after bounce 3)
    ("zerotwosequence", "area", 7, "power"),
    # 3 lights under UNIFORM selection (floor(u*n), not the cdf walk)
    ("zerotwosequence", "both", 4, "uniform"),
    # thin-lens depth of field (lens dims = static dim 1)
    ("zerotwosequence", "dof", 4, "power"),
    # gaussian pixel filter (erfinv importance sampling, unit weights)
    ("zerotwosequence", "gauss", 4, "power"),
    # stratified sampler (film-dim strata; traced dims = uniform hash)
    ("stratified", "area", 4, "power"),
    # halton (pbrt's default): CRT film enumeration
    ("halton", "area", 4, "power"),
    # spot light: smoothstep^4 cone falloff in the NEE branch
    ("zerotwosequence", "spot", 4, "power"),
    # GGX lobes: plastic terrain + copper metal wall
    ("zerotwosequence", "micro", 4, "power"),
    ("random", "micro", 5, "power"),
    # Oren-Nayar matte (sigma=25)
    ("zerotwosequence", "sigma", 4, "power"),
    # sobol: global film-index enumeration (GF(2) inversion)
    ("sobol", "area", 4, "power"),
    # maxmindist: searched film matrix + per-pixel CP rotation
    ("maxmindist", "area", 4, "power"),
])
def test_room_persistent_matches_wave(sampler, light, depth, strategy):
    cs = assert_persistent_matches_wave(room_config(sampler, light, depth, strategy), min_lit=0.5)
    assert not cs.static.use_brute_force  # the BVH traversal path
