"""--cat / --toply round-trip tests (main.rs cat/to_ply printing path)."""
import io
import os

import numpy as np

from pbrt_tpu.parser.catprint import cat_scene, format_directive
from pbrt_tpu.parser.parser import parse_file



def test_cat_round_trips(tmp_path):
    """cat output re-parses to the same directive stream."""
    from bench import spheres_pbrt_text

    spheres = tmp_path / "spheres.pbrt"
    spheres.write_text(spheres_pbrt_text())
    buf = io.StringIO()
    cat_scene(parse_file(str(spheres)), out=buf)
    p2 = tmp_path / "roundtrip.pbrt"
    p2.write_text(buf.getvalue())
    d1 = list(parse_file(str(spheres)))
    assert len(d1) > 10
    d2 = list(parse_file(str(p2)))
    assert [d.name for d in d1] == [d.name for d in d2]
    for a, b in zip(d1, d2):
        assert a.args == b.args or np.allclose(np.asarray(a.args, float), np.asarray(b.args, float))
        ka = set() if a.params is None else set(a.params.params)
        kb = set() if b.params is None else set(b.params.params)
        assert ka == kb


def test_toply_extracts_meshes(tmp_path):
    """Inline trianglemesh >= 500 tris becomes a mesh_00000.ply reference
    that the PLY loader reads back with identical geometry."""
    n = 40
    xs, ys = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    p = np.stack([xs.ravel(), ys.ravel(), np.zeros(n * n)], -1)
    idx = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            idx += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    scene = tmp_path / "big.pbrt"
    scene.write_text(
        'Camera "perspective"\nWorldBegin\nShape "trianglemesh" '
        + '"integer indices" [ ' + " ".join(str(i) for i in np.ravel(idx)) + " ] "
        + '"point3 P" [ ' + " ".join(f"{v}" for v in p.ravel()) + " ]\nWorldEnd\n"
    )
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        n_ply = cat_scene(parse_file(str(scene)), to_ply=True, out=buf)
    finally:
        os.chdir(old)
    assert n_ply == 1
    text = buf.getvalue()
    assert '"plymesh"' in text and "mesh_00000.ply" in text
    assert "trianglemesh" not in text
    from pbrt_tpu.scene.ply import read_ply

    mesh = read_ply(str(tmp_path / "mesh_00000.ply"))
    assert mesh["p"].shape == (n * n, 3)
    assert mesh["indices"].shape == (len(idx), 3)
    np.testing.assert_allclose(mesh["p"], p, atol=1e-6)
