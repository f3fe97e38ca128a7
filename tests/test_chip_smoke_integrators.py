"""chip_smoke.py phase 6 at tiny size on the CPU: every integrator besides
path renders a finite, non-black image through render()."""
import pytest

import chip_smoke


@pytest.mark.parametrize("kind", chip_smoke.INTEGRATORS)
def test_phase_integrators_small(kind):
    out = chip_smoke.phase_integrators("test card, 0 W", kinds=(kind,), W=16, H=8)
    assert out[kind]["mean"] > 0


def test_phase_integrators_threads_beside_the_calling_thread():
    """sppm and bdpt render in worker threads while ao renders here."""
    assert {"sppm", "bdpt"} <= set(chip_smoke.THREADED) and "ao" not in chip_smoke.THREADED
    out = chip_smoke.phase_integrators("test card, 0 W", kinds=("ao", "sppm", "bdpt"), W=16, H=8)
    assert set(out) == {"ao", "sppm", "bdpt"}
    assert all(rec["mean"] > 0 for rec in out.values())
