"""render/parity.py: the equal-seed parity harness that chip_smoke.py runs on
the card, exercised here on the CPU at a small frame."""

import numpy as np
import pytest

from hijiki.render import parity


def test_schedule_matches_the_renderer():
    from hijiki.render.blocks import BlockScheduler, per_pixel_seeds

    seeds, offsets = parity.schedule(16, 8, seed=3, spp=3)
    assert seeds.shape == (3, 16 * 8) and offsets.shape == (3, 2)
    sched = BlockScheduler(16, 8, parity.BLOCK, 3)
    for s in range(3):
        sw = sched.sweep(s)
        np.testing.assert_array_equal(seeds[s], per_pixel_seeds(16, 8, parity.BLOCK, sw.block_seeds).reshape(-1))
        np.testing.assert_array_equal(offsets[s], np.asarray(sw.sample_offset, np.float32))


def test_compare_counts_divergent_pixels():
    a = np.zeros((4, 4, 3))
    b = a.copy()
    b[1, 2] = 0.3  # one rerouted sample
    b[0, 0] = 1e-5  # rounding noise
    r = parity.compare(a, b)
    assert r["divergent_pixels"] == 1 and r["pixels"] == 16
    assert r["mse"] == pytest.approx(0.09 / 16)
    assert r["trimmed_mse"] == pytest.approx(1e-10 / 15)


def test_driver_matches_native_oracle(cbox_compiled):
    from hijiki.ops.oracle_native import load_library
    from hijiki.scene.cbox_mesh import CBOX_OBJ
    from hijiki.scene.compile import compile_scene
    from hijiki.scene.obj import load_obj_scene

    if load_library() is None:
        pytest.skip("native oracle unavailable (no C++ compiler)")
    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    host = compile_scene(scene)
    seeds, offsets = parity.schedule(12, 12, seed=1, spp=3)
    drv = parity.driver_radiance(cbox_compiled, 12, 12, seeds, offsets, max_bounces=64, batch=2)
    orc = parity.oracle_radiance(host, 12, 12, seeds, offsets, max_bounces=64, workers=2)
    r = parity.compare(orc, drv)
    assert r["mse"] < parity.PARITY_MSE_BOUND
    assert r["divergent_pixels"] <= 2
    assert drv.mean() > 0.01
