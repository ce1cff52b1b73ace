"""Regenerating wavefront driver: estimator-exact vs the bulk-synchronous
integrator (same per-pixel seeds -> same paths, regardless of lane
scheduling), across lane-pool sizes and with lane sorting."""

import numpy as np
import pytest

from hijiki.render.renderer import RenderConfig, Renderer
from hijiki.scene.cbox_mesh import CBOX_OBJ


@pytest.fixture(scope="module")
def cbox_small():
    from hijiki.scene.compile import compile_scene
    from hijiki.scene.obj import load_obj_scene

    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    return compile_scene(scene)


def _render(cbox, **kw):
    base = dict(
        width=32, height=32, spp=2, block_size=64, seed=3, max_bounces=24
    )
    base.update(kw)
    r = Renderer(cbox, RenderConfig(**base))
    r.render()
    return np.asarray(r.film)


@pytest.mark.parametrize("lanes", [1 << 10, 256])
def test_wavefront_matches_sync(cbox_small, lanes):
    sync = _render(cbox_small, driver="sync")
    wave = _render(cbox_small, driver="wavefront", wavefront_lanes=lanes)
    # identical paths & RNG streams; only float summation order / fusion
    # (FMA contraction) may differ
    np.testing.assert_allclose(wave, sync, rtol=1e-4, atol=2e-4)


def test_wavefront_sorted_matches(cbox_small):
    sync = _render(cbox_small, driver="sync")
    wave = _render(
        cbox_small, driver="wavefront", wavefront_lanes=512, sort_lanes=True
    )
    np.testing.assert_allclose(wave, sync, rtol=1e-4, atol=2e-4)
