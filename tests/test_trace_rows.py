"""Merged trace-row traversal: exact equivalence with the threaded-BVH walk
and brute force, for closest-hit and any-hit, across leaf sizes."""

import jax.numpy as jnp
import numpy as np
import pytest

from hijiki.ops.intersect import (
    intersect_brute,
    intersect_bvh,
    intersect_rows,
    occluded_rows,
)
from hijiki.scene.compile import compile_scene, scene_to_device

# fast per-commit gate tier (README: python -m pytest tests -m quick)
pytestmark = pytest.mark.quick


def _rays(rng, n):
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    o[:, 1] += 1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (
        jnp.asarray(o),
        jnp.asarray(d),
        jnp.full(n, 1e-4, jnp.float32),
        jnp.full(n, np.inf, jnp.float32),
    )


@pytest.mark.parametrize("leaf_size", [1, 4])
def test_rows_equal_bvh_walk(cbox_scene, rng_np, leaf_size):
    import copy

    scene = copy.deepcopy(cbox_scene)
    scene.put_cbox_spheres()
    cs = scene_to_device(compile_scene(scene, leaf_size=leaf_size))
    o, d, tmin, tmax = _rays(rng_np, 512)

    hr = intersect_rows(o, d, tmin, tmax, scene=cs)
    hv = intersect_bvh(o, d, tmin, tmax, scene=cs, leaf_size=leaf_size)
    np.testing.assert_array_equal(np.asarray(hr.valid), np.asarray(hv.valid))
    m = np.asarray(hr.valid)
    np.testing.assert_array_equal(
        np.asarray(hr.prim_slot)[m], np.asarray(hv.prim_slot)[m]
    )
    # identical math, but the two kernels may fuse FMAs differently -> ULP noise
    np.testing.assert_allclose(np.asarray(hr.t)[m], np.asarray(hv.t)[m], rtol=1e-5)

    hb = intersect_brute(o, d, tmin, tmax, scene=cs)
    np.testing.assert_array_equal(np.asarray(hr.valid), np.asarray(hb.valid))
    np.testing.assert_allclose(np.asarray(hr.t)[m], np.asarray(hb.t)[m], rtol=1e-5)


def test_occluded_rows(cbox_compiled, rng_np):
    cs = cbox_compiled
    n = 256
    o, d, _, _ = _rays(rng_np, n)
    tmin = jnp.full(n, 2e-4, jnp.float32)
    tmax = jnp.asarray(rng_np.uniform(0.05, 3.0, n).astype(np.float32))
    occ = occluded_rows(o, d, tmin, tmax, scene=cs)
    hit = intersect_rows(o, d, tmin, tmax, scene=cs)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(hit.valid))
    # inactive lanes report unoccluded
    occ2 = occluded_rows(o, d, tmin, tmax, jnp.zeros(n, bool), scene=cs)
    assert not np.asarray(occ2).any()
