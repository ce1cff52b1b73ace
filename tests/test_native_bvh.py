"""Native C++ BVH builder: invariants, traversal equivalence vs the numpy
builder, and build performance."""

import numpy as np
import pytest

from hijiki.accel.bvh import build_bvh
from hijiki.accel.native import build_bvh_native, load_library


def _random_aabbs(rng, n):
    lo = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    ext = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return lo, lo + ext


@pytest.fixture(scope="module")
def native_available():
    if load_library() is None:
        pytest.skip("g++ unavailable")


def _check_invariants(bvh, n, leaf_size):
    num = bvh.num_nodes
    assert sorted(bvh.prim_order.tolist()) == list(range(n))
    assert bvh.count.sum() == n
    assert bvh.exit[0] == num
    assert np.all(bvh.exit > np.arange(num))
    assert np.all(bvh.exit <= num)
    interior = bvh.count == 0
    assert np.all(bvh.first[interior] == np.nonzero(interior)[0] + 1)
    assert np.all(bvh.count <= leaf_size)
    # every leaf's range is within prim_order
    leaves = ~interior
    assert np.all(bvh.first[leaves] >= 0)
    assert np.all(bvh.first[leaves] + bvh.count[leaves] <= n)
    # parent AABB contains left child (preorder: left = parent+1)
    par = np.nonzero(interior)[0]
    assert np.all(bvh.aabb_min[par] <= bvh.aabb_min[par + 1] + 1e-5)
    assert np.all(bvh.aabb_max[par] >= bvh.aabb_max[par + 1] - 1e-5)


@pytest.mark.parametrize("leaf_size", [1, 4, 12])
@pytest.mark.parametrize("n", [1, 2, 7, 500])
def test_native_invariants(native_available, leaf_size, n):
    rng = np.random.default_rng(n)
    lo, hi = _random_aabbs(rng, n)
    bvh = build_bvh_native(lo, hi, leaf_size)
    _check_invariants(bvh, n, leaf_size)


def test_native_matches_numpy_traversal(native_available, cbox_scene):
    """Same scene through both builders must yield identical closest hits."""
    import copy

    import jax.numpy as jnp

    from hijiki.ops.intersect import intersect_rows
    from hijiki.scene import compile as sc
    from hijiki.scene.compile import compile_scene, scene_to_device

    scene = copy.deepcopy(cbox_scene)
    scene.put_cbox_spheres()

    import hijiki.accel.bvh as bvh_mod

    orig = bvh_mod.build_bvh
    try:
        bvh_mod_build = lambda mn, mx, leaf_size=1: orig(mn, mx, leaf_size, backend="numpy")
        sc.build_bvh = bvh_mod_build
        cs_np = scene_to_device(compile_scene(scene))
        sc.build_bvh = lambda mn, mx, leaf_size=1: orig(mn, mx, leaf_size, backend="native")
        cs_cc = scene_to_device(compile_scene(scene))
    finally:
        sc.build_bvh = orig

    rng = np.random.default_rng(1)
    n = 256
    o = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    o[:, 1] += 1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    tmin = jnp.full(n, 1e-4, jnp.float32)
    tmax = jnp.full(n, np.inf, jnp.float32)
    h1 = intersect_rows(o, d, tmin, tmax, scene=cs_np)
    h2 = intersect_rows(o, d, tmin, tmax, scene=cs_cc)
    np.testing.assert_array_equal(np.asarray(h1.valid), np.asarray(h2.valid))
    m = np.asarray(h1.valid)
    np.testing.assert_array_equal(
        np.asarray(h1.shape_id)[m], np.asarray(h2.shape_id)[m]
    )
    np.testing.assert_allclose(np.asarray(h1.t)[m], np.asarray(h2.t)[m], rtol=1e-6)


def test_native_build_speed(native_available):
    import time

    rng = np.random.default_rng(0)
    n = 200_000
    lo, hi = _random_aabbs(rng, n)
    t0 = time.monotonic()
    bvh = build_bvh_native(lo, hi, leaf_size=4)
    dt = time.monotonic() - t0
    _check_invariants(bvh, n, 4)
    # native build should handle 200k prims in well under 10s
    assert dt < 10.0, f"native build too slow: {dt:.1f}s"


def test_numpy_builder_subnormal_extent():
    """A positive-but-float32-subnormal centroid extent must not overflow
    the SAH bin scale (float32 divide -> inf -> NaN bins -> IndexError);
    the scale is float64 and bins are clipped."""
    import numpy as np

    from hijiki.accel.bvh import build_bvh

    eps = 2e-38  # below the float32 normal minimum (~1.18e-38)
    centers = np.array([[0, 0, 0], [eps, 0, 0], [2 * eps, 0, 0]], np.float64)
    h = 1e-40
    bvh = build_bvh(
        (centers - h).astype(np.float32),
        (centers + h).astype(np.float32),
        backend="numpy",
    )
    assert bvh.count.sum() >= 0  # built without crashing
    assert len(bvh.prim_order) == 3
