"""Intersection: analytic cases, BVH-vs-brute-force equivalence (the
framework's version of the reference's --use-bvh A/B cross-check)."""

import jax.numpy as jnp
import numpy as np

from hijiki.ops.intersect import (
    intersect_brute,
    intersect_bvh,
    occluded_bvh,
    populate_intersection,
)
from hijiki.scene.compile import compile_scene, scene_to_device
from hijiki.scene.model import Camera, Diffuse, Quad, Scene, Sphere, Triangle


def _mini_scene():
    s = Scene(camera=Camera.cbox_default())
    m = s.add_material(Diffuse((0.5, 0.5, 0.5)))
    s.add_object(Sphere((0.0, 0.0, -5.0), 1.0), m)
    s.add_object(Quad((-1.0, -1.0, -10.0), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0)), m)
    s.positions = np.array([[0, 0, -3], [1, 0, -3], [0, 1, -3]], np.float32)
    s.normals = np.array([[0, 0, 1]] * 3, np.float32)
    s.uvs = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    s.add_object(Triangle((0, 1, 2)), m)
    return scene_to_device(compile_scene(s))


def test_analytic_hits():
    cs = _mini_scene()
    o = jnp.array([[-0.2, -0.2, 0.0], [0.25, 0.25, 0.0], [0.1, 0.1, 0.0]], jnp.float32)
    d = jnp.array([[0.0, 0.0, -1.0]] * 3, jnp.float32)
    tmin = jnp.full(3, 1e-4, jnp.float32)
    tmax = jnp.full(3, jnp.inf, jnp.float32)
    hit = intersect_brute(o, d, tmin, tmax, scene=cs)
    assert bool(hit.valid.all())
    t_sphere = 5.0 - np.sqrt(1.0 - 0.08)  # off-axis sphere hit
    np.testing.assert_allclose(np.asarray(hit.t), [t_sphere, 3.0, 3.0], rtol=1e-6)
    # ray 0: sphere (shape 0); rays 1,2: triangle (shape 2, in front of quad)
    np.testing.assert_array_equal(np.asarray(hit.shape_id), [0, 2, 2])
    its = populate_intersection(o, d, hit, cs)
    np.testing.assert_allclose(
        np.asarray(its.n[1:]), [[0, 0, 1]] * 2, atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(its.p[0, 2]), -t_sphere, atol=1e-6)
    # triangle barycentric uv interpolation
    np.testing.assert_allclose(np.asarray(its.uv[1]), [0.25, 0.25], atol=1e-6)


def test_sphere_inside_hit():
    cs = _mini_scene()
    # origin inside the sphere: near root is behind tmin, far root hits
    o = jnp.array([[0.0, 0.0, -5.0]], jnp.float32)
    d = jnp.array([[0.0, 0.0, -1.0]], jnp.float32)
    hit = intersect_brute(o, d, jnp.full(1, 1e-4), jnp.full(1, jnp.inf), scene=cs)
    assert bool(hit.valid[0])
    np.testing.assert_allclose(float(hit.t[0]), 1.0, rtol=1e-6)


def test_bvh_matches_brute_force_on_cbox(cbox_compiled, rng_np):
    cs = cbox_compiled
    n = 512
    # random rays from a box around the scene, random directions
    o = rng_np.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    o[:, 1] += 1.0
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    hb = intersect_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax), scene=cs)
    hv = intersect_bvh(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax), scene=cs)
    np.testing.assert_array_equal(np.asarray(hb.valid), np.asarray(hv.valid))
    m = np.asarray(hb.valid)
    np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(hv.t)[m], rtol=1e-6)
    # same winning primitive except exact-t ties (none expected on random rays)
    assert np.array_equal(np.asarray(hb.shape_id)[m], np.asarray(hv.shape_id)[m])


def test_occlusion_matches_closest_hit(cbox_compiled, rng_np):
    cs = cbox_compiled
    n = 256
    o = rng_np.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    o[:, 1] += 1.0
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 2e-4, np.float32)
    tmax = rng_np.uniform(0.05, 3.0, n).astype(np.float32)
    occ = occluded_bvh(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax), scene=cs)
    hit = intersect_bvh(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax), scene=cs)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(hit.valid))
