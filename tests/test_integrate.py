"""Integrator vs the scalar oracle: identical per-path RNG streams and
matching radiance on real cbox paths (diffuse, emissive, NEE, mirror,
checkerboard, Russian roulette all exercised)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hijiki.ops.camera import camera_rays
from hijiki.ops.integrate import integrate
from hijiki.ops.oracle import integrate_ray_oracle
from hijiki.ops.rng import seed_rng
from hijiki.scene.cbox_mesh import CBOX_OBJ
from hijiki.scene.compile import compile_scene, scene_to_device
from hijiki.scene.obj import load_obj_scene


@pytest.fixture(scope="module")
def scenes():
    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    cs_host = compile_scene(scene)
    return cs_host, scene_to_device(cs_host)


# Pixel coords on a 64x64 render + seeds; chosen to hit a mix of materials
# (walls, teapot, mirror sphere, checkerboard sphere, light).
PIXELS = [
    (32, 32, 1),
    (8, 32, 2),
    (32, 12, 3),
    (18, 44, 4),
    (48, 42, 5),
    (33, 6, 6),
]


@pytest.mark.parametrize("use_bvh", [False, True])
def test_integrator_matches_oracle(scenes, use_bvh):
    cs_host, cs_dev = scenes
    W = H = 64
    px = jnp.asarray(
        [[x + 0.5, y + 0.5] for (x, y, _) in PIXELS], jnp.float32
    )
    o, d, tmin, tmax = camera_rays(
        cs_dev.cam_position,
        cs_dev.cam_rotation,
        cs_dev.cam_fov,
        px,
        jnp.asarray([W, H], jnp.float32),
    )
    seeds = jnp.asarray([s for (_, _, s) in PIXELS], jnp.uint32)
    state = seed_rng(seeds)
    out = integrate(cs_dev, o, d, tmin, tmax, state, use_bvh=use_bvh, max_bounces=64)

    o_np, d_np = np.asarray(o), np.asarray(d)
    for i, (_, _, seed) in enumerate(PIXELS):
        ref = integrate_ray_oracle(cs_host, o_np[i], d_np[i], seed, max_bounces=64)
        # Identical RNG consumption -> identical final state.
        assert np.uint32(np.asarray(out.state)[i]) == ref["state"], (
            f"pixel {i}: RNG stream diverged"
        )
        np.testing.assert_allclose(
            np.asarray(out.total)[i], ref["total"], rtol=2e-3, atol=2e-4,
            err_msg=f"pixel {i} radiance mismatch",
        )
        np.testing.assert_allclose(
            np.asarray(out.depth)[i], ref["depth"], rtol=1e-4,
            err_msg=f"pixel {i} depth mismatch",
        )
        np.testing.assert_allclose(
            np.asarray(out.normal)[i], ref["normal"], rtol=1e-3, atol=1e-4,
            err_msg=f"pixel {i} normal mismatch",
        )


def test_dielectric_path_matches_oracle():
    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    scene.put_dielectric_sphere()  # third sphere: clear glass at cbox position
    # Move it so it doesn't coincide with the checkerboard sphere.
    from hijiki.scene.model import Sphere

    shape, mat = scene.objects[-1]
    scene.objects[-1] = (Sphere((0.0, 0.35, 0.9), 0.3), mat)
    cs_host = compile_scene(scene)
    cs_dev = scene_to_device(cs_host)

    W = H = 64
    # Rays aimed at the glass sphere region (lower center of image).
    pixels = [(31, 40, 11), (33, 42, 12), (32, 41, 13), (30, 43, 14)]
    px = jnp.asarray([[x + 0.5, y + 0.5] for (x, y, _) in pixels], jnp.float32)
    o, d, tmin, tmax = camera_rays(
        cs_dev.cam_position,
        cs_dev.cam_rotation,
        cs_dev.cam_fov,
        px,
        jnp.asarray([W, H], jnp.float32),
    )
    seeds = jnp.asarray([s for (_, _, s) in pixels], jnp.uint32)
    out = integrate(cs_dev, o, d, tmin, tmax, seed_rng(seeds), max_bounces=64)
    o_np, d_np = np.asarray(o), np.asarray(d)
    hit_glass = 0
    for i, (_, _, seed) in enumerate(pixels):
        ref = integrate_ray_oracle(cs_host, o_np[i], d_np[i], seed, max_bounces=64)
        assert np.uint32(np.asarray(out.state)[i]) == ref["state"]
        np.testing.assert_allclose(
            np.asarray(out.total)[i], ref["total"], rtol=2e-3, atol=2e-4
        )
        if ref["depth"] < 4.6:  # glass sphere is ~4.5 units from camera
            hit_glass += 1
    assert hit_glass > 0, "test rays should exercise the dielectric"
