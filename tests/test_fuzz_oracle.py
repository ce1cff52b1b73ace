"""Randomized-scene integrator-vs-oracle fuzz: the cbox oracle tests
(test_integrate.py) pin real-scene paths; this builds seeded random scenes —
triangle soup + analytic spheres/quads, all five material types, sphere and
quad emitters — and checks the vectorized integrator consumes the exact
per-path RNG stream of the scalar oracle (identical sampling decisions,
``shader/render.glsl:92-144`` semantics) and matches its radiance/AOVs.

Scenes and pixels are fixed by seed, so the test is deterministic; the
tolerance absorbs only FMA/ULP noise, not decision divergence (the RNG
state equality would catch that first).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hijiki.ops.camera import camera_rays
from hijiki.ops.integrate import integrate
from hijiki.ops.oracle import integrate_ray_oracle
from hijiki.ops.rng import seed_rng
from hijiki.scene.compile import compile_scene, scene_to_device
from hijiki.scene.model import (
    Camera,
    Dielectric,
    Diffuse,
    DiffuseCheckerboard,
    Emissive,
    Mirror,
    Quad,
    Scene,
    Sphere,
    Triangle,
)


def _add_tri(scene: Scene, rng, center, mat):
    v = center + rng.uniform(-0.35, 0.35, (3, 3))
    n = np.cross(v[1] - v[0], v[2] - v[0])
    ln = np.linalg.norm(n)
    if ln < 1e-6:
        return
    n = (n / ln).astype(np.float32)
    base = len(scene.positions)
    scene.positions = np.concatenate(
        [scene.positions, v.astype(np.float32)]
    )
    scene.normals = np.concatenate(
        [scene.normals, np.repeat(n[None], 3, axis=0)]
    )
    scene.uvs = np.concatenate(
        [scene.uvs, rng.random((3, 2), dtype=np.float32)]
    )
    scene.add_object(Triangle((base, base + 1, base + 2)), mat)


def random_scene(seed: int) -> Scene:
    rng = np.random.default_rng(seed)
    scene = Scene(camera=Camera.cbox_default())
    m_diff = scene.add_material(Diffuse(tuple(rng.uniform(0.2, 0.9, 3))))
    m_cb = scene.add_material(
        DiffuseCheckerboard(
            tuple(rng.uniform(0.2, 0.9, 3)),
            float(rng.uniform(2, 8)),
            tuple(rng.uniform(0.2, 0.9, 3)),
            float(rng.uniform(2, 8)),
        )
    )
    m_mir = scene.add_material(Mirror())
    m_die = scene.add_material(
        Dielectric(tuple(rng.uniform(0.0, 0.4, 3)), float(rng.uniform(1.3, 1.7)))
    )
    m_em = scene.add_material(Emissive(tuple(rng.uniform(5.0, 20.0, 3))))

    # quad emitter (ceiling-ish) + sphere emitter: exercises both emitter
    # kinds in sampleEmitter (shader/scene.glsl:54-89)
    scene.add_object(
        Quad((-0.4, 1.95, -0.4), (0.8, 0.0, 0.0), (0.0, 0.0, 0.8)), m_em
    )
    scene.add_object(Sphere(tuple(rng.uniform(-0.8, 0.8, 3) + [0, 1, 0]), 0.12), m_em)

    # floor quad so most paths hit something diffuse
    scene.add_object(
        Quad((-2.0, 0.0, -2.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0)), m_diff
    )
    mats = [m_diff, m_cb, m_mir, m_die]
    for _ in range(2):
        scene.add_object(
            Sphere(tuple(rng.uniform(-1, 1, 3) + [0, 0.9, 0]),
                   float(rng.uniform(0.15, 0.4))),
            mats[rng.integers(0, len(mats))],
        )
    for _ in range(12):
        center = rng.uniform(-1, 1, 3) + np.array([0, 0.9, 0])
        _add_tri(scene, rng, center, int(mats[rng.integers(0, len(mats))]))
    return scene


PIXELS = [(32, 32), (10, 40), (50, 20), (24, 56), (44, 44), (16, 16)]


@pytest.mark.parametrize("scene_seed", [11, 22, 33])
@pytest.mark.parametrize("use_bvh", [False, True])
def test_random_scene_matches_oracle(scene_seed, use_bvh):
    scene = random_scene(scene_seed)
    cs_host = compile_scene(scene)
    cs_dev = scene_to_device(cs_host)
    W = H = 64
    px = jnp.asarray([[x + 0.5, y + 0.5] for (x, y) in PIXELS], jnp.float32)
    o, d, tmin, tmax = camera_rays(
        cs_dev.cam_position,
        cs_dev.cam_rotation,
        cs_dev.cam_fov,
        px,
        jnp.asarray([W, H], jnp.float32),
    )
    seeds = jnp.asarray(
        [scene_seed * 100 + i for i in range(len(PIXELS))], jnp.uint32
    )
    state = seed_rng(seeds)
    out = integrate(
        cs_dev, o, d, tmin, tmax, state, use_bvh=use_bvh, max_bounces=32
    )
    o_np, d_np = np.asarray(o), np.asarray(d)
    for i in range(len(PIXELS)):
        ref = integrate_ray_oracle(
            cs_host, o_np[i], d_np[i], scene_seed * 100 + i, max_bounces=32
        )
        assert np.uint32(np.asarray(out.state)[i]) == ref["state"], (
            f"scene {scene_seed} pixel {i}: RNG stream diverged"
        )
        np.testing.assert_allclose(
            np.asarray(out.total)[i], ref["total"], rtol=2e-3, atol=2e-4,
            err_msg=f"scene {scene_seed} pixel {i} radiance",
        )
        np.testing.assert_allclose(
            np.asarray(out.depth)[i], ref["depth"], rtol=1e-4,
            err_msg=f"scene {scene_seed} pixel {i} depth",
        )


def test_random_scene_wavefront_matches_sync():
    """Second production driver on a random scene: the regenerating wavefront
    pool must reproduce the sync driver's film (identical paths and RNG
    streams; only summation order / FMA fusion may differ)."""
    from hijiki.render.renderer import RenderConfig, Renderer

    scene = random_scene(55)
    cs = compile_scene(scene)
    films = {}
    for driver, extra in (("sync", {}), ("wavefront", dict(wavefront_lanes=512))):
        r = Renderer(
            cs,
            RenderConfig(width=32, height=32, spp=2, block_size=64, seed=5,
                         max_bounces=16, driver=driver, **extra),
        )
        r.render()
        films[driver] = np.asarray(r.film)
    np.testing.assert_allclose(
        films["wavefront"], films["sync"], rtol=1e-4, atol=2e-4
    )
