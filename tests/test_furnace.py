"""Closed-form estimator validation: a closed emissive box ("furnace").

Every wall of a closed box emits radiance L uniformly, so the incident
radiance at any interior point is exactly L from every direction. The
reference's estimator (shader/render.glsl:81-146 semantics) then has
closed-form pixel values we can assert against:

- emissive wall seen directly:    L            (wasDiscrete first hit)
- diffuse sphere, albedo rho:     rho * L      (one NEE estimate; the BSDF
                                                bounce lands on an emissive
                                                wall with wasDiscrete=false,
                                                adding nothing, and dies)
- mirror sphere:                  L            (deterministic reflect ->
                                                discrete emitter hit)
- clear dielectric sphere:        L            (stochastic Fresnel choice
                                                with unit throughput: every
                                                path ends on a wall)

Neither the reference nor round 1 had an analytic ground-truth test; this
pins the NEE weights, emitter pdf conversion (area -> solid angle), the
discrete-hit accounting, and dielectric energy conservation to numbers
derived outside the implementation.
"""

import numpy as np
import pytest


def _furnace_scene(sphere_material, L=1.0):
    from hijiki.scene.model import (
        Camera,
        Emissive,
        Quad,
        Scene,
        Sphere,
    )

    cam = Camera(
        position=np.array([0.0, 0.0, 1.0], dtype=np.float32),
        rotation=np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32),  # -z
        fov=60.0,
    )
    s = Scene(camera=cam)
    light = s.add_material(Emissive((L, L, L)))
    mat = s.add_material(sphere_material)

    # box [-4,4]^3, edge order chosen so cross(e1,e2) points INWARD (the
    # emitter pdf is zero for backfacing samples — scene.glsl:82-86)
    E = 8.0
    walls = [
        ((-4, -4, -4), (0, 0, E), (E, 0, 0)),  # floor  y=-4, n=+y
        ((-4, 4, -4), (E, 0, 0), (0, 0, E)),   # ceil   y=+4, n=-y
        ((-4, -4, -4), (E, 0, 0), (0, E, 0)),  # back   z=-4, n=+z
        ((-4, -4, 4), (0, E, 0), (E, 0, 0)),   # front  z=+4, n=-z
        ((-4, -4, -4), (0, E, 0), (0, 0, E)),  # left   x=-4, n=+x
        ((4, -4, -4), (0, 0, E), (0, E, 0)),   # right  x=+4, n=-x
    ]
    for origin, e1, e2 in walls:
        s.add_object(Quad(origin, e1, e2), light)
    s.add_object(Sphere((0.0, 0.0, -1.5), 1.0), mat)
    return s


def _render_center(scene, spp, seed=11):
    from hijiki.render.renderer import RenderConfig, Renderer
    from hijiki.scene.compile import compile_scene, scene_to_device

    cs = scene_to_device(compile_scene(scene))
    cfg = RenderConfig(
        width=64, height=64, spp=spp, block_size=64, seed=seed,
        max_bounces=32, driver="sync",
    )
    r = Renderer(cs, cfg)
    r.render()
    img = r.image()
    # center 12x12 px: well inside the sphere silhouette (angular radius
    # asin(1/2.5)=23.6 deg ~ 24 px vs the 32 px fov half-width)
    c = img[26:38, 26:38]
    # a wall region: top-left corner rays miss the sphere
    w = img[0:4, 0:4]
    return c, w


def test_furnace_diffuse_half_albedo():
    from hijiki.scene.model import Diffuse

    c, w = _render_center(_furnace_scene(Diffuse((0.5, 0.5, 0.5))), spp=32)
    # walls are noise-free: the camera ray hits the emitter discretely
    np.testing.assert_allclose(w, 1.0, atol=1e-5)
    # sphere: one-sample NEE per path; mean over 100 px * 32 spp
    assert abs(float(c.mean()) - 0.5) < 0.02, float(c.mean())


def test_furnace_mirror_unit_radiance():
    from hijiki.scene.model import Mirror

    c, w = _render_center(_furnace_scene(Mirror()), spp=4)
    np.testing.assert_allclose(w, 1.0, atol=1e-5)
    # deterministic: reflect -> wall, radiance exactly L
    np.testing.assert_allclose(c, 1.0, atol=1e-4)


def test_furnace_dielectric_energy_conservation():
    from hijiki.scene.model import Dielectric

    c, w = _render_center(_furnace_scene(Dielectric.clear(1.5)), spp=8)
    np.testing.assert_allclose(w, 1.0, atol=1e-5)
    # every path carries unit throughput to a wall regardless of the
    # Fresnel coin; only RR survival weighting adds noise
    assert abs(float(c.mean()) - 1.0) < 0.02, float(c.mean())
