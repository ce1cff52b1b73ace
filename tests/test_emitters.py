"""Emitter-type coverage: sphere and quad emitters (cbox's light is triangles)
through the oracle and the XLA integrator's two BVH walkers (trace rows and
the direct threaded walk); plus the gather fallback for emitter counts
beyond the unroll limit."""

import numpy as np
import pytest

# fast per-commit gate tier (README: python -m pytest tests -m quick)
pytestmark = pytest.mark.quick


def _scene_with(emitter_kind):
    from hijiki.scene.model import (
        Camera, Diffuse, Emissive, Quad, Scene, Sphere
    )

    s = Scene(camera=Camera.cbox_default())
    white = s.add_material(Diffuse((0.6, 0.6, 0.6)))
    light = s.add_material(Emissive((8.0, 8.0, 8.0)))
    s.add_object(Quad((-2, 0, -2), (4, 0, 0), (0, 0, 4)), white)  # floor
    if emitter_kind == "sphere":
        s.add_object(Sphere((0.0, 2.0, 0.0), 0.4), light)
    else:
        s.add_object(Quad((-0.5, 2.5, -0.5), (1, 0, 0), (0, 0, 1)), light)
    s.add_object(Sphere((0.0, 0.6, 0.5), 0.5), white)
    return s


@pytest.mark.parametrize("kind", ["sphere", "quad"])
def test_emitter_kinds_all_backends(kind):
    import jax.numpy as jnp

    from hijiki.ops.camera import camera_rays
    from hijiki.ops.integrate import integrate
    from hijiki.ops.oracle import integrate_ray_oracle
    from hijiki.ops.rng import seed_rng
    from hijiki.scene.compile import compile_scene, scene_to_device

    s = _scene_with(kind)
    cs_host = compile_scene(s)
    cs = scene_to_device(cs_host)
    W = H = 32
    N = W * H
    y, x = np.mgrid[0:H, 0:W]
    px = jnp.asarray((x + 0.55).ravel().astype(np.float32))
    py = jnp.asarray((y + 0.44).ravel().astype(np.float32))
    seeds = jnp.asarray((np.arange(N) * 362437 % (1 << 32)).astype(np.uint32))

    pxy = jnp.stack([px, py], -1)
    o, d, tmin, tmax = camera_rays(
        cs.cam_position, cs.cam_rotation, cs.cam_fov, pxy, jnp.asarray([W, H], jnp.float32)
    )
    out = integrate(cs, o, d, tmin, tmax, seed_rng(seeds), max_bounces=16, traversal="rows")
    assert float(jnp.mean(out.total)) > 0.002, "emitter contributes light"

    # the direct threaded-BVH walk agrees with the trace-row walk
    alt = integrate(cs, o, d, tmin, tmax, seed_rng(seeds), max_bounces=16, traversal="bvh")
    total, state = alt.total, alt.state
    same = np.asarray(state) == np.asarray(out.state)
    assert same.mean() >= 0.995
    # occlusion/backface gates consume no RNG, so a grazing shadow ray can
    # flip on f32 ULP without diverging the stream; require >=99% exact-ish
    # pixels and matching means
    tm, to = np.asarray(total), np.asarray(out.total)
    close = np.isclose(tm, to, rtol=2e-3, atol=2e-3).all(axis=-1)
    assert (close | ~same).mean() >= 0.99 or close[same].mean() >= 0.99
    np.testing.assert_allclose(tm.mean(), to.mean(), rtol=0.02, atol=1e-4)

    # scalar oracle agrees on a few pixels (NEE math for this emitter kind)
    o_np, d_np = np.asarray(o), np.asarray(d)
    for i in (264, 520, 777):
        ref = integrate_ray_oracle(cs_host, o_np[i], d_np[i], int(seeds[i]), max_bounces=16)
        assert np.uint32(np.asarray(out.state)[i]) == ref["state"]
        np.testing.assert_allclose(
            np.asarray(out.total)[i], ref["total"], rtol=2e-3, atol=2e-4
        )


def test_many_emitters_gather_fallback():
    """>8 emitters: sample_emitter's gather path (vs the static unroll)."""
    import jax.numpy as jnp

    from hijiki.ops.emitter import sample_emitter, _UNROLL_EMITTERS
    from hijiki.ops.rng import seed_rng
    from hijiki.scene.compile import compile_scene, scene_to_device
    from hijiki.scene.model import Camera, Diffuse, Emissive, Quad, Scene, Sphere

    s = Scene(camera=Camera.cbox_default())
    white = s.add_material(Diffuse((0.5, 0.5, 0.5)))
    s.add_object(Quad((-3, 0, -3), (6, 0, 0), (0, 0, 6)), white)
    for i in range(12):  # > _UNROLL_EMITTERS
        li = s.add_material(Emissive((1.0 + i, 2.0, 3.0)))
        s.add_object(Sphere((i - 6.0, 3.0, 0.0), 0.2), li)
    cs = scene_to_device(compile_scene(s))
    assert cs.num_emitters > _UNROLL_EMITTERS

    n = 64
    state = seed_rng(jnp.arange(n, dtype=jnp.uint32))
    ref_p = jnp.tile(jnp.asarray([[0.0, 0.5, 0.0]], jnp.float32), (n, 1))
    new_state, es = sample_emitter(cs, state, ref_p, jnp.ones(n, bool))
    imp = np.asarray(es.importance)
    assert np.isfinite(imp).all()
    assert (imp >= 0).all() and imp.max() > 0
    assert not np.array_equal(np.asarray(new_state), np.asarray(state))


def test_pick_thresholds_match_reference_scan():
    """emitter_pick_thresholds must reproduce the reference's running-
    subtraction scan (scene.glsl:57-64) for every u, including the
    cumsum-divergent edge (three equal f32 pdfs: chain at u=1.0 ends
    negative -> emitter 2, while a cumsum cdf of exactly 1.0 would fall
    back to emitter 0)."""
    import numpy as np

    from hijiki.scene.compile import emitter_pick_thresholds

    def reference_pick(u, pdf):
        r = np.float32(u)
        for i, p in enumerate(pdf):
            r = np.float32(r - np.float32(p))
            if r < 0:
                return i
        return 0

    def threshold_pick(u, C):
        for i, c in enumerate(C):
            if u < c:
                return i
        return 0

    rng = np.random.default_rng(0)
    for pdf in (
        np.full(3, np.float32(1.0 / 3.0)),
        np.full(7, np.float32(1.0 / 7.0)),
        np.float32(rng.dirichlet(np.ones(5))),
        np.array([1.0], np.float32),
    ):
        C = emitter_pick_thresholds(pdf)
        us = list(np.float32(rng.random(400)))
        us += [np.float32(1.0), np.float32(0.0)]
        for c in C:  # probe both sides of every threshold
            us += [c, np.nextafter(c, np.float32(0.0), dtype=np.float32),
                   np.nextafter(c, np.float32(2.0), dtype=np.float32)]
        for u in us:
            assert threshold_pick(u, C) == reference_pick(u, pdf), (u, pdf, C)
