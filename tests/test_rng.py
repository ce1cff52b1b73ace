"""RNG bit-exactness: jnp vs numpy vs a direct scalar transcription of
``shader/rand.glsl``."""

import jax.numpy as jnp
import numpy as np

from hijiki.ops import rng
import pytest


# fast per-commit gate tier (README: python -m pytest tests -m quick)
pytestmark = pytest.mark.quick


def scalar_wang(seed: int) -> int:
    M = 0xFFFFFFFF
    seed = ((seed ^ 61) ^ (seed >> 16)) & M
    seed = (seed * 9) & M
    seed = (seed ^ (seed >> 4)) & M
    seed = (seed * 0x27D4EB2D) & M
    seed = (seed ^ (seed >> 15)) & M
    return seed


def scalar_xorshift(s: int) -> int:
    M = 0xFFFFFFFF
    s ^= (s << 13) & M
    s ^= s >> 17
    s ^= (s << 5) & M
    return s & M


def test_wang_hash_matches_scalar():
    seeds = np.array([0, 1, 61, 12345, 0xDEADBEEF, 0xFFFFFFFF], dtype=np.uint32)
    expected = np.array([scalar_wang(int(s)) for s in seeds], dtype=np.uint32)
    np.testing.assert_array_equal(np.asarray(rng.wang_hash(jnp.asarray(seeds))), expected)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(rng.wang_hash(seeds), expected)


def test_xorshift_stream_matches_scalar():
    state = rng.seed_rng(jnp.asarray([12345, 999], dtype=jnp.uint32))
    s0 = scalar_wang(12345)
    s1 = scalar_wang(999)
    for _ in range(100):
        state, bits = rng.rand_uint(state)
        s0 = scalar_xorshift(s0)
        s1 = scalar_xorshift(s1)
        np.testing.assert_array_equal(np.asarray(bits), np.array([s0, s1], np.uint32))


def test_numpy_jnp_bitwise_identical():
    seeds = np.arange(1000, dtype=np.uint32) * np.uint32(2654435761)
    with np.errstate(over="ignore"):
        s_np = rng.seed_rng(seeds)
    s_j = rng.seed_rng(jnp.asarray(seeds))
    for _ in range(20):
        with np.errstate(over="ignore"):
            s_np, f_np = rng.rand_uniform_float(s_np, np)
        s_j, f_j = rng.rand_uniform_float(s_j, jnp)
        np.testing.assert_array_equal(s_np, np.asarray(s_j))
        np.testing.assert_array_equal(f_np, np.asarray(f_j))


def test_unit_float_rounding_edge():
    # float(0xFFFFFFFF) rounds to 4294967296.0 => exactly 1.0, like GLSL.
    bits = jnp.asarray([0, 1, 0xFFFFFFFF, 0x80000000], dtype=jnp.uint32)
    f = rng.uint_to_unit_float(bits, jnp)
    np.testing.assert_array_equal(
        np.asarray(f), np.array([0.0, 2.0**-32, 1.0, 0.5], np.float32)
    )


def test_cos_hemisphere_distribution():
    state = rng.seed_rng(jnp.arange(20000, dtype=jnp.uint32))
    state, (x, y, z) = rng.rand_cos_hemisphere(state, jnp)
    assert float(jnp.min(z)) >= 0.0
    r = np.asarray(x) ** 2 + np.asarray(y) ** 2 + np.asarray(z) ** 2
    np.testing.assert_allclose(r, 1.0, atol=1e-5)
    # E[cos(theta)] = 2/3 for pdf = cos/pi
    assert abs(float(jnp.mean(z)) - 2.0 / 3.0) < 0.01


def test_barycentric_in_simplex():
    state = rng.seed_rng(jnp.arange(10000, dtype=jnp.uint32) + jnp.uint32(7))
    state, (u, v, w) = rng.rand_barycentric(state, jnp)
    for comp in (u, v, w):
        assert float(jnp.min(comp)) >= 0.0
        assert float(jnp.max(comp)) <= 1.0
    np.testing.assert_allclose(np.asarray(u + v + w), 1.0, atol=1e-6)
