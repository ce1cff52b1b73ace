"""Counter-free per-lane RNG: xorshift32 state + Thomas Wang hash seeding.

Bit-exact reimplementation of the reference RNG (``shader/rand.glsl:1-50``):
each ray/path carries an explicit uint32 state; all helpers are pure functions
``state -> (state', value)`` so they vectorize over ray batches in jnp and
also run on numpy scalars (the oracles). Conditional (masked) consumption — the
reference consumes randoms data-dependently (NEE only for diffuse, Fresnel
coin only without TIR, RR only after bounce 3) — is expressed by updating the
state with ``jnp.where(pred, new_state, state)``, keeping per-path streams
identical to the reference's divergent execution.

All functions accept either jnp or numpy uint32 arrays (the module only uses
operators), so the same code is the device implementation and the host oracle.
"""

from __future__ import annotations

import numpy as np

# 2 * pi as the f32 GLSL literal `2*M_PI` evaluates to.
_TWO_PI = np.float32(2.0) * np.float32(3.1415926535897932384626433832795)


def wang_hash(seed):
    """Thomas Wang's integer hash; reference ``shader/rand.glsl:9-16``."""
    seed = np.uint32(seed) if np.isscalar(seed) else seed
    seed = (seed ^ np.uint32(61)) ^ (seed >> np.uint32(16))
    seed = seed * np.uint32(9)
    seed = seed ^ (seed >> np.uint32(4))
    seed = seed * np.uint32(0x27D4EB2D)
    seed = seed ^ (seed >> np.uint32(15))
    return seed


def seed_rng(seed):
    """``seedRng``: initial state = wang_hash(seed). ``shader/rand.glsl:9-16``."""
    return wang_hash(seed)


def rand_uint(state):
    """xorshift32 step; returns (new_state, new_state). ``shader/rand.glsl:2-7``."""
    state = state ^ (state << np.uint32(13))
    state = state ^ (state >> np.uint32(17))
    state = state ^ (state << np.uint32(5))
    return state, state


def uint_to_unit_float(bits, xp):
    """``randUniformFloat``: float(u32) * 2^-32. ``shader/rand.glsl:18-20``.

    GLSL's float(uint) rounds to nearest f32, so 0xFFFFFFFF yields exactly 1.0;
    the astype below matches that rounding.
    """
    return bits.astype(xp.float32) * xp.float32(1.0 / 4294967296.0)


def rand_uniform_float(state, xp):
    """One xorshift draw mapped to [0, 1] f32 (1.0 inclusive — see above)."""
    state, bits = rand_uint(state)
    return state, uint_to_unit_float(bits, xp)


def rand_cos_hemisphere(state, xp):
    """Cosine-weighted hemisphere sample around +z. ``shader/rand.glsl:22-30``.

    Returns (state, (x, y, z)) consuming exactly two draws (u then v).
    """
    state, u = rand_uniform_float(state, xp)
    state, v = rand_uniform_float(state, xp)
    r = xp.sqrt(u)
    theta = _TWO_PI * v
    x = r * xp.cos(theta)
    y = r * xp.sin(theta)
    z = xp.sqrt(xp.maximum(xp.float32(0.0), xp.float32(1.0) - u))
    return state, (x, y, z)


def rand_uniform_sphere(state, xp):
    """Uniform direction on the unit sphere. ``shader/rand.glsl:32-40``."""
    state, u = rand_uniform_float(state, xp)
    state, v = rand_uniform_float(state, xp)
    z = xp.float32(2.0) * u - xp.float32(1.0)
    theta = _TWO_PI * v
    r = xp.sqrt(xp.float32(1.0) - z * z)
    return state, (r * xp.cos(theta), r * xp.sin(theta), z)


def rand_barycentric(state, xp):
    """Uniform barycentric coordinates. ``shader/rand.glsl:42-50``.

    Reproduces the reference's fold exactly, including its quirk: when
    u + v > 1 it sets u = 1 - v *then* v = 1 - u using the *new* u, i.e.
    v = 1 - (1 - v) = v. (GLSL executes the two statements sequentially, so
    the second reads the already-updated u.)
    """
    state, u = rand_uniform_float(state, xp)
    state, v = rand_uniform_float(state, xp)
    over = u + v > xp.float32(1.0)
    new_u = xp.float32(1.0) - v
    new_v = xp.float32(1.0) - new_u  # == v, faithfully mirroring the quirk
    u = xp.where(over, new_u, u)
    v = xp.where(over, new_v, v)
    return state, (u, v, xp.float32(1.0) - u - v)
