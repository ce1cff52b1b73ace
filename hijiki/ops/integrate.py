"""The wavefront path integrator.

Vectorized re-architecture of the reference megakernel ``integrateRay``
(``shader/render.glsl:81-146``): instead of one divergent thread per path, the
whole ray batch advances bounce-synchronously through batched stages —
intersect, AOV record, Beer-Lambert attenuation, emissive accumulation,
next-event estimation (second traversal for shadow rays), BSDF sampling,
Russian roulette — with per-lane live masks. The Monte-Carlo estimator is
identical to the reference's:

* emitter radiance is added only when the previous bounce was discrete
  (``wasDiscrete``, avoids double-counting with NEE; render.glsl:114-116,135),
* NEE runs for diffuse/checkerboard hits with the backface/eps gates of
  render.glsl:117-126,
* Russian roulette after bounce 3 with q = min(0.99, max throughput channel)
  (render.glsl:137-144) — including the reference's q=0 division when a path
  already has zero throughput,
* per-path RNG consumption is predicated identically, so per-path streams
  match the reference's divergent execution draw-for-draw.

Emissive hits do not terminate paths (reference behaviour: throughput goes to
zero and RR eventually kills the path — zombie bounces consume RNG exactly as
the reference does).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hijiki.ops import rng
from hijiki.ops.bsdf import _clamp_gather, eval_bsdf, sample_bsdf, split_handle
from hijiki.ops.emitter import sample_emitter
from hijiki.ops.intersect import (
    M_EPS,
    intersect_brute,
    intersect_bvh,
    intersect_rows,
    occluded_bvh,
    occluded_rows,
    populate_intersection,
)
from hijiki.scene.compile import CompiledScene
from hijiki.utils.vma import match_vma
from hijiki.scene.model import (
    TAG_DIFFUSE,
    TAG_DIFFUSECBOARD,
    TAG_EMISSIVE,
)


class RenderOutputs(NamedTuple):
    """Per-lane AOVs, mirroring the 3 output layers of render.glsl:172-174."""

    total: jnp.ndarray  # (N,3) radiance
    normal: jnp.ndarray  # (N,3) first-hit shading normal
    depth: jnp.ndarray  # (N,) first-hit t
    albedo: jnp.ndarray  # (N,3) — always zero (reference quirk render.glsl:84-85)
    state: jnp.ndarray  # (N,) u32 final RNG state


def _occluded_brute(o, d, tmin, tmax, active=None, *, scene):
    hit = intersect_brute(o, d, tmin, tmax, scene=scene)
    return hit.valid


def make_intersectors(scene: CompiledScene, traversal: str, leaf_size: int = 1):
    """(closest_hit, any_hit) functions for the chosen traversal backend."""
    if traversal == "rows":
        return (
            partial(intersect_rows, scene=scene),
            partial(occluded_rows, scene=scene),
        )
    if traversal == "bvh":
        return (
            partial(intersect_bvh, scene=scene, leaf_size=leaf_size),
            partial(occluded_bvh, scene=scene, leaf_size=leaf_size),
        )
    if traversal == "brute":
        return (
            partial(intersect_brute, scene=scene),
            partial(_occluded_brute, scene=scene),
        )
    raise ValueError(f"unknown traversal {traversal!r}")

# All intersectors share the signature (o, d, tmin, tmax, active=None).


def bounce_step(
    scene: CompiledScene, s: dict, intersect, occluded, albedo_aov: bool = False
) -> dict:
    """One wavefront bounce over the lane batch: intersect, record first-hit
    AOVs, Beer-Lambert attenuation, emissive accumulation, NEE + shadow ray,
    BSDF sampling, Russian roulette. ``s`` holds per-lane state including a
    per-lane ``bounce`` counter (so the bulk-synchronous and regenerating
    drivers share this body). Returns the updated state dict.

    Semantics are the reference megakernel's (render.glsl:92-145) — see the
    module docstring for the estimator contract.
    """
    f32 = jnp.float32
    alive = s["alive"]
    hit = intersect(s["o"], s["d"], s["tmin"], s["tmax"], alive)
    its = populate_intersection(s["o"], s["d"], hit, scene)
    found = alive & hit.valid

    first = (s["bounce"] == 0) & found
    depth = jnp.where(first, hit.t, s["depth"])
    normal = jnp.where(first[..., None], its.n, s["normal"])

    handle = scene.materials[jnp.minimum(its.shape_id, scene.num_shapes - 1)]
    tag, idx = split_handle(handle)

    if albedo_aov:
        # fixed-albedo mode (SURVEY §7 quirk 4): populate the AOV the
        # reference declares but never assigns, activating the denoiser's
        # albedo feature term
        from hijiki.ops.bsdf import base_color

        albedo = jnp.where(
            first[..., None], base_color(scene, tag, idx, its), s["albedo"]
        )

    # Beer-Lambert volumetric extinction (render.glsl:111-112).
    dist = jnp.linalg.norm(its.p - s["o"], axis=-1)
    throughput = jnp.where(
        found[..., None],
        s["throughput"] * jnp.exp(-s["extinction"] * dist[..., None]),
        s["throughput"],
    )

    # Emissive hit, only after a discrete bounce (render.glsl:114-116).
    power = _clamp_gather(scene.emissive_power, idx)
    em = found & (tag == TAG_EMISSIVE) & s["was_discrete"]
    total = jnp.where(em[..., None], s["total"] + throughput * power, s["total"])

    # NEE for diffuse-ish lanes (render.glsl:117-126).
    dif = found & ((tag == TAG_DIFFUSE) | (tag == TAG_DIFFUSECBOARD))
    new_state, es = sample_emitter(scene, s["state"], its.p, dif)
    imp_len = jnp.linalg.norm(es.importance, axis=-1)
    gate = dif & (imp_len > M_EPS) & (jnp.sum(es.shadow_d * its.n, axis=-1) > f32(0.0))
    occ = occluded(es.shadow_o, es.shadow_d, es.shadow_tmin, es.shadow_tmax, gate)
    contrib = throughput * eval_bsdf(scene, tag, idx, es.shadow_d, its) * es.importance
    total = jnp.where((gate & ~occ)[..., None], total + contrib, total)

    # BSDF sampling (render.glsl:128-133).
    new_state, wo, weight, extinction = sample_bsdf(
        scene, tag, idx, s["d"], its, new_state, s["extinction"], found
    )
    throughput = jnp.where(found[..., None], throughput * weight, throughput)
    new_o = jnp.where(found[..., None], its.p, s["o"])
    new_d = jnp.where(found[..., None], wo, s["d"])
    new_tmin = jnp.where(found, f32(2.0) * M_EPS, s["tmin"])
    new_tmax = jnp.where(found, jnp.inf, s["tmax"])

    was_discrete = jnp.where(
        found, (tag != TAG_DIFFUSE) & (tag != TAG_DIFFUSECBOARD), s["was_discrete"]
    )

    # Russian roulette after bounce 3 (render.glsl:137-144).
    rr = found & (s["bounce"] > 3)
    state_rr, u_rr = rng.rand_uniform_float(new_state, jnp)
    new_state = jnp.where(rr, state_rr, new_state)
    q = jnp.minimum(f32(0.99), jnp.max(throughput, axis=-1))
    kill = rr & (u_rr > q)
    throughput = jnp.where((rr & ~kill)[..., None], throughput / q[..., None], throughput)
    alive = found & ~kill

    out = dict(s)
    out.update(
        bounce=s["bounce"] + 1,
        o=new_o,
        d=new_d,
        tmin=new_tmin,
        tmax=new_tmax,
        state=new_state,
        total=total,
        throughput=throughput,
        extinction=extinction,
        was_discrete=was_discrete,
        alive=alive,
        depth=depth,
        normal=normal,
    )
    if albedo_aov:
        out["albedo"] = albedo
    return out


def integrate(
    scene: CompiledScene,
    o,
    d,
    tmin,
    tmax,
    state,
    *,
    max_bounces: int = 1000,
    use_bvh: bool = True,
    leaf_size: int = 1,
    traversal: str = "rows",
    albedo_aov: bool = False,
) -> RenderOutputs:
    """Trace a batch of rays to completion. All inputs are per-lane arrays.

    traversal: "rows" (merged trace-table walk, the fast path), "bvh" (the
    direct threaded-BVH walk), or "brute". ``use_bvh=False`` forces "brute"
    (the reference's A/B switch, ``src/main.rs:1432-1434``).
    """
    f32 = jnp.float32
    shape = state.shape

    if not use_bvh:
        traversal = "brute"
    intersect, occluded = make_intersectors(scene, traversal, leaf_size)

    init = dict(
        iteration=jnp.int32(0),
        bounce=jnp.zeros(shape, jnp.int32),
        o=o,
        d=d,
        tmin=tmin,
        tmax=tmax,
        state=state,
        total=jnp.zeros(shape + (3,), f32),
        throughput=jnp.ones(shape + (3,), f32),
        extinction=jnp.zeros(shape + (3,), f32),
        was_discrete=jnp.ones(shape, bool),
        alive=jnp.ones(shape, bool),
        depth=jnp.zeros(shape, f32),
        normal=jnp.zeros(shape + (3,), f32),
        albedo=jnp.zeros(shape + (3,), f32),
    )

    def cond(s):
        return (s["iteration"] < max_bounces) & jnp.any(s["alive"])

    def body(s):
        out = bounce_step(scene, s, intersect, occluded, albedo_aov=albedo_aov)
        out["iteration"] = s["iteration"] + 1
        return out

    # constant-initialized carries must match the per-shard ray data's
    # varying axes under shard_map's check_vma (utils/vma.py; no-op unsharded)
    s = jax.lax.while_loop(cond, body, match_vma(init, state))
    return RenderOutputs(
        total=s["total"],
        normal=s["normal"],
        depth=s["depth"],
        albedo=s["albedo"],
        state=s["state"],
    )
