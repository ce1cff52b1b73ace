"""Regenerating wavefront driver: stream compaction via path regeneration.

The bulk-synchronous integrator keeps every lane in the loop until the whole
batch dies, so late bounces run at single-digit occupancy (Russian roulette
tails). True stream compaction (shrinking batches) is impossible under
jit — shapes are static — so the idiomatic equivalent is **path
regeneration**: a fixed-size lane pool plus a queue of (pixel, sample) work
items; whenever a lane's path terminates, its results are scattered to the
framebuffer and the lane is immediately reloaded with a fresh camera ray from
the queue. Occupancy stays near 100% for the whole sweep instead of decaying
geometrically — this is the "stream compaction between bounces" of the
wavefront architecture, realised with static shapes.

Optionally lanes are reordered by material/traversal coherence between
bounces ("per-material stream sort"): terminated lanes sort to the front
(making the refill gather contiguous) and live lanes group by material tag.
Every lane executes all material branches regardless (bsdf.py selects by
tag), so the sort's benefit is traversal coherence only; it is off by
default.

The Monte-Carlo estimator is untouched: each (pixel, sample) path consumes
exactly the RNG stream seeded by its own pixel seed, regardless of which lane
or iteration executes it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from hijiki.ops import rng
from hijiki.ops.camera import camera_rays
from hijiki.ops.integrate import bounce_step, make_intersectors
from hijiki.scene.compile import CompiledScene
from hijiki.utils.vma import match_vma


class WavefrontImages(NamedTuple):
    color: jnp.ndarray  # (Q,3) per-queue-item radiance
    normal: jnp.ndarray  # (Q,3)
    depth: jnp.ndarray  # (Q,)


def render_wavefront(
    scene: CompiledScene,
    pixel_xy,  # (Q,2) f32: sample positions (pixel + jitter), queue order
    seeds,  # (Q,) u32: per-item RNG seeds
    image_dim,  # (2,) f32 (width, height) for the camera model
    *,
    num_lanes: int,
    max_iters: int = 4096,
    max_path_bounces: int = 1000,
    traversal: str = "rows",
    leaf_size: int = 1,
    sort_lanes: bool = False,
) -> WavefrontImages:
    """Trace every queue item to completion with a regenerating lane pool."""
    f32 = jnp.float32
    Q = pixel_xy.shape[0]
    L = num_lanes
    intersect, occluded = make_intersectors(scene, traversal, leaf_size)

    def lane_zeros():
        return dict(
            bounce=jnp.zeros(L, jnp.int32),
            o=jnp.zeros((L, 3), f32),
            d=jnp.ones((L, 3), f32),
            tmin=jnp.zeros(L, f32),
            tmax=jnp.zeros(L, f32),
            state=jnp.zeros(L, jnp.uint32),
            total=jnp.zeros((L, 3), f32),
            throughput=jnp.zeros((L, 3), f32),
            extinction=jnp.zeros((L, 3), f32),
            was_discrete=jnp.zeros(L, bool),
            alive=jnp.zeros(L, bool),
            depth=jnp.zeros(L, f32),
            normal=jnp.zeros((L, 3), f32),
        )

    init = dict(
        lanes=lane_zeros(),
        item=jnp.full(L, -1, jnp.int32),  # queue item a lane is working on
        queue_head=jnp.int32(0),
        iteration=jnp.int32(0),
        out_color=jnp.zeros((Q, 3), f32),
        out_normal=jnp.zeros((Q, 3), f32),
        out_depth=jnp.zeros(Q, f32),
    )

    def flush(s, flush_mask):
        """Scatter finished lanes' results to their queue items."""
        lanes = s["lanes"]
        tgt = jnp.where(flush_mask & (s["item"] >= 0), s["item"], Q)  # Q = dropped
        out_color = s["out_color"].at[tgt].add(lanes["total"], mode="drop")
        out_normal = s["out_normal"].at[tgt].add(lanes["normal"], mode="drop")
        out_depth = s["out_depth"].at[tgt].add(lanes["depth"], mode="drop")
        return dict(s, out_color=out_color, out_normal=out_normal, out_depth=out_depth)

    def refill(s):
        """Load fresh camera rays from the queue into dead lanes."""
        lanes = s["lanes"]
        dead = ~lanes["alive"]
        rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
        fetch = s["queue_head"] + rank
        take = dead & (fetch < Q)
        fetch_c = jnp.minimum(fetch, Q - 1)

        px = pixel_xy[fetch_c]
        o, d, tmin, tmax = camera_rays(
            scene.cam_position, scene.cam_rotation, scene.cam_fov, px, image_dim
        )
        st = rng.seed_rng(seeds[fetch_c])

        t3 = take[..., None]
        new = dict(
            bounce=jnp.where(take, 0, lanes["bounce"]),
            o=jnp.where(t3, o, lanes["o"]),
            d=jnp.where(t3, d, lanes["d"]),
            tmin=jnp.where(take, tmin, lanes["tmin"]),
            tmax=jnp.where(take, tmax, lanes["tmax"]),
            state=jnp.where(take, st, lanes["state"]),
            total=jnp.where(t3, 0.0, lanes["total"]),
            throughput=jnp.where(t3, 1.0, lanes["throughput"]),
            extinction=jnp.where(t3, 0.0, lanes["extinction"]),
            was_discrete=jnp.where(take, True, lanes["was_discrete"]),
            alive=lanes["alive"] | take,
            depth=jnp.where(take, 0.0, lanes["depth"]),
            normal=jnp.where(t3, 0.0, lanes["normal"]),
        )
        item = jnp.where(take, fetch, s["item"])
        head = s["queue_head"] + jnp.sum(take.astype(jnp.int32))
        return dict(s, lanes=new, item=item, queue_head=head)

    # scene bounds (BVH root AABB) for spatial sort keys
    root_min = scene.bvh_aabb_min[0]
    root_span = jnp.maximum(scene.bvh_aabb_max[0] - root_min, 1e-6)

    def sort_pass(s):
        """Group lanes for packet coherence: dead lanes first (so the refill
        gather is contiguous), live lanes by (origin cell, direction octant).
        The packet traversal kernel walks one cursor per 128 rays, so packets
        of spatially-and-directionally similar rays visit far fewer rows."""
        lanes = s["lanes"]
        o, d = lanes["o"], lanes["d"]
        octant = (
            (d[:, 0] > 0).astype(jnp.int32)
            + 2 * (d[:, 1] > 0).astype(jnp.int32)
            + 4 * (d[:, 2] > 0).astype(jnp.int32)
        )
        q = jnp.clip(((o - root_min) / root_span * 8.0).astype(jnp.int32), 0, 7)
        cell = q[:, 0] + 8 * q[:, 1] + 64 * q[:, 2]
        key = jnp.where(lanes["alive"], 1 + octant + 8 * cell, 0)
        order = jnp.argsort(key, stable=True)
        lanes = {k: v[order] for k, v in lanes.items()}
        return dict(s, lanes=lanes, item=s["item"][order])

    def cond(s):
        return (s["iteration"] < max_iters) & (
            (s["queue_head"] < Q) | jnp.any(s["lanes"]["alive"])
        )

    def body(s):
        # flush lanes that terminated last iteration, then refill them
        s = flush(s, ~s["lanes"]["alive"])
        # ...but only once per item: mark flushed lanes as item=-1 unless refilled
        s = dict(s, item=jnp.where(s["lanes"]["alive"], s["item"], -1))
        s = refill(s)
        if sort_lanes:
            s = sort_pass(s)
        lanes = bounce_step(scene, s["lanes"], intersect, occluded)
        # per-path depth cap, matching the sync driver's max_bounces semantics
        lanes = dict(
            lanes, alive=lanes["alive"] & (lanes["bounce"] < max_path_bounces)
        )
        return dict(s, lanes=lanes, iteration=s["iteration"] + 1)

    s = jax.lax.while_loop(cond, body, match_vma(init, seeds))
    # final flush of lanes that terminated on the last iteration
    s = flush(s, ~s["lanes"]["alive"] & (s["item"] >= 0))

    return WavefrontImages(
        color=s["out_color"], normal=s["out_normal"], depth=s["out_depth"]
    )
