"""Ray-scene intersection: unified primitive test, brute force, and the
lockstep threaded-BVH walk.

Vectorized redesign of the reference's intersection layer
(``shader/scene.glsl:97-175``, per-shape kernels ``shader/shapes/*.glsl``):
instead of per-thread divergent shape dispatch, every primitive is a unified
(a, b, c, kind) record and one branchless vectorized test covers spheres,
parallelogram quads, and triangles. Traversal is the reference's stackless
exit-index walk (``shader/scene.glsl:99-133``) run in lockstep over the whole
ray batch: a ``lax.while_loop`` advances a per-ray node cursor; node fetches
are gathers. The walk's hit semantics (closest hit, AABB slab test with M_EPS
slack, tMin/tMax window) match the reference; the only deliberate divergence
is exact closest-hit (t < best) instead of the reference's epsilon-shrunken
``tMax = t - M_EPS`` re-test, which can differ only for hits within 1e-4 of
each other (documented quirk; statistically irrelevant).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from hijiki.scene.compile import CompiledScene, KIND_SPHERE, KIND_TRIANGLE
from hijiki.utils.vma import match_vma

# numpy scalars, NOT jnp: module-level jnp constants become captured device
# arrays inside jit instead of compile-time literals
M_EPS = np.float32(1e-4)
M_PI = np.float32(3.1415926535897932384626433832795)


class Hit(NamedTuple):
    """SoA closest-hit record for a ray batch."""

    valid: jnp.ndarray  # (N,) bool
    t: jnp.ndarray  # (N,) f32
    prim_slot: jnp.ndarray  # (N,) i32 — BVH-reordered primitive slot
    shape_id: jnp.ndarray  # (N,) i32 — global shape index (materials key)
    u: jnp.ndarray  # (N,) f32 barycentric/param u
    v: jnp.ndarray  # (N,) f32


class Its(NamedTuple):
    """Populated intersection (``Intersection`` struct, shader/render.glsl:39-46)."""

    valid: jnp.ndarray
    t: jnp.ndarray
    shape_id: jnp.ndarray  # (N,) i32
    p: jnp.ndarray  # (N,3)
    n: jnp.ndarray  # (N,3) shading normal
    uv: jnp.ndarray  # (N,2)
    frame_t: jnp.ndarray  # (N,3) tangent   (frame columns: t, b, n)
    frame_b: jnp.ndarray  # (N,3) bitangent


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def intersect_unified(o, d, tmin, tmax, a, b, c, kind):
    """Test rays against unified primitives (broadcastable).

    For parallelograms/triangles this is the Lagrange-identity (Moller-style)
    test of ``shader/shapes/quad.glsl:7-25`` / ``triangle.glsl:15-52``; for
    spheres the near/far quadratic of ``shader/shapes/sphere.glsl:18-41``.

    Returns (hit, t, u, v); for spheres u = v = 0.
    """
    f32 = jnp.float32
    # --- parallelogram / triangle ---
    n = jnp.cross(b, c)
    ro = o - a
    q = jnp.cross(ro, d)
    dd = f32(1.0) / _dot(d, n)
    u = dd * _dot(-q, c)
    v = dd * _dot(q, b)
    t_pq = dd * _dot(-n, ro)
    in_tri = (u >= 0) & (v >= 0) & (u + v <= f32(1.0))
    in_quad = (u >= 0) & (u <= f32(1.0)) & (v >= 0) & (v <= f32(1.0))
    ok_pq = jnp.where(kind == KIND_TRIANGLE, in_tri, in_quad)
    ok_pq &= (tmin <= t_pq) & (t_pq <= tmax)

    # --- sphere ---
    radius = b[..., 0]
    l = ro  # o - center
    sb = f32(2.0) * _dot(d, l)
    sc = _dot(l, l) - radius * radius
    disc = sb * sb - f32(4.0) * sc
    sq = jnp.sqrt(jnp.maximum(disc, f32(0.0)))
    t0 = f32(-0.5) * (sb + sq)
    t1 = f32(-0.5) * (sb - sq)
    ok0 = (tmin <= t0) & (t0 <= tmax)
    ok1 = (tmin <= t1) & (t1 <= tmax)
    t_s = jnp.where(ok0, t0, t1)
    ok_s = (disc >= f32(0.0)) & (ok0 | ok1)

    is_sphere = kind == KIND_SPHERE
    hit = jnp.where(is_sphere, ok_s, ok_pq)
    t = jnp.where(is_sphere, t_s, t_pq)
    zero = jnp.zeros_like(t)
    return hit, t, jnp.where(is_sphere, zero, u), jnp.where(is_sphere, zero, v)


def intersect_brute(o, d, tmin, tmax, active=None, *, scene: CompiledScene) -> Hit:
    """Closest hit by testing every primitive (oracle / tiny scenes).

    The analog of the reference's non-BVH fallback loops
    (``shader/scene.glsl:134-158``) minus the >100-primitive failsafe.
    Winner = minimum t, ties to the lowest primitive slot.
    """
    P = scene.num_prims
    hit, t, u, v = intersect_unified(
        o[..., None, :],
        d[..., None, :],
        tmin[..., None],
        tmax[..., None],
        scene.prim_a[:P],
        scene.prim_b[:P],
        scene.prim_c[:P],
        scene.prim_kind[:P],
    )
    t_masked = jnp.where(hit, t, jnp.inf)
    slot = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
    take = lambda arr: jnp.take_along_axis(arr, slot[..., None], axis=-1)[..., 0]
    valid = take(hit)
    return Hit(
        valid=valid,
        t=take(t),
        prim_slot=slot,
        shape_id=scene.prim_shape_id[slot],
        u=take(u),
        v=take(v),
    )


def intersect_bvh(
    o, d, tmin, tmax, active=None, *, scene: CompiledScene, leaf_size: int = 1
) -> Hit:
    """Lockstep stackless BVH walk over the ray batch.

    Per-ray node cursor; each ``while_loop`` step gathers one node per ray,
    does the slab test for interior nodes (``shader/scene.glsl:117-131``) or
    the unified primitive test for leaves, and advances to ``cur+1`` (descend)
    or ``exit`` (skip). Runs until every lane has exited the tree.
    """
    num_nodes = scene.num_bvh_nodes
    shape = o.shape[:-1]
    f32 = jnp.float32

    inv_d = f32(1.0) / d
    t_off = -o * inv_d

    cur0 = jnp.zeros(shape, jnp.int32)
    if active is not None:
        cur0 = jnp.where(active, cur0, num_nodes)
    init = dict(
        cur=cur0,
        best_t=jnp.broadcast_to(tmax, shape).astype(f32),
        best_slot=jnp.full(shape, -1, jnp.int32),
        best_u=jnp.zeros(shape, f32),
        best_v=jnp.zeros(shape, f32),
    )

    def cond(s):
        return jnp.any(s["cur"] < num_nodes)

    def body(s):
        cur = s["cur"]
        active = cur < num_nodes
        idx = jnp.minimum(cur, num_nodes - 1)
        nmin = scene.bvh_aabb_min[idx]
        nmax = scene.bvh_aabb_max[idx]
        first = scene.bvh_first[idx]
        count = scene.bvh_count[idx]
        nexit = scene.bvh_exit[idx]
        is_leaf = count > 0

        # Interior: slab test (shader/scene.glsl:118-130).
        tneg = nmin * inv_d + t_off
        tpos = nmax * inv_d + t_off
        tn = jnp.minimum(tneg, tpos)
        tf = jnp.maximum(tneg, tpos)
        t0 = jnp.max(tn, axis=-1)
        t1 = jnp.min(tf, axis=-1)
        aabb_hit = (t0 < t1 + M_EPS) & (t0 < s["best_t"]) & (t1 > tmin)

        best_t, best_slot = s["best_t"], s["best_slot"]
        best_u, best_v = s["best_u"], s["best_v"]
        for k in range(leaf_size):
            pslot = jnp.minimum(first + k, scene.num_prims - 1)
            phit, pt, pu, pv = intersect_unified(
                o,
                d,
                tmin,
                best_t,
                scene.prim_a[pslot],
                scene.prim_b[pslot],
                scene.prim_c[pslot],
                scene.prim_kind[pslot],
            )
            accept = active & is_leaf & (k < count) & phit & (pt < best_t)
            best_t = jnp.where(accept, pt, best_t)
            best_slot = jnp.where(accept, pslot, best_slot)
            best_u = jnp.where(accept, pu, best_u)
            best_v = jnp.where(accept, pv, best_v)

        nxt = jnp.where(is_leaf, nexit, jnp.where(aabb_hit, cur + 1, nexit))
        return dict(
            cur=jnp.where(active, nxt, cur),
            best_t=best_t,
            best_slot=best_slot,
            best_u=best_u,
            best_v=best_v,
        )

    s = jax.lax.while_loop(cond, body, match_vma(init, o))
    valid = s["best_slot"] >= 0
    slot = jnp.maximum(s["best_slot"], 0)
    return Hit(
        valid=valid,
        t=s["best_t"],
        prim_slot=slot,
        shape_id=scene.prim_shape_id[slot],
        u=s["best_u"],
        v=s["best_v"],
    )


def intersect_rows(o, d, tmin, tmax, active=None, *, scene: CompiledScene) -> Hit:
    """Lockstep traversal over the merged trace-row table — one (N,12) gather
    per step (see ``scene.compile.build_trace_rows``). Visit order and hit
    semantics are identical to ``intersect_bvh``; this is the fast path: XLA
    keeps the row table VMEM-resident across the fused while_loop, so each
    step is one vectorized gather + branchless unified AABB/primitive test."""
    rows = scene.trace_rows
    num_rows = rows.shape[0]
    shape = o.shape[:-1]
    f32 = jnp.float32

    inv_d = f32(1.0) / d
    t_off = -o * inv_d

    cur0 = jnp.zeros(shape, jnp.int32)
    if active is not None:
        cur0 = jnp.where(active, cur0, num_rows)
    init = dict(
        cur=cur0,
        best_t=jnp.broadcast_to(tmax, shape).astype(f32),
        best_slot=jnp.full(shape, -1, jnp.int32),
        best_u=jnp.zeros(shape, f32),
        best_v=jnp.zeros(shape, f32),
    )

    def cond(s):
        return jnp.any(s["cur"] < num_rows)

    def body(s):
        cur = s["cur"]
        active = cur < num_rows
        row = rows[jnp.minimum(cur, num_rows - 1)]
        v0, v1, v2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
        kind = row[..., 9].astype(jnp.int32)
        nexit = row[..., 10].astype(jnp.int32)
        slot = row[..., 11].astype(jnp.int32)
        is_prim = kind >= 0

        # slab test (interior rows): v0=min, v1=max
        tneg = v0 * inv_d + t_off
        tpos = v1 * inv_d + t_off
        tn = jnp.minimum(tneg, tpos)
        tf = jnp.maximum(tneg, tpos)
        t0 = jnp.max(tn, axis=-1)
        t1 = jnp.min(tf, axis=-1)
        aabb_hit = (t0 < t1 + M_EPS) & (t0 < s["best_t"]) & (t1 > tmin)

        # primitive test (prim rows)
        phit, pt, pu, pv = intersect_unified(o, d, tmin, s["best_t"], v0, v1, v2, kind)
        accept = active & is_prim & phit & (pt < s["best_t"])
        best_t = jnp.where(accept, pt, s["best_t"])
        best_slot = jnp.where(accept, slot, s["best_slot"])
        best_u = jnp.where(accept, pu, s["best_u"])
        best_v = jnp.where(accept, pv, s["best_v"])

        nxt = jnp.where(is_prim | ~aabb_hit, nexit, cur + 1)
        return dict(
            cur=jnp.where(active, nxt, cur),
            best_t=best_t,
            best_slot=best_slot,
            best_u=best_u,
            best_v=best_v,
        )

    s = jax.lax.while_loop(cond, body, match_vma(init, o))
    valid = s["best_slot"] >= 0
    slot = jnp.maximum(s["best_slot"], 0)
    return Hit(
        valid=valid,
        t=s["best_t"],
        prim_slot=slot,
        shape_id=scene.prim_shape_id[slot],
        u=s["best_u"],
        v=s["best_v"],
    )


def occluded_rows(o, d, tmin, tmax, active=None, *, scene: CompiledScene) -> jnp.ndarray:
    """Any-hit query over the trace-row table with per-lane early exit."""
    rows = scene.trace_rows
    num_rows = rows.shape[0]
    shape = o.shape[:-1]
    f32 = jnp.float32
    inv_d = f32(1.0) / d
    t_off = -o * inv_d

    cur0 = jnp.zeros(shape, jnp.int32)
    if active is not None:
        cur0 = jnp.where(active, cur0, num_rows)
    init = dict(cur=cur0, hit=jnp.zeros(shape, bool))

    def cond(s):
        return jnp.any(s["cur"] < num_rows)

    def body(s):
        cur = s["cur"]
        lane_on = cur < num_rows
        row = rows[jnp.minimum(cur, num_rows - 1)]
        v0, v1, v2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
        kind = row[..., 9].astype(jnp.int32)
        nexit = row[..., 10].astype(jnp.int32)
        is_prim = kind >= 0

        tneg = v0 * inv_d + t_off
        tpos = v1 * inv_d + t_off
        tn = jnp.minimum(tneg, tpos)
        tf = jnp.maximum(tneg, tpos)
        t0 = jnp.max(tn, axis=-1)
        t1 = jnp.min(tf, axis=-1)
        aabb_hit = (t0 < t1 + M_EPS) & (t0 < tmax) & (t1 > tmin)

        phit, _, _, _ = intersect_unified(o, d, tmin, tmax, v0, v1, v2, kind)
        new_hit = s["hit"] | (lane_on & is_prim & phit)

        nxt = jnp.where(is_prim | ~aabb_hit, nexit, cur + 1)
        nxt = jnp.where(new_hit, num_rows, nxt)  # early out on first hit
        return dict(cur=jnp.where(lane_on, nxt, cur), hit=new_hit)

    return jax.lax.while_loop(cond, body, match_vma(init, o))["hit"]


def occluded_bvh(
    o, d, tmin, tmax, active=None, *, scene: CompiledScene, leaf_size: int = 1
) -> jnp.ndarray:
    """Any-hit query for shadow rays (``intersectScene(ray)`` overload,
    ``shader/scene.glsl:92-96`` — the reference traces to closest hit and
    discards it; we early-out per lane on first accepted hit). Lanes where
    ``active`` is False skip traversal entirely and report unoccluded."""
    num_nodes = scene.num_bvh_nodes
    shape = o.shape[:-1]
    f32 = jnp.float32
    inv_d = f32(1.0) / d
    t_off = -o * inv_d

    cur0 = jnp.zeros(shape, jnp.int32)
    if active is not None:
        cur0 = jnp.where(active, cur0, num_nodes)
    init = dict(cur=cur0, hit=jnp.zeros(shape, bool))

    def cond(s):
        return jnp.any(s["cur"] < num_nodes)

    def body(s):
        cur = s["cur"]
        active = (cur < num_nodes) & ~s["hit"]
        idx = jnp.minimum(cur, num_nodes - 1)
        nmin = scene.bvh_aabb_min[idx]
        nmax = scene.bvh_aabb_max[idx]
        first = scene.bvh_first[idx]
        count = scene.bvh_count[idx]
        nexit = scene.bvh_exit[idx]
        is_leaf = count > 0

        tneg = nmin * inv_d + t_off
        tpos = nmax * inv_d + t_off
        tn = jnp.minimum(tneg, tpos)
        tf = jnp.maximum(tneg, tpos)
        t0 = jnp.max(tn, axis=-1)
        t1 = jnp.min(tf, axis=-1)
        aabb_hit = (t0 < t1 + M_EPS) & (t0 < tmax) & (t1 > tmin)

        new_hit = s["hit"]
        for k in range(leaf_size):
            pslot = jnp.minimum(first + k, scene.num_prims - 1)
            phit, _, _, _ = intersect_unified(
                o,
                d,
                tmin,
                tmax,
                scene.prim_a[pslot],
                scene.prim_b[pslot],
                scene.prim_c[pslot],
                scene.prim_kind[pslot],
            )
            new_hit = new_hit | (active & is_leaf & (k < count) & phit)

        nxt = jnp.where(is_leaf, nexit, jnp.where(aabb_hit, cur + 1, nexit))
        cur = jnp.where(new_hit, num_nodes, jnp.where(active, nxt, cur))
        return dict(cur=cur, hit=new_hit)

    s = jax.lax.while_loop(cond, body, match_vma(init, o))
    return s["hit"]


def populate_intersection(o, d, hit: Hit, scene: CompiledScene) -> Its:
    """Fill shading data for the winning primitive (vectorized masked version
    of ``populate{Sphere,Quad,Triangle}Intersection``,
    ``shader/scene.glsl:160-174`` + ``shader/shapes/*.glsl``)."""
    f32 = jnp.float32
    slot = hit.prim_slot
    a = scene.prim_a[slot]
    b = scene.prim_b[slot]
    c = scene.prim_c[slot]
    kind = scene.prim_kind[slot]
    tri = scene.prim_tri[slot]

    p = o + hit.t[..., None] * d

    # --- sphere (shader/shapes/sphere.glsl:43-52) ---
    radius = b[..., 0:1]
    n_s = (p - a) / radius
    t_s = jnp.stack([-n_s[..., 2], jnp.zeros_like(n_s[..., 0]), n_s[..., 0]], axis=-1)
    t_s = t_s / jnp.linalg.norm(t_s, axis=-1, keepdims=True)
    b_s = jnp.cross(n_s, t_s)
    uv_s_x = f32(0.5) + jnp.arctan2(n_s[..., 2], n_s[..., 0]) / (f32(2.0) * M_PI)
    uv_s_x = jnp.where(jnp.isnan(uv_s_x), f32(0.0), uv_s_x)  # NaN guard, sphere.glsl:49-51
    uv_s_y = f32(0.5) + jnp.arcsin(jnp.clip(n_s[..., 1], -1.0, 1.0)) / M_PI
    uv_s = jnp.stack([uv_s_x, uv_s_y], axis=-1)

    # --- quad (shader/shapes/quad.glsl:27-32): frame from normalized edges ---
    t_q = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    b_q = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
    n_q = jnp.cross(t_q, b_q)
    uv_q = jnp.stack([hit.u, hit.v], axis=-1)

    # --- triangle (shader/shapes/triangle.glsl:54-78): smooth normal + UV ---
    lam0 = f32(1.0) - hit.u - hit.v
    vn = scene.vtx_normals
    vuv = scene.vtx_uvs
    n_t = (
        vn[tri[..., 0]] * lam0[..., None]
        + vn[tri[..., 1]] * hit.u[..., None]
        + vn[tri[..., 2]] * hit.v[..., None]
    )
    n_t = n_t / jnp.linalg.norm(n_t, axis=-1, keepdims=True)
    uv_t = (
        vuv[tri[..., 0]] * lam0[..., None]
        + vuv[tri[..., 1]] * hit.u[..., None]
        + vuv[tri[..., 2]] * hit.v[..., None]
    )
    bt_seed = jnp.where(
        (jnp.abs(n_t[..., 0]) > jnp.abs(n_t[..., 1]))[..., None],
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], f32), n_t.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], f32), n_t.shape),
    )
    t_t = jnp.cross(n_t, bt_seed)
    t_t = t_t / jnp.linalg.norm(t_t, axis=-1, keepdims=True)
    b_t = jnp.cross(n_t, t_t)

    is_sphere = (kind == KIND_SPHERE)[..., None]
    is_tri = (kind == KIND_TRIANGLE)[..., None]
    n = jnp.where(is_sphere, n_s, jnp.where(is_tri, n_t, n_q))
    tt = jnp.where(is_sphere, t_s, jnp.where(is_tri, t_t, t_q))
    bb = jnp.where(is_sphere, b_s, jnp.where(is_tri, b_t, b_q))
    uv = jnp.where(is_sphere[..., :1], uv_s, jnp.where(is_tri[..., :1], uv_t, uv_q))

    return Its(
        valid=hit.valid,
        t=hit.t,
        shape_id=hit.shape_id,
        p=p,
        n=n,
        uv=uv,
        frame_t=tt,
        frame_b=bb,
    )
