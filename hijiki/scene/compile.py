"""Scene compiler: Scene -> CompiledScene (SoA device arrays + BVH).

The analog of ``Scene::compile`` (``src/main.rs:172-358``): shapes are split
into type-sorted SoA arrays (spheres, quads, triangles), materials are packed
into u32 tagged handles ``(tag << 24) | per_type_index`` (``src/main.rs:45,
251-276``), per-shape material handles are ordered spheres->quads->triangles
(``src/main.rs:278-287``), and emissive shapes get a uniform-pdf emitter table
with CDF (``src/main.rs:289-307``). Instead of the reference's 12-binding
byte-packed GPU buffer (``src/main.rs:314-339``), the compiled scene is a
pytree of arrays — XLA addresses arrays directly, byte offsets are the
compiler's job.

For traversal, all primitives are additionally flattened into **unified
records** (a,b,c vectors + kind) in BVH-reordered order so a ray-primitive
intersection kernel is a single branchless vectorized test — the vectorized
replacement for the reference's per-type shader dispatch
(``shader/scene.glsl:104-114``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import jax
import numpy as np

from hijiki.accel.bvh import build_bvh, collapse_bvh, order_children_by_area
from hijiki.scene.model import (
    Camera,
    Dielectric,
    Diffuse,
    DiffuseCheckerboard,
    Emissive,
    MATERIAL_TAG_SHIFT,
    Mirror,
    Quad,
    Scene,
    Sphere,
    TAG_EMISSIVE,
    Triangle,
    material_handle,
)

KIND_SPHERE = 0
KIND_QUAD = 1
KIND_TRIANGLE = 2


def _pad_rows(a: np.ndarray, min_rows: int = 1) -> np.ndarray:
    """Pad a (possibly empty) array to at least min_rows rows of zeros so
    device-side gathers never see zero-length arrays."""
    if a.shape[0] >= min_rows:
        return a
    pad = np.zeros((min_rows - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CompiledScene:
    """Device-ready scene: arrays are pytree leaves, counts are static meta."""

    # Camera
    cam_position: Any  # (3,) f32
    cam_rotation: Any  # (4,) f32 quaternion (x,y,z,w)
    cam_fov: Any  # () f32, horizontal fov in degrees

    # Type-sorted shape SoA (reference global shape order: spheres,quads,tris)
    sphere_pos_radius: Any  # (S',4) f32
    quad_origin: Any  # (Q',3) f32
    quad_edge1: Any  # (Q',3)
    quad_edge2: Any  # (Q',3)
    tri_indices: Any  # (T',3) i32 into vertex arrays
    vtx_positions: Any  # (V',3) f32
    vtx_normals: Any  # (V',3) f32
    vtx_uvs: Any  # (V',2) f32

    # Per-shape material handles, global shape order (src/main.rs:278-287)
    materials: Any  # (S+Q+T,) u32

    # Emitter table (src/main.rs:289-307)
    emitter_shape: Any  # (E',) i32 global shape index
    emitter_pdf: Any  # (E',) f32
    emitter_cdf: Any  # (E',) f32

    # Per-type material data tables
    diffuse_color: Any  # (D',3) f32
    cb_color1: Any  # (C',3) f32
    cb_color2: Any  # (C',3) f32
    cb_scale: Any  # (C',2) f32 (scale_u, scale_v)
    dielectric_ext_eta: Any  # (L',4) f32 (extinction rgb, eta_ratio)
    emissive_power: Any  # (M',3) f32

    # Threaded BVH over all shapes (hijiki.accel.bvh layout)
    bvh_aabb_min: Any  # (N,3) f32
    bvh_aabb_max: Any  # (N,3) f32
    bvh_first: Any  # (N,) i32
    bvh_count: Any  # (N,) i32
    bvh_exit: Any  # (N,) i32

    # Unified primitive records in BVH-reordered order
    prim_a: Any  # (P,3) f32: sphere center / quad origin / tri vertex 0
    prim_b: Any  # (P,3) f32: (radius,0,0) / edge1 / edge ab
    prim_c: Any  # (P,3) f32: 0 / edge2 / edge ac
    prim_kind: Any  # (P,) i32
    prim_shape_id: Any  # (P,) i32 global shape index (materials/emitters key)
    prim_tri: Any  # (P,3) i32 vertex indices (zeros for non-triangles)

    # Merged threaded trace table: the whole BVH as one uniform row stream so
    # a traversal step is a single gather (see build_trace_rows below).
    trace_rows: Any  # (R,32) f32

    # Static metadata (hashable -> static under jit)
    num_spheres: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_quads: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_triangles: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_emitters: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_bvh_nodes: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_prims: int = dataclasses.field(metadata=dict(static=True), default=0)

    # Static per-emitter metadata (host ints) enabling gather-free statically
    # unrolled emitter sampling when the emitter count is small: shape kind
    # (KIND_*), index into the per-type shape arrays, and the emissive
    # material's table index (src/main.rs:289-307 equivalents).
    emitter_kind_static: tuple = dataclasses.field(
        metadata=dict(static=True), default=()
    )
    emitter_local_static: tuple = dataclasses.field(
        metadata=dict(static=True), default=()
    )
    emitter_midx_static: tuple = dataclasses.field(
        metadata=dict(static=True), default=()
    )

    # Camera as host floats (position xyz, rotation quaternion xyzw, fov):
    # the native oracle (ops/oracle_native.py) reads it without a device
    # round-trip.
    camera_static: tuple = dataclasses.field(metadata=dict(static=True), default=())

    @property
    def num_shapes(self) -> int:
        return self.num_spheres + self.num_quads + self.num_triangles

TRACE_ROW_WIDTH = 32


def build_trace_rows(
    bvh, prim_a, prim_b, prim_c, prim_kind, prim_tag, prim_midx, prim_payload
) -> np.ndarray:
    """Flatten the threaded BVH + reordered primitives into one uniform row
    stream for single-gather lockstep traversal.

    Each row is TRACE_ROW_WIDTH f32 (ints stored as exact small-int floats):
      cols 0-2   v0: aabb_min (interior) or prim a
      cols 3-5   v1: aabb_max (interior) or prim b
      cols 6-8   v2: prim c (zeros for interior)
      col  9     kind: -1 interior (AABB test) else primitive kind
      col  10    exit row: next row if the AABB test fails / after a prim test
      col  11    prim slot (BVH order) or -1
      col  12    material tag (prim rows)
      col  13    material per-type index (prim rows)
      cols 14-28 shading payload (prim rows): triangles carry the vertex data
                 barycentric shading needs (n0,n1,n2 then uv0,uv1,uv2);
                 spheres carry (center, radius); quads carry (edge1, edge2)
      cols 29-31 precomputed plane normal v1 x v2 (quad/triangle rows)

    Embedding material handle + shading payload in the row lets the traversal
    kernels return everything shading needs with the hit in one row
    gather per step.

    Interior rows jump to ``cur+1`` on AABB hit (preorder left child) and to
    ``exit`` on miss — the reference's stackless walk
    (``shader/scene.glsl:117-131``). A leaf with count prims becomes count
    consecutive primitive rows threaded by exit pointers (row k exits to k+1,
    the last to the leaf's exit), so multi-prim leaves need no special case.
    Leaf rows are tested unconditionally, exactly like the reference's leaves.
    """
    n_nodes = bvh.aabb_min.shape[0]
    counts = bvh.count.astype(np.int64)
    rows_per_node = np.where(counts > 0, counts, 1)
    row_start = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(rows_per_node, out=row_start[1:])
    total = int(row_start[-1])
    # exit pointers live in an f32 column: row indices past 2^24 are no
    # longer exactly representable and traversal would silently corrupt
    assert total < 2**24, (
        f"trace table has {total} rows; f32 exit pointers are exact only "
        "below 2^24 — split the scene or raise leaf_size"
    )

    rows = np.zeros((total, TRACE_ROW_WIDTH), dtype=np.float32)
    is_leaf = counts > 0
    exit_rows = row_start[np.minimum(bvh.exit.astype(np.int64), n_nodes)]

    # interior rows (fully vectorized — a python per-node loop costs ~10s at
    # 100k prims)
    int_r = row_start[:-1][~is_leaf]
    rows[int_r, 0:3] = bvh.aabb_min[~is_leaf]
    rows[int_r, 3:6] = bvh.aabb_max[~is_leaf]
    rows[int_r, 9] = -1.0
    rows[int_r, 10] = exit_rows[~is_leaf]
    rows[int_r, 11] = -1.0

    # primitive rows: expand each leaf into `count` consecutive rows
    leaf_nodes = np.nonzero(is_leaf)[0]
    if leaf_nodes.size:
        leaf_counts = counts[leaf_nodes]
        node_rep = np.repeat(leaf_nodes, leaf_counts)  # owning node per row
        # k = index within the leaf run
        ends = np.cumsum(leaf_counts)
        k = np.arange(int(ends[-1]), dtype=np.int64) - np.repeat(
            ends - leaf_counts, leaf_counts
        )
        r = row_start[node_rep] + k
        slot = bvh.first[node_rep].astype(np.int64) + k
        rows[r, 0:3] = prim_a[slot]
        rows[r, 3:6] = prim_b[slot]
        rows[r, 6:9] = prim_c[slot]
        rows[r, 9] = prim_kind[slot]
        last = k + 1 == np.repeat(leaf_counts, leaf_counts)
        rows[r, 10] = np.where(last, exit_rows[node_rep], r + 1)
        rows[r, 11] = slot
        rows[r, 12] = prim_tag[slot]
        rows[r, 13] = prim_midx[slot]
        rows[r, 14 : 14 + 15] = prim_payload[slot]
        # cols 29-31: precomputed plane normal v1 x v2 for the quad/triangle
        # test (unused by spheres/interiors) so the traversal kernel skips
        # the per-step cross product
        rows[r, 29:32] = np.cross(prim_b[slot], prim_c[slot])
    return rows


def emitter_pick_thresholds(pdf: np.ndarray) -> np.ndarray:
    """Reference-exact emitter-pick thresholds (shader/scene.glsl:57-64).

    The reference scans ``r = u; r -= pdf_i; pick first i with r < 0``
    (fallback emitter 0 when the chain never goes negative). The chain
    ``r_i(u) = fl(...fl(u - pdf_0)... - pdf_i)`` is monotone in u, so
    "picked at or before i" is exactly ``u < C_i`` where C_i is the
    smallest f32 with ``r_i(C_i) >= 0``. A plain f32 cumsum is NOT that
    threshold — the partial sums round differently from the subtraction
    chain (e.g. three equal pdfs 0.33333334 cumsum to exactly 1.0 while
    the chain at u = 1.0 ends at -6e-8) — so cdf-compare pickers diverge
    from the reference for ~2^-32 of draws. Binary-search the exact
    thresholds instead; every ``u < cdf_e`` consumer (ops/emitter.py,
    ops/oracle.py) is then bit-equivalent
    to the reference scan, fallback included.
    """
    E = len(pdf)
    pdf = np.asarray(pdf, np.float32)

    def chains_ge0(u: np.ndarray) -> np.ndarray:
        # r_i(u[i]) >= 0 for every i at once: element i accumulates the f32
        # subtraction chain pdf[0..i] (elementwise f32 subtract == the scalar
        # np.float32 chain bit-for-bit). One O(E^2) vectorized pass replaces
        # the per-(i, probe) scalar re-walk, which was O(E^2 * ~60 probes)
        # in interpreted Python — minutes at a few thousand emitters.
        r = u.astype(np.float32).copy()
        for j in range(E):
            r[j:] -= pdf[j]
        return r >= 0

    lo = np.zeros(E, np.float32)
    hi = np.full(E, 2.0, np.float32)
    ge_lo = chains_ge0(lo)  # True: picked-at-or-before-i is empty -> lo
    out = np.where(ge_lo, lo, hi)
    active = ~ge_lo & chains_ge0(hi)
    # (chain negative even at u=2 -> out stays hi: everything picks <= i)
    while active.any():
        mid = ((lo.astype(np.float64) + hi.astype(np.float64)) / 2.0).astype(
            np.float32
        )
        done = active & ((mid == lo) | (mid == hi))
        out[done] = hi[done]
        active &= ~done
        ge = chains_ge0(mid)
        hi = np.where(active & ge, mid, hi)
        lo = np.where(active & ~ge, mid, lo)
    return out


def compile_scene(scene: Scene, leaf_size: int = 1, collapse: int = 1) -> CompiledScene:
    """Compile a Scene to device arrays + static metadata.    """
    spheres: list[tuple[Sphere, int]] = []
    quads: list[tuple[Quad, int]] = []
    tris: list[tuple[Triangle, int]] = []
    for shape, mat in scene.objects:
        if isinstance(shape, Sphere):
            spheres.append((shape, mat))
        elif isinstance(shape, Quad):
            quads.append((shape, mat))
        elif isinstance(shape, Triangle):
            tris.append((shape, mat))
        else:
            raise TypeError(f"unknown shape {shape!r}")

    bulk_tris = np.ascontiguousarray(scene.bulk_tris, dtype=np.int32).reshape(-1, 3)
    bulk_mats = np.ascontiguousarray(scene.bulk_tri_mats, dtype=np.int64).reshape(-1)
    NB = bulk_tris.shape[0]
    S, Q, T = len(spheres), len(quads), len(tris) + NB
    num_shapes = S + Q + T
    if num_shapes == 0:
        raise ValueError("scene has no shapes")

    positions = np.asarray(scene.positions, dtype=np.float32).reshape(-1, 3)
    normals = np.asarray(scene.normals, dtype=np.float32).reshape(-1, 3)
    uvs = np.asarray(scene.uvs, dtype=np.float32).reshape(-1, 2)

    # --- material packing (src/main.rs:251-276) ---
    diffuse, cb1, cb2, cbs, diel, emis = [], [], [], [], [], []
    handles = []
    for mat in scene.materials:
        if isinstance(mat, Diffuse):
            handles.append(material_handle(mat.tag, len(diffuse)))
            diffuse.append(mat.color)
        elif isinstance(mat, DiffuseCheckerboard):
            handles.append(material_handle(mat.tag, len(cb1)))
            cb1.append(mat.color1)
            cb2.append(mat.color2)
            cbs.append((mat.scale_u, mat.scale_v))
        elif isinstance(mat, Mirror):
            handles.append(material_handle(mat.tag, 0))  # no data (src/main.rs:262-264)
        elif isinstance(mat, Dielectric):
            handles.append(material_handle(mat.tag, len(diel)))
            diel.append(tuple(mat.extinction) + (mat.eta_ratio,))
        elif isinstance(mat, Emissive):
            handles.append(material_handle(mat.tag, len(emis)))
            emis.append(mat.power)
        else:
            raise TypeError(f"unknown material {mat!r}")

    # Per-shape handles in global shape order (src/main.rs:278-287);
    # bulk triangles follow the listed Triangle objects.
    handles_np = np.asarray(handles, dtype=np.uint32).reshape(-1)
    shape_mats = np.concatenate(
        [
            np.array(
                [handles[m] for _, m in spheres]
                + [handles[m] for _, m in quads]
                + [handles[m] for _, m in tris],
                dtype=np.uint32,
            ).reshape(-1),
            handles_np[bulk_mats] if NB else np.zeros(0, np.uint32),
        ]
    ).reshape(num_shapes)

    # --- emitter table (src/main.rs:289-307) ---
    em_shape = np.nonzero((shape_mats >> MATERIAL_TAG_SHIFT) == TAG_EMISSIVE)[0]
    E = len(em_shape)
    em_pdf = np.full(E, 1.0 / E if E else 0.0, dtype=np.float32)
    em_cdf = emitter_pick_thresholds(em_pdf)

    # --- shape SoA ---
    sphere_pr = np.array(
        [list(s.position) + [s.radius] for s, _ in spheres], dtype=np.float32
    ).reshape(S, 4)
    quad_o = np.array([q.origin for q, _ in quads], dtype=np.float32).reshape(Q, 3)
    quad_e1 = np.array([q.edge1 for q, _ in quads], dtype=np.float32).reshape(Q, 3)
    quad_e2 = np.array([q.edge2 for q, _ in quads], dtype=np.float32).reshape(Q, 3)
    tri_idx = np.concatenate(
        [
            np.array([t.indices for t, _ in tris], dtype=np.int32).reshape(-1, 3),
            bulk_tris,
        ]
    ).reshape(T, 3)

    # --- unified primitive records in global shape order ---
    a = np.zeros((num_shapes, 3), dtype=np.float32)
    b = np.zeros((num_shapes, 3), dtype=np.float32)
    c = np.zeros((num_shapes, 3), dtype=np.float32)
    kind = np.empty(num_shapes, dtype=np.int32)
    ptri = np.zeros((num_shapes, 3), dtype=np.int32)
    if S:
        a[:S] = sphere_pr[:, :3]
        b[:S, 0] = sphere_pr[:, 3]
        kind[:S] = KIND_SPHERE
    if Q:
        a[S : S + Q] = quad_o
        b[S : S + Q] = quad_e1
        c[S : S + Q] = quad_e2
        kind[S : S + Q] = KIND_QUAD
    if T:
        v0 = positions[tri_idx[:, 0]]
        a[S + Q :] = v0
        b[S + Q :] = positions[tri_idx[:, 1]] - v0
        c[S + Q :] = positions[tri_idx[:, 2]] - v0
        kind[S + Q :] = KIND_TRIANGLE
        ptri[S + Q :] = tri_idx

    # --- per-shape AABBs (reference impls: src/shape.rs:13-20,47-54; triangle
    # AABB over its three vertices src/main.rs:72-79) ---
    aabb_min = np.empty((num_shapes, 3), dtype=np.float32)
    aabb_max = np.empty((num_shapes, 3), dtype=np.float32)
    if S:
        aabb_min[:S] = sphere_pr[:, :3] - sphere_pr[:, 3:4]
        aabb_max[:S] = sphere_pr[:, :3] + sphere_pr[:, 3:4]
    if Q:
        corners = np.stack(
            [quad_o, quad_o + quad_e1, quad_o + quad_e2, quad_o + quad_e1 + quad_e2]
        )
        aabb_min[S : S + Q] = corners.min(axis=0)
        aabb_max[S : S + Q] = corners.max(axis=0)
    if T:
        tv = positions[tri_idx]  # (T,3,3)
        aabb_min[S + Q :] = tv.min(axis=1)
        aabb_max[S + Q :] = tv.max(axis=1)

    # per-prim shading payload (see build_trace_rows cols 14-28)
    payload = np.zeros((num_shapes, 15), dtype=np.float32)
    if S:
        payload[:S, 0:3] = sphere_pr[:, :3]
        payload[:S, 3] = sphere_pr[:, 3]
    if Q:
        payload[S : S + Q, 0:3] = quad_e1
        payload[S : S + Q, 3:6] = quad_e2
    if T:
        payload[S + Q :, 0:3] = normals[tri_idx[:, 0]]
        payload[S + Q :, 3:6] = normals[tri_idx[:, 1]]
        payload[S + Q :, 6:9] = normals[tri_idx[:, 2]]
        payload[S + Q :, 9:11] = uvs[tri_idx[:, 0]]
        payload[S + Q :, 11:13] = uvs[tri_idx[:, 1]]
        payload[S + Q :, 13:15] = uvs[tri_idx[:, 2]]

    bvh = build_bvh(aabb_min, aabb_max, leaf_size=leaf_size)
    if collapse:
        # widen to 4-ary: interior rows dominate packet-walk visits (~83% on
        # cbox) and packets descend most of them, so the skipped levels'
        # culling doesn't pay for its row visits
        bvh = collapse_bvh(bvh, rounds=collapse)
    bvh = order_children_by_area(bvh)
    order = bvh.prim_order  # reordered slot -> global shape index
    mats_by_order = shape_mats[order]
    trace_rows = build_trace_rows(
        bvh,
        a[order],
        b[order],
        c[order],
        kind[order],
        mats_by_order >> MATERIAL_TAG_SHIFT,
        mats_by_order & ((1 << MATERIAL_TAG_SHIFT) - 1),
        payload[order],
    )

    # static per-emitter metadata for gather-free unrolled emitter sampling
    em_kind, em_local, em_midx = [], [], []
    for sh in em_shape.tolist():
        em_midx.append(int(shape_mats[sh]) & ((1 << MATERIAL_TAG_SHIFT) - 1))
        if sh < S:
            em_kind.append(KIND_SPHERE)
            em_local.append(int(sh))
        elif sh < S + Q:
            em_kind.append(KIND_QUAD)
            em_local.append(int(sh) - S)
        else:
            em_kind.append(KIND_TRIANGLE)
            em_local.append(int(sh) - S - Q)

    cam: Camera = scene.camera
    camera_static = (
        tuple(float(x) for x in np.asarray(cam.position).reshape(3))
        + tuple(float(x) for x in np.asarray(cam.rotation).reshape(4))
        + (float(cam.fov),)
    )

    return CompiledScene(
        cam_position=np.asarray(cam.position, dtype=np.float32).reshape(3),
        cam_rotation=np.asarray(cam.rotation, dtype=np.float32).reshape(4),
        cam_fov=np.float32(cam.fov),
        sphere_pos_radius=_pad_rows(sphere_pr),
        quad_origin=_pad_rows(quad_o),
        quad_edge1=_pad_rows(quad_e1),
        quad_edge2=_pad_rows(quad_e2),
        tri_indices=_pad_rows(tri_idx),
        vtx_positions=_pad_rows(positions),
        vtx_normals=_pad_rows(normals),
        vtx_uvs=_pad_rows(uvs),
        materials=shape_mats,
        emitter_shape=_pad_rows(em_shape.astype(np.int32)),
        emitter_pdf=_pad_rows(em_pdf),
        emitter_cdf=_pad_rows(em_cdf),
        diffuse_color=_pad_rows(np.asarray(diffuse, dtype=np.float32).reshape(-1, 3)),
        cb_color1=_pad_rows(np.asarray(cb1, dtype=np.float32).reshape(-1, 3)),
        cb_color2=_pad_rows(np.asarray(cb2, dtype=np.float32).reshape(-1, 3)),
        cb_scale=_pad_rows(np.asarray(cbs, dtype=np.float32).reshape(-1, 2)),
        dielectric_ext_eta=_pad_rows(np.asarray(diel, dtype=np.float32).reshape(-1, 4)),
        emissive_power=_pad_rows(np.asarray(emis, dtype=np.float32).reshape(-1, 3)),
        bvh_aabb_min=bvh.aabb_min,
        bvh_aabb_max=bvh.aabb_max,
        bvh_first=bvh.first,
        bvh_count=bvh.count,
        bvh_exit=bvh.exit,
        prim_a=a[order],
        prim_b=b[order],
        prim_c=c[order],
        prim_kind=kind[order],
        prim_shape_id=order.astype(np.int32),
        prim_tri=ptri[order],
        trace_rows=trace_rows,
        num_spheres=S,
        num_quads=Q,
        num_triangles=T,
        num_emitters=E,
        num_bvh_nodes=bvh.num_nodes,
        num_prims=num_shapes,
        emitter_kind_static=tuple(em_kind),
        emitter_local_static=tuple(em_local),
        emitter_midx_static=tuple(em_midx),
        camera_static=camera_static,
    )


def scene_to_device(cs: CompiledScene) -> CompiledScene:
    """Move all arrays to the default device as jnp arrays."""
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, cs)
