"""Next-event estimation: emitter selection + area sampling.

Reference ``sampleEmitter`` (``shader/scene.glsl:54-89``) and ``sampleShape``
(``scene.glsl:44-52``) with the per-shape samplers from
``shader/shapes/*.glsl``. Consumes exactly three RNG draws per active lane
(one emitter pick + two shape-sample draws), matching the reference stream.

Emitter pick: the reference does a linear pdf scan with fallback to emitter 0
when the running value never goes negative (possible because randUniformFloat
can return exactly 1.0); we pick the first i with u < cdf[i], same fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from hijiki.ops import rng
from hijiki.ops.bsdf import split_handle, _clamp_gather
from hijiki.ops.intersect import M_EPS, M_PI
from hijiki.scene.compile import CompiledScene


class EmitterSample(NamedTuple):
    importance: jnp.ndarray  # (N,3) power/pdf, zero if backfacing
    shadow_o: jnp.ndarray  # (N,3)
    shadow_d: jnp.ndarray  # (N,3)
    shadow_tmin: jnp.ndarray  # (N,)
    shadow_tmax: jnp.ndarray  # (N,)


_UNROLL_EMITTERS = 8


def _sample_shape_static(scene, kind, local, u1, u2):
    """Sample one statically-known emitter shape; returns (p, n, pdf).

    All scene indexing uses python-int rows (slices, not gathers) — this is
    what makes the unrolled emitter path gather-free.
    """
    from hijiki.scene.compile import KIND_SPHERE, KIND_QUAD

    f32 = jnp.float32
    if kind == KIND_SPHERE:  # shader/shapes/sphere.glsl:54-62
        sp = scene.sphere_pos_radius[local]
        z = f32(2.0) * u1 - f32(1.0)
        theta = f32(2.0) * M_PI * u2
        rr = jnp.sqrt(f32(1.0) - z * z)
        n = jnp.stack([rr * jnp.cos(theta), rr * jnp.sin(theta), z], axis=-1)
        p = sp[:3] + sp[3] * n
        pdf = jnp.broadcast_to(
            f32(1.0) / (sp[3] * sp[3] * f32(4.0) * M_PI), u1.shape
        )
        return p, n, pdf
    if kind == KIND_QUAD:  # shader/shapes/quad.glsl:34-45
        qo = scene.quad_origin[local]
        e1 = scene.quad_edge1[local]
        e2 = scene.quad_edge2[local]
        qn = jnp.cross(e1, e2)
        area = jnp.linalg.norm(qn)
        n = jnp.broadcast_to(qn / area, u1.shape + (3,))
        p = qo + u1[..., None] * e1 + u2[..., None] * e2
        return p, n, jnp.broadcast_to(f32(1.0) / area, u1.shape)
    # triangle (shader/shapes/triangle.glsl:81-102), randBarycentric fold quirk
    tri = scene.tri_indices[local]
    pa = scene.vtx_positions[tri[0]]
    pb = scene.vtx_positions[tri[1]]
    pc = scene.vtx_positions[tri[2]]
    na = scene.vtx_normals[tri[0]]
    nb = scene.vtx_normals[tri[1]]
    nc = scene.vtx_normals[tri[2]]
    over = u1 + u2 > f32(1.0)
    lu = jnp.where(over, f32(1.0) - u2, u1)
    lv = u2  # fold quirk: v = 1 - (1 - v) (rand.glsl:44-47)
    lw = f32(1.0) - lu - lv
    ab = pb - pa
    ac = pc - pa
    area = jnp.linalg.norm(jnp.cross(ab, ac)) / f32(2.0)
    n = na * lu[..., None] + nb * lv[..., None] + nc * lw[..., None]
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    p = pa * lu[..., None] + pb * lv[..., None] + pc * lw[..., None]
    return p, n, jnp.broadcast_to(f32(1.0) / area, u1.shape)


def _sample_emitter_unrolled(scene, emitter, u1, u2):
    """Gather-free emitter sampling: evaluate every (statically known) emitter
    candidate and select by the picked index. Returns (p, n, pdf_shape,
    power, em_pdf)."""
    f32 = jnp.float32
    E = scene.num_emitters
    p_s = n_s = pdf_s = power = em_pdf = None
    for e in range(E):
        pe, ne, pdfe = _sample_shape_static(
            scene, scene.emitter_kind_static[e], scene.emitter_local_static[e], u1, u2
        )
        pwe = jnp.broadcast_to(
            scene.emissive_power[scene.emitter_midx_static[e]], u1.shape + (3,)
        )
        epe = jnp.broadcast_to(scene.emitter_pdf[e], u1.shape)
        if e == 0:
            p_s, n_s, pdf_s, power, em_pdf = pe, ne, pdfe, pwe, epe
        else:
            sel = emitter == e
            sel3 = sel[..., None]
            p_s = jnp.where(sel3, pe, p_s)
            n_s = jnp.where(sel3, ne, n_s)
            pdf_s = jnp.where(sel, pdfe, pdf_s)
            power = jnp.where(sel3, pwe, power)
            em_pdf = jnp.where(sel, epe, em_pdf)
    return p_s, n_s, pdf_s, power, em_pdf


def sample_emitter(scene: CompiledScene, state, ref_p, active):
    """Sample a point on an emitter; build the shadow ray toward it.

    Returns (new_state, EmitterSample). State advances only where active.
    """
    f32 = jnp.float32
    E = scene.num_emitters
    S, Q = scene.num_spheres, scene.num_quads

    state1, u_pick = rng.rand_uniform_float(state, jnp)
    state2, u1 = rng.rand_uniform_float(state1, jnp)
    state3, u2 = rng.rand_uniform_float(state2, jnp)
    new_state = jnp.where(active, state3, state)

    # First emitter with u < cdf (argmax picks the first True; all-False -> 0,
    # the reference's fallback, shader/scene.glsl:57-64).
    cdf = scene.emitter_cdf[:E]
    emitter = jnp.argmax(u_pick[..., None] < cdf, axis=-1).astype(jnp.int32)

    if 0 < len(scene.emitter_kind_static) == E <= _UNROLL_EMITTERS:
        p_s, n_s, pdf_s, power, em_pdf = _sample_emitter_unrolled(
            scene, emitter, u1, u2
        )
        dvec = p_s - ref_p
        dist = jnp.linalg.norm(dvec, axis=-1)
        direction = dvec / dist[..., None]
        cos_theta = -jnp.sum(direction * n_s, axis=-1)
        pdf = em_pdf * pdf_s * dist * dist / cos_theta
        importance = jnp.where(
            (cos_theta < f32(0.0))[..., None], f32(0.0), power / pdf[..., None]
        )
        return new_state, EmitterSample(
            importance=importance,
            shadow_o=ref_p,
            shadow_d=direction,
            shadow_tmin=jnp.full(dist.shape, f32(2.0) * M_EPS, f32),
            shadow_tmax=dist - M_EPS,
        )

    em_pdf = scene.emitter_pdf[emitter]
    shape = scene.emitter_shape[emitter]  # global shape index

    # --- sampleShape dispatch by global index range (scene.glsl:44-52) ---
    # sphere (shader/shapes/sphere.glsl:54-62): uniform area
    sp = _clamp_gather(scene.sphere_pos_radius, shape)
    z = f32(2.0) * u1 - f32(1.0)
    theta = f32(2.0) * M_PI * u2
    rr = jnp.sqrt(f32(1.0) - z * z)
    n_sph = jnp.stack([rr * jnp.cos(theta), rr * jnp.sin(theta), z], axis=-1)
    p_sph = sp[..., :3] + sp[..., 3:4] * n_sph
    pdf_sph = f32(1.0) / (sp[..., 3] * sp[..., 3] * f32(4.0) * M_PI)

    # quad (shader/shapes/quad.glsl:34-45)
    qidx = jnp.clip(shape - S, 0, scene.quad_origin.shape[0] - 1)
    qo = scene.quad_origin[qidx]
    qe1 = scene.quad_edge1[qidx]
    qe2 = scene.quad_edge2[qidx]
    qn = jnp.cross(qe1, qe2)
    q_area = jnp.linalg.norm(qn, axis=-1)
    n_quad = qn / q_area[..., None]
    p_quad = qo + u1[..., None] * qe1 + u2[..., None] * qe2
    pdf_quad = f32(1.0) / q_area

    # triangle (shader/shapes/triangle.glsl:81-102): randBarycentric fold
    tidx = jnp.clip(shape - S - Q, 0, scene.tri_indices.shape[0] - 1)
    tri = scene.tri_indices[tidx]
    pa = scene.vtx_positions[tri[..., 0]]
    pb = scene.vtx_positions[tri[..., 1]]
    pc = scene.vtx_positions[tri[..., 2]]
    na = scene.vtx_normals[tri[..., 0]]
    nb = scene.vtx_normals[tri[..., 1]]
    nc = scene.vtx_normals[tri[..., 2]]
    # randBarycentric fold quirk (rand.glsl:44-47): u = 1-v, then v = 1-u
    # reads the *new* u, so v is unchanged.
    over = u1 + u2 > f32(1.0)
    lu = jnp.where(over, f32(1.0) - u2, u1)
    lv = u2
    lw = f32(1.0) - lu - lv
    ab = pb - pa
    ac = pc - pa
    tn = jnp.cross(ab, ac)
    t_area = jnp.linalg.norm(tn, axis=-1) / f32(2.0)
    # Reference barycentric order: lambda=(u,v,1-u-v) weights (a,b,c)
    n_tri = na * lu[..., None] + nb * lv[..., None] + nc * lw[..., None]
    n_tri = n_tri / jnp.linalg.norm(n_tri, axis=-1, keepdims=True)
    p_tri = pa * lu[..., None] + pb * lv[..., None] + pc * lw[..., None]
    pdf_tri = f32(1.0) / t_area

    is_sphere = shape < S
    is_quad = (shape >= S) & (shape < S + Q)
    sel = lambda a, b, c: jnp.where(is_sphere, a, jnp.where(is_quad, b, c))
    sel3 = lambda a, b, c: jnp.where(
        is_sphere[..., None], a, jnp.where(is_quad[..., None], b, c)
    )
    p_s = sel3(p_sph, p_quad, p_tri)
    n_s = sel3(n_sph, n_quad, n_tri)
    pdf_s = sel(pdf_sph, pdf_quad, pdf_tri)

    # --- importance + shadow ray (scene.glsl:66-88) ---
    handle = scene.materials[shape]
    _, midx = split_handle(handle)
    power = _clamp_gather(scene.emissive_power, midx)

    dvec = p_s - ref_p
    dist = jnp.linalg.norm(dvec, axis=-1)
    direction = dvec / dist[..., None]
    cos_theta = -jnp.sum(direction * n_s, axis=-1)
    pdf = em_pdf * pdf_s * dist * dist / cos_theta
    importance = jnp.where(
        (cos_theta < f32(0.0))[..., None], jnp.float32(0.0), power / pdf[..., None]
    )

    return new_state, EmitterSample(
        importance=importance,
        shadow_o=ref_p,
        shadow_d=direction,
        shadow_tmin=jnp.full(dist.shape, f32(2.0) * M_EPS, f32),
        shadow_tmax=dist - M_EPS,
    )
