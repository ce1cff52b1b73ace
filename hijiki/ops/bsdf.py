"""BSDF evaluation and sampling — masked, branchless, all materials at once.

Vectorized replacement for the reference's per-thread switch dispatch
(``shader/material.glsl:18-91``): every lane computes every material branch
and selects by tag. RNG consumption is predicated to
match the reference's divergent stream exactly: cosine-hemisphere draws only
for diffuse/checkerboard lanes, the Fresnel coin only for dielectric lanes
without total internal reflection.

Reference quirks reproduced deliberately:

* The dielectric's ``isInsideDielectric`` bookkeeping (``material.glsl:55-84``)
  is inverted relative to physical intuition for reflections (a ray reflecting
  off the outside still gets the medium's extinction, one reflecting inside
  does not). All shipped scenes use extinction 0, so images are unaffected,
  but the state machine is mirrored verbatim.
* Extinction is never reset by other materials (``inout`` param semantics).
* Emissive sampleBSDF leaves ``wo`` undefined in GLSL (``material.glsl:88-89``)
  with zero weight; we define wo := wi (the value is irrelevant to the image —
  throughput is zero — but must be NaN-free for the masked pipeline).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from hijiki.ops import rng
from hijiki.ops.intersect import Its, M_PI
from hijiki.scene.compile import CompiledScene
from hijiki.scene.model import (
    MATERIAL_TAG_SHIFT,
    TAG_DIELECTRIC,
    TAG_DIFFUSE,
    TAG_DIFFUSECBOARD,
    TAG_EMISSIVE,
    TAG_MIRROR,
)

_IDX_MASK = np.uint32((1 << MATERIAL_TAG_SHIFT) - 1)  # numpy, not jnp (perf)


def split_handle(handle):
    """(tag, index) from a packed u32 material handle (``src/main.rs:275``)."""
    tag = (handle >> MATERIAL_TAG_SHIFT).astype(jnp.int32)
    idx = (handle & _IDX_MASK).astype(jnp.int32)
    return tag, idx


_UNROLL_LIMIT = 16


def select_row(table, idx):
    """table[idx] for small tables without a gather: an unrolled where-chain.

    Material tables are tiny, so a static select chain replaces the gather.
    Falls back to a clamped gather for big tables.
    """
    k = table.shape[0]
    if k <= _UNROLL_LIMIT:
        out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
        for row in range(1, k):
            out = jnp.where((idx == row)[..., None], table[row], out)
        return out
    return table[jnp.minimum(idx, k - 1)]


def _clamp_gather(table, idx):
    return select_row(table, idx)


def checkerboard_texture(color1, color2, scale, uv):
    """Procedural checkerboard (``materials/diffusecb.glsl:6-13``)."""
    f32 = jnp.float32
    st = f32(0.5) * uv / scale
    st = st - jnp.floor(st)  # fract
    flip = (st[..., 0] < f32(0.5)) ^ (st[..., 1] < f32(0.5))
    return jnp.where(flip[..., None], color2, color1)


def _reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n."""
    return i - jnp.float32(2.0) * jnp.sum(n * i, axis=-1, keepdims=True) * n


def eval_bsdf(scene: CompiledScene, tag, idx, wi, its: Its):
    """``evalBSDF`` (``shader/material.glsl:18-30``): nonzero only for
    diffuse/checkerboard; value = dot(n, wi) * albedo / pi."""
    cos_term = jnp.sum(its.n * wi, axis=-1, keepdims=True)
    dif_color = _clamp_gather(scene.diffuse_color, idx)
    cb_color = checkerboard_texture(
        _clamp_gather(scene.cb_color1, idx),
        _clamp_gather(scene.cb_color2, idx),
        _clamp_gather(scene.cb_scale, idx),
        its.uv,
    )
    val_dif = cos_term * dif_color / M_PI
    val_cb = cos_term * cb_color / M_PI
    zero = jnp.zeros_like(val_dif)
    return jnp.where(
        (tag == TAG_DIFFUSE)[..., None],
        val_dif,
        jnp.where((tag == TAG_DIFFUSECBOARD)[..., None], val_cb, zero),
    )


def base_color(scene: CompiledScene, tag, idx, its: Its):
    """First-hit surface reflectance for the fixed-albedo AOV mode.

    The reference declares an albedo AOV but never assigns it
    (render.glsl:84-85,174); parity mode keeps it zero. With
    ``fixed_albedo`` the denoiser's albedo feature term becomes active using
    this value: diffuse color / checkerboard texel at the hit UV; specular
    and emissive surfaces contribute no albedo feature (zero), matching the
    term's intent of separating diffuse texture detail from noise."""
    dif_color = _clamp_gather(scene.diffuse_color, idx)
    cb_color = checkerboard_texture(
        _clamp_gather(scene.cb_color1, idx),
        _clamp_gather(scene.cb_color2, idx),
        _clamp_gather(scene.cb_scale, idx),
        its.uv,
    )
    zero = jnp.zeros_like(dif_color)
    return jnp.where(
        (tag == TAG_DIFFUSE)[..., None],
        dif_color,
        jnp.where((tag == TAG_DIFFUSECBOARD)[..., None], cb_color, zero),
    )


def sample_bsdf(scene: CompiledScene, tag, idx, wi, its: Its, state, extinction, active):
    """``sampleBSDF`` (``shader/material.glsl:33-91``), masked over all tags.

    Args:
      tag, idx: (N,) i32 material tag / per-type index (split handle).
      wi: (N,3) incident direction (the ray's direction, pointing into the
        surface) — reference convention.
      state: (N,) u32 RNG state; advanced only where the reference consumes.
      extinction: (N,3) current Beer-Lambert extinction (inout).
      active: (N,) bool — lanes that actually shade this bounce.

    Returns (state, wo, weight, extinction).
    """
    f32 = jnp.float32
    n = its.n

    # Two speculative draws off the current state; committed per-tag below.
    state1, u1 = rng.rand_uniform_float(state, jnp)
    state2, u2 = rng.rand_uniform_float(state1, jnp)

    # --- diffuse / checkerboard: cosine hemisphere in the shading frame ---
    r = jnp.sqrt(u1)
    theta = f32(2.0) * M_PI * u2
    lx = r * jnp.cos(theta)
    ly = r * jnp.sin(theta)
    lz = jnp.sqrt(jnp.maximum(f32(0.0), f32(1.0) - u1))
    wo_diffuse = (
        its.frame_t * lx[..., None] + its.frame_b * ly[..., None] + n * lz[..., None]
    )
    w_dif = _clamp_gather(scene.diffuse_color, idx)
    w_cb = checkerboard_texture(
        _clamp_gather(scene.cb_color1, idx),
        _clamp_gather(scene.cb_color2, idx),
        _clamp_gather(scene.cb_scale, idx),
        its.uv,
    )

    # --- mirror ---
    wo_mirror = _reflect(wi, n)

    # --- dielectric (material.glsl:50-87, quirks and all) ---
    ext_eta = _clamp_gather(scene.dielectric_ext_eta, idx)
    eta0 = ext_eta[..., 3]
    eta_inv0 = f32(1.0) / eta0
    cos_i0 = -jnp.sum(n * wi, axis=-1)
    inside0 = cos_i0 > f32(0.0)
    flip = cos_i0 < f32(0.0)
    eta = jnp.where(flip, eta_inv0, eta0)
    # reference inside-hit etaInv is the DOUBLE reciprocal fl(1/fl(1/eta)),
    # which differs from eta in f32 for ~9% of eta values (material.glsl:
    # 56-58: eta = etaInv; etaInv = 1./eta) — substituting eta0 directly
    # diverges k/f_r/refraction on inside faces for non-involutive eta
    eta_inv = jnp.where(flip, f32(1.0) / eta_inv0, eta_inv0)
    normal = jnp.where(flip[..., None], -n, n)
    cos_i = jnp.where(flip, -cos_i0, cos_i0)
    k = f32(1.0) - eta_inv * eta_inv * (f32(1.0) - cos_i * cos_i)
    tir = k <= f32(0.0)
    cos_o = jnp.sqrt(jnp.maximum(k, f32(0.0)))
    rho_par = (eta * cos_i - cos_o) / (eta * cos_i + cos_o)
    rho_orth = (cos_i - eta * cos_o) / (cos_i + eta * cos_o)
    f_r = f32(0.5) * (rho_par * rho_par + rho_orth * rho_orth)
    # Fresnel coin = the *first* speculative draw (consumed only if !tir).
    choose_reflect = u1 < f_r
    refl = _reflect(wi, normal)
    parallel = wi - jnp.sum(wi * normal, axis=-1, keepdims=True) * normal
    refr = eta_inv[..., None] * parallel - cos_o[..., None] * normal
    wo_diel = jnp.where((tir | choose_reflect)[..., None], refl, refr)
    refracted = ~tir & ~choose_reflect
    inside_final = jnp.where(refracted, ~inside0, inside0)
    ext_diel = jnp.where(inside_final[..., None], ext_eta[..., :3], extinction)

    # --- select by tag ---
    is_dif = tag == TAG_DIFFUSE
    is_cb = tag == TAG_DIFFUSECBOARD
    is_mir = tag == TAG_MIRROR
    is_diel = tag == TAG_DIELECTRIC
    is_em = tag == TAG_EMISSIVE

    wo = jnp.where(
        (is_dif | is_cb)[..., None],
        wo_diffuse,
        jnp.where(is_mir[..., None], wo_mirror, jnp.where(is_diel[..., None], wo_diel, wi)),
    )
    one = jnp.ones_like(extinction)
    zero = jnp.zeros_like(extinction)
    weight = jnp.where(
        is_dif[..., None],
        w_dif,
        jnp.where(
            is_cb[..., None],
            w_cb,
            jnp.where((is_mir | is_diel)[..., None], one, zero),
        ),
    )
    weight = jnp.where(is_em[..., None], zero, weight)
    new_ext = jnp.where((is_diel & active)[..., None], ext_diel, extinction)

    # RNG commit: diffuse-ish lanes consumed two draws, dielectric (no TIR) one.
    consumed2 = active & (is_dif | is_cb)
    consumed1 = active & is_diel & ~tir
    new_state = jnp.where(consumed2, state2, jnp.where(consumed1, state1, state))
    return new_state, wo, weight, new_ext
