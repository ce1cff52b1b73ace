"""Reconstruction filter vs a direct per-block transcription of
shader/reconstruction.glsl (including block spill/OOB-center quirks)."""

import numpy as np
import jax.numpy as jnp

from hijiki.render.reconstruct import normalize_film, reconstruct_sweep
import pytest


# fast per-commit gate tier (README: python -m pytest tests -m quick)
pytestmark = pytest.mark.quick

F = np.float32


def reconstruct_block_oracle(color, normal, albedo, so, B, R, sigma):
    """Per-block GLSL-semantics reconstruction (slow numpy oracle).

    Mirrors reconstruction.glsl's dispatch: per block, output locals in
    [0, d+R) (negative locals discarded by the unsigned-underflow quirk),
    window reads restricted to the block interior, center features read from
    the block-local intermediate texture (OOB -> 0 for full blocks; clipped
    blocks' spill pixels land outside the image and are dropped).
    """
    H, W = color.shape[:2]
    out = np.zeros((H, W, 4), F)
    gauss_fac = F(-1.0 / (2 * sigma * sigma))
    curve = F(np.exp(gauss_fac * R * R))
    for by in range(0, H, B):
        for bx in range(0, W, B):
            dw, dh = min(B, W - bx), min(B, H - by)
            for ly in range(0, dh + R):
                for lx in range(0, dw + R):
                    px, py = bx + lx, by + ly
                    if px >= W or py >= H:
                        continue  # imageStore OOB dropped
                    # center features: block-local intermediate texture read;
                    # OOB (local >= block texture size B) -> 0. For spill
                    # pixels inside the texture the overdraw value at the same
                    # global pixel is read (first-hit AOVs are deterministic
                    # per pixel, so it equals the image value).
                    if lx < B and ly < B:
                        n_c = normal[py, px]
                        a_c = albedo[py, px]
                    else:
                        n_c = np.zeros(3, F)
                        a_c = np.zeros(3, F)
                    acc = np.zeros(4, F)
                    for dy in range(-R, R + 1):
                        if ly + dy < 0 or ly + dy >= dh:
                            continue
                        for dx in range(-R, R + 1):
                            if lx + dx < 0 or lx + dx >= dw:
                                continue
                            off = np.array([dx, dy], F) + so - F(0.5)
                            w_sp = np.exp(gauss_fac * np.dot(off, off)) - curve
                            if w_sp < 0:
                                continue
                            qx, qy = px + dx, py + dy
                            dn = normal[qy, qx] - n_c
                            da = albedo[qy, qx] - a_c
                            w = w_sp * np.exp(-(2 * np.dot(dn, dn) + np.dot(da, da)))
                            contrib = w * np.array(
                                [color[qy, qx, 0], color[qy, qx, 1], color[qy, qx, 2], 1.0],
                                F,
                            )
                            if np.any(np.isnan(contrib)):
                                continue
                            acc += contrib
                    out[py, px] += acc
    return out


def test_reconstruct_matches_block_oracle():
    rng = np.random.default_rng(3)
    H = W = 24
    B, R, sigma = 8, 2, 0.5
    color = rng.uniform(0, 2, (H, W, 3)).astype(F)
    normal = rng.normal(size=(H, W, 3)).astype(F)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    albedo = np.zeros((H, W, 3), F)
    # inject a NaN to exercise rejection
    color[5, 5, 1] = np.nan
    so = np.array([0.3, 0.7], F)

    got = np.asarray(
        reconstruct_sweep(
            jnp.asarray(color),
            jnp.asarray(normal),
            jnp.asarray(albedo),
            jnp.asarray(so),
            block_size=B,
            radius=R,
            stddev=sigma,
        )
    )
    want = reconstruct_block_oracle(color, normal, albedo, so, B, R, sigma)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_reconstruct_clipped_blocks():
    # image not a multiple of the block size: exercises clipped-dim masks
    rng = np.random.default_rng(4)
    H, W, B, R, sigma = 19, 21, 8, 2, 0.5
    color = rng.uniform(0, 1, (H, W, 3)).astype(F)
    normal = rng.normal(size=(H, W, 3)).astype(F)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    albedo = np.zeros((H, W, 3), F)
    so = np.array([0.9, 0.1], F)
    got = np.asarray(
        reconstruct_sweep(
            jnp.asarray(color),
            jnp.asarray(normal),
            jnp.asarray(albedo),
            jnp.asarray(so),
            block_size=B,
            radius=R,
            stddev=sigma,
        )
    )
    want = reconstruct_block_oracle(color, normal, albedo, so, B, R, sigma)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_normalize():
    film = jnp.asarray(np.array([[[2.0, 4.0, 6.0, 2.0]]], F))
    np.testing.assert_allclose(np.asarray(normalize_film(film)), [[[1, 2, 3]]])
