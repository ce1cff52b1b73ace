"""Equal-seed parity: the production integrator against the native oracle.

Both sides trace the same per-pixel seeds and per-sweep jitter that the
renderer's BlockScheduler draws, and both return the per-pixel mean
radiance before reconstruction. With identical estimators the difference is
f32 rounding noise, except on the few paths where FMA contraction or a
transcendental's last bit flips a grazing hit decision; such a path becomes
an independent valid sample. The gate is the repo's equal-seed bound
(docs/PARITY.md): MSE < 1e-4.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

PARITY_MSE_BOUND = 1e-4
BLOCK = 64  # the block size the oracle tools have always used


def schedule(width: int, height: int, seed: int, spp: int):
    """(seeds (spp, H*W) u32, offsets (spp, 2) f32) of the renderer's
    scheduler for ``spp`` sweeps."""
    from hijiki.render.blocks import BlockScheduler, per_pixel_seeds

    sched = BlockScheduler(width, height, BLOCK, seed)
    seeds, offsets = [], []
    for s in range(spp):
        sw = sched.sweep(s)
        seeds.append(np.asarray(per_pixel_seeds(width, height, BLOCK, sw.block_seeds)).reshape(-1))
        offsets.append(np.asarray(sw.sample_offset, np.float32))
    return np.stack(seeds), np.stack(offsets)


def driver_radiance(scene, width, height, seeds, offsets, *, max_bounces=1000, batch=16):
    """Per-pixel mean radiance (H, W, 3) f64 of the sync integrator on the
    default device. ``batch`` sweeps go into one launch: per-lane paths do
    not depend on their neighbours, so stacking sweeps is exact."""
    import jax.numpy as jnp

    from hijiki.ops.camera import camera_rays
    from hijiki.ops.integrate import integrate
    from hijiki.ops.rng import seed_rng

    spp = seeds.shape[0]
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    acc = np.zeros((height, width, 3), np.float64)
    for s0 in range(0, spp, batch):
        n = min(batch, spp - s0)
        px = np.concatenate([(x + offsets[s, 0]).reshape(-1) for s in range(s0, s0 + n)])
        py = np.concatenate([(y + offsets[s, 1]).reshape(-1) for s in range(s0, s0 + n)])
        pxy = jnp.stack([jnp.asarray(px), jnp.asarray(py)], axis=-1)
        o, d, tmin, tmax = camera_rays(
            scene.cam_position, scene.cam_rotation, scene.cam_fov, pxy,
            jnp.asarray([width, height], jnp.float32),
        )
        out = integrate(
            scene, o, d, tmin, tmax, seed_rng(jnp.asarray(seeds[s0 : s0 + n].reshape(-1))),
            max_bounces=max_bounces,
        )
        acc += np.asarray(out.total, np.float64).reshape(n, height, width, 3).sum(axis=0)
    return acc / spp


def oracle_radiance(compiled, width, height, seeds, offsets, *, max_bounces=1000, workers=None):
    """Per-pixel mean radiance (H, W, 3) f64 of the native oracle, the sweeps
    split over ``workers`` host threads (the ctypes call releases the GIL)."""
    import os

    from hijiki.ops.oracle_native import render_oracle_native

    spp = seeds.shape[0]
    workers = max(1, min(workers or os.cpu_count() or 1, spp))
    parts = np.array_split(np.arange(spp), workers)

    def run(idx):
        return render_oracle_native(
            compiled, seeds[idx], offsets[idx], width, height, max_bounces=max_bounces
        )

    with ThreadPoolExecutor(workers) as pool:
        accs = list(pool.map(run, [p for p in parts if p.size]))
    return sum(accs) / spp


def compare(a, b) -> dict:
    """Raw MSE of two radiance images plus the divergent-pixel accounting:
    a pixel whose per-pixel MSE exceeds 1e-6 (far above f32 noise) holds at
    least one rerouted path; the trimmed MSE leaves those pixels out."""
    err = ((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).mean(axis=-1)
    tie = err > 1e-6
    return dict(
        mse=float(err.mean()),
        divergent_pixels=int(tie.sum()),
        pixels=int(err.size),
        trimmed_mse=float(err[~tie].mean()) if (~tie).any() else 0.0,
    )
