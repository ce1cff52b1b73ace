"""Block/sweep scheduling and the deterministic seed schedule.

The reference's ``ImageBlockGenerator`` (``src/main.rs:619-682``) raster-scans
the image in ``block_size`` tiles, one full sweep per sample: each block gets
a fresh random u32 seed and each sweep a shared random subpixel offset, both
from OS entropy. We keep the exact structure (per-block seeds, per-sweep
offsets, per-pixel seed = block_seed + lx + ly*block_width with the *clipped*
block width, ``shader/render.glsl:156-157``) but derive everything from one
user seed through numpy's PCG so renders are reproducible. Statistically
identical to the reference; strictly more debuggable.

Here a "block" is a seeding/reconstruction unit, not a dispatch unit: all
blocks of a sweep trace as one batched wavefront.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class SweepSchedule:
    """Host-side randomness for one sweep."""

    sweep: int
    sample_offset: np.ndarray  # (2,) f32 in [0,1)
    block_seeds: np.ndarray  # (nby, nbx) u32


class BlockScheduler:
    """Deterministic replacement for the reference's OS-entropy seeding."""

    def __init__(self, width: int, height: int, block_size: int, seed: int):
        if block_size & 63:
            # same constraint as the reference (src/main.rs:633)
            raise ValueError("block_size must be a multiple of 64")
        self.width = width
        self.height = height
        self.block_size = block_size
        self.nbx = cdiv(width, block_size)
        self.nby = cdiv(height, block_size)
        # numpy 2.x: np.uint64(x) REJECTS out-of-range python ints
        # (OverflowError) instead of wrapping — wrap explicitly so
        # --seed -1 and huge seeds behave like uint64 arithmetic
        self._rng = np.random.default_rng(np.uint64(int(seed) & (2**64 - 1)))

    def sweep(self, sweep_index: int) -> SweepSchedule:
        offset = self._rng.random(2, dtype=np.float32)
        seeds = self._rng.integers(
            0, 1 << 32, size=(self.nby, self.nbx), dtype=np.uint32
        )
        return SweepSchedule(sweep_index, offset, seeds)


def per_pixel_seeds_device(width, height, block_size, block_seeds):
    """Traced (jnp) twin of per_pixel_seeds: expands the (bh, bw) u32 block
    seeds to (H, W) per-pixel seeds ON DEVICE with repeat + iota arithmetic,
    so a sweep uploads the block seeds instead of the expanded (H, W) array."""
    import jax
    import jax.numpy as jnp

    B = block_size
    bh, bw_n = block_seeds.shape
    base = jnp.repeat(jnp.repeat(block_seeds, B, axis=0), B, axis=1)
    base = base[:height, :width]
    y = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
    x = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
    bx = x // B
    lx = x - bx * B
    ly = y - (y // B) * B
    clip_w = jnp.minimum(B, width - bx * B)
    return (
        base
        + lx.astype(jnp.uint32)
        + ly.astype(jnp.uint32) * clip_w.astype(jnp.uint32)
    )


def per_pixel_seeds(width, height, block_size, block_seeds):
    """Per-pixel RNG seeds for a sweep (numpy, host side).

    seed = block_seed + lx + ly * block_width_clipped
    (``shader/render.glsl:156-157`` with ``dimension`` = the clipped block
    dims from ``src/main.rs:657-658``). The hot path uses the traced twin
    ``per_pixel_seeds_device`` (render_sweep's seeds_from_blocks mode); this
    host form remains for tools/tests and the non-jit paths.
    """
    block_seeds = np.asarray(block_seeds, dtype=np.uint32)
    y, x = np.mgrid[0:height, 0:width]
    bx, by = x // block_size, y // block_size
    lx, ly = x - bx * block_size, y - by * block_size
    bw = np.minimum(block_size, width - bx * block_size)
    with np.errstate(over="ignore"):
        return (
            block_seeds[by, bx]
            + lx.astype(np.uint32)
            + ly.astype(np.uint32) * bw.astype(np.uint32)
        )
