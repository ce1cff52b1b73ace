"""Multi-device rendering: blocks sharded over a device mesh, summed films.

The distributed layer the reference never had (single GPU, single queue —
SURVEY.md §2.5): each sweep's image blocks are distributed round-robin over a
1-D ``jax.sharding.Mesh``; every device traces its blocks as one wavefront
batch, reconstructs them into a full-size *partial* (rgb*weight, weight)
framebuffer (the bilateral filter only ever reads within a block, so partials
are exact), and the partials are summed across the mesh with a banded
``psum_scatter`` (or ``psum``). Every pixel's block is traced on exactly one
device and the others contribute zeros, so the multi-device film equals the
single-device render.

Per-shard RNG: block seeds come from the same host schedule as single-chip
rendering (seed = f(user_seed, sweep, block)), so device count does not change
the sampled estimate — only which chip computes it.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from hijiki.ops.camera import camera_rays
from hijiki.ops.integrate import integrate
from hijiki.ops.rng import seed_rng
from hijiki.render.reconstruct import reconstruct_sweep
from hijiki.render.renderer import RenderConfig, Renderer
from hijiki.scene.compile import CompiledScene
from hijiki.utils.vma import match_vma


def trace_blocks(
    scene: CompiledScene,
    origins,  # (k,2) i32 block origins (x,y); dummy blocks use (W,H)
    dims,  # (k,2) i32 clipped block dims (w,h)
    seeds,  # (k,) u32 block seeds
    sample_offset,  # (2,) f32
    *,
    width: int,
    height: int,
    block_size: int,
    use_bvh: bool,
    max_bounces: int,
    radius: int,
    stddev: float,
    leaf_size: int,
):
    """Trace k blocks (tiles of block_size^2 lanes) and reconstruct them into
    a full-size partial framebuffer delta. Pure function of its inputs — the
    unit sharded by shard_map."""
    f32 = jnp.float32
    B = block_size
    k = origins.shape[0]

    ly = jax.lax.broadcasted_iota(jnp.int32, (k, B, B), 1)
    lx = jax.lax.broadcasted_iota(jnp.int32, (k, B, B), 2)
    gx = origins[:, 0, None, None] + lx
    gy = origins[:, 1, None, None] + ly

    # per-pixel seed = block_seed + lx + ly*clipped_width (render.glsl:156-157)
    state = seed_rng(
        seeds[:, None, None]
        + lx.astype(jnp.uint32)
        + ly.astype(jnp.uint32) * dims[:, 0, None, None].astype(jnp.uint32)
    )

    px = jnp.stack(
        [gx.astype(f32) + sample_offset[0], gy.astype(f32) + sample_offset[1]], axis=-1
    )
    o, d, tmin, tmax = camera_rays(
        scene.cam_position,
        scene.cam_rotation,
        scene.cam_fov,
        px,
        jnp.asarray([width, height], f32),
    )
    out = integrate(
        scene,
        o,
        d,
        tmin,
        tmax,
        state,
        max_bounces=max_bounces,
        use_bvh=use_bvh,
        leaf_size=leaf_size,
    )

    # Scatter tiles into a padded full-image canvas (pad absorbs dummy blocks
    # placed at origin (W,H) and edge-block overdraw), then crop.
    def scatter(tiles, ch):
        # the loop-carried canvas (and constant tiles like the all-ones
        # weight) must share the per-shard block origins' varying axes under
        # shard_map's check_vma (utils/vma.py; no-op unsharded)
        canvas = match_vma(jnp.zeros((height + B, width + B, ch), f32), origins)
        tiles = match_vma(tiles, origins)

        def body(i, cv):
            return jax.lax.dynamic_update_slice(
                cv, tiles[i], (origins[i, 1], origins[i, 0], 0)
            )

        return jax.lax.fori_loop(0, k, body, canvas)[:height, :width]

    color = scatter(out.total, 3)
    normal = scatter(out.normal, 3)
    albedo = scatter(out.albedo, 3)
    ones = scatter(jnp.ones((k, B, B, 1), f32), 1)[..., 0]

    return reconstruct_sweep(
        color,
        normal,
        albedo,
        sample_offset,
        block_size=B,
        radius=radius,
        stddev=stddev,
        sample_weight=ones,
    )


def make_sharded_sweep(mesh: Mesh, scene: CompiledScene, **kwargs):
    """Build the jitted sharded sweep function for a mesh.

    Film reduction is a banded ``psum_scatter`` over rows whenever the
    height is a multiple of the device count: each device ends
    the sweep OWNING the fully-reduced band of rows it is responsible for,
    so the per-hop payload is O(frame/N) instead of the full-frame
    O(frame) an all-reduce ships, and the film stays row-sharded on device
    across sweep accumulation — it is gathered once, at host readback
    (np.asarray in save/checkpoint). Falls back to the full psum for odd
    heights (the result is identical either way; sample accumulation is
    associative addition)."""
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    banded = kwargs["height"] % ndev == 0

    def per_device(scene_, origins, dims, seeds, sample_offset):
        delta = trace_blocks(scene_, origins, dims, seeds, sample_offset, **kwargs)
        if banded:
            return jax.lax.psum_scatter(
                delta, axis, scatter_dimension=0, tiled=True
            )
        return jax.lax.psum(delta, axis)

    scene_specs = jax.tree.map(lambda _: P(), scene)
    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(scene_specs, P(axis), P(axis), P(axis), P()),
        out_specs=P(axis) if banded else P(),
        # check_vma stays ON: loop-carry inits are vma-promoted where they
        # mix with per-shard data (utils/vma.py match_vma at every loop site)
    )
    return jax.jit(fn)


class MultiChipRenderer(Renderer):
    """Renderer sharding each sweep's blocks over a device mesh."""

    def __init__(
        self,
        compiled: CompiledScene,
        config: RenderConfig,
        num_devices: Optional[int] = None,
        devices=None,
    ):
        super().__init__(compiled, config)
        if devices is None:
            devices = jax.devices()[: num_devices or len(jax.devices())]
        self.mesh = Mesh(np.array(devices), ("d",))
        self.n_dev = len(devices)

        c = config
        # static block list (origins/dims), padded to a multiple of n_dev
        ox, oy = np.meshgrid(
            np.arange(0, c.width, c.block_size), np.arange(0, c.height, c.block_size)
        )
        origins = np.stack([ox.ravel(), oy.ravel()], axis=-1).astype(np.int32)
        dims = np.stack(
            [
                np.minimum(c.block_size, c.width - origins[:, 0]),
                np.minimum(c.block_size, c.height - origins[:, 1]),
            ],
            axis=-1,
        ).astype(np.int32)
        self.n_real_blocks = origins.shape[0]
        pad = (-origins.shape[0]) % self.n_dev
        if pad:
            dummy_o = np.tile([[c.width, c.height]], (pad, 1)).astype(np.int32)
            dummy_d = np.tile([[1, 1]], (pad, 1)).astype(np.int32)
            origins = np.concatenate([origins, dummy_o])
            dims = np.concatenate([dims, dummy_d])
        self.block_origins = origins
        self.block_dims = dims

        self._sweep_fn = make_sharded_sweep(
            self.mesh,
            self.scene,
            width=c.width,
            height=c.height,
            block_size=c.block_size,
            use_bvh=c.use_bvh,
            max_bounces=c.max_bounces,
            radius=c.reconstruction_radius,
            stddev=c.reconstruction_stddev,
            leaf_size=c.leaf_size,
        )

    def _sweep_delta(self, sched):
        """One sweep's film delta, blocks sharded over the mesh."""
        seeds = sched.block_seeds.reshape(-1)
        pad = self.block_origins.shape[0] - seeds.shape[0]
        if pad:
            seeds = np.concatenate([seeds, np.zeros(pad, np.uint32)])
        return self._sweep_fn(
            self.scene,
            jnp.asarray(self.block_origins),
            jnp.asarray(self.block_dims),
            jnp.asarray(seeds),
            jnp.asarray(sched.sample_offset),
        )

    def render(self, progress=None):
        import time

        from hijiki.utils.tracing import maybe_span

        c = self.config
        start = time.monotonic()
        resume_start = self.sweeps_done
        for sweep in range(self.sweeps_done, c.spp):
            with maybe_span(self.tracer, "dispatch sweep (sharded blocks)",
                            sweep=sweep, devices=self.n_dev):
                delta = self._sweep_delta(self.scheduler.sweep(sweep))
            self.film = self.film + delta
            self.sweeps_done = sweep + 1
            if progress is not None:
                progress(self.sweeps_done, c.spp)
            if c.preview_interval and self.sweeps_done % c.preview_interval == 0:
                self.save_png(c.preview_path)
        with maybe_span(self.tracer, "film ready"):
            self.film.block_until_ready()
        elapsed = time.monotonic() - start
        # only the sweeps traced in THIS call (same rule as Renderer.render:
        # counting the full spp inflates rays/s after a checkpoint resume)
        sweeps_traced = self.sweeps_done - resume_start
        primary = c.width * c.height * sweeps_traced
        self.metrics = dict(
            render_seconds=elapsed,
            primary_rays=primary,
            rays_per_second=primary / elapsed if elapsed > 0 else 0.0,
            spp_per_second=sweeps_traced / elapsed if elapsed > 0 else 0.0,
            devices=self.n_dev,
        )
        return self.metrics
