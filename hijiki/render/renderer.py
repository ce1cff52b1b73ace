"""The renderer driver: sweeps, film, checkpointing, metrics, previews.

Replaces the reference's ``Renderer`` + per-block command loop
(``src/main.rs:1143-1355``): a sweep traces every pixel of the image as one
batched wavefront dispatch (jitted once, replayed per sweep), reconstructs
with the bilateral filter, and accumulates into the persistent
(rgb*weight, weight) framebuffer. The live winit preview window becomes
periodic PNG snapshots (``preview_interval``); progressive accumulate +
normalize-at-read semantics are identical (``shader/reconstruction.glsl:59,65``,
``shader/preview.glsl:11``).

Checkpoint/resume: the film plus the sweep cursor and the scheduler seed is a
complete render state (the design the reference enables but never implements —
SURVEY.md §5); ``save_checkpoint``/``resume_checkpoint`` snapshot it to .npz.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hijiki.ops.camera import camera_rays
from hijiki.ops.integrate import integrate
from hijiki.ops.rng import seed_rng
from hijiki.render.blocks import BlockScheduler
from hijiki.render.reconstruct import normalize_film, reconstruct_sweep
from hijiki.scene.compile import CompiledScene, scene_to_device
from hijiki.utils.exr import write_exr, write_png

DRIVERS = ("sync", "wavefront")


@dataclass(frozen=True)
class RenderConfig:
    """CLI-level options; defaults mirror the reference's ``Opt``
    (``src/main.rs:1426-1456``: 800x600, 64 spp, preview every 128 blocks)."""

    width: int = 800
    height: int = 600
    spp: int = 64
    block_size: int = 128
    seed: int = 0
    use_bvh: bool = True
    max_bounces: int = 1000
    reconstruction_radius: int = 2  # src/main.rs:1284
    reconstruction_stddev: float = 0.5  # src/main.rs:1285
    preview_interval: int = 0  # sweeps between PNG previews; 0 = off
    preview_path: str = "preview.png"
    leaf_size: int = 1
    # "sync": bulk-synchronous bounce loop; "wavefront": regenerating lane
    # pool with path-regeneration compaction (render/wavefront.py)
    driver: str = "sync"
    wavefront_lanes: int = 1 << 18
    sort_lanes: bool = False
    # traversal backend: "" = "rows" (or "brute" when use_bvh=False)
    traversal: str = ""
    # fixed-albedo mode: populate the albedo AOV (the reference declares but
    # never assigns it — render.glsl:84-85), activating the denoiser's
    # albedo feature term. sync driver only; off = reference parity.
    fixed_albedo: bool = False
    # live terminal preview (ANSI half-blocks; the winit window analog
    # for headless hosts): redraw every N sweeps, 0 = off
    live_preview: int = 0


@partial(
    jax.jit,
    static_argnames=(
        "width",
        "height",
        "block_size",
        "use_bvh",
        "max_bounces",
        "radius",
        "stddev",
        "leaf_size",
        "driver",
        "wavefront_lanes",
        "sort_lanes",
        "traversal",
        "fixed_albedo",
        "seeds_from_blocks",
    ),
)
def render_sweep(
    scene: CompiledScene,
    pixel_seeds,
    sample_offset,
    *,
    width: int,
    height: int,
    block_size: int,
    use_bvh: bool,
    max_bounces: int,
    radius: int,
    stddev: float,
    leaf_size: int,
    driver: str = "sync",
    wavefront_lanes: int = 1 << 18,
    sort_lanes: bool = False,
    traversal: str = "",
    fixed_albedo: bool = False,
    seeds_from_blocks: bool = False,
):
    """Trace + reconstruct one full-image sweep; returns (film_delta, stats).

    seeds_from_blocks: ``pixel_seeds`` is the scheduler's tiny (bh, bw) u32
    block-seed array and the (H, W) per-pixel seeds are derived on device
    (render.blocks.per_pixel_seeds_device), so a sweep uploads a few bytes
    instead of the expanded (H, W) seeds.

    The two halves run under the named scopes ``trace`` and
    ``reconstruct_sweep``, which a profiler trace's op names carry."""
    f32 = jnp.float32
    H, W = height, width
    if seeds_from_blocks:
        from hijiki.render.blocks import per_pixel_seeds_device

        seeds = per_pixel_seeds_device(width, height, block_size, pixel_seeds)
    else:
        seeds = pixel_seeds

    y = jax.lax.broadcasted_iota(f32, (H, W), 0)
    x = jax.lax.broadcasted_iota(f32, (H, W), 1)
    px = jnp.stack([x + sample_offset[0], y + sample_offset[1]], axis=-1)
    if not traversal:
        traversal = "rows" if use_bvh else "brute"

    with jax.named_scope("trace"):
        if driver == "wavefront":
            from hijiki.render.wavefront import render_wavefront

            lanes = min(wavefront_lanes, H * W)
            imgs = render_wavefront(
                scene,
                px.reshape(-1, 2),
                seeds.reshape(-1),
                jnp.asarray([W, H], f32),
                num_lanes=lanes,
                max_iters=max_bounces * max(1, H * W // lanes) + 64,
                max_path_bounces=max_bounces,
                traversal=traversal,
                sort_lanes=sort_lanes,
            )
            total = imgs.color.reshape(H, W, 3)
            normal = imgs.normal.reshape(H, W, 3)
            depth = imgs.depth.reshape(H, W)
            albedo = jnp.zeros((H, W, 3), f32)
        elif driver == "sync":
            o, d, tmin, tmax = camera_rays(
                scene.cam_position,
                scene.cam_rotation,
                scene.cam_fov,
                px,
                jnp.asarray([W, H], f32),
            )
            out = integrate(
                scene,
                o,
                d,
                tmin,
                tmax,
                seed_rng(seeds),
                max_bounces=max_bounces,
                use_bvh=use_bvh,
                leaf_size=leaf_size,
                traversal=traversal,
                albedo_aov=fixed_albedo,
            )
            total, normal, depth, albedo = out.total, out.normal, out.depth, out.albedo
        else:
            raise ValueError(f"unknown driver {driver!r}")

    with jax.named_scope("reconstruct_sweep"):
        film_delta = reconstruct_sweep(
            total,
            normal,
            albedo,
            sample_offset,
            block_size=block_size,
            radius=radius,
            stddev=stddev,
        )
    stats = dict(mean_radiance=jnp.mean(total), mean_depth=jnp.mean(depth))
    return film_delta, stats


class Renderer:
    """Progressive sweep renderer over a compiled scene (reference driver
    loop: src/main.rs:1284-1492 — block scheduling, film accumulation,
    metrics, checkpoint/resume).

    ``compiled`` may be host-side (fresh from ``compile_scene``) or already
    device-resident (``scene_to_device``). To share one table upload across
    several Renderer instances — benchmarks, sweeps over configs — convert
    once with ``scene_to_device`` and pass the converted scene: the
    constructor's own conversion is a no-op on jax arrays."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig):
        if config.driver not in DRIVERS:
            raise ValueError(f"unknown driver {config.driver!r}; choose from {DRIVERS}")
        self.scene = scene_to_device(compiled)
        self.config = config
        self.scheduler = BlockScheduler(
            config.width, config.height, config.block_size, config.seed
        )
        self.film = jnp.zeros((config.height, config.width, 4), jnp.float32)
        self.sweeps_done = 0
        self.metrics: dict = {}
        # optional host-span tracing (utils/tracing.SpanTracer; CLI
        # --trace-json): per-sweep dispatch spans, film sync, checkpoint
        # saves. None = allocation-free no-op.
        self.tracer = None

    def _sweep_kwargs(self):
        c = self.config
        return dict(
            width=c.width,
            height=c.height,
            block_size=c.block_size,
            use_bvh=c.use_bvh,
            max_bounces=c.max_bounces,
            radius=c.reconstruction_radius,
            stddev=c.reconstruction_stddev,
            leaf_size=c.leaf_size,
            driver=c.driver,
            wavefront_lanes=c.wavefront_lanes,
            sort_lanes=c.sort_lanes,
            traversal=c.traversal,
            fixed_albedo=c.fixed_albedo,
        )

    def render(self, progress: Optional[Callable[[int, int], None]] = None):
        """Run the remaining sweeps (all of them unless resumed)."""
        from hijiki.utils.tracing import maybe_span

        c = self.config
        kwargs = self._sweep_kwargs()
        start = time.monotonic()
        sweep_marks = []
        resume_start = self.sweeps_done
        for sweep in range(self.sweeps_done, c.spp):
            sched = self.scheduler.sweep(sweep)
            # per-pixel seeds expand on device from the tiny block-seed array
            # (seeds_from_blocks in render_sweep)
            block_seeds = jnp.asarray(np.asarray(sched.block_seeds, dtype=np.uint32))
            offset = jnp.asarray(sched.sample_offset)
            with maybe_span(self.tracer, "dispatch sweep", sweep=sweep):
                delta, _ = render_sweep(
                    self.scene, block_seeds, offset, seeds_from_blocks=True, **kwargs
                )
            self.film = self.film + delta
            self.sweeps_done = sweep + 1
            if progress is not None:
                progress(self.sweeps_done, c.spp)
            if c.preview_interval and self.sweeps_done % c.preview_interval == 0:
                self.save_png(c.preview_path)
            if c.live_preview and self.sweeps_done % c.live_preview == 0:
                self._term_preview().update(
                    self.image(),
                    f"{self.sweeps_done}/{c.spp} sweeps",
                )
            # dispatch-side wall-clock marks; device work may lag behind
            sweep_marks.append(time.monotonic() - start)
        with maybe_span(self.tracer, "film ready"):
            self.film.block_until_ready()
        elapsed = time.monotonic() - start
        # only the sweeps traced in THIS call: after a checkpoint resume the
        # loop starts at resume_start, and counting the full spp would inflate
        # rays/s (parallel/multihost.py applies the same rule)
        sweeps_traced = self.sweeps_done - resume_start
        primary_rays = c.width * c.height * sweeps_traced
        self.metrics = dict(
            render_seconds=elapsed,
            primary_rays=primary_rays,
            rays_per_second=primary_rays / elapsed if elapsed > 0 else 0.0,
            spp_per_second=sweeps_traced / elapsed if elapsed > 0 else 0.0,
            sweep_marks=sweep_marks,
        )
        if self.tracer is not None:
            self.tracer.counter(
                "throughput",
                mrays_per_s=self.metrics["rays_per_second"] / 1e6,
                spp_per_s=self.metrics["spp_per_second"],
            )
        return self.metrics

    def _term_preview(self):
        if not hasattr(self, "_term_preview_obj"):
            from hijiki.utils.term_preview import TerminalPreview

            self._term_preview_obj = TerminalPreview()
        return self._term_preview_obj

    def image(self) -> np.ndarray:
        """Normalized (H,W,3) float RGB."""
        return np.asarray(normalize_film(self.film))

    def save_exr(self, path: str) -> None:
        write_exr(path, self.image())

    def save_png(self, path: str) -> None:
        write_png(path, self.image())

    # --- checkpoint / resume (net-new vs the reference, SURVEY.md §5) ---

    def save_checkpoint(self, path: str) -> None:
        from hijiki.utils.tracing import maybe_span

        with maybe_span(self.tracer, "checkpoint save", path=path):
            np.savez(
                path,
                film=np.asarray(self.film),
                sweeps_done=self.sweeps_done,
                config=json.dumps(dataclasses.asdict(self.config)),
            )

    @classmethod
    def resume_checkpoint(
        cls,
        compiled: CompiledScene,
        path: str,
        config: "RenderConfig | None" = None,
        **ctor_kwargs,
    ) -> "Renderer":
        """Resume a checkpointed render.

        ``config`` (e.g. from fresh CLI flags) may override the checkpointed
        one — so resuming with a higher spp renders the extra sweeps — but
        fields that would change the already-accumulated film (geometry of
        the estimate: size, seed, block size, driver, bounces) must match.
        """
        data = np.load(path, allow_pickle=False)
        ckpt_config = RenderConfig(**json.loads(str(data["config"])))
        if config is not None:
            for f in ("width", "height", "block_size", "seed", "use_bvh",
                      "max_bounces", "driver", "reconstruction_radius",
                      "reconstruction_stddev", "fixed_albedo"):
                a, b = getattr(config, f), getattr(ckpt_config, f)
                if a != b:
                    raise ValueError(
                        f"checkpoint resume: {f}={a!r} conflicts with the "
                        f"checkpointed render's {f}={b!r}"
                    )
        r = cls(compiled, config or ckpt_config, **ctor_kwargs)
        r.film = jnp.asarray(data["film"])
        r.sweeps_done = int(data["sweeps_done"])
        # replay the scheduler to the checkpointed sweep so the remaining
        # sweeps use the seeds they would have had uninterrupted
        for s in range(r.sweeps_done):
            r.scheduler.sweep(s)
        return r
