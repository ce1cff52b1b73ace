"""Multi-host rendering: sweeps sharded across processes.

The second distributed axis (SURVEY.md §2.5): *within* a process, blocks
shard over the local devices' mesh (parallel/multichip.py); *across* processes,
whole sweeps shard round-robin — host h renders sweeps h, h+N, h+2N, ... of
the identical deterministic schedule (seed = f(user_seed, sweep, block), see
render/blocks.py), so the union over hosts is exactly the single-host sample
set. Films are (rgb*weight, weight) running sums (shader/reconstruction.glsl
semantics), i.e. associative additions, so the merge is one allreduce-style
sum at readback time — no per-sweep communication at all.

On GPUs, run one process per card: a JAX process reserves most of a card's
memory when it first uses it, so a second process on the same card fails.

Works without a jax.distributed environment: hosts can be simulated by
constructing several renderers with explicit (host_id, num_hosts) and merging
their films with ``merge_films`` (this is how the tests validate exactness);
under a real multi-process run ``merged_film()`` gathers via
``process_allgather``.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hijiki.parallel.multichip import MultiChipRenderer
from hijiki.render.blocks import per_pixel_seeds
from hijiki.render.reconstruct import normalize_film
from hijiki.render.renderer import RenderConfig, Renderer, render_sweep
from hijiki.scene.compile import CompiledScene


def host_sweeps(spp: int, host_id: int, num_hosts: int) -> list:
    """Round-robin sweep assignment: host h gets sweeps h, h+N, ..."""
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} outside [0, {num_hosts})")
    return list(range(host_id, spp, num_hosts))


def merge_films(films) -> jnp.ndarray:
    """Merge per-host partial films. Accumulation is associative addition of
    (rgb*w, w) sums, so the merged film equals a single-host render of the
    union of sweeps (up to float summation order)."""
    out = films[0]
    for f in films[1:]:
        out = out + f
    return out


class MultiHostRenderer(Renderer):
    """Renderer that traces only this host's share of the sweeps.

    host_id/num_hosts default to jax.process_index()/jax.process_count(), so
    under jax.distributed each process automatically takes its stride; both
    can be passed explicitly for simulation or external schedulers.
    """

    def __init__(
        self,
        compiled: CompiledScene,
        config: RenderConfig,
        host_id: Optional[int] = None,
        num_hosts: Optional[int] = None,
    ):
        super().__init__(compiled, config)
        self.num_hosts = jax.process_count() if num_hosts is None else num_hosts
        self.host_id = jax.process_index() if host_id is None else host_id
        self.sweep_ids = host_sweeps(config.spp, self.host_id, self.num_hosts)
        self._done = 0
        self.sweeps_done = 0  # mirrors _done (checkpoint compatibility)
        # BlockScheduler draws are call-order-stateful (the reference seeds
        # sequentially from OS entropy, src/main.rs:643,675); every host must
        # therefore draw the FULL schedule in order and keep only its share —
        # that is what makes the union over hosts the exact single-host
        # sample set.
        self._schedules = [self.scheduler.sweep(s) for s in range(config.spp)]

    def render(self, progress: Optional[Callable[[int, int], None]] = None):
        import time

        c = self.config
        kwargs = self._sweep_kwargs()
        start = time.monotonic()
        resume_start = self._done
        for sweep in self.sweep_ids[self._done :]:
            sched = self._schedules[sweep]
            pixel_seeds = per_pixel_seeds(
                c.width, c.height, c.block_size, sched.block_seeds
            )
            delta, _ = render_sweep(
                self.scene,
                jnp.asarray(pixel_seeds),
                jnp.asarray(sched.sample_offset),
                **kwargs,
            )
            self.film = self.film + delta
            self._done += 1
            self.sweeps_done = self._done
            if progress is not None:
                progress(self._done, len(self.sweep_ids))
        self.film.block_until_ready()
        elapsed = time.monotonic() - start
        # only the sweeps traced in THIS call (renderer.py's resume rule)
        primary = c.width * c.height * (self._done - resume_start)
        self.metrics = dict(
            render_seconds=elapsed,
            primary_rays=primary,
            rays_per_second=primary / elapsed if elapsed > 0 else 0.0,
            host_id=self.host_id,
            num_hosts=self.num_hosts,
            sweeps=len(self.sweep_ids),
        )
        return self.metrics

    @classmethod
    def resume_checkpoint(
        cls, compiled, path, config=None, host_id=None, num_hosts=None
    ):
        """Resume a checkpointed partial render. The checkpoint stores this
        host's completed-sweep COUNT; resuming with a different host_id or
        num_hosts than the original run would change which sweeps the count
        refers to, so pass the same split as the original run."""
        base = Renderer.resume_checkpoint(compiled, path, config)
        r = cls(compiled, base.config, host_id=host_id, num_hosts=num_hosts)
        r.film = base.film
        r._done = r.sweeps_done = base.sweeps_done
        return r

    def merged_film(self) -> jnp.ndarray:
        """The full-estimate film: sum of every host's partial film.

        Under a multi-process jax.distributed run this gathers the partials;
        single-process it is the local film (num_hosts simulations merge
        explicitly with merge_films)."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            stacked = multihost_utils.process_allgather(self.film)
            return jnp.sum(stacked, axis=0)
        return self.film

    def merged_image(self) -> np.ndarray:
        """Normalized (H,W,3) RGB of the merged estimate."""
        return np.asarray(normalize_film(self.merged_film()))


class _HostStrideMixin:
    """Host-striding over a device-sharding base renderer: the two-level
    topology of SURVEY §2.5 — within a process, every sweep's work shards
    over the LOCAL devices (shard_map + psum, parallel/multichip.py);
    across processes, whole sweeps stride round-robin and partial films
    merge associatively at readback (no per-sweep communication).

    The base class must provide ``_sweep_delta(sched)``. Checkpoint/resume
    is not specialized here — use MultiHostRenderer for resumable
    multi-host runs, or checkpoint the merged film externally.
    """

    def _init_stride(self, config, host_id, num_hosts):
        self.num_hosts = jax.process_count() if num_hosts is None else num_hosts
        self.host_id = jax.process_index() if host_id is None else host_id
        self.sweep_ids = host_sweeps(config.spp, self.host_id, self.num_hosts)
        self._done = 0
        self.sweeps_done = 0
        # every host draws the FULL stateful schedule and keeps its stride
        # (see MultiHostRenderer.__init__)
        self._schedules = [self.scheduler.sweep(s) for s in range(config.spp)]

    def render(self, progress: Optional[Callable[[int, int], None]] = None):
        import time

        c = self.config
        start = time.monotonic()
        resume_start = self._done
        for sweep in self.sweep_ids[self._done :]:
            delta = self._sweep_delta(self._schedules[sweep])
            self.film = self.film + delta
            self._done += 1
            self.sweeps_done = self._done
            if progress is not None:
                progress(self._done, len(self.sweep_ids))
        self.film.block_until_ready()
        elapsed = time.monotonic() - start
        traced = self._done - resume_start
        primary = c.width * c.height * traced
        self.metrics = dict(
            render_seconds=elapsed,
            primary_rays=primary,
            rays_per_second=primary / elapsed if elapsed > 0 else 0.0,
            spp_per_second=traced / elapsed if elapsed > 0 else 0.0,
            devices=self.n_dev,
            host_id=self.host_id,
            num_hosts=self.num_hosts,
            sweeps=len(self.sweep_ids),
        )
        return self.metrics

    merged_film = MultiHostRenderer.merged_film
    merged_image = MultiHostRenderer.merged_image


def _local_devices(num_devices):
    devices = jax.local_devices()
    return devices[:num_devices] if num_devices else devices


class MultiHostMultiChipRenderer(_HostStrideMixin, MultiChipRenderer):
    """Blocks shard over this process's local devices; sweeps stride across
    processes. host_id/num_hosts default to the jax.distributed topology."""

    def __init__(self, compiled, config, host_id=None, num_hosts=None,
                 num_devices=None, devices=None):
        super().__init__(
            compiled, config,
            devices=list(_local_devices(num_devices)) if devices is None
            else devices,
        )
        self._init_stride(config, host_id, num_hosts)
