#!/usr/bin/env python3
"""Smoke test of the path tracer on an NVIDIA GPU: the quickest proof that
the system still starts, renders correctly and what it costs on the card.

Every phase runs in this one process, through the entry points a user calls
(``hijiki.cli.main``, ``Renderer``, ``MultiChipRenderer``), at the size users
render, and prints one line of what it found:

  device       jax sees a GPU; the card's name and power limit (nvidia-smi)
  compile      the sync sweep for 1024^2 cbox+spheres: seconds, memory
  parity       64^2 sync integrator on the card vs the native C++ oracle on
               the host, equal per-pixel seeds: raw MSE < 1e-4
  main path    ``cli.main`` at 1024^2 x 8 spp, sync then wavefront: EXR
               written, finite, mean vs the oracle's, wavefront vs sync
               film, warm sweep seconds and Mrays/s
  beyond L2    the level-3 subdivided scene (~406k triangles, a ~77 MB
               trace table) at 1024^2 x 1 spp: time and peak memory
  trace        profiler trace of one warm 1024^2 sync sweep: top device
               operations, idle share, reconstruction share
  determinism  the same seed twice: bitwise-equal films or not

``--four`` runs only the four-GPU path: ``MultiChipRenderer`` over 4 cards
(1024^2 x 8 spp, sync) and the one-card film it must equal.

A failed phase raises, so the script exits non-zero and prints no result.
Without a GPU it fails at once. The last stdout line is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Files (EXRs, CLI logs, traces) go to ``smoke_out/`` or ``--out``.

Usage: python chip_smoke.py [--four] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SIZE = 1024  # the benchmark frame, reference rays/s definition (src/main.rs:1490)
SPP = 8
PARITY_SIZE = 64
PARITY_SPP = 128
MEAN_RTOL = 0.05  # frame mean vs the oracle's 64^2 mean (MC noise + filter)
FILM_RTOL, FILM_ATOL = 1e-4, 2e-4  # tests/test_wavefront.py
# On the CPU the wavefront image meets that tolerance everywhere. On the card
# the two drivers compile to differently fused kernels, and FMA contraction
# flips a grazing hit on ~1e-5 of paths; each such rerouted path is an
# independent valid sample that the reconstruction spreads over its 5x5
# footprint. So the card check is: almost every pixel within the tolerance,
# and the image MSE inside the equal-seed parity bound.
FILM_CLOSE_SHARE = 0.99
BIG_LEVELS = 3


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def load_cbox():
    """(host CompiledScene, device CompiledScene) of cbox + spheres."""
    from hijiki.scene.cbox_mesh import CBOX_OBJ
    from hijiki.scene.compile import compile_scene, scene_to_device
    from hijiki.scene.obj import load_obj_scene

    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    host = compile_scene(scene)
    return host, scene_to_device(host)


def phase_compile(scene, size=SIZE):
    import jax.numpy as jnp
    import numpy as np

    from hijiki.render.blocks import BlockScheduler
    from hijiki.render.renderer import RenderConfig, Renderer, render_sweep

    cfg = RenderConfig(width=size, height=size, spp=1)
    kwargs = Renderer(scene, cfg)._sweep_kwargs()
    sched = BlockScheduler(size, size, cfg.block_size, 0).sweep(0)
    t = time.monotonic()
    compiled = render_sweep.lower(
        scene,
        jnp.asarray(np.asarray(sched.block_seeds, np.uint32)),
        jnp.asarray(sched.sample_offset),
        seeds_from_blocks=True,
        **kwargs,
    ).compile()
    seconds = time.monotonic() - t
    ma = compiled.memory_analysis()
    mem = (
        "n/a"
        if ma is None
        else f"args {ma.argument_size_in_bytes} B, outputs {ma.output_size_in_bytes} B, "
        f"temp {ma.temp_size_in_bytes} B, code {ma.generated_code_size_in_bytes} B"
    )
    say("compile", f"sync sweep {size}x{size}: {seconds:.2f} s; memory_analysis: {mem}")


def phase_parity(host, scene, size=PARITY_SIZE, spp=PARITY_SPP):
    """Returns the oracle's mean radiance (the reference level for the
    full-size frames)."""
    from hijiki.render import parity

    seeds, offsets = parity.schedule(size, size, 0, spp)
    t = time.monotonic()
    drv = parity.driver_radiance(scene, size, size, seeds, offsets, batch=32)
    t_drv = time.monotonic() - t
    t = time.monotonic()
    orc = parity.oracle_radiance(host, size, size, seeds, offsets)
    t_orc = time.monotonic() - t
    r = parity.compare(orc, drv)
    say(
        "parity",
        f"{size}x{size} x {spp} spp equal seeds: raw MSE {r['mse']:.3e} "
        f"(bound {parity.PARITY_MSE_BOUND:g}), divergent pixels {r['divergent_pixels']}/{r['pixels']}, "
        f"trimmed MSE {r['trimmed_mse']:.3e}; means oracle {orc.mean():.6f} card {drv.mean():.6f}; "
        f"card {t_drv:.1f} s incl. compile, oracle {t_orc:.1f} s on {os.cpu_count()} host threads",
    )
    if not r["mse"] < parity.PARITY_MSE_BOUND:
        raise AssertionError(f"parity MSE {r['mse']:.3e} >= {parity.PARITY_MSE_BOUND}")
    return float(orc.mean())


def check_mean(phase, img, ref_mean):
    import numpy as np

    if not np.isfinite(img).all():
        raise AssertionError(f"{phase}: non-finite pixels")
    rel = abs(float(img.mean()) - ref_mean) / ref_mean
    if rel > MEAN_RTOL:
        raise AssertionError(f"{phase}: mean {img.mean():.6f} vs oracle {ref_mean:.6f} ({rel:.1%})")
    return rel


def phase_main_path(out_dir, ref_mean, card, size=SIZE, spp=SPP):
    import numpy as np

    from hijiki.cli import main as cli_main
    from hijiki.scene.cbox_mesh import CBOX_OBJ
    from hijiki.utils.exr import read_exr

    images = {}
    for driver in ("sync", "wavefront"):
        exr = os.path.join(out_dir, f"cbox_{driver}_{size}.exr")
        mjson = os.path.join(out_dir, f"cbox_{driver}_{size}.json")
        argv = [
            CBOX_OBJ, "--put-cbox-spheres", "--use-bvh", "-w", str(size), "-H", str(size),
            "-s", str(spp), "--driver", driver, "-o", exr, "--metrics-json", mjson,
        ]
        seconds = []
        # the first run compiles (set-up); the second is the warm number
        with open(os.path.join(out_dir, f"cli_{driver}.log"), "w") as log:
            for _ in range(2):
                with contextlib.redirect_stdout(log):
                    rc = cli_main(argv)
                if rc != 0:
                    raise AssertionError(f"cli.main {driver} returned {rc}")
                with open(mjson) as f:
                    seconds.append(json.load(f)["metrics"]["render_seconds"])
        img = read_exr(exr)
        if img.shape != (size, size, 3):
            raise AssertionError(f"{driver}: image shape {img.shape}")
        rel = check_mean(driver, img, ref_mean)
        images[driver] = img
        warm = seconds[1]
        say(
            "main path",
            f"cli {driver} {size}x{size} x {spp} spp: first run {seconds[0]:.2f} s (incl. compile), "
            f"warm {warm:.3f} s = {warm / spp:.3f} s/sweep, {size * size * spp / warm / 1e6:.3f} Mrays/s "
            f"[{card}]; mean {img.mean():.6f} ({rel:.2%} from oracle); {exr}",
        )
    from hijiki.render.parity import PARITY_MSE_BOUND

    s, w = images["sync"], images["wavefront"]
    close = np.isclose(w, s, rtol=FILM_RTOL, atol=FILM_ATOL).all(axis=-1)
    share = float(close.mean())
    mse = float(((w.astype(np.float64) - s) ** 2).mean())
    say(
        "main path",
        f"wavefront vs sync image: {share:.6f} of pixels within rtol {FILM_RTOL:g} atol {FILM_ATOL:g} "
        f"({int((~close).sum())} outside; max abs diff {float(np.abs(w - s).max()):.3e}); "
        f"image MSE {mse:.3e}",
    )
    if share < FILM_CLOSE_SHARE or not mse < PARITY_MSE_BOUND:
        raise AssertionError(f"wavefront image departs from sync: {1 - share:.2%} of pixels, MSE {mse:.3e}")


def make_bigscene(levels=BIG_LEVELS):
    spec = importlib.util.spec_from_file_location(
        "make_bigscene", os.path.join(HERE, "tools", "make_bigscene.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with contextlib.redirect_stdout(sys.stderr):
        return mod.make_bigscene(levels)


def phase_big(ref_mean, card, size=SIZE, levels=BIG_LEVELS):
    import jax

    from hijiki.render.renderer import RenderConfig, Renderer
    from hijiki.scene.compile import compile_scene, scene_to_device
    from hijiki.scene.obj import load_obj_scene

    t = time.monotonic()
    scene = load_obj_scene(make_bigscene(levels))
    scene.put_cbox_spheres()
    host = compile_scene(scene)
    setup = time.monotonic() - t
    dev = scene_to_device(host)
    cfg = RenderConfig(width=size, height=size, spp=1, seed=0)
    times = []
    for _ in range(2):  # compile + render, then warm
        r = Renderer(dev, cfg)
        t = time.monotonic()
        r.render()
        times.append(time.monotonic() - t)
    img = r.image()
    rel = check_mean("beyond L2", img, ref_mean)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    say(
        "beyond L2",
        f"{host.num_triangles} triangles, trace table {host.trace_rows.nbytes} B; set-up "
        f"(generate+load+compile scene) {setup:.1f} s; {size}x{size} x 1 spp: first {times[0]:.2f} s, "
        f"warm {times[1]:.3f} s, {size * size / times[1] / 1e6:.3f} Mrays/s [{card}]; "
        f"peak_bytes_in_use {peak}; mean {img.mean():.6f} ({rel:.2%} from oracle)",
    )


def phase_trace(scene, out_dir, size=SIZE):
    import jax
    import numpy as np

    from hijiki.render.reconstruct import reconstruct_sweep
    from hijiki.render.renderer import RenderConfig, Renderer
    from hijiki.utils import devtrace

    cfg = RenderConfig(width=size, height=size, spp=1, seed=1)
    Renderer(scene, cfg).render()  # warm
    trace_dir = os.path.join(out_dir, "trace_sync_sweep")
    r = Renderer(scene, cfg)
    t = time.monotonic()
    with jax.profiler.trace(trace_dir):
        r.render()
    wall = time.monotonic() - t
    s = devtrace.summarize(devtrace.load_device_events(trace_dir))
    top = "; ".join(f"{name[:60]} {ms:.2f} ms x{n}" for name, ms, n in s["top"][:6])
    scoped = (
        f"{s['scope_share']:.2%} of kernel time"
        if s["scope_share"]
        else "not attributable (no kernel's op name carries the scope)"
    )
    say(
        "trace",
        f"one warm {size}^2 sync sweep: wall {wall:.3f} s (traced), device span "
        f"{s['span_ns'] / 1e6:.2f} ms, busy {s['busy_ns'] / 1e6:.2f} ms, idle share "
        f"{s['idle_share']:.3f}, {s['kernels']} kernels; reconstruct_sweep scope {scoped}; top: {top}",
    )

    # reconstruction alone, same shapes as in the sweep
    rng = np.random.default_rng(0)
    total = jax.numpy.asarray(rng.random((size, size, 3), np.float32))
    normal = jax.numpy.asarray(rng.standard_normal((size, size, 3)).astype(np.float32))
    albedo = jax.numpy.zeros((size, size, 3), jax.numpy.float32)
    offset = jax.numpy.asarray([0.5, 0.5], jax.numpy.float32)
    recon = jax.jit(lambda c, n, a, o: reconstruct_sweep(c, n, a, o, block_size=cfg.block_size))
    recon(total, normal, albedo, offset).block_until_ready()
    recon_dir = os.path.join(out_dir, "trace_reconstruct")
    reps = 5
    with jax.profiler.trace(recon_dir):
        for _ in range(reps):
            recon(total, normal, albedo, offset).block_until_ready()
    rs = devtrace.summarize(devtrace.load_device_events(recon_dir))
    per_call = rs["kernel_ns"] / reps / 1e6
    say(
        "trace",
        f"reconstruct_sweep alone at {size}^2: {per_call:.3f} ms device time per sweep "
        f"({per_call / (s['busy_ns'] / 1e6):.2%} of the sweep's busy time)",
    )


def phase_determinism(scene, size=SIZE):
    import numpy as np

    from hijiki.render.renderer import RenderConfig, Renderer

    parts = []
    for driver in ("sync", "wavefront"):
        films = []
        for _ in range(2):
            r = Renderer(scene, RenderConfig(width=size, height=size, spp=1, seed=5, driver=driver))
            r.render()
            films.append(np.asarray(r.film))
        a, b = films
        same = a.tobytes() == b.tobytes()
        parts.append(
            f"{driver}: {'bitwise equal' if same else 'NOT bitwise equal'}"
            + ("" if same else f" (max abs diff {float(np.abs(a - b).max()):.3e}, "
               f"{int((a != b).any(-1).sum())} pixels)")
        )
    say("determinism", f"same seed twice at {size}^2 x 1 spp: " + "; ".join(parts))


def run_four(out_dir, card, size=SIZE, spp=SPP, ndev=4):
    """MultiChipRenderer over ``ndev`` devices vs the one-device film."""
    import jax
    import numpy as np

    from hijiki.parallel.multichip import MultiChipRenderer
    from hijiki.render.renderer import RenderConfig, Renderer

    if len(jax.devices()) < ndev:
        raise AssertionError(f"--four needs {ndev} devices, jax sees {len(jax.devices())}")
    _, scene = load_cbox()
    cfg = RenderConfig(width=size, height=size, spp=spp, seed=0)
    times = []
    for _ in range(2):  # compile, then warm
        multi = MultiChipRenderer(scene, cfg, num_devices=ndev)
        times.append(multi.render()["render_seconds"])
    single = Renderer(scene, cfg)
    one = single.render()["render_seconds"]
    a, b = np.asarray(multi.film), np.asarray(single.film)
    diff = float(np.abs(a - b).max())
    say(
        "four",
        f"MultiChipRenderer {ndev} devices {size}x{size} x {spp} spp: first {times[0]:.2f} s, "
        f"warm {times[1]:.3f} s = {size * size * spp / times[1] / 1e6:.3f} Mrays/s "
        f"(one device, first run: {one:.2f} s) [{card}]; film vs one device: "
        f"{'bitwise equal' if a.tobytes() == b.tobytes() else 'differs'}, max abs diff {diff:.3e}, "
        f"{int((a != b).any(-1).sum())} pixels differ",
    )
    if not np.allclose(a, b, rtol=5e-4, atol=5e-5):  # tests/test_multichip.py
        raise AssertionError(f"{ndev}-device film departs from the one-device film")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four", action="store_true", help="run only the four-GPU path")
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out"))
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from hijiki.utils.cache import CacheCounter, enable_compilation_cache
    from hijiki.utils.native import find_cxx
    from hijiki.utils.platform import gpu_name_and_power_limit, require_gpu

    dev = require_gpu()
    card = gpu_name_and_power_limit()
    print(card, flush=True)
    card_label = " | ".join(card.splitlines())
    say(
        "device",
        f"{dev['count']} x {dev['kind']} (platform {dev['platform']}); nvidia-smi: {card_label}; "
        f"C++ compiler for the native helpers: {find_cxx()}",
    )
    os.makedirs(args.out, exist_ok=True)
    cache_dir = enable_compilation_cache()
    counter = CacheCounter().attach()
    t_start = time.monotonic()

    if args.four:
        run_four(args.out, card_label)
    else:
        host, scene = load_cbox()
        phase_compile(scene)
        ref_mean = phase_parity(host, scene)
        phase_main_path(args.out, ref_mean, card_label)
        phase_big(ref_mean, card_label)
        phase_trace(scene, args.out)
        phase_determinism(scene)
    say(
        "cache",
        f"compile cache {cache_dir}: {counter.hits} hits, {counter.misses} misses; "
        f"all phases {time.monotonic() - t_start:.1f} s",
    )
    print(json.dumps({"ok": True, "device": {"platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
