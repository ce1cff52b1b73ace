"""Benchmark: cbox (+spheres) at 1024^2 x 8 spp on one GPU.

Prints ONE JSON line on stdout: primary Mrays/s (the reference's rays/s,
src/main.rs:1490-1492: width*height*spp / wall-clock) for each timed pass and
their median, the first (compiling) pass's seconds, the device as jax reports
it, the card's name and power limit, and persistent compile-cache hits.
Diagnostics go to stderr.

Each pass renders with a fresh Renderer; ``Renderer.render`` ends with
``block_until_ready`` on the film, so a pass's time covers the device work.
It fails without a GPU: a CPU run must never pass for a card number.

Usage: python bench.py [--driver sync|wavefront] [--passes N] [--size S] [--spp N]
"""

import argparse
import json
import statistics
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from hijiki.render.renderer import DRIVERS

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--driver", choices=DRIVERS, default="sync")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=8)
    args = ap.parse_args()

    from hijiki.utils.cache import CacheCounter, enable_compilation_cache
    from hijiki.utils.platform import gpu_name_and_power_limit, require_gpu

    device = require_gpu()
    card = gpu_name_and_power_limit()
    cache_dir = enable_compilation_cache()
    counter = CacheCounter().attach()

    from hijiki.render.renderer import RenderConfig, Renderer
    from hijiki.scene.cbox_mesh import CBOX_OBJ
    from hijiki.scene.compile import compile_scene, scene_to_device
    from hijiki.scene.obj import load_obj_scene

    W = H = args.size
    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    # device-resident once: every pass's Renderer shares these buffers
    compiled = scene_to_device(compile_scene(scene))
    log(f"device {device}, card {card}, driver {args.driver}")

    def one_pass(seed: int):
        r = Renderer(
            compiled,
            RenderConfig(width=W, height=H, spp=args.spp, seed=seed, driver=args.driver),
        )
        t = time.monotonic()
        r.render()
        return time.monotonic() - t, r

    first_s, _ = one_pass(0)
    log(f"first pass (incl. compile): {first_s:.2f} s; cache {counter.hits} hits / {counter.misses} misses")
    times = []
    for i in range(args.passes):
        seconds, r = one_pass(1 + i)
        times.append(seconds)
        log(f"pass {i}: {seconds:.3f} s")
    img = r.image()
    primary = W * H * args.spp
    rates = [primary / t / 1e6 for t in times]
    print(
        json.dumps(
            {
                "metric": f"primary Mrays/s, cbox+spheres {W}x{H} x {args.spp} spp, {args.driver} driver",
                "value": statistics.median(rates),
                "unit": "Mrays/s",
                "passes_mrays_per_s": rates,
                "passes_s": times,
                "first_pass_s": first_s,
                "image_mean": float(img.mean()),
                "image_finite": bool((img == img).all()),
                "device": device,
                "card": card,
                "compile_cache": {"dir": cache_dir, "hits": counter.hits, "misses": counter.misses},
            }
        )
    )


if __name__ == "__main__":
    main()
