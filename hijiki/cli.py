"""Command-line interface — argparse twin of the reference's ``Opt``
(``src/main.rs:1426-1456``), plus extras the reference lacks (seed,
previews, checkpointing, multi-device).

Usage:
    python -m hijiki.cli [flags] scene.obj
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from hijiki.render.renderer import DRIVERS
from hijiki.utils.platform import PLATFORMS, device_summary, pin_platform


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hijiki", description="Wavefront Monte-Carlo path tracer (JAX/XLA)"
    )
    p.add_argument(
        "scene",
        help="The scene to render: an OBJ file, or builtin:<name> "
        "(cornell, cornell-spheres, cornell-glass)",
    )
    p.add_argument(
        "--put-cbox-spheres",
        action="store_true",
        help="Add a mirror and a checkerboard sphere to the scene",
    )
    p.add_argument(
        "--put-dielectric-sphere",
        action="store_true",
        help="Add a clear glass sphere (the reference's commented-out variant)",
    )
    p.add_argument(
        "--use-bvh",
        action="store_true",
        help="Use a BVH to optimize intersections",
    )
    p.add_argument("-w", "--width", type=int, default=800)
    p.add_argument("-H", "--height", type=int, default=600)
    p.add_argument("-s", "--sample-count", type=int, default=64)
    p.add_argument(
        "--present-interval",
        type=int,
        default=0,
        help="Write a PNG preview every N sweeps (0 = off)",
    )
    p.add_argument("-o", "--output-image", default="output.exr")
    p.add_argument("--preview-image", default="preview.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--max-bounces", type=int, default=1000)
    p.add_argument(
        "--metrics-json",
        default=None,
        help="Write render metrics (rays/s, path length, traversal counters, "
        "config) as one JSON object to this path ('-' for stdout)",
    )
    p.add_argument("--checkpoint", default=None, help="Checkpoint file to write/resume")
    p.add_argument(
        "--checkpoint-interval", type=int, default=0, help="Sweeps between checkpoints"
    )
    p.add_argument(
        "--driver",
        choices=DRIVERS,
        default="sync",
        help="Execution driver: sync (bulk-synchronous bounce loop), "
        "wavefront (regenerating lane pool)",
    )
    p.add_argument(
        "--sort-lanes",
        action="store_true",
        help="Coherence-sort ray lanes between bounces (wavefront driver)",
    )
    p.add_argument(
        "--fixed-albedo",
        action="store_true",
        help="Populate the albedo AOV (the reference declares it but never "
        "assigns it), activating the denoiser's albedo feature term. "
        "sync driver; default off = reference parity",
    )
    p.add_argument(
        "--live-preview",
        type=int,
        default=0,
        help="Redraw a live ANSI preview in the terminal every N sweeps "
        "(the reference's preview window, headless edition); 0 = off",
    )
    p.add_argument(
        "--profile-dir",
        default=None,
        help="Write a jax.profiler trace of the render to this directory "
        "(device and host events; open with TensorBoard or Perfetto)",
    )
    p.add_argument(
        "--trace-json",
        default=None,
        help="Write a Chrome-trace timeline of the driver loop (sweep "
        "dispatches, film sync, checkpoint saves) to this path; load in "
        "chrome://tracing or ui.perfetto.dev (utils/tracing.py)",
    )
    p.add_argument(
        "--devices",
        type=int,
        default=1,
        help="Shard sweeps/blocks over this many devices (jax mesh)",
    )
    p.add_argument(
        "--platform",
        default=None,
        choices=PLATFORMS,
        help="Pin the jax platform before backend init (cpu for tests, gpu "
        "for the card); default = $JAX_PLATFORMS, else jax's own choice",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    pin_platform(args.platform)
    from hijiki.utils.cache import enable_compilation_cache

    dev = device_summary()
    print(f"Devices: platform={dev['platform']} kind={dev['kind']} count={dev['count']}")
    enable_compilation_cache()

    from hijiki.render.renderer import RenderConfig, Renderer
    from hijiki.scene.compile import compile_scene
    from hijiki.scene.obj import load_obj_scene

    t0 = time.monotonic()
    if args.scene.startswith("builtin:"):
        from hijiki.scene.presets import load_preset

        scene = load_preset(args.scene[len("builtin:"):])
    else:
        scene = load_obj_scene(args.scene)
    if args.put_cbox_spheres:
        scene.put_cbox_spheres()
    if args.put_dielectric_sphere:
        scene.put_dielectric_sphere()
    compiled = compile_scene(scene)
    print(
        f"Compiled scene: {compiled.num_spheres} spheres, {compiled.num_quads} quads, "
        f"{compiled.num_triangles} triangles, {compiled.num_emitters} emitters, "
        f"{compiled.num_bvh_nodes} BVH nodes ({time.monotonic()-t0:.2f}s)"
    )

    config = RenderConfig(
        width=args.width,
        height=args.height,
        spp=args.sample_count,
        block_size=args.block_size,
        seed=args.seed,
        use_bvh=args.use_bvh,
        max_bounces=args.max_bounces,
        preview_interval=args.present_interval,
        preview_path=args.preview_image,
        driver=args.driver,
        sort_lanes=args.sort_lanes,
        fixed_albedo=args.fixed_albedo,
        live_preview=args.live_preview,
    )
    if args.fixed_albedo and args.driver == "wavefront":
        print("--fixed-albedo requires the sync driver", file=sys.stderr)
        return 2

    if args.devices > 1 and args.driver != "sync":
        print("--devices > 1 shards the sync driver only", file=sys.stderr)
        return 2

    if args.devices > 1:
        from hijiki.parallel.multichip import MultiChipRenderer

        if args.checkpoint and os.path.exists(args.checkpoint):
            # resume works across device counts: the checkpoint is the
            # device-agnostic (rgb*w, w) film + sweep cursor, and the
            # scheduler replay keeps the remaining sweeps' seeds identical
            renderer = MultiChipRenderer.resume_checkpoint(
                compiled, args.checkpoint, config, num_devices=args.devices
            )
            print(f"Resumed from {args.checkpoint} at sweep {renderer.sweeps_done}")
        else:
            renderer = MultiChipRenderer(compiled, config, num_devices=args.devices)
    elif args.checkpoint:

        if os.path.exists(args.checkpoint):
            renderer = Renderer.resume_checkpoint(compiled, args.checkpoint, config)
            print(f"Resumed from {args.checkpoint} at sweep {renderer.sweeps_done}")
        else:
            renderer = Renderer(compiled, config)
    else:
        renderer = Renderer(compiled, config)

    print("Starting to render...")
    if args.trace_json:
        from hijiki.utils.tracing import SpanTracer

        renderer.tracer = SpanTracer()
    last_ckpt = [renderer.sweeps_done]

    def progress(done, total):
        pct = 100.0 * done / total
        sys.stdout.write(f"\rRendering... {pct:5.1f}% ({done}/{total} sweeps)")
        sys.stdout.flush()
        if (
            args.checkpoint
            and args.checkpoint_interval
            and done - last_ckpt[0] >= args.checkpoint_interval
        ):
            renderer.save_checkpoint(args.checkpoint)
            last_ckpt[0] = done

    # Partial-render-on-interrupt: the reference saves the image even when the
    # preview window is closed mid-render (src/main.rs:1349-1352,1493); we do
    # the same on Ctrl-C, plus a resumable checkpoint.
    interrupted = False
    try:
        if args.profile_dir:
            import jax

            with jax.profiler.trace(args.profile_dir):
                metrics = renderer.render(progress=progress)
        else:
            metrics = renderer.render(progress=progress)
    except KeyboardInterrupt:
        interrupted = True
        metrics = renderer.metrics or dict(
            primary_rays=0, render_seconds=0.0, rays_per_second=0.0, spp_per_second=0.0
        )
        print(f"\nInterrupted at sweep {renderer.sweeps_done}; saving partial render")
    print()
    if not interrupted:
        ray_count = metrics["primary_rays"]
        print(
            f"Integrated {ray_count} rays in {metrics['render_seconds']:.3f}s "
            f"({metrics['rays_per_second']:.0f} rays/s, "
            f"{metrics['spp_per_second']:.2f} spp/s)"
        )
    if args.trace_json and renderer.tracer is not None:
        renderer.tracer.write(args.trace_json)
        print(f"Trace: {args.trace_json}")
    if args.metrics_json:
        import json

        def scalarize(v):
            if isinstance(v, (list, tuple)):
                return [float(x) for x in v]
            return float(v)

        payload = dict(
            metrics={k: scalarize(v) for k, v in (metrics or {}).items()},
            sweeps_done=renderer.sweeps_done,
            interrupted=interrupted,
            config=dict(
                width=args.width,
                height=args.height,
                spp=args.sample_count,
                seed=args.seed,
                driver=args.driver,
                block_size=args.block_size,
                max_bounces=args.max_bounces,
                use_bvh=args.use_bvh,
            ),
        )
        if args.metrics_json == "-":
            print(json.dumps(payload))
        else:
            with open(args.metrics_json, "w") as f:
                json.dump(payload, f, indent=1)
            print(f"Metrics: {args.metrics_json}")
    if renderer.sweeps_done > 0:
        renderer.save_exr(args.output_image)
        print(f"Wrote {args.output_image}")
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)
        print(f"Checkpoint at sweep {renderer.sweeps_done}: {args.checkpoint}")
    return 130 if interrupted else 0


if __name__ == "__main__":
    sys.exit(main())
