"""Image-scale oracle render + MSE vs the production driver (the parity gate).

Renders cbox(+spheres) at 64x64 with the *scalar-control-flow numpy oracle*
(ops/oracle.py semantics — a per-path transcription of shader/render.glsl)
using the SAME per-pixel seeds and per-sweep jitter as the production
renderer, then reports MSE(oracle, sync driver) on mean radiance at equal
spp. Because the seeds are identical, any MSE above float-associativity
noise exposes a sampling-decision divergence somewhere in the image.

The only change vs ops/oracle.py is the closest-hit loop vectorized over
PRIMS (not paths): per-prim candidate t/u/v are computed with the exact same
accumulation-free f32 expressions, and the winner is the first minimum —
bitwise the same winner the scalar shrinking-tmax loop selects (a prim
rejected for exceeding the running best is never the minimum; equal-t ties
resolve to the earliest slot in both). Path control flow, RNG draws, BSDF
sampling and emitter sampling stay scalar and reference-shaped.

Usage:
  python tools/oracle_mse.py oracle [--spp 256] [--side 64] [--out PATH] [--native]
      CPU-only; checkpoints the accumulator every sweep (resumable).
  python tools/oracle_mse.py compare [--oracle PATH]
      renders the same seeds with the sync integrator on the current
      backend and prints the MSE.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np

F = np.float32
M_EPS = F(1e-4)

DEFAULT_OUT = "oracle_film.npz"


def _load_compiled():
    from hijiki.scene.cbox_mesh import CBOX_OBJ
    from hijiki.scene.compile import compile_scene
    from hijiki.scene.obj import load_obj_scene

    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    return compile_scene(scene)


# ----------------------------------------------------------------------------
# prims-vectorized exact closest-hit / any-hit (see module docstring)
# ----------------------------------------------------------------------------


class FastScene:
    def __init__(self, cs):
        from hijiki.scene.compile import KIND_SPHERE, KIND_TRIANGLE

        self.cs = cs
        self.a = np.asarray(cs.prim_a, np.float32)
        self.b = np.asarray(cs.prim_b, np.float32)
        self.c = np.asarray(cs.prim_c, np.float32)
        self.kind = np.asarray(cs.prim_kind)
        self.is_sphere = self.kind == KIND_SPHERE
        self.is_tri = self.kind == KIND_TRIANGLE
        # plane normal cross(b, c), f32 componentwise (matches np.cross f32)
        b, c = self.b, self.c
        self.n = np.stack(
            [
                b[:, 1] * c[:, 2] - b[:, 2] * c[:, 1],
                b[:, 2] * c[:, 0] - b[:, 0] * c[:, 2],
                b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0],
            ],
            axis=-1,
        ).astype(np.float32)
        self.radius = self.b[:, 0].copy()  # sphere rows: b = (radius, _, _)

    def candidates(self, o, d, tmin, tmax):
        """Per-prim candidate (valid, t, u, v), exact f32 per-prim math."""
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            ro = (o - self.a).astype(np.float32)  # (N,3)
            # tri/quad (Lagrange) test
            q = np.stack(
                [
                    ro[:, 1] * d[2] - ro[:, 2] * d[1],
                    ro[:, 2] * d[0] - ro[:, 0] * d[2],
                    ro[:, 0] * d[1] - ro[:, 1] * d[0],
                ],
                axis=-1,
            ).astype(np.float32)
            denom = (
                d[0] * self.n[:, 0] + d[1] * self.n[:, 1] + d[2] * self.n[:, 2]
            ).astype(np.float32)
            dd = (F(1.0) / denom).astype(np.float32)
            u = (
                dd
                * -(
                    q[:, 0] * self.c[:, 0]
                    + q[:, 1] * self.c[:, 1]
                    + q[:, 2] * self.c[:, 2]
                )
            ).astype(np.float32)
            v = (
                dd
                * (
                    q[:, 0] * self.b[:, 0]
                    + q[:, 1] * self.b[:, 1]
                    + q[:, 2] * self.b[:, 2]
                )
            ).astype(np.float32)
            t_pq = (
                dd
                * -(
                    self.n[:, 0] * ro[:, 0]
                    + self.n[:, 1] * ro[:, 1]
                    + self.n[:, 2] * ro[:, 2]
                )
            ).astype(np.float32)
            in_tri = (u >= 0) & (v >= 0) & (u + v <= 1)
            in_quad = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
            ok_pq = np.where(self.is_tri, in_tri, in_quad)
            ok_pq &= (tmin <= t_pq) & (t_pq <= tmax)

            # sphere test
            sb = (
                F(2.0) * (d[0] * ro[:, 0] + d[1] * ro[:, 1] + d[2] * ro[:, 2])
            ).astype(np.float32)
            sc = (
                ro[:, 0] * ro[:, 0]
                + ro[:, 1] * ro[:, 1]
                + ro[:, 2] * ro[:, 2]
                - self.radius * self.radius
            ).astype(np.float32)
            disc = (sb * sb - F(4.0) * sc).astype(np.float32)
            sq = np.sqrt(np.maximum(disc, F(0.0))).astype(np.float32)
            st0 = (F(-0.5) * (sb + sq)).astype(np.float32)
            st1 = (F(-0.5) * (sb - sq)).astype(np.float32)
            ok0 = (tmin <= st0) & (st0 <= tmax)
            ok1 = (tmin <= st1) & (st1 <= tmax)
            t_s = np.where(ok0, st0, st1).astype(np.float32)
            ok_s = (disc >= 0) & (ok0 | ok1)

            valid = np.where(self.is_sphere, ok_s, ok_pq)
            t = np.where(self.is_sphere, t_s, t_pq).astype(np.float32)
            u = np.where(self.is_sphere, F(0.0), u).astype(np.float32)
            v = np.where(self.is_sphere, F(0.0), v).astype(np.float32)
        return valid, t, u, v

    def closest(self, o, d, tmin, tmax):
        valid, t, u, v = self.candidates(o, d, tmin, tmax)
        if not valid.any():
            return None
        tt = np.where(valid, t, np.float32(np.inf))
        slot = int(np.argmin(tt))  # first minimum == the scalar loop's winner
        return slot, F(t[slot]), F(u[slot]), F(v[slot])

    def occluded(self, o, d, tmin, tmax):
        valid, _, _, _ = self.candidates(o, d, tmin, tmax)
        return bool(valid.any())


def camera_ray(cam, px, py, W, H):
    """Scalar camera raygen from the host camera floats (shader/render.glsl:
    26-36; the native oracle's camera_ray is its C++ twin)."""
    cx, cy, cz, qx, qy, qz, qw, fov = cam
    R00 = 1 - 2 * (qy * qy + qz * qz)
    R01 = 2 * (qx * qy - qz * qw)
    R02 = 2 * (qx * qz + qy * qw)
    R10 = 2 * (qx * qy + qz * qw)
    R11 = 1 - 2 * (qx * qx + qz * qz)
    R12 = 2 * (qy * qz - qx * qw)
    R20 = 2 * (qx * qz - qy * qw)
    R21 = 2 * (qy * qz + qx * qw)
    R22 = 1 - 2 * (qx * qx + qy * qy)
    scale = math.tan(math.radians(0.5 * fov)) / (0.5 * W)
    lx = F((px - F(0.5 * W)) * F(scale))
    ly = F(-(py - F(0.5 * H)) * F(scale))
    dx = F(F(R00) * lx + F(R01) * ly - F(R02))
    dy = F(F(R10) * lx + F(R11) * ly - F(R12))
    dz = F(F(R20) * lx + F(R21) * ly - F(R22))
    inv = F(1.0) / F(np.sqrt(dx * dx + dy * dy + dz * dz))
    o = np.array([cx, cy, cz], np.float32)
    d = np.array([dx * inv, dy * inv, dz * inv], np.float32)
    return o, d


def integrate_path_fast(cs, fs: FastScene, o, d, seed, max_bounces=1000):
    """ops/oracle.integrate_ray_oracle with the prims-vectorized intersect."""
    from hijiki.ops.oracle import (
        _Rng,
        _eval_bsdf,
        _populate,
        _sample_bsdf,
        _sample_emitter,
    )
    from hijiki.scene.model import (
        MATERIAL_TAG_SHIFT,
        TAG_DIFFUSE,
        TAG_DIFFUSECBOARD,
        TAG_EMISSIVE,
    )

    r = _Rng(seed)
    o = np.asarray(o, np.float32).copy()
    d = np.asarray(d, np.float32).copy()
    tmin, tmax = M_EPS, F(np.inf)
    total = np.zeros(3, np.float32)
    throughput = np.ones(3, np.float32)
    extinction = np.zeros(3, np.float32)
    was_discrete = True

    for bounce in range(max_bounces):
        best = fs.closest(o, d, tmin, tmax)
        if best is None:
            break
        slot, t, u, v = best
        p, n, uv, frame_t, frame_b = _populate(o, d, t, slot, u, v, cs)
        shape_id = int(cs.prim_shape_id[slot])
        handle = int(cs.materials[shape_id])
        tag = handle >> MATERIAL_TAG_SHIFT

        dist = F(np.linalg.norm(p - o))
        throughput = (throughput * np.exp(-extinction * dist)).astype(np.float32)

        if tag == TAG_EMISSIVE and was_discrete:
            midx = handle & ((1 << MATERIAL_TAG_SHIFT) - 1)
            total = total + throughput * np.asarray(
                cs.emissive_power[midx], np.float32
            )

        if tag in (TAG_DIFFUSE, TAG_DIFFUSECBOARD):
            importance, shadow = _sample_emitter(cs, r, p)
            if (
                F(np.linalg.norm(importance)) > M_EPS
                and F(np.dot(shadow["d"], n)) > 0
            ):
                if not fs.occluded(
                    shadow["o"], shadow["d"], shadow["tmin"], shadow["tmax"]
                ):
                    total = total + throughput * _eval_bsdf(
                        cs, handle, shadow["d"], n, uv
                    ) * importance

        wo, weight, extinction = _sample_bsdf(
            cs, handle, d, n, uv, frame_t, frame_b, r, extinction
        )
        throughput = (throughput * weight).astype(np.float32)
        d = wo
        o = p
        tmin, tmax = F(2.0) * M_EPS, F(np.inf)
        was_discrete = tag not in (TAG_DIFFUSE, TAG_DIFFUSECBOARD)

        if bounce > 3:
            q = F(min(F(0.99), float(np.max(throughput))))
            if r.uniform() > q:
                break
            throughput = (throughput / q).astype(np.float32)

    return total


def render_oracle(args):
    sys.setrecursionlimit(10000)
    from hijiki.render.blocks import BlockScheduler, per_pixel_seeds

    cs = _load_compiled()
    fs = FastScene(cs)
    W = H = args.side
    spp = args.spp
    sched = BlockScheduler(W, H, 64, args.seed)

    acc = np.zeros((H, W, 3), np.float64)
    start_sweep = 0
    if os.path.exists(args.out):
        ck = np.load(args.out)
        if int(ck["side"]) == W and int(ck["seed"]) == args.seed:
            acc = ck["acc"]
            start_sweep = int(ck["sweeps"])
            # BlockScheduler.sweep() is call-order-stateful (the index is a
            # label, not a stream position): replay the already-accumulated
            # sweeps' schedules so the resumed run draws the TAIL schedules,
            # not sweep 0's again (same replay as Renderer.resume_checkpoint;
            # without it a resumed oracle silently double-counts the early
            # sample sets and never traces the tail — round-3 review finding).
            for _si in range(start_sweep):
                sched.sweep(_si)
            print(f"resuming at sweep {start_sweep}", file=sys.stderr)

    cam = cs.camera_static
    t_start = time.monotonic()
    if getattr(args, "native", False):
        # C++ twin (ops/oracle_native.py): same per-path semantics at
        # ~15-25x the numpy rate (validated equal-seed in
        # tests/test_oracle_native.py: MSE ~1e-14 at small configs, the
        # only divergence class is libm-vs-numpy 1-ulp trig rounding).
        # Batched sweeps between checkpoints.
        from hijiki.ops.oracle_native import render_oracle_native

        BATCH = 32
        sweep = start_sweep
        while sweep < spp:
            n = min(BATCH, spp - sweep)
            seeds_b, offs_b = [], []
            for si in range(sweep, sweep + n):
                s = sched.sweep(si)
                seeds_b.append(
                    np.asarray(per_pixel_seeds(W, H, 64, s.block_seeds)).reshape(-1)
                )
                offs_b.append(np.asarray(s.sample_offset, np.float32))
            t0 = time.monotonic()
            render_oracle_native(
                cs, np.stack(seeds_b), np.stack(offs_b), W, H, acc=acc
            )
            sweep += n
            np.savez(
                args.out, acc=acc, sweeps=sweep, side=W, seed=args.seed,
                spp_target=spp,
            )
            dt = time.monotonic() - t0
            total = time.monotonic() - t_start
            print(
                f"sweeps {sweep}/{spp} (native): {dt:.1f}s for {n} "
                f"({total / 60:.1f} min total, mean {acc.mean() / sweep:.4f})",
                file=sys.stderr,
                flush=True,
            )
        print(f"done: {args.out}")
        return
    for sweep in range(start_sweep, spp):
        s = sched.sweep(sweep)
        seeds = np.asarray(per_pixel_seeds(W, H, 64, s.block_seeds)).reshape(-1)
        offx, offy = F(s.sample_offset[0]), F(s.sample_offset[1])
        t0 = time.monotonic()
        for y in range(H):
            for x in range(W):
                o, d = camera_ray(cam, F(x) + offx, F(y) + offy, W, H)
                acc[y, x] += integrate_path_fast(cs, fs, o, d, int(seeds[y * W + x]))
        np.savez(
            args.out,
            acc=acc,
            sweeps=sweep + 1,
            side=W,
            seed=args.seed,
            spp_target=spp,
        )
        dt = time.monotonic() - t0
        total = time.monotonic() - t_start
        print(
            f"sweep {sweep + 1}/{spp}: {dt:.1f}s ({total/60:.1f} min total, "
            f"mean {acc.mean()/(sweep+1):.4f})",
            file=sys.stderr,
            flush=True,
        )
    print(f"done: {args.out}")


def compare(args):
    """The sync integrator on the current backend against a saved oracle
    film, at the oracle's seeds (hijiki/render/parity.py)."""
    from hijiki.render import parity
    from hijiki.scene.compile import scene_to_device

    ck = np.load(args.oracle)
    side = int(ck["side"])
    sweeps = int(ck["sweeps"])
    seed = int(ck["seed"])
    oracle = ck["acc"] / sweeps
    print(f"oracle: {side}x{side}, {sweeps} spp, seed {seed}", file=sys.stderr)

    seeds, offsets = parity.schedule(side, side, seed, sweeps)
    sync = parity.driver_radiance(scene_to_device(_load_compiled()), side, side, seeds, offsets)
    if args.save:
        np.savez(args.save, oracle=oracle, sync=sync, sweeps=sweeps)
        print(f"saved images to {args.save}", file=sys.stderr)
    r = parity.compare(oracle, sync)
    print(
        f"MSE(oracle, sync) = {r['mse']:.3e}  divergent pixels: "
        f"{r['divergent_pixels']}/{r['pixels']}  trimmed MSE: {r['trimmed_mse']:.3e}"
    )
    print(f"(equal seeds, {sweeps} spp, mean radiance, gate < {parity.PARITY_MSE_BOUND})")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    o = sub.add_parser("oracle")
    o.add_argument("--spp", type=int, default=256)
    o.add_argument("--side", type=int, default=64)
    o.add_argument("--seed", type=int, default=0)
    o.add_argument("--out", default=DEFAULT_OUT)
    o.add_argument("--native", action="store_true",
                   help="use the C++ oracle twin (ops/oracle_native)")
    o.set_defaults(fn=render_oracle)
    c = sub.add_parser("compare")
    c.add_argument("--oracle", default=DEFAULT_OUT)
    c.add_argument("--save", default="oracle_compare.npz")
    c.set_defaults(fn=compare)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
