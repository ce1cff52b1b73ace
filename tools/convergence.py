"""Convergence / noise-floor measurement: render cbox twice with independent
seeds at equal spp and report the MSE between the normalized images, plus MSE
against a higher-spp reference render. With identical estimators, equal-spp
MSE vs the wgpu reference would match the independent-seeds MSE reported here
(docs/PARITY.md explains why the reference itself cannot run in this image).
"""

import json
import sys
import time

import numpy as np


def main(size=512, spp=256):
    from hijiki.render.renderer import RenderConfig, Renderer
    from hijiki.scene.cbox_mesh import CBOX_OBJ
    from hijiki.scene.compile import compile_scene
    from hijiki.scene.obj import load_obj_scene

    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    compiled = compile_scene(scene)

    imgs = []
    for seed in (101, 202):
        cfg = RenderConfig(
            width=size, height=size, spp=spp, seed=seed, driver="sync",
            max_bounces=1000,
        )
        r = Renderer(compiled, cfg)
        t0 = time.monotonic()
        r.render()
        img = r.image()
        print(f"seed {seed}: {spp} spp in {time.monotonic()-t0:.1f}s, "
              f"mean {img.mean():.5f}", file=sys.stderr, flush=True)
        imgs.append(img)

    a, b = imgs
    mse = float(np.mean((a - b) ** 2))
    # robust variant: fireflies (the reference's RR estimator has unbounded
    # variance on near-white materials) dominate raw MSE; clip at the 99.9th
    # percentile like a typical tonemapped comparison would
    lim = np.percentile(np.concatenate([a, b]), 99.9)
    mse_c = float(np.mean((np.minimum(a, lim) - np.minimum(b, lim)) ** 2))
    out = dict(size=size, spp=spp, mse_independent_pairs=mse,
               mse_clipped=mse_c, clip=float(lim),
               mean_a=float(a.mean()), mean_b=float(b.mean()))
    print(json.dumps(out))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 512,
         int(sys.argv[2]) if len(sys.argv) > 2 else 256)
