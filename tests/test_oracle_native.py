"""Native C++ oracle (ops/oracle_native) vs the numpy oracle: same per-path
semantics, same RNG stream, equal-seed radiance agreement.

The C++ twin exists because the parity gate (render/parity.py) needs
thousands of oracle spp and the numpy oracle costs ~15-30 s per 64^2 sweep;
its float math mirrors the numpy expression trees exactly except libm's
1-ulp trig/exp rounding (sqrtf is bitwise), so equal-seed films agree at
~1e-14 MSE with most values bitwise-equal."""

import numpy as np
import pytest

from hijiki.ops.oracle_native import load_library, render_oracle_native
from hijiki.render.blocks import BlockScheduler, per_pixel_seeds
from hijiki.scene.cbox_mesh import CBOX_OBJ


def _oracle_mse():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools", "oracle_mse.py")
    spec = importlib.util.spec_from_file_location("oracle_mse", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def compiled():
    from hijiki.scene.compile import compile_scene
    from hijiki.scene.obj import load_obj_scene

    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    return compile_scene(scene)


@pytest.fixture(scope="module")
def native_lib():
    lib = load_library()
    if lib is None:
        pytest.skip("native oracle unavailable (g++ build failed)")
    return lib


def test_native_matches_numpy_oracle(compiled, native_lib):
    om = _oracle_mse()

    cs = compiled
    fs = om.FastScene(cs)
    W = H = 16
    spp = 2
    sched = BlockScheduler(W, H, 64, 3)
    cam = cs.camera_static
    F = np.float32

    acc_np = np.zeros((H, W, 3), np.float64)
    seeds_all, offs_all = [], []
    for sw in range(spp):
        s = sched.sweep(sw)
        seeds = np.asarray(per_pixel_seeds(W, H, 64, s.block_seeds)).reshape(-1)
        offx, offy = F(s.sample_offset[0]), F(s.sample_offset[1])
        seeds_all.append(seeds)
        offs_all.append([offx, offy])
        for y in range(H):
            for x in range(W):
                o, d = om.camera_ray(cam, F(x) + offx, F(y) + offy, W, H)
                acc_np[y, x] += om.integrate_path_fast(
                    cs, fs, o, d, int(seeds[y * W + x])
                )

    acc_c = render_oracle_native(
        cs, np.stack(seeds_all), np.array(offs_all, np.float32), W, H
    )
    mse = float(((acc_np / spp - acc_c / spp) ** 2).mean())
    assert mse < 1e-10, mse
    # most values bitwise-equal (divergence = libm 1-ulp trig only)
    assert (acc_np == acc_c).mean() > 0.5
    np.testing.assert_allclose(acc_c, acc_np, rtol=1e-3, atol=1e-4)


def test_native_single_ray_matches_scalar_oracle(compiled, native_lib):
    """One specific camera ray through the original scalar oracle
    (ops/oracle.integrate_ray_oracle) — the slowest, most literal
    transcription — vs the native twin."""
    om = _oracle_mse()

    from hijiki.ops.oracle import integrate_ray_oracle

    cs = compiled
    o, d = om.camera_ray(cs.camera_static, np.float32(8.5), np.float32(9.5), 16, 16)
    ref = integrate_ray_oracle(cs, o, d, seed=1234)

    seeds = np.full(16 * 16, 0, np.uint32)
    seeds[9 * 16 + 8] = 1234
    acc = render_oracle_native(
        cs, seeds[None], np.array([[0.5, 0.5]], np.float32), 16, 16
    )
    got = acc[9, 8]
    np.testing.assert_allclose(got, ref["total"], rtol=1e-4, atol=1e-6)
