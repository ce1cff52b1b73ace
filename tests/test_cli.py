"""CLI end-to-end on the CPU backend: flag plumbing, outputs, checkpointing.

The reference's only interface is its CLI (src/main.rs:1426-1494); these
tests drive ours the same way (main(argv), no subprocess so the conftest's
CPU-mesh config applies).
"""

import os

import numpy as np
import pytest


def test_cli_end_to_end(tmp_path, capsys):
    from hijiki.cli import main
    from hijiki.utils.exr import read_exr

    out = str(tmp_path / "out.exr")
    png = str(tmp_path / "prev.png")
    rc = main([
        "builtin:cornell", "--use-bvh", "-w", "64", "-H", "64", "-s", "2",
        "--block-size", "64", "--max-bounces", "6",
        "-o", out, "--preview-image", png, "--present-interval", "1",
    ])
    assert rc == 0
    img = read_exr(out)
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert os.path.exists(png)  # progressive preview snapshots
    # the start-up line names the backend, so a CPU run never passes for a
    # card run
    assert "Devices: platform=cpu kind=cpu count=8" in capsys.readouterr().out


def test_cli_checkpoint_resume(tmp_path):
    from hijiki.cli import main
    from hijiki.utils.exr import read_exr

    ckpt = str(tmp_path / "r.ckpt.npz")
    o1 = str(tmp_path / "a.exr")
    o2 = str(tmp_path / "b.exr")
    o3 = str(tmp_path / "c.exr")
    base = ["builtin:cornell", "--use-bvh", "-w", "64", "-H", "64",
            "--block-size", "64", "--max-bounces", "6", "--seed", "3"]
    # 4 sweeps in one go
    assert main(base + ["-s", "4", "-o", o1]) == 0
    # 2 sweeps, checkpoint, then resume for the remaining 2
    assert main(base + ["-s", "2", "-o", o2, "--checkpoint", ckpt]) == 0
    assert os.path.exists(ckpt)
    assert main(base + ["-s", "4", "-o", o3, "--checkpoint", ckpt]) == 0
    a, c = read_exr(o1), read_exr(o3)
    np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


def test_cli_flag_validation(tmp_path):
    from hijiki.cli import main

    # --fixed-albedo is sync-only
    rc = main(["builtin:cornell", "--driver", "wavefront", "--fixed-albedo",
               "-w", "64", "-H", "64", "-s", "1"])
    assert rc == 2
    # the multi-device renderer shards the sync driver only
    rc = main(["builtin:cornell", "--driver", "wavefront", "--devices", "2",
               "-w", "64", "-H", "64", "-s", "1"])
    assert rc == 2
    # the removed megakernel driver is no longer a choice
    with pytest.raises(SystemExit):
        main(["builtin:cornell", "--driver", "mega", "-s", "1"])
    # unknown builtin
    with pytest.raises(KeyError):
        main(["builtin:nope", "-w", "64", "-H", "64", "-s", "1"])


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_cli_platform_parses(platform):
    """--platform offers the CPU (tests) and the GPU (the card); nothing
    else parses."""
    from hijiki.cli import build_parser

    assert build_parser().parse_args(["s.obj", "--platform", platform]).platform == platform
    with pytest.raises(SystemExit):
        build_parser().parse_args(["s.obj", "--platform", "metal"])


def test_cli_platform_pin(tmp_path):
    """--platform cpu pins the backend at BOTH the env and jax.config level
    (jax.config wins over the env var once jax is imported)."""
    from hijiki.cli import main

    out = str(tmp_path / "cpu.exr")
    rc = main(["builtin:cornell", "--use-bvh", "-w", "64", "-H", "64",
               "-s", "1", "--block-size", "64", "--max-bounces", "4",
               "--platform", "cpu", "-o", out])
    assert rc == 0
    assert os.path.exists(out)
    import jax

    assert jax.config.jax_platforms == "cpu"
    assert os.environ["JAX_PLATFORMS"] == "cpu"


def test_cli_metrics_json(tmp_path):
    import json

    from hijiki.cli import main

    out = str(tmp_path / "out.exr")
    mj = str(tmp_path / "metrics.json")
    rc = main([
        "builtin:cornell", "--use-bvh", "-w", "64", "-H", "64", "-s", "2",
        "--block-size", "64", "--max-bounces", "6",
        "-o", out, "--metrics-json", mj,
    ])
    assert rc == 0
    with open(mj) as f:
        payload = json.load(f)
    m = payload["metrics"]
    assert m["primary_rays"] == 64 * 64 * 2
    assert m["rays_per_second"] > 0
    assert len(m["sweep_marks"]) == 2
    assert payload["sweeps_done"] == 2
    assert payload["interrupted"] is False
    assert payload["config"]["driver"] == "sync"


def test_cli_devices_mesh(tmp_path):
    """--devices shards the render over the virtual CPU mesh end-to-end and
    matches the single-device image (same seeds -> same estimator)."""
    import numpy as np

    from hijiki.cli import main
    from hijiki.utils.exr import read_exr

    o1 = str(tmp_path / "one.exr")
    o2 = str(tmp_path / "two.exr")
    base = ["builtin:cornell", "--use-bvh", "-w", "64", "-H", "128", "-s", "2",
            "--block-size", "64", "--max-bounces", "6", "--seed", "5"]
    assert main(base + ["-o", o1]) == 0
    assert main(base + ["-o", o2, "--devices", "2"]) == 0
    a, b = read_exr(o1), read_exr(o2)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_cli_checkpoint_resume_across_device_counts(tmp_path):
    """A single-device checkpoint resumes under --devices 2 (the film is a
    device-agnostic (rgb*w, w) accumulator and the scheduler replay keeps
    remaining-sweep seeds identical), matching the uninterrupted render."""
    import numpy as np

    from hijiki.cli import main
    from hijiki.utils.exr import read_exr

    ckpt = str(tmp_path / "r.ckpt.npz")
    o1 = str(tmp_path / "full.exr")
    o2 = str(tmp_path / "a.exr")
    o3 = str(tmp_path / "b.exr")
    base = ["builtin:cornell", "--use-bvh", "-w", "64", "-H", "128",
            "--block-size", "64", "--max-bounces", "6", "--seed", "9"]
    assert main(base + ["-s", "4", "-o", o1]) == 0
    assert main(base + ["-s", "2", "-o", o2, "--checkpoint", ckpt]) == 0
    assert main(base + ["-s", "4", "-o", o3, "--checkpoint", ckpt,
                        "--devices", "2"]) == 0
    a, c = read_exr(o1), read_exr(o3)
    np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


def test_negative_seed_accepted(tmp_path):
    """numpy 2.x np.uint64 rejects out-of-range ints; --seed -1 must wrap,
    not crash."""
    from hijiki.render.blocks import BlockScheduler

    s1 = BlockScheduler(64, 64, 64, seed=-1)
    s2 = BlockScheduler(64, 64, 64, seed=2**64 - 1)
    a, b = s1.sweep(0), s2.sweep(0)
    import numpy as np

    assert np.array_equal(a.block_seeds, b.block_seeds)
    # numpy integer seeds (e.g. drawn from an RNG / array element): numpy 2.x
    # raises OverflowError on np.int64(x) & (2**64 - 1) unless cast via int()
    s3 = BlockScheduler(64, 64, 64, seed=np.int64(-1))
    assert np.array_equal(s3.sweep(0).block_seeds, a.block_seeds)
