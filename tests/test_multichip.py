"""Multi-device sharding on the virtual 8-device CPU mesh: the sharded render
must match the single-device render (same seeds, same estimate)."""

import dataclasses

import jax
import numpy as np
import pytest

from hijiki.parallel.multichip import MultiChipRenderer
from hijiki.render.renderer import RenderConfig, Renderer


@pytest.fixture(scope="module")
def cbox_small():
    from hijiki.scene.cbox_mesh import CBOX_OBJ
    from hijiki.scene.compile import compile_scene
    from hijiki.scene.obj import load_obj_scene

    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    return compile_scene(scene)


def test_eight_devices_available():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"


@pytest.mark.parametrize("ndev", [2, 8])
def test_multichip_matches_single(cbox_small, ndev):
    cfg = RenderConfig(
        width=128,
        height=128,
        spp=1,
        block_size=64,  # 2x2 = 4 blocks
        seed=5,
        max_bounces=8,
    )
    single = Renderer(cbox_small, cfg)
    single.render()
    multi = MultiChipRenderer(cbox_small, cfg, num_devices=ndev)
    metrics = multi.render()
    assert metrics["devices"] == ndev
    np.testing.assert_allclose(
        np.asarray(multi.film), np.asarray(single.film), rtol=5e-4, atol=5e-5
    )


def test_multichip_nondivisible_blocks(cbox_small):
    # 3x2 = 6 blocks over 4 devices -> padding with dummy blocks
    cfg = RenderConfig(
        width=192, height=128, spp=1, block_size=64, seed=9, max_bounces=6
    )
    single = Renderer(cbox_small, cfg)
    single.render()
    multi = MultiChipRenderer(cbox_small, cfg, num_devices=4)
    multi.render()
    np.testing.assert_allclose(
        np.asarray(multi.film), np.asarray(single.film), rtol=5e-4, atol=5e-5
    )


def test_multihost_sweep_sharding_matches_single(cbox_small):
    """Simulated multi-host run (explicit host ids): the merged film of N
    host-strided partial renders must equal the single render bitwise — the
    sweep set is identical and film accumulation is plain addition."""
    from hijiki.parallel.multihost import (
        MultiHostRenderer,
        host_sweeps,
        merge_films,
    )

    cfg = RenderConfig(
        width=128, height=64, spp=5, block_size=64, seed=11, max_bounces=6
    )
    single = Renderer(cbox_small, cfg)
    single.render()

    n_hosts = 3
    ids = [host_sweeps(cfg.spp, h, n_hosts) for h in range(n_hosts)]
    assert sorted(sum(ids, [])) == list(range(cfg.spp))  # exact partition

    hosts = [
        MultiHostRenderer(cbox_small, cfg, host_id=h, num_hosts=n_hosts)
        for h in range(n_hosts)
    ]
    for h in hosts:
        m = h.render()
        assert m["sweeps"] == len(ids[h.host_id])
    merged = merge_films([h.film for h in hosts])
    # same sweeps, same per-sweep deltas; merge order may differ from the
    # single render's accumulation order -> float-assoc tolerance
    np.testing.assert_allclose(
        np.asarray(merged), np.asarray(single.film), rtol=1e-6, atol=1e-7
    )
    # single-process merged_film() is the local partial
    np.testing.assert_array_equal(
        np.asarray(hosts[0].merged_film()), np.asarray(hosts[0].film)
    )


def test_multihost_checkpoint_resume(cbox_small, tmp_path):
    """Resuming a checkpointed multi-host partial render continues at this
    host's completed-sweep count instead of re-tracing (review finding)."""
    import dataclasses

    from hijiki.parallel.multihost import MultiHostRenderer

    cfg = RenderConfig(
        width=64, height=64, spp=6, block_size=64, seed=3, max_bounces=4
    )
    full = MultiHostRenderer(cbox_small, cfg, host_id=1, num_hosts=2)
    full.render()

    # render only the first of host 1's three sweeps, checkpoint, resume
    part = MultiHostRenderer(
        cbox_small, dataclasses.replace(cfg, spp=2), host_id=1, num_hosts=2
    )
    part.render()
    assert part.sweeps_done == 1
    ck = str(tmp_path / "mh.npz")
    part.config = cfg
    part.save_checkpoint(ck)

    resumed = MultiHostRenderer.resume_checkpoint(
        cbox_small, ck, cfg, host_id=1, num_hosts=2
    )
    resumed.render()
    np.testing.assert_array_equal(np.asarray(resumed.film), np.asarray(full.film))


def test_multichip_resumed_metrics_count_traced_sweeps(cbox_small):
    """After a mid-render resume, rays_per_second must count only the sweeps
    traced in THIS render() call (the Renderer.render rule),
    not the full spp."""
    cfg = RenderConfig(width=128, height=64, spp=4, block_size=64, seed=3,
                       max_bounces=6)
    r = MultiChipRenderer(cbox_small, cfg, num_devices=2)
    r.sweeps_done = 3  # simulate a resumed render: 1 sweep left
    for s in range(3):
        r.scheduler.sweep(s)  # scheduler replay, as resume_checkpoint does
    m = r.render()
    assert m["primary_rays"] == 128 * 64 * 1


@pytest.mark.parametrize("cls_name", ["MultiHostMultiChipRenderer"])
def test_host_stride_times_chip_shard_matches_single(cbox_small, cls_name):
    """The two-level topology (SURVEY §2.5): sweeps stride across simulated
    hosts while each host shards its sweeps over a 2-device mesh. The merged
    film must equal the plain single-device render (identical per-sweep
    deltas; only film-add order differs)."""
    import hijiki.parallel.multihost as mh
    from hijiki.parallel.multihost import merge_films
    from hijiki.render.renderer import RenderConfig, Renderer

    cls = getattr(mh, cls_name)
    cfg = dict(width=64, height=128, spp=3, block_size=64, seed=7,
               max_bounces=8)
    films = []
    for h in range(2):
        r = cls(cbox_small, RenderConfig(**cfg), host_id=h, num_hosts=2,
                num_devices=2)
        m = r.render()
        assert m["host_id"] == h and m["devices"] == 2
        films.append(r.film)
    merged = np.asarray(merge_films(films))

    ref = Renderer(cbox_small, RenderConfig(**cfg))
    ref.render()
    # sharded-vs-single FMA/fusion noise, same bound as
    # test_multichip_matches_single
    np.testing.assert_allclose(merged, np.asarray(ref.film),
                               rtol=1e-4, atol=2e-4)
