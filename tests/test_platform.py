"""The platform decision (utils/platform.py), the compile-cache location
(utils/cache.py) and the smoke script's refusal to run without a GPU."""

import logging
import os
import subprocess
import sys

import pytest

from hijiki.utils import cache, platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_summary_names_the_backend():
    s = platform.device_summary()
    assert s == {"platform": "cpu", "kind": "cpu", "count": 8}


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        platform.require_gpu()


def test_pin_platform_sets_env_and_config(monkeypatch):
    import jax

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    platform.pin_platform(None)  # falls back to the explicit env var
    assert jax.config.jax_platforms == "cpu"
    platform.pin_platform("cpu")
    assert os.environ["JAX_PLATFORMS"] == "cpu"


@pytest.mark.parametrize("env", [None, "custom"])
def test_cache_dir_resolution(monkeypatch, tmp_path, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env))
        assert cache.cache_dir() == str(tmp_path / env)


def test_cache_stays_off_on_the_cpu(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "c").exists()


def test_cache_counter_counts_hits_and_misses():
    counter = cache.CacheCounter()
    log = logging.getLogger("test_cache_counter")
    log.addHandler(counter)
    log.setLevel(logging.DEBUG)
    try:
        log.debug("Persistent compilation cache hit for '%s' with key %r", "jit_f", "k")
        log.debug("PERSISTENT COMPILATION CACHE MISS for '%s' with key %r", "jit_g", "k")
        log.debug("Persistent compilation cache hit for '%s' with key %r", "jit_h", "k")
        log.debug("unrelated")
    finally:
        log.removeHandler(counter)
    assert (counter.hits, counter.misses) == (2, 1)


def test_chip_smoke_fails_without_a_gpu():
    """The smoke script must exit non-zero and print no result line when jax
    finds no GPU: a CPU run must never pass for a card run."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.gpu
def test_card_is_a_gpu(gpu):
    """On the card: jax reports the GPU platform (skips elsewhere)."""
    assert gpu["platform"] == "gpu" and gpu["count"] >= 1
