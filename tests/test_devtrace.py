"""utils/devtrace.py: the one reduction from a profiler trace to device
metrics (busy/idle share, per-kernel time, named-scope share)."""

import pytest

from hijiki.utils.devtrace import DeviceEvent, busy_ns, load_device_events, summarize


def _ev(name, start, dur, scope=""):
    return DeviceEvent(name=name, start_ns=start, dur_ns=dur, module="jit_f", scope=scope)


def test_busy_is_the_union_of_intervals():
    evs = [_ev("a", 0, 10), _ev("b", 5, 10), _ev("c", 20, 5), _ev("d", 21, 1)]
    assert busy_ns(evs) == 15 + 5


def test_summarize_idle_top_and_scope():
    evs = [
        _ev("gather", 0, 40, "jit(f)/trace/while/gather"),
        _ev("gather", 50, 40, "jit(f)/trace/while/gather"),
        _ev("stencil", 90, 10, "jit(f)/reconstruct_sweep/mul"),
        _ev("empty", 95, 0),
    ]
    s = summarize(evs)
    assert s["span_ns"] == 100 and s["busy_ns"] == 90
    assert s["idle_share"] == pytest.approx(0.1)
    assert s["kernels"] == 3  # zero-length events are dropped
    assert s["top"][0] == ("gather", 80 / 1e6, 2)
    assert s["scope_share"] == pytest.approx(10 / 90)


def test_summarize_refuses_an_empty_trace():
    with pytest.raises(ValueError):
        summarize([])


def test_loads_a_real_trace(tmp_path):
    """Round trip through jax.profiler on the CPU: the CPU backend's op
    events sit on host planes, so read those."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    evs = load_device_events(str(tmp_path), plane_prefix="/host:CPU")
    assert any(e.module == "jit__lambda" for e in evs)
    assert load_device_events(str(tmp_path)) == []  # no GPU planes here
