"""Reduce a ``jax.profiler`` trace to device metrics.

A trace written by ``jax.profiler.trace(dir)`` lands as
``dir/plugins/profile/<time>/<host>.xplane.pb``. ``load_device_events``
reads the kernels that ran on the GPUs from it (``jax.profiler.ProfileData``,
nothing beyond jax), and ``summarize`` turns them into the numbers the
smoke test and the benchmark print: device time per operation, the device's
busy and idle share of the traced span, and the share of device time spent
under a named scope (``jax.named_scope``; render_sweep names its halves
``trace`` and ``reconstruct_sweep``). The reduction lives here, with a test
on synthetic events, so every report computes these numbers the same way.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass

# derived summary lines some profiler versions add to a device plane; they
# repeat the per-stream kernel events and would double-count them
_SUMMARY_LINES = ("XLA Modules", "XLA Ops", "Steps", "TensorFlow Ops", "Framework Ops", "Source code")


@dataclass(frozen=True)
class DeviceEvent:
    name: str  # kernel name
    start_ns: float
    dur_ns: float
    module: str  # hlo_module stat ("" when absent)
    scope: str  # every stat value joined: op names carry the named scopes


def newest_xplane(trace_dir: str) -> str:
    files = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb"))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(files, key=os.path.getmtime)


def load_device_events(trace_dir: str, plane_prefix: str = "/device:GPU") -> list[DeviceEvent]:
    """Kernel events of every plane whose name starts with ``plane_prefix``."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(newest_xplane(trace_dir))
    out = []
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if line.name in _SUMMARY_LINES:
                continue
            for ev in line.events:
                stats = {k: str(v) for k, v in ev.stats}
                out.append(
                    DeviceEvent(
                        name=ev.name,
                        start_ns=float(ev.start_ns),
                        dur_ns=float(ev.duration_ns),
                        module=stats.get("hlo_module", ""),
                        scope=" ".join(stats.values()),
                    )
                )
    return out


def busy_ns(events) -> float:
    """Length of the union of the events' [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted((ev.start_ns, ev.start_ns + ev.dur_ns) for ev in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(events, *, scope: str = "reconstruct_sweep", top: int = 8) -> dict:
    """Device metrics of one traced window.

    ``span_ns`` runs from the first kernel's start to the last kernel's end;
    ``idle_share`` is the part of that span in which no kernel ran.
    ``top`` lists (kernel name, total ms, calls) by total device time.
    ``scope_share`` is the share of summed kernel time whose name or stats
    mention ``scope``."""
    events = [e for e in events if e.dur_ns > 0]
    if not events:
        raise ValueError("no device events in the trace")
    t0 = min(e.start_ns for e in events)
    t1 = max(e.start_ns + e.dur_ns for e in events)
    span = t1 - t0
    busy = busy_ns(events)
    kernel_ns = sum(e.dur_ns for e in events)
    per_name: dict[str, list] = {}
    for e in events:
        acc = per_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.dur_ns
        acc[1] += 1
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    scoped = sum(e.dur_ns for e in events if scope in e.name or scope in e.scope)
    return dict(
        span_ns=span,
        busy_ns=busy,
        idle_share=1.0 - busy / span if span > 0 else 0.0,
        kernel_ns=kernel_ns,
        kernels=len(events),
        top=[(name, ns / 1e6, n) for name, (ns, n) in ranked],
        scope=scope,
        scope_share=scoped / kernel_ns,
    )
