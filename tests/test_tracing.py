"""Host-span tracing (utils/tracing.py): the Chrome-trace timeline of the
driver loop. Net-new vs the reference (SURVEY §5 tracing subsystem)."""

import json

import numpy as np
import pytest

from hijiki.render.renderer import RenderConfig, Renderer
from hijiki.scene.cbox_mesh import CBOX_OBJ
from hijiki.utils.tracing import SpanTracer, maybe_span


@pytest.fixture(scope="module")
def cbox_small():
    from hijiki.scene.compile import compile_scene
    from hijiki.scene.obj import load_obj_scene

    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    return compile_scene(scene)


def test_span_tracer_basic(tmp_path):
    tr = SpanTracer()
    with tr.span("outer", foo=1) as extra:
        with tr.span("inner"):
            pass
        extra["late"] = 42
    tr.instant("marker", note="x")
    tr.counter("rate", mrays=1.5)
    path = tmp_path / "trace.json"
    tr.write(str(path))
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    names = [e["name"] for e in evs]
    assert names == ["inner", "outer", "marker", "rate"]  # spans close inner-first
    outer = evs[1]
    assert outer["ph"] == "X" and outer["dur"] >= evs[0]["dur"]
    assert outer["args"] == {"foo": 1, "late": 42}
    assert evs[3]["ph"] == "C" and evs[3]["args"]["mrays"] == 1.5


def test_maybe_span_none_is_noop():
    with maybe_span(None, "anything") as extra:
        extra["ignored"] = 1  # the null context yields a throwaway dict


def test_renderer_emits_spans(cbox_small):
    cfg = RenderConfig(width=64, height=64, spp=2, block_size=64, seed=3,
                       driver="wavefront", max_bounces=4)
    r = Renderer(cbox_small, cfg)
    r.tracer = SpanTracer()
    r.render()
    names = [e["name"] for e in r.tracer.events]
    # one dispatch span per sweep, the film sync, and the throughput counter
    assert names == ["dispatch sweep", "dispatch sweep", "film ready", "throughput"]
    assert "throughput" in names
    disp = [e for e in r.tracer.events if e["name"] == "dispatch sweep"]
    assert all(e["dur"] > 0 for e in disp)
    assert disp[0]["args"]["sweep"] == 0 and disp[1]["args"]["sweep"] == 1
    # the tracer's timeline must cover the metrics' elapsed window
    total_us = max(e["ts"] + e.get("dur", 0) for e in r.tracer.events)
    assert total_us <= (r.metrics["render_seconds"] + 1.0) * 1e6


def test_cli_trace_json(tmp_path):
    from hijiki.cli import main

    out = tmp_path / "t.exr"
    trace = tmp_path / "trace.json"
    main(
        [
            CBOX_OBJ,
            "--use-bvh",
            "-w", "32", "-H", "32", "-s", "1",
            "--driver", "sync",
            "-o", str(out),
            "--trace-json", str(trace),
        ]
    )
    doc = json.loads(trace.read_text())
    assert any(e["name"] == "dispatch sweep" for e in doc["traceEvents"])
    assert out.exists()
