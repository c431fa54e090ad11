"""Metric arithmetic, K1's byte count and the trace reader."""

import json

import pytest

from roombench import devtrace, metrics
from roombench.metrics.k1_bytes import k1_bytes


def _rec(**kw):
    rec = {
        "setup_s": 20.0, "window_s": 10.0, "edits": 5000, "joins": 0,
        "work": 5000, "n_received": 5000, "ingest_s": 2.0,
        "flush": {"n": 10, "t_plan_s": 1.0, "t_pack_s": 0.25, "t_dispatch_s": 0.25,
                  "t_device_wait_s": 0.0, "t_emit_s": 0.5},
        "batches": {"n": 0, "wall_s": 0.0, "flush_s": 0.0, "flush_spans": 0},
        "join_latency_s": [], "k1": {"rows": 700, "deletes": 300, "rooms": 100},
        "device_kind": "NVIDIA H100 80GB HBM3", "trace": None,
    }
    rec.update(kw)
    return rec


def test_rates_and_per_edit_layers():
    rec = _rec()
    assert metrics.read("edits_per_s", rec) == 500.0
    assert metrics.read("setup_s", rec) == 20.0
    assert metrics.read("ingest_us.typing", rec) == pytest.approx(400.0)
    assert metrics.read("plan_us.typing", rec) == pytest.approx(200.0)
    assert metrics.read("flush_rest_us.typing", rec) == pytest.approx(200.0)
    assert metrics.read("joins_per_s", rec) is None
    assert metrics.read("join_p95_ms", rec) is None
    assert metrics.read("device_idle.typing", rec) is None
    assert metrics.read("k1_roofline.typing", rec) is None


def test_join_metrics():
    lat = [0.1] * 95 + [0.3] * 5
    rec = _rec(edits=6400, joins=100, work=100, join_latency_s=lat,
               batches={"n": 2, "wall_s": 0.5, "flush_s": 0.1, "flush_spans": 2})
    assert metrics.read("joins_per_s", rec) == 10.0
    assert metrics.read("join_p95_ms", rec) == pytest.approx(100.0)
    lat[94] = 0.2
    assert metrics.read("join_p95_ms", rec) == pytest.approx(200.0)
    assert metrics.read("reply_us.join", rec) == pytest.approx(4000.0)
    assert metrics.read("ingest_us.join", rec) == pytest.approx(2e4)
    rec["batches"]["flush_spans"] = 1  # a flush span was not found
    assert metrics.read("reply_us.join", rec) is None


def test_k1_bytes_and_roofline():
    assert k1_bytes(rows=1, deletes=0, rooms=0) == 20
    assert k1_bytes(rows=0, deletes=1, rooms=0) == 5
    assert k1_bytes(rows=0, deletes=0, rooms=1) == 16
    tr = {"busy_s": 0.5, "window_s": 10.0,
          "kernels": {"void apply_lanes_kernel<true>": 2e-6, "other": 1.0}}
    rec = _rec(trace=tr)
    want = k1_bytes(700, 300, 100) / 3.35e12 / 2e-6 * 100
    assert metrics.read("k1_roofline.typing", rec) == pytest.approx(want)
    assert metrics.read("device_idle.typing", rec) == pytest.approx(95.0)
    assert metrics.read("k1_roofline.typing", _rec(trace=tr, device_kind="cpu")) is None
    tr2 = dict(tr, kernels={"other": 1.0})
    assert metrics.read("k1_roofline.typing", _rec(trace=tr2)) is None


def test_trace_reader_busy_union_and_named_gaps(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "roombench.window", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "tick.ingest", "ts": 0, "dur": 600},
        {"ph": "X", "cat": "user_annotation", "name": "tick.flush", "ts": 600, "dur": 400},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 650, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 700, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 900, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000, "dur": 50},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    t = devtrace.read_trace(str(p))
    assert t["busy_s"] == pytest.approx(200e-6)
    assert t["window_s"] == pytest.approx(1000e-6)
    assert t["kernels"]["k1"] == pytest.approx(150e-6)
    gaps = t["breakdown"]["idle_gaps"]
    assert gaps[0] == ["roombench.window/tick.ingest", pytest.approx(650e-6)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert t["breakdown"]["device_ops"][0][0] == "k1"
