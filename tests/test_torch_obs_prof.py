"""The cases of the JAX package's ``tests/test_obs_prof.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

yjs_tpu_torch.obs.prof: compile-aware cost attribution.

Covers: call-signature mirroring and shape buckets, compile / cache-hit
/ retrace accounting (incl. the retrace-detection contract with
offending shapes), device-mode timing, device-memory gauges, host batch
op histograms, WAL append latency, Chrome-trace flow/metadata export,
torn-scrape safety under a concurrent flusher, and the ytpu_top /
ytpu_stats dashboard surfaces.
"""

import importlib.util
import io
import json
import os
import threading
import time
from pathlib import Path

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.obs.prof import (
    KernelProfiler,
    call_signature,
    host_timed,
    kernel_profiler,
    profiled,
    shape_bucket,
)
from yjs_tpu_torch.obs.registry import MetricsRegistry
from yjs_tpu_torch.obs.trace import Tracer
from torch_service import BatchEngine
from torch_service import TpuProvider
from yjs_tpu_torch.updates import encode_state_as_update

import torch


ROOT = Path(__file__).resolve().parent.parent


def _update(text="hello"):
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, text)
    return encode_state_as_update(d)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fresh_profiler():
    return KernelProfiler(
        registry=MetricsRegistry(), tracer=Tracer(enabled=True)
    )


# -- signatures & buckets ----------------------------------------------------


def test_call_signature_distinguishes_shapes_dtypes_and_statics():
    a8 = torch.zeros((8,), dtype=torch.int32)
    a16 = torch.zeros((16,), dtype=torch.int32)
    f8 = torch.zeros((8,), dtype=torch.float32)
    assert call_signature((a8,), {}) != call_signature((a16,), {})
    assert call_signature((a8,), {}) != call_signature((f8,), {})
    assert call_signature((a8,), {}) == call_signature((a8,), {})
    # hashable statics participate by VALUE (part of the call's key)
    assert call_signature((a8, 3), {}) != call_signature((a8, 4), {})


def test_shape_bucket_pow2_and_scalar():
    assert shape_bucket(call_signature((1, 2.5), {})) == "scalar"
    sig = call_signature((torch.zeros((3, 3)),), {})
    assert shape_bucket(sig) == "le_16"  # 9 elements -> next pow2
    sig = call_signature((torch.zeros((8,)), torch.zeros((64,))), {})
    assert shape_bucket(sig) == "le_64"  # largest leaf wins


# -- compile / hit / retrace accounting --------------------------------------


def test_profiler_compile_then_cache_hits():
    p = _fresh_profiler()
    fn = lambda x: x + 1  # noqa: E731
    x = torch.zeros((4,), dtype=torch.int32)
    for _ in range(3):
        out = p.call("k", fn, (x,), {})
    assert int(out[0]) == 1
    snap = p.snapshot()["kernels"]["k"]
    assert snap["compiles"] == 1
    assert snap["hits"] == 2
    assert snap["retraces"] == 0
    assert snap["hit_rate"] == pytest.approx(2 / 3)


def test_retrace_detection_records_offending_shapes():
    p = _fresh_profiler()
    fn = lambda x: x * 2  # noqa: E731
    p.call("grow", fn, (torch.zeros((8,), dtype=torch.int32),), {})
    p.call("grow", fn, (torch.zeros((32,), dtype=torch.int32),), {})  # NEW signature
    snap = p.snapshot()
    assert snap["kernels"]["grow"]["retraces"] == 1
    assert snap["kernels"]["grow"]["compiles"] == 2
    (event,) = snap["retrace_events"]
    assert event["kernel"] == "grow"
    assert event["shape"] == "le_32"
    # the offending abstract shape, with the tensor's device
    assert "int32@cpu[32]" in event["signature"]
    assert event["n_signatures"] == 2
    assert event["compile_s"] >= 0.0
    # the retrace also lands as a tracer instant for Perfetto
    names = [e["name"] for e in p.tracer.trace_events()]
    assert "ytpu.prof.retrace" in names


def test_retrace_events_bounded():
    from yjs_tpu_torch.obs.prof import RETRACE_EVENTS_MAX

    p = _fresh_profiler()
    assert p.retrace_events.maxlen == RETRACE_EVENTS_MAX


def test_profiled_decorator_transparent_when_disabled(monkeypatch):
    calls = []

    @profiled("nope")
    def fn(x):
        calls.append(x)
        return x + 1

    monkeypatch.setenv("YTPU_OBS_DISABLED", "1")
    before = dict(kernel_profiler().snapshot()["kernels"])
    assert fn(1) == 2
    assert calls == [1]
    assert kernel_profiler().snapshot()["kernels"] == before
    assert fn.__wrapped__ is not None  # introspection survives wrapping


def test_device_mode_records_device_seconds(monkeypatch):
    p = _fresh_profiler()
    fn = lambda x: x + 1  # noqa: E731
    x = torch.zeros((4,), dtype=torch.int32)
    p.call("dev", fn, (x,), {})  # compile with device mode off
    monkeypatch.setenv("YTPU_PROF_DEVICE", "1")
    p.call("dev", fn, (x,), {})  # cached, but routed through the slow path
    fam = p.registry.get("ytpu_prof_device_seconds")
    counts = {
        labels["kernel"]: series.count for labels, series in fam.samples()
    }
    assert counts.get("dev") == 1
    assert p.snapshot()["kernels"]["dev"]["hits"] == 1


# -- engine / provider integration -------------------------------------------


def test_engine_flush_populates_prof_families():
    eng = BatchEngine(2)
    eng.queue_update(0, _update())
    eng.flush()
    snap = kernel_profiler().snapshot()["kernels"]
    assert snap, "no kernel attributed during a flush"
    # the device apply path compiles at least one engine kernel
    assert any(rec["compiles"] >= 1 for rec in snap.values())
    # prof families ride the provider/engine exposition (global merge)
    text = eng.metrics_text()
    assert "ytpu_prof_compiles_total" in text


def test_device_memory_gauges_after_flush():
    eng = BatchEngine(4)
    eng.queue_update(0, _update())
    eng.flush()
    table = eng.obs.registry.get("ytpu_prof_device_table_bytes")
    sizes = {
        labels["table"]: series.value for labels, series in table.samples()
    }
    assert sizes.get("right_link", 0) > 0
    assert sizes.get("deleted", 0) > 0
    total = eng.obs.registry.get("ytpu_prof_device_bytes_total")
    assert sum(s.value for _, s in total.samples()) >= sum(sizes.values())
    occ = eng.obs.registry.get("ytpu_prof_slot_occupancy")
    (sample,) = list(occ.samples())
    assert sample[1].value == pytest.approx(1 / 4)  # 1 active doc of 4


def test_slot_occupancy_tracks_release(tmp_path):
    prov = TpuProvider(4)
    prov.receive_update("a", _update("a"))
    prov.receive_update("b", _update("b"))
    prov.flush()
    occ = prov.engine.obs.registry.get("ytpu_prof_slot_occupancy")
    assert list(occ.samples())[0][1].value == pytest.approx(2 / 4)
    prov.release_doc("a")
    prov.receive_update("b", _update("bb"))
    prov.flush()
    assert list(occ.samples())[0][1].value == pytest.approx(1 / 4)


def test_batch_ops_record_host_histogram():
    from yjs_tpu_torch.ops.batch import merge_updates_columnar

    before = _op_count("merge_updates")
    merged = merge_updates_columnar([_update("a"), _update("b")])
    assert merged  # real output, instrumentation is transparent
    assert _op_count("merge_updates") == before + 1


def _op_count(op):
    fam = kernel_profiler().registry.get("ytpu_prof_batch_op_seconds")
    for labels, series in fam.samples():
        if labels.get("op") == op:
            return series.count
    return 0


def test_wal_append_latency_histogram(tmp_path):
    prov = TpuProvider(2, wal_dir=str(tmp_path))
    prov.receive_update("room", _update())
    fam = prov.engine.obs.registry.get("ytpu_wal_append_seconds")
    assert fam.count == 1
    assert fam.summary()["max"] > 0.0


# -- chrome trace: metadata + flow linking -----------------------------------


def test_trace_flow_links_receive_to_flush():
    prov = TpuProvider(2)
    prov.receive_update("room", _update())
    prov.flush()
    events = prov.engine.obs.tracer.trace_events()
    starts = [e for e in events if e["ph"] == "s"]
    ends = [e for e in events if e["ph"] == "f"]
    assert len(starts) == 1 and len(ends) == 1
    assert starts[0]["id"] == ends[0]["id"]  # same flow arrow
    assert ends[0]["bp"] == "e"  # binds to the enclosing flush slice
    # the arrow leaves the receive span and lands inside the flush span
    names = [e["name"] for e in events]
    assert "ytpu.provider.receive_update" in names
    assert "ytpu.provider.flush" in names
    # process/thread metadata present so Perfetto labels the lanes
    meta = {e["name"] for e in events if e["ph"] == "M"}
    assert meta >= {"process_name", "thread_name"}


def test_tracer_thread_naming():
    tr = Tracer(enabled=True)
    tr.name_thread("flusher")
    tr.instant("tick")
    events = tr.trace_events()
    thread_meta = [
        e for e in events
        if e["ph"] == "M" and e["name"] == "thread_name"
    ]
    assert thread_meta[0]["args"]["name"] == "flusher"


# -- concurrency: scrapes never observe torn state ---------------------------


def test_concurrent_scrape_never_torn():
    """Exposition scrapes run against a provider that is concurrently
    flushing and recovering dead letters: every scrape must parse, and
    `provider.metrics` copies must stay defensive (mutating one can
    never corrupt the ring)."""
    prov = TpuProvider(8)
    stop = threading.Event()
    errors = []

    def flusher():
        k = 0
        while not stop.is_set():
            try:
                k += 1
                prov.receive_update(f"room{k % 8}", _update(f"edit {k}"))
                if k % 8 == 0:  # exercise the dead-letter path too
                    prov.handle_sync_message(f"room{k % 8}", b"\x02\xff\xff")
                prov.flush()
            except Exception as e:  # pragma: no cover - the failure mode
                errors.append(e)
                return

    t = threading.Thread(target=flusher, daemon=True)
    t.start()
    deadline = time.time() + 2.0
    scrapes = 0
    try:
        while time.time() < deadline:
            text = prov.metrics_text()
            assert "ytpu_engine_flushes_total" in text
            snap = prov.metrics_snapshot()
            json.dumps(snap)  # JSON-able even mid-flush
            m = prov.metrics
            if m is not None:
                m["n_docs_flushed"] = -999  # defensive copy: no effect
                assert prov.engine.last_flush_metrics["n_docs_flushed"] != -999
            prov.slo_snapshot()
            scrapes += 1
    finally:
        stop.set()
        t.join(timeout=5)
    assert not errors
    assert scrapes > 0


# -- dashboards --------------------------------------------------------------


def test_ytpu_top_collect_and_render(tmp_path):
    top = _load_script("torch_ytpu_top")
    prov = TpuProvider(4)
    prov.receive_update("room", _update())
    prov.flush()
    snap = prov.metrics_snapshot()
    row = top.collect_row("prov-a", snap, None, 2.0)
    assert row["flushes"] >= 1
    assert row["slo"] in ("ok", "warning", "page")
    assert row["conv p50"].endswith("ms")
    frame = top.render([row], 2.0)
    assert "prov-a" in frame and "fleet verdict" in frame
    # rates derive from consecutive polls of monotonic counters
    snap2 = prov.metrics_snapshot()
    row2 = top.collect_row("prov-a", snap2, row, 2.0)
    assert row2["docs/s"] == "0.0"  # nothing flushed between polls


def test_ytpu_top_file_source_and_run_plain(tmp_path):
    top = _load_script("torch_ytpu_top")
    prov = TpuProvider(2)
    prov.receive_update("room", _update())
    prov.flush()
    path = tmp_path / "prov.json"
    path.write_text(json.dumps(prov.metrics_snapshot()))
    out = io.StringIO()
    top.run_plain(
        top.FileSource([str(path)]), interval=0.01, iterations=2, out=out
    )
    frames = out.getvalue()
    assert frames.count("ytpu_top") == 2
    assert "prov" in frames
    # unreadable file renders an empty row instead of crashing
    rows = top.FileSource([str(tmp_path / "missing.json")]).poll()
    assert rows[0][1] == {}


def test_ytpu_stats_groups_and_watch(tmp_path):
    stats = _load_script("torch_ytpu_stats")
    prov = TpuProvider(2, wal_dir=str(tmp_path))
    prov.receive_update("room", _update())
    prov.flush()
    text = stats.render_snapshot(prov.metrics_snapshot())
    for section in (
        "engine", "provider", "durability (WAL)",
        "cost attribution (prof)", "convergence SLO", "slo verdict",
    ):
        assert section in text, f"missing section {section!r}"
    out = io.StringIO()
    stats._watch(
        lambda: stats.render_snapshot(prov.metrics_snapshot()),
        interval=0.01, iterations=2, out=out,
    )
    assert out.getvalue().count("--- ") == 2


def test_knob_regex_covers_prof_and_slo():
    mod = _load_script("torch_check_metrics_schema")
    knobs = mod.resilience_knobs_in_code()
    assert "YTPU_PROF_DEVICE" in knobs
    assert "YTPU_SLO_CONVERGENCE_MS" in knobs
    assert "YTPU_SLO_WINDOW" in knobs


def test_host_timed_decorator_transparent_and_recording(monkeypatch):
    @host_timed("unit_op")
    def op(x):
        return x * 2

    before = _op_count("unit_op")
    assert op(21) == 42
    assert _op_count("unit_op") == before + 1
    monkeypatch.setenv("YTPU_OBS_DISABLED", "1")
    assert op(2) == 4
    assert _op_count("unit_op") == before + 1  # disabled: not recorded
