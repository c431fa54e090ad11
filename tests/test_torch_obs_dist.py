"""The cases of the JAX package's ``tests/test_obs_dist.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Distributed-observability unit suite: trace-context wire
format and deterministic identity, in-process context propagation, the
black-box flight recorder (ring bound, dump dedupe, file dumps, the
torn-scrape concurrency contract), and cross-shard metrics federation
(merge semantics, file scrape, the fleet router's federated snapshot,
and the ``ytpu_top`` directory mode).

Everything is deterministic: trace ids are keyed hashes of update
bytes, sampling is a residue test, and the concurrency test asserts
structural invariants that hold under any interleaving.
"""

import json
import sys
import threading
from pathlib import Path

import pytest

import yjs_tpu_torch as Y
from torch_service import FleetRouter
from yjs_tpu_torch.obs.blackbox import (
    FlightRecorder,
    flight_recorder,
    reset_flight_recorder,
)
from yjs_tpu_torch.obs.dist import (
    TRACE_CTX_LEN,
    TraceContext,
    current_context,
    flow_id_for,
    mint_for_update,
    sample_rate,
    trace_metrics,
    use_context,
)
from yjs_tpu_torch.obs.expo import registry_snapshot
from yjs_tpu_torch.obs.federate import (
    federate_snapshots,
    merge_summaries,
    read_snapshot_dir,
)
from yjs_tpu_torch.updates import encode_state_as_update

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

pytestmark = pytest.mark.tracing


# -- trace context: wire + identity ------------------------------------------


def test_trace_context_wire_roundtrip():
    ctx = TraceContext(0xDEADBEEF << 64 | 0x1234, 0xCAFE, True)
    raw = ctx.to_bytes()
    assert len(raw) == TRACE_CTX_LEN
    back = TraceContext.from_bytes(raw)
    assert back == ctx
    assert back.sampled
    # future flag bytes may extend the blob: a longer buffer still
    # parses (only the 25-byte prefix is interpreted)
    assert TraceContext.from_bytes(raw + b"\xff\xff") == ctx
    # unsampled flag survives too
    cold = TraceContext(1, 2, False)
    assert not TraceContext.from_bytes(cold.to_bytes()).sampled


def test_trace_context_rejects_malformed_blobs():
    assert TraceContext.from_bytes(b"") is None
    assert TraceContext.from_bytes(b"\x00" * (TRACE_CTX_LEN - 1)) is None
    assert TraceContext.from_bytes(None) is None
    assert TraceContext.from_bytes("not-bytes") is None


def test_mint_is_deterministic_across_providers(monkeypatch):
    # two providers hashing the same raw update bytes must agree on the
    # trace id AND the sampling verdict — stitching without coordination
    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "1")
    a = mint_for_update(b"update-payload")
    b = mint_for_update(b"update-payload")
    assert a == b
    assert a.sampled
    assert a.trace_hex == b.trace_hex
    assert mint_for_update(b"other-payload") != a
    # salted mints occupy a distinct id space (failover episodes)
    assert mint_for_update(b"update-payload", salt=b"failover") != a


def test_sampling_rate_knob(monkeypatch):
    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "1")
    assert sample_rate() == 1
    assert mint_for_update(b"x").sampled
    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "0")
    assert sample_rate() == 0
    assert not mint_for_update(b"x").sampled
    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "garbage")
    assert sample_rate() == 64  # malformed -> default
    monkeypatch.delenv("YTPU_TRACE_SAMPLE")
    # default head-samples 1-in-64: the verdict is a pure residue test
    ctx = mint_for_update(b"x")
    assert ctx.sampled == (ctx.trace_id % 64 == 0)


def test_force_sampling_preserves_identity(monkeypatch):
    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "0")
    ctx = mint_for_update(b"doomed-update")
    assert not ctx.sampled
    before = trace_metrics().forced.labels(reason="dlq").value
    forced = ctx.force("dlq")
    assert forced.sampled
    assert forced.trace_id == ctx.trace_id
    assert forced.span_id == ctx.span_id
    assert trace_metrics().forced.labels(reason="dlq").value == before + 1
    # already-sampled contexts pass through without a second count
    assert forced.force("dlq") is forced
    assert trace_metrics().forced.labels(reason="dlq").value == before + 1


def test_child_spans_are_deterministic():
    ctx = TraceContext(77, 88, True)
    c1, c2 = ctx.child("flush"), ctx.child("flush")
    assert c1 == c2
    assert c1.trace_id == ctx.trace_id and c1.sampled
    assert c1.span_id != ctx.span_id
    assert ctx.child("repl").span_id != c1.span_id


def test_flow_id_for_is_stable_and_collision_resistant():
    key = ("abc123", "repl", "room-0", 7, 2)
    assert flow_id_for(key) == flow_id_for(key)
    assert flow_id_for(key) != flow_id_for(("abc123", "repl", "room-0", 7, 1))
    ids = {flow_id_for((i, j)) for i in range(50) for j in range(50)}
    assert len(ids) == 2500  # no collisions across a realistic key space
    assert all(isinstance(i, int) and i > 0 for i in ids)


def test_use_context_nests_and_clears():
    assert current_context() is None
    outer = TraceContext(1, 1, True)
    inner = TraceContext(2, 2, True)
    with use_context(outer):
        assert current_context() is outer
        with use_context(inner):
            assert current_context() is inner
        assert current_context() is outer
        with use_context(None):  # nested ingress isolation
            assert current_context() is None
        assert current_context() is outer
    assert current_context() is None


# -- flight recorder ----------------------------------------------------------


def test_ring_bound_and_dropped_accounting():
    rec = FlightRecorder(cap=16)
    for i in range(40):
        rec.record("test", "evt", guid=f"doc-{i}", i=i)
    assert len(rec) == 16
    st = rec.stats()
    assert st["cap"] == 16
    assert st["events"] == 40
    assert st["in_ring"] == 16
    assert st["dropped"] == 40 - 16
    # the ring keeps the NEWEST events (a black box records the crash,
    # not the takeoff)
    snap = rec.snapshot()
    assert snap[0]["kv"]["i"] == 24 and snap[-1]["kv"]["i"] == 39
    assert all(snap[i]["tick"] < snap[i + 1]["tick"]
               for i in range(len(snap) - 1))


def test_record_shapes_entries():
    rec = FlightRecorder(cap=64)
    rec.record("failover", "conviction", severity="error", guid="g",
               tenant="t", shard=2, trace="ab" * 16,
               reason="missed heartbeats", payload=b"\x00" * 9)
    (e,) = rec.snapshot()
    assert e["subsystem"] == "failover" and e["event"] == "conviction"
    assert e["severity"] == "error"
    assert e["guid"] == "g" and e["tenant"] == "t" and e["shard"] == 2
    assert e["trace"] == "ab" * 16
    assert e["kv"]["reason"] == "missed heartbeats"
    assert e["kv"]["payload"] == "<9 bytes>"  # bytes never leak raw
    json.dumps(e)  # every entry must be JSON-able as recorded
    rec.record("x", "y", severity="not-a-severity")
    assert rec.snapshot()[-1]["severity"] == "info"


def test_dump_dedupes_until_new_events():
    rec = FlightRecorder(cap=64)
    rec.record("resilience", "quarantine", severity="error", guid="g")
    out = rec.dump("quarantine", doc="g", cause="boom")
    assert out is not None
    assert out["reason"] == "quarantine" and out["seq"] == 1
    assert out["context"] == {"doc": "g", "cause": "boom"}
    assert len(out["events"]) == 1
    assert rec.last_dump is out
    # a hot failure seam re-dumping with nothing new is suppressed
    assert rec.dump("quarantine", doc="g") is None
    assert rec.stats()["dumps"] == 1
    rec.record("resilience", "quarantine", severity="error", guid="h")
    again = rec.dump("quarantine")
    assert again is not None and again["seq"] == 2
    assert rec.last_dump is again and len(rec.dumps) == 2


def test_dump_writes_json_file(tmp_path, monkeypatch):
    monkeypatch.setenv("YTPU_BLACKBOX_DIR", str(tmp_path / "bb"))
    rec = FlightRecorder(cap=64)
    rec.record("fleet", "shard_killed", shard=1)
    out = rec.dump("failover: shard 1 died", shard=1)
    path = Path(out["path"])
    assert path.parent == tmp_path / "bb"
    assert path.name == "blackbox-failover--shard-1-died-0001.json"
    loaded = json.loads(path.read_text())
    assert loaded["reason"] == "failover: shard 1 died"
    assert loaded["events"] == out["events"]
    assert not list(path.parent.glob("*.tmp"))  # atomic rename, no turds


def test_blackbox_disable_knob(monkeypatch):
    monkeypatch.setenv("YTPU_BLACKBOX", "0")
    rec = FlightRecorder(cap=64)
    rec.record("test", "evt")
    assert len(rec) == 0
    assert rec.dump("anything") is None
    assert rec.stats()["events"] == 0


def test_global_recorder_reset_isolation():
    a = flight_recorder()
    assert flight_recorder() is a
    b = reset_flight_recorder()
    assert b is not a and flight_recorder() is b


def test_concurrent_writers_never_tear_a_scrape():
    """Satellite 3: hammer the recorder from writer threads while other
    threads scrape.  Every scraped entry must be complete (no torn
    dicts), ticks strictly increase, and stats stay self-consistent —
    under the same lock discipline that fixed the FlushHistory race."""
    rec = FlightRecorder(cap=128)
    n_writers, n_events = 4, 300
    stop = threading.Event()
    errors: list = []

    def write(w):
        try:
            for i in range(n_events):
                rec.record("stress", "evt", guid=f"w{w}-{i}", w=w, i=i)
                if i % 50 == 0:
                    rec.dump(f"w{w}")
        except Exception as e:  # pragma: no cover - the assertion
            errors.append(e)

    def scrape():
        try:
            while not stop.is_set():
                for e in rec.snapshot():
                    # a torn entry would miss keys written before the
                    # ring append (entries are fully built pre-lock)
                    assert "subsystem" in e and "event" in e and "tick" in e
                st = rec.stats()
                assert st["in_ring"] <= st["cap"]
                assert st["dropped"] <= st["events"]
                snap = rec.snapshot()
                assert all(snap[i]["tick"] < snap[i + 1]["tick"]
                           for i in range(len(snap) - 1))
        except Exception as e:  # pragma: no cover - the assertion
            errors.append(e)

    writers = [threading.Thread(target=write, args=(w,))
               for w in range(n_writers)]
    scrapers = [threading.Thread(target=scrape) for _ in range(2)]
    for t in scrapers + writers:
        t.start()
    for t in writers:
        t.join()
    stop.set()
    for t in scrapers:
        t.join()
    assert not errors, errors[:3]
    st = rec.stats()
    assert st["events"] == n_writers * n_events
    assert st["in_ring"] == min(128, st["events"])
    assert st["dropped"] == st["events"] - st["in_ring"]


# -- metrics federation -------------------------------------------------------


def _summary(count, total, mn, mx, p50, p95, p99):
    return {"count": count, "sum": total, "min": mn, "max": mx,
            "p50": p50, "p95": p95, "p99": p99}


def test_merge_summaries_weighted():
    merged = merge_summaries([
        _summary(3, 30.0, 5.0, 15.0, 10.0, 14.0, 15.0),
        _summary(1, 100.0, 100.0, 100.0, 100.0, 100.0, 100.0),
        _summary(0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),  # empty part ignored
    ])
    assert merged["count"] == 4
    assert merged["sum"] == 130.0
    assert merged["min"] == 5.0 and merged["max"] == 100.0
    # count-weighted estimate: (3*10 + 1*100) / 4, clamped to [min,max]
    assert merged["p50"] == pytest.approx(32.5)
    empty = merge_summaries([])
    assert empty["count"] == 0 and empty["p99"] == 0.0


def test_federate_counters_sum_gauges_keep_shards():
    s0 = {
        "counters": {"ytpu_x_total": {"": 3, "kind=a": 1}},
        "gauges": {"ytpu_depth": {"": 5}},
        "histograms": {"ytpu_lat": {"": _summary(2, 2.0, 0.5, 1.5,
                                                 1.0, 1.5, 1.5)}},
    }
    s1 = {
        "counters": {"ytpu_x_total": {"": 4}},
        "gauges": {"ytpu_depth": {"": 7}},
        "histograms": {"ytpu_lat": {"": _summary(2, 6.0, 2.0, 4.0,
                                                 3.0, 4.0, 4.0)}},
    }
    fed = federate_snapshots([
        {"label": "0", "role": "primary", "snapshot": s0},
        {"label": "1", "role": "replica", "snapshot": s1},
    ])
    # counters: summed per labels-key
    assert fed["counters"]["ytpu_x_total"][""] == 7
    assert fed["counters"]["ytpu_x_total"]["kind=a"] == 1
    # gauges: per-shard labeled series AND the unlabeled aggregate
    assert fed["gauges"]["ytpu_depth"]["shard=0,role=primary"] == 5
    assert fed["gauges"]["ytpu_depth"]["shard=1,role=replica"] == 7
    assert fed["gauges"]["ytpu_depth"][""] == 12
    # histograms: counts/sums add, min/max widen, quantiles weighted
    lat = fed["histograms"]["ytpu_lat"][""]
    assert lat["count"] == 4 and lat["sum"] == 8.0
    assert lat["min"] == 0.5 and lat["max"] == 4.0
    assert lat["p50"] == pytest.approx(2.0)
    assert fed["federation"] == {
        "sources": 2, "roles": {"0": "primary", "1": "replica"},
        "stale": [],
    }


def test_federate_layers_global_once():
    shard = {"counters": {"ytpu_x_total": {"": 1}}}
    glob = {"counters": {"ytpu_x_total": {"": 999},
                         "ytpu_fleet_total": {"": 10}}}
    fed = federate_snapshots(
        [{"label": str(k), "snapshot": shard} for k in range(3)],
        global_snapshot=glob,
    )
    # the shard-local family wins (never double-counted with global)...
    assert fed["counters"]["ytpu_x_total"][""] == 3
    # ...and the shared global family is layered exactly once, not x3
    assert fed["counters"]["ytpu_fleet_total"][""] == 10


def test_read_snapshot_dir(tmp_path):
    (tmp_path / "shard-1.json").write_text(json.dumps(
        {"role": "replica", "counters": {"ytpu_x_total": {"": 2}}}
    ))
    (tmp_path / "shard-0.json").write_text(json.dumps(
        {"counters": {"ytpu_x_total": {"": 1}}}
    ))
    (tmp_path / "torn.json").write_text('{"counters": {')  # mid-write
    (tmp_path / "notes.txt").write_text("ignored")
    sources = read_snapshot_dir(str(tmp_path))
    assert [s["label"] for s in sources] == ["shard-0", "shard-1", "torn"]
    assert sources[1]["role"] == "replica"
    assert sources[2]["snapshot"] == {}  # unreadable -> blank row
    fed = federate_snapshots(sources)
    assert fed["counters"]["ytpu_x_total"][""] == 3
    assert read_snapshot_dir(str(tmp_path / "missing")) == []


def test_router_snapshot_is_federated():
    fleet = FleetRouter(3, 2, backend="cpu")
    d = Y.Doc(gc=False)
    d.client_id = 7
    d.get_text("text").insert(0, "hello fleet")
    fleet.receive_update("room-0", encode_state_as_update(d))
    fleet.flush()
    snap = fleet.metrics_snapshot()
    fed = snap["federation"]
    assert fed["sources"] == 3
    assert set(fed["roles"]) == {"0", "1", "2"}
    # per-shard gauge series exist alongside the unlabeled aggregate the
    # single-provider dashboards keep reading
    pend = snap["gauges"]["ytpu_engine_pending_docs"]
    assert "" in pend
    assert any(k.startswith("shard=0") for k in pend)
    # engine-local counters summed across shards match the edit we made
    flushes = snap["counters"]["ytpu_engine_flushes_total"]
    assert sum(v for k, v in flushes.items() if k == "") >= 1
    # the shared process-global families are present but NOT multiplied
    assert snap["gauges"]["ytpu_fed_sources"][""] == 3
    assert "fleet" in snap and "admission" in snap


def test_ytpu_top_directory_mode(tmp_path):
    import torch_ytpu_top as ytpu_top

    fleet = FleetRouter(2, 2, backend="cpu")
    d = Y.Doc(gc=False)
    d.client_id = 9
    d.get_text("text").insert(0, "dir mode")
    fleet.receive_update("room-0", encode_state_as_update(d))
    fleet.flush()
    for k, p in enumerate(fleet.shards):
        snap = registry_snapshot(p.engine.obs.registry)
        snap["role"] = "primary" if k == 0 else "replica"
        (tmp_path / f"shard-{k}.json").write_text(json.dumps(snap))
    rows = ytpu_top.DirSource(str(tmp_path)).poll()
    assert [name for name, _ in rows] == ["FLEET", "shard-0", "shard-1"]
    fleet_snap = rows[0][1]
    assert fleet_snap["federation"]["sources"] == 2
    # every row renders through the shared column collector
    rendered = [
        ytpu_top.collect_row(name, s, None, 1.0) for name, s in rows
    ]
    assert rendered[0]["provider"] == "FLEET"
    assert all("flushes" in r for r in rendered)
