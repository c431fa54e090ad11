"""The cases of the JAX package's ``tests/test_slo.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

yjs_tpu_torch.obs.slo: convergence-latency SLOs.

Covers: the zero-wire-change update key (first-struct id + digest
fallback), the origin clock, the receive→integrate→visible pipeline
under a fake clock, multiwindow burn-rate transitions (ok / warning /
page, incl. the required two-provider breach→page test), window
aging, duplicate/rejected handling, bounded pending state, env knobs,
and the CPU-doc protocol seam.
"""

import json

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.lib0.decoding import Decoder
from yjs_tpu_torch.lib0.encoding import Encoder
from yjs_tpu_torch.obs.registry import MetricsRegistry
from yjs_tpu_torch.obs.slo import (
    ConvergenceTracker,
    OriginClock,
    update_key,
)
from torch_service import TpuProvider
from yjs_tpu_torch.sync import protocol
from yjs_tpu_torch.updates import encode_state_as_update, encode_state_vector


def _update(text="hello", client=None):
    d = Y.Doc(gc=False)
    if client is not None:
        d.client_id = client
    d.get_text("text").insert(0, text)
    return encode_state_as_update(d)


class _Clock:
    """Injectable deterministic clock for the tracker's ``now``."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _tracker(clock, **kw):
    kw.setdefault("origins", OriginClock())
    return ConvergenceTracker(MetricsRegistry(), now=clock, **kw)


def _key_bytes(i):
    """Unique unparseable payloads (numClients=0 -> digest fallback)."""
    return b"\x00" + str(i).encode()


# -- update keys -------------------------------------------------------------


def test_update_key_is_first_struct_client_clock():
    u = _update("hi", client=12345)
    assert update_key(u) == (12345, 0)
    # the key is computed from the BYTES both sides transport: identical
    # bytes, identical key, no wire change needed
    assert update_key(bytes(u)) == update_key(u)


def test_update_key_delete_only_digest_fallback():
    d = Y.Doc(gc=False)
    t = d.get_text("text")
    t.insert(0, "abc")
    sv = encode_state_vector(d)
    t.delete(0, 3)
    delete_only = encode_state_as_update(d, sv)
    key = update_key(delete_only)
    assert key[0] == -1  # no struct blocks: digest fallback
    assert key == update_key(delete_only)  # deterministic
    assert key != update_key(b"\x00other")


def test_update_key_garbage_never_raises():
    for junk in (b"", b"\xff\xff\xff\xff", b"\x00"):
        client, _ = update_key(junk)
        assert client == -1


# -- origin clock ------------------------------------------------------------


def test_origin_clock_first_sighting_wins_and_bounded():
    oc = OriginClock(maxlen=4)
    oc.record_once("k", 1.0)
    oc.record_once("k", 99.0)  # later sighting must not overwrite
    assert oc.lookup("k") == 1.0
    for i in range(6):
        oc.record_once(f"x{i}", float(i))
    assert len(oc) <= 4
    assert oc.lookup("k") is None  # oldest evicted


# -- the pipeline under a fake clock -----------------------------------------


def test_pipeline_stages_and_latency_histogram():
    clock = _Clock()
    tr = _tracker(clock, target_ms=250.0)
    u = _update("stage test", client=7)
    clock.t = 1.0
    key = tr.receive(u)
    clock.t = 1.01
    tr.integrated(key)
    clock.t = 1.05
    assert tr.visible() == 1
    snap = tr.snapshot()
    assert snap["completed"] == 1 and snap["pending"] == 0
    assert snap["state"] == "ok"  # 50ms < 250ms target
    lat = tr._latency.summary()
    assert lat["count"] == 1
    assert lat["max"] == pytest.approx(0.05, abs=1e-6)
    # stage decomposition: receive 0 (origin floored at receive),
    # integrate 10ms, visible 40ms
    assert tr._stage["integrate"].summary()["max"] == pytest.approx(
        0.01, abs=1e-6
    )
    assert tr._stage["visible"].summary()["max"] == pytest.approx(
        0.04, abs=1e-6
    )


def test_origin_stamp_measures_true_end_to_end():
    clock = _Clock()
    tr = _tracker(clock, target_ms=250.0)
    u = _update("origin test", client=9)
    clock.t = 0.0
    tr.origin(u)  # emitted now (the broadcasting provider stamps)
    clock.t = 0.4  # transport delay
    key = tr.receive(u)
    tr.integrated(key)
    clock.t = 0.5
    tr.visible()
    # latency is origin->visible (500ms), not receive->visible (100ms)
    assert tr._latency.summary()["max"] == pytest.approx(0.5, abs=1e-6)
    assert tr.snapshot()["state"] == "page"  # 500ms > 250ms, 100% breach


def test_duplicate_delivery_completes_once():
    clock = _Clock()
    tr = _tracker(clock)
    u = _update("dup", client=3)
    k1 = tr.receive(u)
    k2 = tr.receive(u)  # duplicate: first delivery wins
    assert k1 == k2
    tr.integrated(k1)
    assert tr.visible() == 1
    assert tr.visible() == 0  # nothing left
    assert tr.snapshot()["completed"] == 1


def test_rejected_updates_stop_tracking():
    clock = _Clock()
    tr = _tracker(clock)
    key = tr.receive(_update("bad", client=4))
    tr.rejected(key)
    assert tr.visible() == 0
    assert tr.snapshot()["pending"] == 0


def test_unintegrated_pending_survives_flush():
    clock = _Clock()
    tr = _tracker(clock)
    tr.receive(_update("parked", client=5))  # never integrated (parked)
    assert tr.visible() == 0  # a flush does NOT complete it
    assert tr.snapshot()["pending"] == 1


def test_pending_bounded():
    clock = _Clock()
    tr = _tracker(clock, max_pending=8)
    for i in range(50):
        tr.receive(_key_bytes(i))
    assert tr.snapshot()["pending"] <= 8


# -- burn-rate state machine -------------------------------------------------


def _drive(tr, clock, n, breach_every=None, dt=0.001, breach_s=1.0):
    """Complete ``n`` convergences; every ``breach_every``-th one is slow."""
    for i in range(n):
        clock.t += dt
        key = tr.receive(_key_bytes(i))
        tr.integrated(key)
        if breach_every and i % breach_every == 0:
            clock.t += breach_s
        tr.visible()


def test_all_fast_stays_ok():
    clock = _Clock()
    tr = _tracker(clock, target_ms=250.0, window_s=1200.0, objective=0.99)
    _drive(tr, clock, 50)
    snap = tr.snapshot()
    assert snap["state"] == "ok"
    assert snap["burn_rates"]["long"] == 0.0


def test_warning_state_at_moderate_burn():
    clock = _Clock()
    tr = _tracker(clock, target_ms=250.0, window_s=1200.0, objective=0.99)
    # 10% breaches against a 1% budget -> burn 10: warning (>=6, <14.4)
    _drive(tr, clock, 100, breach_every=10)
    snap = tr.snapshot()
    assert snap["state"] == "warning"
    assert snap["burn_rates"]["long"] == pytest.approx(10.0)
    assert snap["windows"]["long"]["breached"] == 10


def test_page_state_at_high_burn():
    clock = _Clock()
    tr = _tracker(clock, target_ms=250.0, window_s=1200.0, objective=0.99)
    # 20% breaches -> burn 20 on BOTH windows: page
    _drive(tr, clock, 50, breach_every=5)
    assert tr.snapshot()["state"] == "page"


def test_breaches_age_out_of_the_windows():
    clock = _Clock()
    tr = _tracker(clock, target_ms=250.0, window_s=10.0, objective=0.99)
    _drive(tr, clock, 10, breach_every=2)  # heavy breaching -> page
    assert tr.snapshot()["state"] == "page"
    clock.t += 100.0  # both windows age out completely
    snap = tr.snapshot()
    assert snap["state"] == "ok"
    assert snap["windows"]["long"]["total"] == 0


def test_env_knobs_configure_tracker(monkeypatch):
    monkeypatch.setenv("YTPU_SLO_CONVERGENCE_MS", "42")
    monkeypatch.setenv("YTPU_SLO_WINDOW", "60")
    monkeypatch.setenv("YTPU_SLO_OBJECTIVE", "0.999")
    tr = ConvergenceTracker(MetricsRegistry(), origins=OriginClock())
    assert tr.target_ms == 42.0
    assert tr.window_s == 60.0
    assert tr.short_window_s == 5.0  # window/12
    assert tr.objective == 0.999


def test_snapshot_is_json_able():
    clock = _Clock()
    tr = _tracker(clock)
    _drive(tr, clock, 3)
    snap = json.loads(json.dumps(tr.snapshot()))
    assert set(snap) >= {
        "target_ms", "window_s", "objective", "state", "burn_rates",
        "windows", "completed", "pending",
    }


# -- two-provider end-to-end (the acceptance test) ---------------------


def test_two_provider_breach_transitions_to_page(monkeypatch):
    """Provider A broadcasts, provider B converges; with a 0 ms target
    every real convergence breaches, and B's multiwindow burn rate must
    transition its verdict to ``page``."""
    monkeypatch.setenv("YTPU_SLO_CONVERGENCE_MS", "0")
    a = TpuProvider(4)
    b = TpuProvider(4)
    a.on_update(lambda guid, u: b.receive_update(guid, u))
    for k in range(3):
        d = Y.Doc(gc=False)
        d.get_text("text").insert(0, f"edit {k} ")
        a.receive_update("room", encode_state_as_update(d))
        a.flush()  # emits the broadcast -> B receives
        b.flush()  # B integrates: convergence completes
    assert "edit 0" in b.text("room")
    snap = b.slo_snapshot()
    assert snap["completed"] >= 3
    assert snap["windows"]["long"]["breached"] == snap["windows"]["long"]["total"]
    assert snap["state"] == "page"
    # the verdict also rides the exposition surfaces
    assert b.metrics_snapshot()["slo"]["state"] == "page"
    text = b.metrics_text()
    assert "ytpu_slo_state 2" in text


def test_two_provider_convergence_within_target():
    """With a generous target the same exchange stays ``ok`` and the
    latency histogram records one completion per converged update."""
    a = TpuProvider(4)
    b = TpuProvider(4)
    a.on_update(lambda guid, u: b.receive_update(guid, u))
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "hello peer")
    a.receive_update(
        "room", encode_state_as_update(d)
    )
    a.flush()
    b.flush()
    assert b.text("room") == "hello peer"
    fam = b.engine.obs.registry.get("ytpu_convergence_latency_seconds")
    assert fam.count == 1


# -- the CPU-doc protocol seam -----------------------------------------------


def test_protocol_slo_seam_zero_wire_change():
    d1 = Y.Doc(gc=False)
    d1.get_text("text").insert(0, "wire test")
    enc_plain = Encoder()
    protocol.write_update(enc_plain, encode_state_as_update(d1))
    frame = enc_plain.to_bytes()

    clock = _Clock()
    tr = _tracker(clock)
    d2 = Y.Doc(gc=False)
    reply = Encoder()
    mt = protocol.read_sync_message(Decoder(frame), reply, d2, slo=tr)
    assert mt == protocol.MESSAGE_YJS_UPDATE
    assert str(d2.get_text("text")) == "wire test"
    # a CPU Doc integrates synchronously: the pipeline completed inline
    snap = tr.snapshot()
    assert snap["completed"] == 1 and snap["pending"] == 0
    # zero wire change: the tracked frame IS the plain frame
    d3 = Y.Doc(gc=False)
    protocol.read_sync_message(Decoder(frame), Encoder(), d3)
    assert str(d3.get_text("text")) == "wire test"
