"""The cases of the JAX package's ``tests/test_resilience.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Failure isolation: transactional per-doc flush
rollback, the health state machine, the dead-letter queue, replay, and
the validating decoder seam — including the committed corrupt fixture
set (tests/fixtures/corrupt/, scripts/gen_corrupt_fixtures.py)."""

import json
from pathlib import Path

import pytest

import yjs_tpu_torch as Y
from torch_service import BatchEngine
from torch_service import TpuProvider
from yjs_tpu_torch.resilience import (
    DEGRADED,
    HEALTHY,
    QUARANTINED,
    DeadLetterQueue,
    HealthTracker,
)
from yjs_tpu_torch.updates import InvalidUpdate, validate_update

FIXTURES = Path(__file__).parent / "fixtures" / "corrupt"


def _update(text="hello", client=None):
    d = Y.Doc(gc=False)
    if client is not None:
        d.client_id = client
    d.get_text("text").insert(0, text)
    return Y.encode_state_as_update(d)


# -- validate_update ---------------------------------------------------------


def test_validate_update_accepts_valid():
    info = validate_update(_update("abc"))
    assert info["structs"] >= 1
    assert info["bytes"] > 0


def test_validate_update_rejects_garbage():
    for bad in (b"", b"\xff", b"\xff\xff\xff\xff", b"\x05hello", None, "str"):
        with pytest.raises(InvalidUpdate):
            validate_update(bad)


def test_corrupt_fixtures_all_rejected():
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    assert manifest["cases"], "fixture set must not be empty"
    kinds = {c["kind"] for c in manifest["cases"]}
    assert kinds == {"bitflip", "truncation", "varint_overflow"}
    for case in manifest["cases"]:
        payload = (FIXTURES / case["file"]).read_bytes()
        assert len(payload) == case["bytes"]
        with pytest.raises(InvalidUpdate):
            validate_update(payload)
    # the uncorrupted twin is clean — the cases fail because of the
    # damage, not because the base was bad
    validate_update((FIXTURES / "valid_base.bin").read_bytes())


# -- health state machine ----------------------------------------------------


def test_health_transitions_and_backoff():
    h = HealthTracker(threshold=3, backoff_base=4, backoff_cap=16, recovery=2)
    assert h.state(7) == HEALTHY and not h.tracked
    assert h.record_failure(7, "boom") == DEGRADED
    assert h.record_failure(7, "boom") == DEGRADED
    assert h.record_failure(7, "boom") == QUARANTINED
    assert not h.admissible(7)
    for _ in range(4):
        h.tick()
    # backoff expired: lazy re-admission into degraded probation
    assert h.admissible(7)
    assert h.state(7) == DEGRADED
    # one more failure from probation re-quarantines immediately at the
    # doubled sentence (consecutive counter reset on re-admission, so it
    # takes threshold failures again)
    for _ in range(3):
        h.record_failure(7, "again")
    rec = h.record(7)
    assert rec["state"] == QUARANTINED
    assert rec["n_quarantines"] == 2
    assert rec["quarantined_until"] - h.tick_count == 8  # 4 * 2**1


def test_health_backoff_cap():
    h = HealthTracker(threshold=1, backoff_base=4, backoff_cap=16, recovery=1)
    for k in range(6):
        h.record_failure(1, "x")
        until = h.record(1)["quarantined_until"]
        assert until - h.tick_count == min(16, 4 * 2**k)
        # serve the sentence, re-admit, fail again
        while not h.admissible(1):
            h.tick()


def test_health_recovery_frees_record():
    h = HealthTracker(threshold=3, recovery=2)
    h.record_failure(5, "x")
    assert h.tracked and h.state(5) == DEGRADED
    h.record_success(5)
    assert h.tracked  # one success is not enough
    h.record_success(5)
    assert not h.tracked and h.state(5) == HEALTHY


def test_health_reset():
    h = HealthTracker(threshold=1)
    h.record_failure(1, "x")
    h.record_failure(2, "x")
    h.reset(1)
    assert h.state(1) == HEALTHY and h.state(2) == QUARANTINED
    h.reset()
    assert not h.tracked


# -- dead-letter queue -------------------------------------------------------


def test_dlq_bounded_drop_oldest():
    q = DeadLetterQueue(maxlen=3)
    for k in range(5):
        q.append(doc=k, update=bytes([k]), v2=False, reason=f"r{k}")
    assert len(q) == 3
    assert q.total == 5 and q.dropped == 2
    assert [e.doc for e in q] == [2, 3, 4]  # oldest evicted first
    snap = q.snapshot()
    assert snap["depth"] == 3 and snap["capacity"] == 3


def test_dlq_list_and_take():
    q = DeadLetterQueue(maxlen=10)
    for k in range(6):
        q.append(doc=k % 2, update=b"u", v2=False, reason="invalid-update: x")
    assert len(q.list(doc=0)) == 3
    taken = q.take(doc=1)
    assert [e.doc for e in taken] == [1, 1, 1]
    assert len(q) == 3 and not q.list(doc=1)
    # seq-targeted take
    seqs = [e.seq for e in q.list()][:1]
    assert len(q.take(seqs=seqs)) == 1
    assert len(q) == 2
    assert q.snapshot()["reasons"] == {"invalid-update": 2}


# -- transactional flush isolation ------------------------------------------


def test_flush_isolates_one_poisoned_doc():
    n = 8
    bad = 3
    eng = BatchEngine(n)
    for i in range(n):
        eng.queue_update(i, _update(f"doc{i} ", client=100 + i))
    eng.flush()
    for i in range(n):
        eng.queue_update(i, _update("more ", client=200 + i))
    eng.queue_update(bad, b"\xff\xff\xff\xff\xff")  # poison
    eng.flush()  # must NOT raise
    # N-1 docs completed the batch; the poisoned doc kept its good state
    for i in range(n):
        assert f"doc{i} " in eng.text(i)
        assert "more " in eng.text(i)
    snap = eng.resilience_snapshot()
    assert snap["n_rollbacks"] == 1
    assert eng.rollbacks[0]["doc"] == bad
    letters = eng.dead_letters.list(doc=bad)
    assert len(letters) == 1
    assert letters[0].reason.startswith("invalid-update:")
    assert letters[0].update == b"\xff\xff\xff\xff\xff"  # bytes retrievable
    m = eng.last_flush_metrics
    assert m["n_rolled_back"] == 1
    assert m["n_demoted"] >= 1
    # engine is NOT wedged: later flushes work
    eng.queue_update(0, _update("again ", client=300))
    eng.flush()
    assert "again " in eng.text(0)


def test_flush_isolation_python_mirror(monkeypatch):
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    eng = BatchEngine(4)
    for i in range(4):
        eng.queue_update(i, _update(f"d{i} ", client=50 + i))
    eng.queue_update(2, b"\x01\xff\xff\xff")
    eng.flush()
    for i in range(4):
        assert f"d{i} " in eng.text(i)
    assert eng.last_flush_metrics["n_rolled_back"] == 1


def test_corrupt_fixtures_quarantine_not_wedge():
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    eng = BatchEngine(2)
    eng.queue_update(0, _update("keep ", client=1))
    eng.queue_update(1, _update("other ", client=2))
    eng.flush()
    for case in manifest["cases"]:
        eng.queue_update(0, (FIXTURES / case["file"]).read_bytes())
        eng.flush()  # never raises, never wedges
    assert "keep " in eng.text(0)
    assert "other " in eng.text(1)
    assert eng.dead_letters.total >= 1
    # the clean twin still integrates (on the healthy doc)
    eng.health.reset()
    eng.queue_update(1, (FIXTURES / "valid_base.bin").read_bytes())
    eng.flush()


def test_strict_mode_raises(monkeypatch):
    monkeypatch.setenv("YTPU_RESILIENCE_DISABLED", "1")
    eng = BatchEngine(2)
    eng.queue_update(0, _update("x"))
    eng.queue_update(1, b"\xff\xff\xff\xff")
    with pytest.raises(Exception):
        eng.flush()


# -- quarantine + replay -----------------------------------------------------


def test_quarantine_diverts_then_replay_reintegrates(monkeypatch):
    monkeypatch.setenv("YTPU_RESILIENCE_THRESHOLD", "2")
    monkeypatch.setenv("YTPU_RESILIENCE_BACKOFF", "100")
    eng = BatchEngine(2)
    eng.queue_update(0, _update("base ", client=9))
    eng.flush()
    for _ in range(2):  # threshold failures -> quarantine
        eng.queue_update(0, b"\xff\xff\xff")
        eng.flush()
    assert eng.health.state(0) == QUARANTINED
    good = _update("recovered ", client=10)
    assert eng.queue_update(0, good) is False  # diverted, not applied
    assert any(e.reason == "quarantined" for e in eng.dead_letters.list(doc=0))
    assert "recovered" not in eng.text(0)
    # operator repairs + replays: poison letters need a repair that
    # drops them; the diverted good bytes re-integrate
    res = eng.replay_dead_letters(
        doc=0,
        readmit=True,
        repair=lambda e: e.update if e.reason == "quarantined" else None,
    )
    assert res["replayed"] == 1
    assert res["requeued"] == 2  # the two poison letters, left queued
    eng.flush()
    assert "recovered " in eng.text(0)
    assert "base " in eng.text(0)


def test_replay_revalidates():
    eng = BatchEngine(1)
    eng.dead_letters.append(0, b"\xff\xff", False, "quarantined")
    res = eng.replay_dead_letters(doc=0, readmit=True)
    assert res == {
        "replayed": 0, "requeued": 0, "failed": 1, "truncated": 0,
    }
    letters = eng.dead_letters.list(doc=0)
    assert len(letters) == 1
    assert letters[0].reason.startswith("replay-invalid:")


# -- provider surface --------------------------------------------------------


def test_provider_receive_update_quarantine_aware(monkeypatch):
    monkeypatch.setenv("YTPU_RESILIENCE_THRESHOLD", "1")
    monkeypatch.setenv("YTPU_RESILIENCE_BACKOFF", "100")
    p = TpuProvider(2)
    assert p.receive_update("r", _update("ok ", client=1)) is True
    assert p.text("r") == "ok "
    p.receive_update("r", b"\xff\xff\xff")
    p.flush()
    assert p.health("r")["state"] == QUARANTINED
    assert p.health() == {"degraded": 0, "quarantined": 1,
                          "tick": p.engine.health.tick_count}
    assert p.receive_update("r", _update("late ", client=2)) is False
    assert "late" not in p.text("r")
    # operator replay (readmit defaults True at the provider surface)
    res = p.replay_dead_letters(
        "r", repair=lambda e: e.update if e.reason == "quarantined" else None
    )
    assert res["replayed"] == 1
    assert "late " in p.text("r")
    assert p.health("r")["state"] == HEALTHY


def test_provider_dirty_not_stuck_on_device_policy(monkeypatch):
    # backend='device' raises on demotions AFTER integrating; the dirty
    # flag must not stay set or every accessor re-flushes forever
    p = TpuProvider(2, backend="device")
    p.receive_update("r", _update("ok ", client=1))
    p.receive_update("r", b"\xff\xff\xff")  # will demote via rollback
    with pytest.raises(RuntimeError):
        p.flush()
    assert p._dirty is False  # integrated: nothing left to flush
    with pytest.raises(RuntimeError):
        p.flush()  # still alerts (fallback persists) ...
    assert p.engine.text(0) == "ok "  # ... but no data was lost


def test_provider_tolerant_sync_frames():
    from yjs_tpu_torch.lib0 import encoding
    from yjs_tpu_torch.lib0.encoding import Encoder

    p = TpuProvider(2)
    p.receive_update("r", _update("keep ", client=3))
    # unknown frame type
    enc = Encoder()
    encoding.write_var_uint(enc, 42)
    encoding.write_var_uint8_array(enc, b"zz")
    assert p.handle_sync_message("r", enc.to_bytes()) is None
    # corrupt update payload
    enc = Encoder()
    encoding.write_var_uint(enc, 2)
    encoding.write_var_uint8_array(enc, b"\xff\xff\xff")
    assert p.handle_sync_message("r", enc.to_bytes()) is None
    # truncated frame (empty)
    assert p.handle_sync_message("r", b"") is None
    # corrupt step-1 state vector
    enc = Encoder()
    encoding.write_var_uint(enc, 0)
    encoding.write_var_uint8_array(enc, b"\xff\xff\xff\xff")
    assert p.handle_sync_message("r", enc.to_bytes()) is None
    assert p.text("r") == "keep "  # room unharmed, not demoted
    assert p.engine.health.state(0) == HEALTHY
    reasons = {e["reason"].split(":", 1)[0] for e in p.dead_letters("r")}
    assert reasons == {"unknown-frame", "bad-frame"}


def test_protocol_reader_skips_unknown_frames():
    from yjs_tpu_torch.lib0 import encoding
    from yjs_tpu_torch.lib0.decoding import Decoder
    from yjs_tpu_torch.lib0.encoding import Encoder
    from yjs_tpu_torch.obs import global_registry
    from yjs_tpu_torch.sync import protocol

    fam = global_registry().get("ytpu_sync_messages_total")
    child = fam.labels(dir="read", type="unknown")
    before = child.value
    enc = Encoder()
    encoding.write_var_uint(enc, 9)
    rc = protocol.read_sync_message(Decoder(enc.to_bytes()), Encoder(), Y.Doc())
    assert rc == protocol.MESSAGE_UNKNOWN
    assert child.value == before + 1
