"""The cases of the JAX package's ``tests/test_admission.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Admission-control suite: token buckets, weighted-fair
queuing, brownout hysteresis, BUSY backpressure, WAL journaling of
shed-but-accepted traffic, and the admission/tiering interplay.

Everything runs on tick-time with seeded RNGs — a failure replays
byte-for-byte.  In tier-1; the ``admission`` marker deselects it with
``-m 'not admission'`` (scripts/ci_check.sh also runs it standalone).
The two fleet cases are carried in ``tests/test_torch_fleet.py``.
"""

from __future__ import annotations

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.admission import (
    AdmissionConfig,
    AdmissionRejected,
    TokenBucket,
    WeightedFairQueue,
)
from yjs_tpu_torch.admission.brownout import (
    COALESCE,
    NORMAL,
    REJECT_WRITES,
    SHED_BACKGROUND,
    BrownoutController,
)
from yjs_tpu_torch.persistence import WalConfig
from torch_service import TpuProvider
from yjs_tpu_torch.sync import protocol
from yjs_tpu_torch.sync.session import (
    MESSAGE_YTPU_SESSION,
    DocSessionHost,
    SessionConfig,
    SyncSession,
    encode_busy,
)
from yjs_tpu_torch.sync.transport import PipeNetwork
from yjs_tpu_torch.updates import encode_state_as_update, encode_state_vector

pytestmark = pytest.mark.admission

ROOM = "tenant0/room"


def frame(update: bytes) -> bytes:
    from yjs_tpu_torch.lib0.encoding import Encoder, write_var_uint8_array

    enc = Encoder()
    from yjs_tpu_torch.lib0 import encoding

    encoding.write_var_uint(enc, protocol.MESSAGE_YJS_UPDATE)
    write_var_uint8_array(enc, update)
    return enc.to_bytes()


def doc_update(client_id: int, text: str, doc=None):
    d = doc if doc is not None else Y.Doc(gc=False)
    if doc is None:
        d.client_id = client_id
    sv = encode_state_vector(d)
    d.get_text("text").insert(len(str(d.get_text("text"))), text)
    return d, encode_state_as_update(d, sv)


# -- primitives -------------------------------------------------------------


def test_token_bucket_lazy_refill():
    tb = TokenBucket(rate=2.0, burst=4.0, tick=0)
    for _ in range(4):
        assert tb.take()
    assert not tb.take()
    tb.refill_to(1)
    assert tb.tokens == 2.0
    # refill is capped at burst, however long the bucket idled
    tb.refill_to(100)
    assert tb.tokens == 4.0
    # refill never runs time backwards
    tb.refill_to(50)
    assert tb.tick == 100


def test_wfq_flood_cannot_starve_and_is_deterministic():
    def fill(q):
        for i in range(10):
            q.push("abuser", f"a{i}")
        for i in range(2):
            q.push("quiet", f"q{i}")

    q1, q2 = WeightedFairQueue(), WeightedFairQueue()
    fill(q1)
    fill(q2)
    order = [q1.pop() for _ in range(len(q1))]
    # byte-identical drain order on an identical push sequence
    assert order == [q2.pop() for _ in range(len(q2))]
    # the quiet tenant's 2 items drain inside the first 4 pops — the
    # abuser's backlog only delays the abuser
    head = [t for t, _ in order[:4]]
    assert head.count("quiet") == 2
    assert q1.depth_of("abuser") == 0 and len(q1) == 0


def test_brownout_hysteresis_does_not_flap():
    b = BrownoutController(up_ticks=2, down_ticks=4)
    # one bad tick is not enough to climb
    assert b.observe(SHED_BACKGROUND, "queue-high") == NORMAL
    assert b.observe(SHED_BACKGROUND, "queue-high") == SHED_BACKGROUND
    # climbing is one level per hysteresis window, even if the target
    # is far above
    b2 = BrownoutController(up_ticks=2, down_ticks=4)
    levels = [b2.observe(REJECT_WRITES, "queue-full") for _ in range(6)]
    assert levels == [0, 1, 1, 2, 2, 3]
    # an alternating good/bad signal never leaves normal (no flapping)
    b3 = BrownoutController(up_ticks=2, down_ticks=4)
    for i in range(20):
        lvl = b3.observe(SHED_BACKGROUND if i % 2 else NORMAL, "x")
        assert lvl == NORMAL
    # stepping down needs down_ticks consecutive clean observations
    down = [b2.observe(NORMAL, "recovered") for _ in range(12)]
    assert down[:3] == [3, 3, 3]
    assert down[3] == COALESCE
    assert down[-1] == NORMAL


# -- provider seam ----------------------------------------------------------


def test_disabled_is_passthrough():
    p = TpuProvider(2)
    assert not p.admission.enabled
    d = None
    for _ in range(8):
        d, u = doc_update(1, "x", d)
        p.receive_update(ROOM, u)
    p.flush()
    snap = p.admission.snapshot()
    assert snap["enabled"] is False
    assert p.text(ROOM) == str(d.get_text("text"))


def test_queue_then_drain_converges():
    p = TpuProvider(
        2,
        admission_config=AdmissionConfig(
            enabled=True, tenant_rate=1.0, tenant_burst=2,
            doc_rate=1.0, doc_burst=2, queue_max=64, drain_batch=32,
        ),
    )
    d = None
    for i in range(10):
        d, u = doc_update(1, f"w{i} ", d)
        assert p.receive_update(ROOM, u)
    snap = p.admission.snapshot()
    assert snap["queued"] == 8 and snap["admitted"] == 2
    p.flush()
    assert p.admission.snapshot()["queue_depth"] == 0
    assert p.text(ROOM) == str(d.get_text("text"))


def test_queue_full_rejects_typed():
    p = TpuProvider(
        2,
        admission_config=AdmissionConfig(
            enabled=True, tenant_rate=0.0, tenant_burst=1,
            doc_rate=0.0, doc_burst=1, queue_max=2, retry_after=5,
        ),
    )
    d = None
    accepted = 0
    with pytest.raises(AdmissionRejected) as ei:
        for i in range(6):
            d, u = doc_update(1, f"w{i}", d)
            p.receive_update(ROOM, u)
            accepted += 1
    assert accepted == 3  # 1 bucket token + 2 queue slots
    assert ei.value.reason == "queue-full"
    assert ei.value.tenant == "tenant0"
    assert ei.value.retry_after == 5
    snap = p.admission.snapshot()
    assert snap["rejected"].get("queue-full", 0) >= 1


def test_queued_updates_survive_crash(tmp_path):
    cfg = AdmissionConfig(
        enabled=True, tenant_rate=0.0, tenant_burst=1,
        doc_rate=0.0, doc_burst=1, queue_max=64,
    )
    p = TpuProvider(
        2, wal_dir=tmp_path, wal_config=WalConfig(fsync="never"),
        admission_config=cfg,
    )
    d = None
    for i in range(6):
        d, u = doc_update(1, f"w{i} ", d)
        p.receive_update(ROOM, u)
    # 5 of 6 sit in the fair queue, never integrated — but journaled
    assert p.admission.snapshot()["queue_depth"] == 5
    p.wal.abandon()  # kill -9 before any drain
    v = TpuProvider.recover(
        tmp_path, n_docs=2, wal_config=WalConfig(fsync="never"),
    )
    assert v.text(ROOM) == str(d.get_text("text"))


def test_admission_transitions_journaled_and_recovered(tmp_path):
    p = TpuProvider(
        2, wal_dir=tmp_path, wal_config=WalConfig(fsync="never"),
        admission_config=AdmissionConfig(enabled=True),
    )
    d, u = doc_update(1, "seed")
    p.receive_update(ROOM, u)
    p.journal_admission("shed-background", "queue-high", 3)
    p.journal_admission("coalesce", "queue-high", 5)
    p.wal.abandon()
    v = TpuProvider.recover(
        tmp_path, n_docs=2, wal_config=WalConfig(fsync="never"),
        admission_config=AdmissionConfig(enabled=True),
    )
    assert v.last_recovery["adm_transitions"] == 2
    assert v.last_recovery["adm_level"] == "coalesce"
    # the live controller restarts at normal: pre-crash pressure is
    # historical context, not current load
    assert v.admission.level == NORMAL


def test_reject_writes_still_serves_reads():
    p = TpuProvider(
        2, admission_config=AdmissionConfig(enabled=True),
    )
    d, u = doc_update(1, "served")
    p.receive_update(ROOM, u)
    p.flush()
    p.admission.brownout.force(REJECT_WRITES, "test")
    # a sync STEP_1 (read path) is answered normally
    from yjs_tpu_torch.lib0 import encoding
    from yjs_tpu_torch.lib0.encoding import Encoder, write_var_uint8_array

    enc = Encoder()
    encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_1)
    write_var_uint8_array(enc, encode_state_vector(Y.Doc(gc=False)))
    reply = p.handle_sync_message(ROOM, enc.to_bytes())
    assert reply is not None and reply[0] != MESSAGE_YTPU_SESSION
    # a write is refused with a BUSY envelope, not integrated
    before = p.text(ROOM)
    d, u2 = doc_update(1, " dropped", d)
    busy = p.handle_sync_message(ROOM, frame(u2))
    assert busy is not None and busy[0] == MESSAGE_YTPU_SESSION
    assert p.text(ROOM) == before
    assert p.admission.snapshot()["rejected"].get("reject-writes", 0) >= 1


def test_plain_reader_skips_busy_envelope():
    # a BUSY envelope handed to a plain y-protocols reader is counted
    # as unknown and skipped, never a crash or a spurious reply
    p = TpuProvider(1)
    reply = p.handle_sync_message("tenant0/plain", encode_busy(8))
    assert reply is None


def test_busy_roundtrip_session_no_loss():
    """A session client bursting far over rate is BUSY'd, backs off,
    retransmits, and converges byte-identically — refused frames are
    never acked, so nothing is lost."""
    p = TpuProvider(
        2,
        admission_config=AdmissionConfig(
            enabled=True, tenant_rate=0.5, tenant_burst=1,
            doc_rate=0.5, doc_burst=1, queue_max=2, retry_after=2,
        ),
    )
    net = PipeNetwork()
    cfg = SessionConfig(
        retry_base=2, retry_cap=8, retry_max=8, retry_jitter=0.0,
        antientropy=0, heartbeat=0, liveness=0, hello_timeout=0, seed=3,
    )
    d = Y.Doc(gc=False)
    d.client_id = 9
    client = SyncSession(DocSessionHost(d), cfg, peer="server")
    server = p.session(ROOM, "client", cfg)
    tc, ts = net.pair("client", "server")
    client.connect(tc)
    server.connect(ts)
    # settle the handshake first: a pre-LIVE burst would coalesce into
    # the STEP_2 answer and never meet the per-update gate
    for _ in range(8):
        net.pump()
        client.tick()
        p.flush()
        p.tick_sessions()
    assert client.state == "live"
    for i in range(8):
        sv = encode_state_vector(d)
        d.get_text("text").insert(len(str(d.get_text("text"))), f"w{i}")
        client.send_update(encode_state_as_update(d, sv))
    for _ in range(160):
        net.pump()
        client.tick()
        p.flush()
        p.tick_sessions()
        if (
            not net.in_flight
            and not client._outbox
            and p.admission.snapshot()["queue_depth"] == 0
            and p.text(ROOM) == str(d.get_text("text"))
        ):
            break
    assert p.text(ROOM) == str(d.get_text("text"))
    assert client.n_busy_backoffs > 0
    assert p.engine.dead_letters.total == 0
    assert client.n_full_resyncs <= 1


# -- satellites -------------------------------------------------------------


def test_replay_dead_letters_bounded():
    p = TpuProvider(1)
    d, u = doc_update(1, "x")
    p.receive_update(ROOM, u)
    p.flush()
    doc = p.doc_id(ROOM)
    for i in range(10):
        p.engine.dead_letters.append(doc, b"\xff\xff", False, "test")
    res = p.replay_dead_letters(ROOM, max_letters=4)
    assert res["truncated"] == 6
    # the 6 untaken letters stay queued (plus any replay re-failures)
    assert len(p.engine.dead_letters.list(doc=doc)) == 6 + res["failed"]
    counters = p.metrics_snapshot()["counters"]
    assert counters.get(
        "ytpu_resilience_dlq_replay_truncated_total", {}
    ).get("", 0) >= 1
    # 0 = unbounded: the remainder drains in one pass
    res2 = p.replay_dead_letters(ROOM, max_letters=0)
    assert res2["truncated"] == 0


def test_provider_full_dead_letters_typed_and_feeds_admission():
    p = TpuProvider(
        1, admission_config=AdmissionConfig(enabled=True),
    )
    d, u = doc_update(1, "first")
    p.receive_update("tenant0/one", u)
    p.flush()
    from yjs_tpu_torch.provider import _ProviderSessionHost

    # the host seam directly: session() would veto at doc_id() before
    # any frame flows, but an established session whose slot was lost
    # hits ProviderFullError mid-frame exactly here
    host = _ProviderSessionHost(p, "tenant1/two", "peer")
    d2, u2 = doc_update(2, "overflow")
    reply = host.handle_frame(frame(u2))
    # the frame is refused with BUSY, dead-lettered with a typed
    # reason, and the full event feeds the brownout's signal set
    assert reply is not None and reply[0] == MESSAGE_YTPU_SESSION
    letters = p.engine.dead_letters.list()
    assert any("admission-full" in e.reason for e in letters)
    assert p.admission.snapshot()["full_events"].get("provider", 0) >= 1


