"""The cases of the JAX package's ``tests/test_session.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Session-layer suite: the SyncSession state machine over
deterministic in-memory transports — handshake (fresh + resume), plain-
protocol negotiation, ack/retransmit/backoff/dead-letter, backpressure
coalescing, heartbeat/liveness, the anti-entropy repair loop, and the
provider/WAL integration (session registry, ack journaling, recovery
resume hints).

Everything runs on tick-time (no wall clocks): a failure replays
byte-for-byte.  In tier-1; the ``network`` marker deselects it with
``-m 'not network'``.
"""

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.lib0 import encoding
from yjs_tpu_torch.lib0.decoding import Decoder
from yjs_tpu_torch.lib0.encoding import Encoder
from torch_service import TpuProvider
from yjs_tpu_torch.sync import protocol
from yjs_tpu_torch.sync.session import (
    DocSessionHost,
    SessionConfig,
    SessionMetrics,
    SyncSession,
)
from yjs_tpu_torch.sync.transport import CallbackTransport, PipeNetwork
from yjs_tpu_torch.updates import encode_state_as_update, encode_state_vector

pytestmark = pytest.mark.network


def quiet_config(**kw):
    """Timers off unless a test turns one on — each behavior is tested
    in isolation."""
    base = dict(
        heartbeat=0, liveness=0, antientropy=0, hello_timeout=0,
        retry_base=4, retry_jitter=0.0, seed=1,
    )
    base.update(kw)
    return SessionConfig(**base)


def make_pair(net=None, cfg_a=None, cfg_b=None, text_a="", text_b=""):
    net = net if net is not None else PipeNetwork()
    da, db = Y.Doc(gc=False), Y.Doc(gc=False)
    da.client_id, db.client_id = 1, 2
    if text_a:
        da.get_text("t").insert(0, text_a)
    if text_b:
        db.get_text("t").insert(0, text_b)
    ta, tb = net.pair("a", "b")
    sa = SyncSession(DocSessionHost(da), cfg_a or quiet_config(), peer="b")
    sb = SyncSession(DocSessionHost(db), cfg_b or quiet_config(), peer="a")
    return net, (da, sa, ta), (db, sb, tb)


def edit_and_send(doc, sess, pos, s):
    sv = encode_state_vector(doc)
    doc.get_text("t").insert(pos, s)
    sess.send_update(encode_state_as_update(doc, sv))


class ScriptedInjector:
    """Minimal injector: drops the frame indices listed in ``drops``
    (0-based enqueue order), delivers everything else next round."""

    def __init__(self, drops=()):
        self.drops = set(drops)
        self.n = 0

    def fates(self, frame):
        i = self.n
        self.n += 1
        return [None] if i in self.drops else [0]

    def partitioned(self):
        return False

    def maybe_reorder(self, batch):
        return batch


# -- handshake ---------------------------------------------------------------


def test_fresh_handshake_exchanges_state():
    net, (da, sa, ta), (db, sb, tb) = make_pair(
        text_a="hello ", text_b="world"
    )
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    assert sa.state == sb.state == "live"
    assert str(da.get_text("t")) == str(db.get_text("t"))
    assert sa.n_full_resyncs == sb.n_full_resyncs == 1
    assert sa.n_resumes == sb.n_resumes == 0
    assert not sa.plain_mode and not sb.plain_mode


def test_live_updates_flow_with_acks():
    net, (da, sa, ta), (db, sb, tb) = make_pair(text_a="base")
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    edit_and_send(da, sa, 4, "+one")
    edit_and_send(da, sa, 8, "+two")
    net.settle((sa.tick, sb.tick))
    assert str(db.get_text("t")) == "base+one+two"
    assert sa.outbox_depth == 0  # acked and pruned
    assert sa.n_retransmits == 0


def test_handshake_epoch_settles_seq_space_once():
    # both HELLO and WELCOME carry the fresh-handshake verdict; a
    # second send-side reset would recycle seq numbers the peer has
    # already recorded, making the next update look like a duplicate
    net, (da, sa, ta), (db, sb, tb) = make_pair(text_a="seed ")
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    first_seq = sa._send_seq  # the handshake diff consumed >= 1
    edit_and_send(da, sa, 0, "x")
    assert sa._send_seq == first_seq + 1
    net.settle((sa.tick, sb.tick))
    assert str(db.get_text("t")) == "xseed "


def test_reconnect_resumes_without_full_resync():
    net, (da, sa, ta), (db, sb, tb) = make_pair(text_a="persist ")
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    net.kill(ta, tb)
    assert sa.state == sb.state == "reconnecting"
    # edits made while disconnected coalesce into a catch-up delta
    edit_and_send(da, sa, 0, ">> ")
    assert sa.n_coalesced == 1
    ta2, tb2 = net.pair("a2", "b2")
    sa.attach(ta2)
    sb.attach(tb2)
    net.settle((sa.tick, sb.tick))
    assert sa.state == sb.state == "live"
    assert str(da.get_text("t")) == str(db.get_text("t")) == ">> persist "
    assert sa.n_resumes == sb.n_resumes == 1
    assert sa.n_full_resyncs == sb.n_full_resyncs == 1  # only the first


def test_fresh_peer_instance_forces_full_resync():
    net, (da, sa, ta), (db, sb, tb) = make_pair(text_a="one ")
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    net.kill(ta, tb)
    # the peer process died: a brand-new session (no resume state)
    db2 = Y.Doc(gc=False)
    db2.client_id = 3
    sb2 = SyncSession(DocSessionHost(db2), quiet_config(), peer="a")
    ta2, tb2 = net.pair()
    sa.attach(ta2)
    sb2.connect(tb2)
    net.settle((sa.tick, sb2.tick))
    assert str(db2.get_text("t")) == "one "
    # the survivor counted a second full resync, not a resume
    assert sa.n_full_resyncs == 2 and sa.n_resumes == 0


# -- plain-protocol interop --------------------------------------------------


def plain_peer(doc, transport):
    """A peer speaking only the plain y-protocols flow (the v13.4.9
    interop target): tolerant read loop, replies ride the same pipe."""

    def on_frame(frame):
        dec = Decoder(frame)
        enc = Encoder()
        protocol.read_sync_message(dec, enc, doc, "plain-peer")
        out = enc.to_bytes()
        if out:
            transport.send(out)

    transport.on_frame = on_frame


def test_negotiates_down_to_plain_protocol():
    net = PipeNetwork()
    ds = Y.Doc(gc=False)
    ds.client_id = 1
    dp = Y.Doc(gc=False)
    dp.client_id = 2
    dp.get_text("t").insert(0, "plain content")
    ts, tp = net.pair()
    sess = SyncSession(DocSessionHost(ds), quiet_config(), peer="plain")
    plain_peer(dp, tp)
    sess.connect(ts)
    # the plain peer initiates step 1 (a y-websocket server would)
    enc = Encoder()
    protocol.write_sync_step1(enc, dp)
    tp.send(enc.to_bytes())
    net.settle((sess.tick,))
    assert sess.plain_mode and sess.state == "live"
    assert str(ds.get_text("t")) == "plain content"
    # updates in both directions keep flowing, unenveloped
    sv = encode_state_vector(ds)
    ds.get_text("t").insert(0, "S:")
    sess.send_update(encode_state_as_update(ds, sv))
    net.settle((sess.tick,))
    assert str(dp.get_text("t")) == str(ds.get_text("t"))


def test_hello_timeout_falls_back_to_plain_step1():
    # a plain peer that never initiates (a server awaiting step 1):
    # after hello_timeout silent ticks the session probes with a bare
    # step 1 instead of waiting forever
    net = PipeNetwork()
    ds = Y.Doc(gc=False)
    dp = Y.Doc(gc=False)
    dp.get_text("t").insert(0, "lazy server")
    ts, tp = net.pair()
    sess = SyncSession(
        DocSessionHost(ds), quiet_config(hello_timeout=3), peer="srv"
    )
    plain_peer(dp, tp)
    sess.connect(ts)
    net.settle((sess.tick,), max_rounds=50, idle_rounds=6)
    assert sess.plain_mode
    assert str(ds.get_text("t")) == "lazy server"


def test_plain_reader_skips_session_envelope():
    # the envelope message type must be invisible to a tolerant plain
    # reader: counted as unknown, never an exception, never doc damage
    d = Y.Doc(gc=False)
    enc = Encoder()
    encoding.write_var_uint(enc, 121)  # MESSAGE_YTPU_SESSION
    encoding.write_var_uint(enc, 0)  # K_HELLO
    encoding.write_var_uint(enc, 1)
    dec = Decoder(enc.to_bytes())
    out = Encoder()
    mtype = protocol.read_sync_message(dec, out, d, "x")
    assert mtype == protocol.MESSAGE_UNKNOWN
    assert out.to_bytes() == b""


# -- retransmission ----------------------------------------------------------


def test_dropped_frame_retransmits_and_converges():
    inj = ScriptedInjector()
    net, (da, sa, ta), (db, sb, tb) = make_pair(net=PipeNetwork(inj))
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    # drop exactly the next enqueued frame (the DATA we send below)
    inj.drops = {inj.n}
    edit_and_send(da, sa, 0, "lost-then-found")
    net.settle((sa.tick, sb.tick), max_rounds=100, idle_rounds=10)
    assert str(db.get_text("t")) == "lost-then-found"
    assert sa.n_retransmits >= 1
    assert sa.outbox_depth == 0


def test_backoff_grows_exponentially_and_deterministically():
    cfg = quiet_config()
    s = SyncSession(DocSessionHost(Y.Doc(gc=False)), cfg, peer="x")
    delays = [s._backoff(k) for k in range(1, 6)]
    assert delays == [4, 8, 16, 32, 64]  # base 4, jitter 0, cap 64
    capped = SyncSession(
        DocSessionHost(Y.Doc(gc=False)),
        quiet_config(retry_cap=16),
        peer="x",
    )
    assert [capped._backoff(k) for k in range(1, 6)] == [4, 8, 16, 16, 16]
    # jitter is seeded: two sessions with the same seed, same schedule
    j1 = SyncSession(
        DocSessionHost(Y.Doc(gc=False)), quiet_config(retry_jitter=0.5),
        peer="x",
    )
    j2 = SyncSession(
        DocSessionHost(Y.Doc(gc=False)), quiet_config(retry_jitter=0.5),
        peer="x",
    )
    j2.sid = j1.sid  # jitter keys off (seed, sid)
    import random as _r

    j1._rng = _r.Random(1)
    j2._rng = _r.Random(1)
    assert [j1._backoff(k) for k in (1, 2, 3)] == [
        j2._backoff(k) for k in (1, 2, 3)
    ]


def test_retry_cap_dead_letters_payload():
    class DropData:
        """Deliver handshake, drop every frame after it."""

        def __init__(self):
            self.arm = False

        def fates(self, frame):
            return [None] if self.arm else [0]

        def partitioned(self):
            return False

        def maybe_reorder(self, batch):
            return batch

    inj = DropData()
    net, (da, sa, ta), (db, sb, tb) = make_pair(
        net=PipeNetwork(inj),
        cfg_a=quiet_config(retry_base=1, retry_cap=2, retry_max=3),
    )
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    inj.arm = True  # black hole from here on
    edit_and_send(da, sa, 0, "doomed")
    for _ in range(30):
        net.pump()
        sa.tick()
        sb.tick()
    assert sa.outbox_depth == 0  # expired out of the outbox
    assert sa.n_dead_lettered == 1
    payload, reason = sa.host.dead_letters[-1]
    assert "net-retry-exhausted" in reason
    # the dead-lettered payload is the framed inner update — replayable
    dec = Decoder(payload)
    from yjs_tpu_torch.lib0 import decoding as dmod

    assert dmod.read_var_uint(dec) == protocol.MESSAGE_YJS_UPDATE


# -- backpressure ------------------------------------------------------------


def test_outbox_high_watermark_enters_lagging_and_coalesces():
    net, (da, sa, ta), (db, sb, tb) = make_pair(
        cfg_a=quiet_config(outbox_high=3, outbox_low=0, retry_base=64)
    )
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    # stop delivering: acks never come back, the outbox can only grow
    for k in range(8):
        edit_and_send(da, sa, 0, f"{k}")
    assert sa.state == "lagging"
    assert sa.n_coalesced >= 1
    assert sa.outbox_depth <= 3
    # drain the wire again: the coalesced delta catches the peer up
    net.settle((sa.tick, sb.tick), max_rounds=300, idle_rounds=10)
    assert sa.state == "live"
    assert str(db.get_text("t")) == str(da.get_text("t"))


def test_lagging_sheds_unsent_frames_not_sent_ones():
    net, (da, sa, ta), (db, sb, tb) = make_pair(
        cfg_a=quiet_config(outbox_high=2, outbox_low=0, retry_base=64)
    )
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    # a backlog where one frame never made the wire (the transport
    # refused it mid-queue): entering lagging must shed it — the
    # coalesced delta supersedes it — but KEEP sent-once frames, whose
    # seqs the peer may already hold (ack accounting needs them)
    sa._outbox = [
        {"seq": 1, "inner": b"x", "attempts": 1, "next_retry": 99,
         "sent": True},
        {"seq": 2, "inner": b"y", "attempts": 0, "next_retry": 99,
         "sent": False},
    ]
    sa._send_seq = 2
    sa._enter_lagging()
    assert sa.state == "lagging"
    assert sa.n_shed == 1
    assert [e["seq"] for e in sa._outbox] == [1]


# -- heartbeat / liveness ----------------------------------------------------


def test_heartbeats_keep_idle_session_alive():
    net, (da, sa, ta), (db, sb, tb) = make_pair(
        cfg_a=quiet_config(heartbeat=2, liveness=8),
        cfg_b=quiet_config(heartbeat=2, liveness=8),
    )
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    for _ in range(40):  # 5x the liveness window, zero data traffic
        net.pump()
        sa.tick()
        sb.tick()
    assert sa.state == sb.state == "live"
    assert sa.n_liveness_timeouts == 0


def test_liveness_timeout_detects_mute_peer():
    net, (da, sa, ta), (db, sb, tb) = make_pair(
        cfg_a=quiet_config(heartbeat=2, liveness=6)
    )
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    tb.on_frame = lambda frame: None  # peer goes silent (half-open link)
    for _ in range(20):
        net.pump()
        sa.tick()
    assert sa.state == "reconnecting"
    assert sa.n_liveness_timeouts == 1


# -- anti-entropy ------------------------------------------------------------


def test_antientropy_heals_silent_divergence():
    net, (da, sa, ta), (db, sb, tb) = make_pair(
        cfg_a=quiet_config(antientropy=4),
        cfg_b=quiet_config(antientropy=4),
    )
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    # divergence the wire never saw: a local edit NOT sent (exactly the
    # post-dead-letter / shed-frame hole anti-entropy exists to close)
    da.get_text("t").insert(0, "silent change")
    net.settle((sa.tick, sb.tick), max_rounds=100, idle_rounds=8)
    assert str(db.get_text("t")) == "silent change"
    assert sa.n_repairs >= 1


def test_antientropy_idle_sessions_send_digests_not_repairs():
    net, (da, sa, ta), (db, sb, tb) = make_pair(
        cfg_a=quiet_config(antientropy=3),
        cfg_b=quiet_config(antientropy=3),
        text_a="same",
    )
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick), max_rounds=60, idle_rounds=5)
    assert sa.n_repairs == 0  # nothing to heal: digests found parity
    assert str(da.get_text("t")) == str(db.get_text("t"))


# -- provider integration ----------------------------------------------------


def drive(pa, pb):
    def fn():
        pa.flush()
        pb.flush()
        pa.tick_sessions()
        pb.tick_sessions()

    return fn


def test_provider_session_registry_and_snapshot():
    pa = TpuProvider(2, backend="cpu")
    pb = TpuProvider(2, backend="cpu")
    net = PipeNetwork()
    ta, tb = net.pair()
    sa = pa.session("room", "pb", quiet_config())
    assert pa.session("room", "pb") is sa  # get-or-create
    sb = pb.session("room", "pa", quiet_config())
    sa.connect(ta)
    sb.connect(tb)
    net.settle((drive(pa, pb),))
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "via provider")
    pa.receive_update("room", encode_state_as_update(d))
    net.settle((drive(pa, pb),))
    assert pb.text("room") == "via provider"
    rows = pa.sessions_snapshot()
    assert len(rows) == 1
    row = rows[0]
    assert row["guid"] == "room" and row["peer"] == "pb"
    assert row["state"] == "live" and row["sent"] >= 1
    for key in ("outbox_depth", "retransmits", "last_ack_age", "resumes"):
        assert key in row
    # the metrics snapshot carries the same rows for dashboards
    snap = pa.metrics_snapshot()
    assert snap["sessions"][0]["guid"] == "room"
    pa.close_session("room", "pb")
    assert pa.sessions_snapshot() == []
    # a closed (room, peer) gets a FRESH session on the next ask
    assert pa.session("room", "pb", quiet_config()) is not sa


def test_provider_sessions_share_net_metric_families():
    pa = TpuProvider(1, backend="cpu")
    names = set(pa.engine.obs.registry.names())
    for fam in (
        "ytpu_net_sessions",
        "ytpu_net_frames_total",
        "ytpu_net_retransmits_total",
        "ytpu_net_resumes_total",
        "ytpu_net_full_resyncs_total",
        "ytpu_net_antientropy_repairs_total",
        "ytpu_net_outbox_depth",
    ):
        assert fam in names, fam


def test_provider_bad_frame_routes_to_room_dlq():
    pa = TpuProvider(1, backend="cpu")
    pb = TpuProvider(1, backend="cpu")
    net = PipeNetwork()
    ta, tb = net.pair()
    pa.session("room", "pb", quiet_config()).connect(ta)
    pb.session("room", "pa", quiet_config()).connect(tb)
    net.settle((drive(pa, pb),))
    # a damaged envelope injected at the transport seam
    enc = Encoder()
    encoding.write_var_uint(enc, 121)
    encoding.write_var_uint(enc, 2)  # K_DATA ...
    ta.send(enc.to_bytes() + b"\xff")  # ... with a torn body
    net.settle((drive(pa, pb),))
    letters = pb.dead_letters("room")
    assert any("net-" in e["reason"] for e in letters)


def test_wal_journals_acks_and_recovery_resumes(tmp_path):
    cfg = quiet_config()
    p1 = TpuProvider(2, backend="cpu", wal_dir=str(tmp_path))
    p2 = TpuProvider(2, backend="cpu")
    net = PipeNetwork()
    t1, t2 = net.pair()
    p1.session("doc", "p2", cfg).connect(t1)
    s2 = p2.session("doc", "p1", cfg)
    s2.connect(t2)
    net.settle((drive(p1, p2),))
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "durable")
    p2.receive_update("doc", encode_state_as_update(d))
    net.settle((drive(p1, p2),))
    assert p1.text("doc") == "durable"
    # crash p1 (no close, no checkpoint); sever the wire
    net.kill(t1, t2)
    del p1
    pr = TpuProvider.recover(str(tmp_path), backend="cpu")
    assert pr.last_recovery["session_acks"] >= 1
    sr = pr.session("doc", "p2", cfg)
    t1b, t2b = net.pair()
    sr.connect(t1b)
    s2.attach(t2b)
    net.settle((drive(pr, p2),))
    assert pr.text("doc") == p2.text("doc") == "durable"
    # the SURVIVOR resumed (saw its own sid echoed back): delta replay,
    # no second full resync — the acceptance shape
    assert s2.n_resumes == 1
    assert s2.n_full_resyncs == 1


def test_session_admission_veto_leaves_no_half_registration():
    # regression: session() used to register the
    # flush bridge and could leave a half-registered peer behind when
    # doc_id vetoed with ProviderFullError — the carcass was then
    # ticked and snapshotted forever
    from yjs_tpu_torch.provider import ProviderFullError

    pa = TpuProvider(1, backend="cpu")
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "occupies the only slot")
    pa.receive_update("a", encode_state_as_update(d))
    with pytest.raises(ProviderFullError):
        pa.session("b", "peer", quiet_config())
    assert ("b", "peer") not in pa._sessions
    assert pa.sessions_snapshot() == []
    assert not pa._sessions_bridged  # the veto registered no bridge
    # admission works once a slot frees up — nothing stale in the way
    pa.release_doc("a")
    sess = pa.session("b", "peer", quiet_config())
    assert pa._sessions[("b", "peer")] is sess and not sess._closed


def test_release_doc_under_live_session_reconverges_without_resync():
    # evicting a room (release_doc) while a peer
    # session holds it must not wedge the session — the next inbound
    # delta re-admits the room into a fresh slot and the anti-entropy
    # loop heals the evicted history, with NO second full resync
    cfg = quiet_config(antientropy=2)
    pa = TpuProvider(2, backend="cpu")
    pb = TpuProvider(2, backend="cpu")
    net = PipeNetwork()
    ta, tb = net.pair()
    sa = pa.session("room", "pb", cfg)
    sb = pb.session("room", "pa", cfg)
    sa.connect(ta)
    sb.connect(tb)
    net.settle((drive(pa, pb),))
    d = Y.Doc(gc=False)
    d.client_id = 11
    d.get_text("text").insert(0, "kept")
    pb.receive_update("room", encode_state_as_update(d))
    net.settle((drive(pa, pb),))
    assert pa.text("room") == "kept"

    pa.release_doc("room")  # evict while both sessions are live
    sv = encode_state_vector(d)
    d.get_text("text").insert(0, "next ")
    pb.receive_update("room", encode_state_as_update(d, sv))
    net.settle((drive(pa, pb),), max_rounds=120, idle_rounds=5)
    assert pa.text("room") == pb.text("room") == "next kept"
    # byte-identical stores after the repair
    assert Y.merge_updates([pa.encode_state_as_update("room")]) == (
        Y.merge_updates([pb.encode_state_as_update("room")])
    )
    # the handshake's full resync stayed the only one
    assert sa.n_full_resyncs == 1 and sb.n_full_resyncs == 1
    assert sa.state == sb.state == "live"


def test_checkpoint_preserves_ack_floors(tmp_path):
    cfg = quiet_config()
    p1 = TpuProvider(2, backend="cpu", wal_dir=str(tmp_path))
    p2 = TpuProvider(2, backend="cpu")
    net = PipeNetwork()
    t1, t2 = net.pair()
    p1.session("doc", "p2", cfg).connect(t1)
    s2 = p2.session("doc", "p1", cfg)
    s2.connect(t2)
    net.settle((drive(p1, p2),))
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "pre-checkpoint")
    p2.receive_update("doc", encode_state_as_update(d))
    net.settle((drive(p1, p2),))
    p1.checkpoint()  # compaction must re-journal the ack floors
    net.kill(t1, t2)
    del p1
    pr = TpuProvider.recover(str(tmp_path), backend="cpu")
    assert pr.last_recovery["session_acks"] >= 1
    assert pr.text("doc") == "pre-checkpoint"


# -- connector lifecycle hooks -----------------------------------------------


def test_abstract_connector_lifecycle_hooks_default_noop():
    from yjs_tpu_torch.utils.abstract_connector import AbstractConnector

    c = AbstractConnector(Y.Doc(gc=False))
    c.on_connect()
    c.on_disconnect("closed")
    c.on_error(RuntimeError("x"))  # default hooks absorb silently

    events = []

    class Hooked(AbstractConnector):
        def on_connect(self):
            events.append("connect")

        def on_disconnect(self, reason="closed"):
            events.append(f"disconnect:{reason}")

        def on_error(self, exc):
            events.append(f"error:{type(exc).__name__}")

    h = Hooked(Y.Doc(gc=False))
    h.on_connect()
    h.on_error(ValueError("boom"))
    h.on_disconnect("eof")
    assert events == ["connect", "error:ValueError", "disconnect:eof"]


# -- dashboards --------------------------------------------------------------


def test_ytpu_top_renders_session_rows():
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "ytpu_top_session_test",
        pathlib.Path(__file__).resolve().parent.parent
        / "scripts" / "torch_ytpu_top.py",
    )
    top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(top)

    pa = TpuProvider(2, backend="cpu")
    pb = TpuProvider(2, backend="cpu")
    net = PipeNetwork()
    ta, tb = net.pair()
    pa.session("room", "pb", quiet_config()).connect(ta)
    pb.session("room", "pa", quiet_config()).connect(tb)
    net.settle((drive(pa, pb),))
    row = top.collect_row("prov-a", pa.metrics_snapshot(), None, 1.0)
    assert row["sessions"] and row["sessions"][0]["state"] == "live"
    frame = top.render([row], 1.0)
    assert "peer" in frame and "outbox" in frame and "room" in frame
