"""The cases of the JAX package's ``tests/test_trace_propagation.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Cross-peer trace propagation over the session wire:
sampled updates carry the 25-byte trace-context as an optional trailing
key on the type-121 DATA envelope; the receiver adopts the SAME trace
id (in-process via ``use_context`` around ``handle_frame``); unsampled
traffic omits the key entirely; retransmits re-carry the same identity.

Plus the negative compatibility matrix (satellite 6): pre-PR envelope
readers decode only ``seq + inner`` and never touch the trailing key,
stock y-protocols v13.4.9 readers skip the whole unknown type-121
message, and v13.2-era fixture updates ride inside a traced frame
byte-for-byte intact.
"""

import base64
import json
import os

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.lib0 import decoding, encoding
from yjs_tpu_torch.lib0.decoding import Decoder
from yjs_tpu_torch.lib0.encoding import Encoder
from yjs_tpu_torch.obs.dist import (
    TRACE_CTX_LEN,
    TraceContext,
    current_context,
    mint_for_update,
    trace_metrics,
)
from yjs_tpu_torch.sync import protocol
from yjs_tpu_torch.sync.session import (
    K_DATA,
    MESSAGE_YTPU_SESSION,
    DocSessionHost,
    SessionConfig,
    SyncSession,
)
from yjs_tpu_torch.sync.transport import PipeNetwork
from yjs_tpu_torch.updates import encode_state_as_update, encode_state_vector

pytestmark = [pytest.mark.tracing, pytest.mark.network]


def quiet_config(**kw):
    base = dict(
        heartbeat=0, liveness=0, antientropy=0, hello_timeout=0,
        retry_base=4, retry_jitter=0.0, seed=1,
    )
    base.update(kw)
    return SessionConfig(**base)


class SpyHost(DocSessionHost):
    """DocSessionHost that records the trace context in force during
    each ``handle_frame`` — what a downstream provider would observe."""

    def __init__(self, doc):
        super().__init__(doc)
        self.contexts = []

    def handle_frame(self, frame):
        self.contexts.append(current_context())
        return super().handle_frame(frame)


def make_pair(net=None, text_a=""):
    net = net if net is not None else PipeNetwork()
    da, db = Y.Doc(gc=False), Y.Doc(gc=False)
    da.client_id, db.client_id = 1, 2
    if text_a:
        da.get_text("t").insert(0, text_a)
    ta, tb = net.pair("a", "b")
    hb = SpyHost(db)
    sa = SyncSession(DocSessionHost(da), quiet_config(), peer="b")
    sb = SyncSession(hb, quiet_config(), peer="a")
    sa.connect(ta)
    sb.connect(tb)
    net.settle((sa.tick, sb.tick))
    assert sa.state == sb.state == "live"
    hb.contexts.clear()  # handshake frames carry no trace
    return net, (da, sa), (db, sb, hb)


def _carried():
    m = trace_metrics().carried
    return (m.labels(dir="send").value, m.labels(dir="recv").value)


class ScriptedInjector:
    """Drops the frame indices listed in ``drops`` (0-based enqueue
    order), delivers everything else next round."""

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


# -- positive: sampled carry --------------------------------------------------


def test_sampled_update_carries_trace_to_peer(monkeypatch):
    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "1")
    net, (da, sa), (db, sb, hb) = make_pair(text_a="base ")
    sent_before, recv_before = _carried()
    sv = encode_state_vector(da)
    da.get_text("t").insert(5, "traced")
    update = encode_state_as_update(da, sv)
    sa.send_update(update)
    net.settle((sa.tick, sb.tick))
    assert str(db.get_text("t")) == "base traced"
    sent_after, recv_after = _carried()
    assert sent_after == sent_before + 1
    assert recv_after == recv_before + 1
    # the receiver adopted the EXACT context the sender minted from the
    # raw update bytes — same trace id at both peers, one stitched trace
    got = [c for c in hb.contexts if c is not None]
    assert got, "receiver never saw a trace context"
    want = mint_for_update(update)
    assert got[0].sampled
    assert got[0].trace_hex == want.trace_hex
    assert got[0].span_hex == want.span_hex


def test_unsampled_update_omits_key_entirely(monkeypatch):
    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "0")
    net, (da, sa), (db, sb, hb) = make_pair(text_a="base ")
    sent_before, recv_before = _carried()
    sv = encode_state_vector(da)
    da.get_text("t").insert(5, "cold")
    sa.send_update(encode_state_as_update(da, sv))
    net.settle((sa.tick, sb.tick))
    # convergence is byte-identical with the key absent...
    assert str(db.get_text("t")) == "base cold"
    assert Y.merge_updates([encode_state_as_update(db)]) == Y.merge_updates(
        [encode_state_as_update(da)]
    )
    # ...and the wire never carried a context in either direction
    assert _carried() == (sent_before, recv_before)
    assert all(c is None for c in hb.contexts)


def test_retransmit_recarries_same_trace(monkeypatch):
    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "1")
    inj = ScriptedInjector()
    net, (da, sa), (db, sb, hb) = make_pair(
        net=PipeNetwork(inj), text_a="base "
    )
    sent_before, _ = _carried()
    inj.drops = {inj.n}  # drop exactly the DATA frame sent next
    sv = encode_state_vector(da)
    da.get_text("t").insert(0, "lost-then-found ")
    update = encode_state_as_update(da, sv)
    sa.send_update(update)
    net.settle((sa.tick, sb.tick), max_rounds=100, idle_rounds=10)
    assert str(db.get_text("t")).startswith("lost-then-found ")
    assert sa.n_retransmits >= 1
    # the retransmitted frame re-carried the SAME stored context: one
    # send-carry per wire attempt, and the peer adopted the original id
    sent_after, _ = _carried()
    assert sent_after >= sent_before + 2
    got = [c for c in hb.contexts if c is not None]
    assert got and got[0].trace_hex == mint_for_update(update).trace_hex


# -- negative: compatibility --------------------------------------------------


def _traced_data_frame(seq, inner, ctx):
    """A DATA envelope with the trailing trace key, built byte-by-byte
    exactly as ``SyncSession._data_frame`` does."""
    enc = Encoder()
    encoding.write_var_uint(enc, MESSAGE_YTPU_SESSION)
    encoding.write_var_uint(enc, K_DATA)
    encoding.write_var_uint(enc, seq)
    encoding.write_var_uint8_array(enc, inner)
    encoding.write_var_uint8_array(enc, ctx.to_bytes())
    return enc.to_bytes()


def test_prepr_reader_never_touches_trailing_trace_key():
    """A pre-PR session reader decodes ``seq`` + ``inner`` and stops —
    the trailing key must be pure surplus, leaving the inner payload
    byte-for-byte intact."""
    inner = b"\x02\x01\x05hello"
    ctx = mint_for_update(b"whatever").force()
    frame = _traced_data_frame(7, inner, ctx)
    dec = Decoder(frame)
    assert decoding.read_var_uint(dec) == MESSAGE_YTPU_SESSION
    assert decoding.read_var_uint(dec) == K_DATA
    assert decoding.read_var_uint(dec) == 7
    assert bytes(decoding.read_var_uint8_array(dec)) == inner
    # the surplus is exactly the one trailing key: length varint + blob
    assert dec.has_content()
    trailing = bytes(decoding.read_var_uint8_array(dec))
    assert len(trailing) == TRACE_CTX_LEN
    assert TraceContext.from_bytes(trailing) == ctx
    assert not dec.has_content()


def test_stock_v13_reader_skips_traced_envelope():
    """Stock y-protocols v13.4.9 treats the whole type-121 message as
    unknown — with or without the trace key: no exception, no output,
    no doc damage."""
    d = Y.Doc(gc=False)
    ctx = mint_for_update(b"payload").force()
    frame = _traced_data_frame(1, b"\x00\x01\x00", ctx)
    out = Encoder()
    mtype = protocol.read_sync_message(Decoder(frame), out, d, "x")
    assert mtype == protocol.MESSAGE_UNKNOWN
    assert out.to_bytes() == b""


def test_v13_fixture_update_rides_traced_frame_intact():
    """A v13.2-generated update (compat fixture) carried as the inner
    payload of a traced frame survives the pre-PR decode path unchanged
    and still integrates to the recorded value."""
    fx = json.load(open(os.path.join(
        os.path.dirname(__file__), "fixtures", "compat_v1.json"
    )))["testTextDecodingCompatibilityV1"]
    old = base64.b64decode(fx["oldDoc"])
    ctx = mint_for_update(old).force()
    frame = _traced_data_frame(3, old, ctx)
    dec = Decoder(frame)
    decoding.read_var_uint(dec)  # 121
    decoding.read_var_uint(dec)  # K_DATA
    decoding.read_var_uint(dec)  # seq
    recovered = bytes(decoding.read_var_uint8_array(dec))
    assert recovered == old
    doc = Y.Doc()
    Y.apply_update(doc, recovered)
    assert doc.get_text("text").to_delta() == fx["oldVal"]


def test_session_roundtrip_with_key_absent_from_old_sender(monkeypatch):
    """A frame built WITHOUT the trailing key (what a pre-PR sender
    emits) is exactly what today's receiver sees on unsampled traffic:
    parsed as no-context, applied, acked — proven here by driving a
    whole session exchange with sampling off and asserting zero carries
    plus clean convergence (the absent path IS the common path)."""
    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "0")
    net, (da, sa), (db, sb, hb) = make_pair()
    before = _carried()
    for i in range(5):
        sv = encode_state_vector(da)
        da.get_text("t").insert(0, f"op{i} ")
        sa.send_update(encode_state_as_update(da, sv))
        net.settle((sa.tick, sb.tick))
    assert str(da.get_text("t")) == str(db.get_text("t"))
    assert sa.outbox_depth == 0
    assert _carried() == before
