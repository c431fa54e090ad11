"""Gateway wire compatibility of the PyTorch port's gateway (the cases
of ``tests/test_gateway_wire.py``).

Drives the port's cluster gateway's y-websocket dialect with raw v13.4.9
frames — including the Yjs-generated compat fixture documents — and
asserts byte-identical step2/update responses, the unknown-message
tolerance contract, and awareness passthrough.  Runs over
:class:`LocalCluster` around the port's in-process fleet, every shard on
the CPU (``tests/torch_service.py``), under both provider backends: the
dialect code is identical over the multiprocess fabric, which
``tests/test_torch_cluster.py`` covers."""

import base64
import hashlib
import json
import os
import socket
import tempfile
import threading
import time

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.cluster import Gateway, LocalCluster
from yjs_tpu_torch.cluster.config import GatewayConfig
from yjs_tpu_torch.cluster.gateway import (
    MESSAGE_AWARENESS,
    MESSAGE_QUERY_AWARENESS,
    MESSAGE_SYNC,
    ws_accept_key,
)
from yjs_tpu_torch.lib0 import decoding, encoding
from yjs_tpu_torch.lib0.decoding import Decoder
from yjs_tpu_torch.lib0.encoding import Encoder
from yjs_tpu_torch.sync import protocol
from torch_service import BACKENDS, FleetRouter

pytestmark = pytest.mark.cluster

FIXTURES = json.load(
    open(os.path.join(os.path.dirname(__file__), "fixtures", "compat_v1.json"))
)


class WsClient:
    """A minimal stdlib y-websocket client: RFC 6455 handshake, masked
    binary frames out, buffered unmasked frames in."""

    def __init__(self, port: int, room: str):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=20)
        self._buf = b""
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        self.sock.sendall(
            (
                f"GET /{room} HTTP/1.1\r\nHost: t\r\nUpgrade: websocket\r\n"
                f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode("ascii")
        )
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise AssertionError("handshake EOF")
            resp += chunk
        head, _, rest = resp.partition(b"\r\n\r\n")
        self._buf = rest  # a coalesced first frame stays buffered
        assert b" 101 " in head.split(b"\r\n")[0] + b" ", head
        # the server must prove it hashed our key (RFC 6455 §4.2.2)
        accept = [
            ln.split(b":", 1)[1].strip()
            for ln in head.split(b"\r\n")
            if ln.lower().startswith(b"sec-websocket-accept")
        ]
        assert accept and accept[0].decode() == ws_accept_key(key)

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise AssertionError("unexpected EOF")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def read_message(self) -> bytes:
        while True:
            hdr = self._recv_exact(2)
            opcode = hdr[0] & 0x0F
            ln = hdr[1] & 0x7F
            if ln == 126:
                ln = int.from_bytes(self._recv_exact(2), "big")
            elif ln == 127:
                ln = int.from_bytes(self._recv_exact(8), "big")
            payload = self._recv_exact(ln) if ln else b""
            if opcode in (0x1, 0x2):
                return payload
            if opcode == 0x8:
                raise AssertionError("server closed")
            # ping/pong/continuation: skip for these single-frame tests

    def send(self, payload: bytes) -> None:
        mask = os.urandom(4)
        masked = bytes(b ^ mask[i & 3] for i, b in enumerate(payload))
        n = len(payload)
        hdr = bytes([0x82])
        if n < 126:
            hdr += bytes([0x80 | n])
        elif n < 1 << 16:
            hdr += bytes([0x80 | 126]) + n.to_bytes(2, "big")
        else:
            hdr += bytes([0x80 | 127]) + n.to_bytes(8, "big")
        self.sock.sendall(hdr + mask + masked)

    def send_sync(self, inner: bytes) -> None:
        enc = Encoder()
        encoding.write_var_uint(enc, MESSAGE_SYNC)
        self.send(enc.to_bytes() + inner)

    def read_sync(self) -> bytes:
        """Next sync message's inner frame (skips awareness traffic)."""
        while True:
            msg = self.read_message()
            dec = Decoder(msg)
            if decoding.read_var_uint(dec) == MESSAGE_SYNC:
                return bytes(msg[dec.pos:])

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def sync_step1_frame(sv: bytes) -> bytes:
    enc = Encoder()
    encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_1)
    encoding.write_var_uint8_array(enc, sv)
    return enc.to_bytes()


def sync_step2_frame(update: bytes) -> bytes:
    enc = Encoder()
    encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_2)
    encoding.write_var_uint8_array(enc, update)
    return enc.to_bytes()


def sync_update_frame(update: bytes) -> bytes:
    enc = Encoder()
    encoding.write_var_uint(enc, protocol.MESSAGE_YJS_UPDATE)
    encoding.write_var_uint8_array(enc, update)
    return enc.to_bytes()


@pytest.fixture(scope="module", params=BACKENDS)
def gw(request):
    fleet = FleetRouter(
        n_shards=2, docs_per_shard=16, backend=request.param,
        wal_dir=tempfile.mkdtemp(prefix="ytpu-gwwire-"),
    )
    gateway = Gateway(
        LocalCluster(fleet), config=GatewayConfig(port=0)
    ).start()
    yield gateway
    gateway.close()
    fleet.close()


def test_ws_handshake_opens_with_step1(gw):
    c = WsClient(gw.port, "hs-room")
    inner = c.read_sync()
    dec = Decoder(inner)
    assert decoding.read_var_uint(dec) == protocol.MESSAGE_YJS_SYNC_STEP_1
    decoding.read_var_uint8_array(dec)  # a well-formed state vector
    assert not dec.has_content()
    c.close()


@pytest.mark.parametrize(
    "name,root,getter",
    [
        ("testArrayCompatibilityV1", "array", "to_json"),
        ("testMapDecodingCompatibilityV1", "map", "to_json"),
        ("testTextDecodingCompatibilityV1", "text", "to_delta"),
    ],
)
def test_compat_fixture_step2_byte_identical(gw, name, root, getter):
    """Seed a room with a Yjs-v13-generated document, then drive the
    gateway with a raw step 1 and assert the step 2 payload is
    byte-identical to the engine's own diff — the gateway adds and
    removes nothing on the wire."""
    fx = FIXTURES[name]
    old = base64.b64decode(fx["oldDoc"])
    room = f"compat-{root}"
    assert gw.cluster.receive_update(room, old)
    gw.cluster.flush(room)
    reference = gw.cluster.diff_update(room, b"\x00")

    c = WsClient(gw.port, room)
    c.read_sync()  # server's opening step1
    c.send_sync(sync_step1_frame(b"\x00"))  # empty SV: give me everything
    inner = c.read_sync()
    dec = Decoder(inner)
    assert decoding.read_var_uint(dec) == protocol.MESSAGE_YJS_SYNC_STEP_2
    payload = decoding.read_var_uint8_array(dec)
    assert payload == reference, (
        f"step2 not byte-identical: {hashlib.sha256(payload).hexdigest()[:16]}"
        f" != {hashlib.sha256(reference).hexdigest()[:16]}"
    )
    # and the bytes integrate to exactly the recorded fixture value
    doc = Y.Doc()
    Y.apply_update(doc, payload)
    got = getattr(getattr(doc, f"get_{root}")(root), getter)()
    assert got == fx["oldVal"]
    c.close()


def test_ws_update_applies_and_fans_out(gw):
    room = "fanout-room"
    a = WsClient(gw.port, room)
    b = WsClient(gw.port, room)
    a.read_sync()
    b.read_sync()

    doc = Y.Doc(gc=False)
    doc.client_id = 77
    doc.get_text("text").insert(0, "ws edit")
    update = Y.encode_state_as_update(doc)
    a.send_sync(sync_update_frame(update))

    deadline = time.time() + 15
    while time.time() < deadline:
        if gw.cluster.text(room) == "ws edit":
            break
        time.sleep(0.05)
    assert gw.cluster.text(room) == "ws edit"

    # the room's other member receives a flush-merged update frame
    inner = b.read_sync()
    dec = Decoder(inner)
    assert decoding.read_var_uint(dec) == protocol.MESSAGE_YJS_UPDATE
    merged = decoding.read_var_uint8_array(dec)
    doc_b = Y.Doc()
    Y.apply_update(doc_b, merged)
    assert doc_b.get_text("text").to_string() == "ws edit"
    a.close()
    b.close()


def test_unknown_outer_message_skipped(gw):
    """The y-protocols tolerance contract: an unknown outer type is
    counted and skipped; the connection keeps serving sync traffic."""
    room = "tolerant-room"
    c = WsClient(gw.port, room)
    c.read_sync()
    before = gw.metrics.unknown.value
    c.send(bytes([42]) + b"\x01\x02\x03")  # outer type 42: not a thing
    c.send_sync(sync_step1_frame(b"\x00"))  # must still be answered
    inner = c.read_sync()
    assert inner[0] == protocol.MESSAGE_YJS_SYNC_STEP_2
    assert gw.metrics.unknown.value == before + 1
    c.close()


def test_step2_from_plain_reader_applies(gw):
    """A plain y-protocols reader answers our step1 with step2; the
    gateway must apply it exactly like an update."""
    room = "plain-step2"
    c = WsClient(gw.port, room)
    c.read_sync()
    doc = Y.Doc(gc=False)
    doc.client_id = 88
    doc.get_text("text").insert(0, "via step2")
    c.send_sync(sync_step2_frame(Y.encode_state_as_update(doc)))
    deadline = time.time() + 15
    while time.time() < deadline:
        if gw.cluster.text(room) == "via step2":
            break
        time.sleep(0.05)
    assert gw.cluster.text(room) == "via step2"
    c.close()


def test_split_get_still_sniffs_websocket_dialect(gw):
    """TCP may deliver the request head split — a first segment of just
    ``G`` must still classify as the ws dialect, not fall through to a
    raw length-prefixed frame parse that kills the connection."""
    sock = socket.create_connection(("127.0.0.1", gw.port), timeout=20)
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    request = (
        "GET /split-room HTTP/1.1\r\nHost: t\r\nUpgrade: websocket\r\n"
        f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n"
    ).encode("ascii")
    sock.sendall(request[:1])  # just 'G'
    time.sleep(0.3)  # let the sniffer peek the short head
    sock.sendall(request[1:])
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = sock.recv(4096)
        assert chunk, "gateway dropped the split-GET connection"
        resp += chunk
    assert b" 101 " in resp.split(b"\r\n")[0] + b" "
    sock.close()


def test_localcluster_fanout_runs_on_dispatch_thread(tmp_path):
    """The deadlock-fix pin: LocalCluster must deliver ``on_update``
    from its dedicated dispatch thread, never synchronously from inside
    the fleet's flush — that path runs under the facade lock, and a
    subscriber taking the gateway lock there would invert the
    gateway's gw._lock → cluster-lock order."""
    fleet = FleetRouter(
        n_shards=1, docs_per_shard=8, backend="cpu",
        wal_dir=str(tmp_path / "wal"),
    )
    cluster = LocalCluster(fleet)
    try:
        seen = []
        done = threading.Event()

        def on_update(guid, update):
            seen.append(threading.current_thread().name)
            # re-entering the facade from the callback must be legal
            # (the gateway reads state vectors during fan-out handling)
            cluster.state_vector_bytes(guid)
            done.set()

        cluster.on_update = on_update
        doc = Y.Doc(gc=False)
        doc.client_id = 7
        doc.get_text("text").insert(0, "thread pin")
        assert cluster.receive_update(
            "pin-room", Y.encode_state_as_update(doc)
        )
        cluster.flush("pin-room")
        assert done.wait(30), "fan-out never fired"
        assert seen[0] == "ytpu-localcluster-evt"
    finally:
        cluster.close()


def test_awareness_passthrough_and_query(gw):
    room = "aware-room"
    a = WsClient(gw.port, room)
    b = WsClient(gw.port, room)
    a.read_sync()
    b.read_sync()

    # a fabricated awareness update payload (opaque to the gateway)
    enc = Encoder()
    encoding.write_var_uint(enc, MESSAGE_AWARENESS)
    encoding.write_var_uint8_array(enc, b"\x01\x02awareness-blob")
    frame = enc.to_bytes()
    a.send(frame)

    # b receives the passthrough byte-identically
    msg = b.read_message()
    assert msg == frame

    # a late joiner can query the cached state
    late = WsClient(gw.port, room)
    late.read_sync()
    enc = Encoder()
    encoding.write_var_uint(enc, MESSAGE_QUERY_AWARENESS)
    late.send(enc.to_bytes())
    msg = late.read_message()
    assert msg == frame
    a.close()
    b.close()
    late.close()
