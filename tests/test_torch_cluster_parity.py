"""The PyTorch port's process cluster against the JAX package's, byte
for byte.

A JAX :class:`yjs_tpu.cluster.Supervisor` and a port
:class:`yjs_tpu_torch.cluster.Supervisor` (two shard processes each, the
port's on the CPU) take the same seeded updates through their facades;
every room's state vector, full diff and text must be equal.  Then the
same shard is killed with SIGKILL in each: both recovery reports must
give the same outcomes and per-room resolution counts, and the rooms
must still be equal.  The same y-websocket frames into a gateway over
each must get byte-identical replies.  Last, a port supervisor started
on a WAL root the JAX one wrote recovers every room.
"""

import base64
import os
import signal
import socket
import time

import pytest
from torch_service import (
    Supervisor,
    one_thread_a_child,
    seeded_rooms,
    wait_outcome,
)

import yjs_tpu_torch as Y
from yjs_tpu.cluster import Gateway as JaxGateway
from yjs_tpu.cluster import GatewayConfig as JaxGatewayConfig
from yjs_tpu.cluster import Supervisor as JaxSupervisor
from yjs_tpu_torch.cluster import (
    ClusterConfig,
    Gateway,
    GatewayConfig,
    RpcBusy,
    RpcError,
)
from yjs_tpu_torch.cluster.gateway import MESSAGE_SYNC, ws_accept_key
from yjs_tpu_torch.lib0 import decoding, encoding
from yjs_tpu_torch.lib0.decoding import Decoder
from yjs_tpu_torch.lib0.encoding import Encoder
from yjs_tpu_torch.sync import protocol

pytestmark = pytest.mark.cluster

N_ROOMS = 12
N_OPS = 24
FAST = dict(heartbeat_s=0.15, restart_backoff_s=0.05, busy_retry_ticks=4,
            restart_max=2, spawn_timeout_s=120.0)


def _config():
    from yjs_tpu.cluster import ClusterConfig as JaxClusterConfig

    return JaxClusterConfig(**FAST), ClusterConfig(**FAST)


def _retry(fn, deadline_s: float = 60.0):
    """One facade call, retried while the room's shard is down."""
    deadline = time.time() + deadline_s
    while True:
        try:
            return fn()
        except (RpcBusy, RpcError, ConnectionError):
            if time.time() > deadline:
                raise
            time.sleep(0.1)


def _feed(sup, rooms) -> None:
    for guid, (_doc, updates) in sorted(rooms.items()):
        for u in updates:
            assert _retry(lambda: sup.receive_update(guid, u))
    sup.flush()


def _observe(sup, guids) -> dict:
    out = {}
    for g in guids:
        _retry(lambda: sup.flush(g))
        out[g] = (
            _retry(lambda: sup.state_vector_bytes(g)),
            _retry(lambda: sup.diff_update(g, None)),
            _retry(lambda: sup.text(g)),
        )
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    one_thread_a_child(mp)
    root = tmp_path_factory.mktemp("parity")
    jcfg, pcfg = _config()
    jax_sup = JaxSupervisor(
        2, str(root / "jax"), docs_per_shard=16, config=jcfg,
        backend="auto",
    ).start()
    port_sup = Supervisor(
        2, str(root / "port"), docs_per_shard=16, config=pcfg,
        backend="auto",
    ).start()
    jax_gw = JaxGateway(jax_sup, config=JaxGatewayConfig(port=0)).start()
    port_gw = Gateway(port_sup, config=GatewayConfig(port=0)).start()
    rooms = seeded_rooms(14, N_ROOMS, N_OPS)
    try:
        _feed(jax_sup, rooms)
        _feed(port_sup, rooms)
        yield jax_sup, port_sup, jax_gw, port_gw, rooms
    finally:
        jax_gw.close()
        port_gw.close()
        jax_sup.close()
        port_sup.close()
        mp.undo()


def test_rooms_equal_byte_for_byte(pair):
    jax_sup, port_sup, _, _, rooms = pair
    guids = sorted(rooms)
    assert [jax_sup.owner_of(g) for g in guids] == [
        port_sup.owner_of(g) for g in guids
    ]
    want = _observe(jax_sup, guids)
    got = _observe(port_sup, guids)
    for g in guids:
        assert got[g] == want[g], g
        assert got[g][2] == rooms[g][0].get_text("text").to_string()


class _Ws:
    """A stdlib y-websocket client: handshake, masked frames out."""

    def __init__(self, port: int, room: str):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=20)
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        self.sock.sendall((
            f"GET /{room} HTTP/1.1\r\nHost: t\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n"
        ).encode("ascii"))
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            assert chunk, "handshake EOF"
            resp += chunk
        head, _, self._buf = resp.partition(b"\r\n\r\n")
        assert ws_accept_key(key).encode() in head

    def _exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            assert chunk, "unexpected EOF"
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def read_sync(self) -> bytes:
        while True:
            hdr = self._exact(2)
            n = hdr[1] & 0x7F
            if n == 126:
                n = int.from_bytes(self._exact(2), "big")
            elif n == 127:
                n = int.from_bytes(self._exact(8), "big")
            msg = self._exact(n) if n else b""
            if hdr[0] & 0x0F not in (0x1, 0x2):
                continue
            dec = Decoder(msg)
            if decoding.read_var_uint(dec) == MESSAGE_SYNC:
                return bytes(msg[dec.pos:])

    def send_sync(self, inner: bytes) -> None:
        enc = Encoder()
        encoding.write_var_uint(enc, MESSAGE_SYNC)
        payload = enc.to_bytes() + inner
        mask = b"\x01\x02\x03\x04"
        masked = bytes(b ^ mask[i & 3] for i, b in enumerate(payload))
        n = len(payload)
        if n < 126:
            hdr = bytes([0x82, 0x80 | n])
        else:
            hdr = bytes([0x82, 0x80 | 126]) + n.to_bytes(2, "big")
        self.sock.sendall(hdr + mask + masked)

    def close(self) -> None:
        self.sock.close()


def _frame(kind: int, payload: bytes) -> bytes:
    enc = Encoder()
    encoding.write_var_uint(enc, kind)
    encoding.write_var_uint8_array(enc, payload)
    return enc.to_bytes()


def test_gateways_reply_byte_identically(pair):
    _, _, jax_gw, port_gw, rooms = pair
    guid = sorted(rooms)[0]
    doc = rooms[guid][0]
    replies = []
    for gw in (jax_gw, port_gw):
        got = []
        c = _Ws(gw.port, guid)
        try:
            got.append(c.read_sync())  # the gateway's opening step 1
            # a new client's step 1: the whole room as step 2
            c.send_sync(_frame(protocol.MESSAGE_YJS_SYNC_STEP_1, b"\x00"))
            got.append(c.read_sync())
            # a client holding the room's state: an empty diff
            c.send_sync(_frame(protocol.MESSAGE_YJS_SYNC_STEP_1,
                               Y.encode_state_vector(doc)))
            got.append(c.read_sync())
        finally:
            c.close()
        replies.append(got)
    assert replies[0] == replies[1]
    dec = Decoder(replies[1][1])
    assert decoding.read_var_uint(dec) == protocol.MESSAGE_YJS_SYNC_STEP_2
    probe = Y.Doc()
    Y.apply_update(probe, decoding.read_var_uint8_array(dec))
    assert probe.get_text("text").to_string() == doc.get_text(
        "text").to_string()


def test_kill9_same_shard_same_report_same_rooms(pair):
    jax_sup, port_sup, _, _, rooms = pair
    guids = sorted(rooms)
    victim = jax_sup.owner_of(guids[0])
    for sup in (jax_sup, port_sup):
        os.kill(sup._shards[victim].pid, signal.SIGKILL)
    reports = [wait_outcome(sup, "recovered") for sup in (jax_sup, port_sup)]
    for key in ("outcomes", "resolution", "epoch"):
        assert reports[0][key] == reports[1][key], key
    (jev,), (pev,) = reports[0]["events"], reports[1]["events"]
    for key in ("shard", "outcome", "restarts", "resolution"):
        assert jev[key] == pev[key], key
    for key in ("outcome", "records_applied", "migrations_pending"):
        assert jev["recovery"][key] == pev["recovery"][key], key
    assert reports[1]["shards"][victim]["device"] == "cpu"
    want = _observe(jax_sup, guids)
    got = _observe(port_sup, guids)
    for g in guids:
        assert got[g] == want[g], g


def test_port_supervisor_recovers_a_jax_wal_root(tmp_path):
    mp = pytest.MonkeyPatch()
    one_thread_a_child(mp)
    jcfg, pcfg = _config()
    rooms = seeded_rooms(15, 8, 16)
    jax_sup = JaxSupervisor(
        2, str(tmp_path / "wal"), docs_per_shard=16, config=jcfg,
    ).start()
    try:
        _feed(jax_sup, rooms)
        want = _observe(jax_sup, sorted(rooms))
    finally:
        jax_sup.close()  # graceful: each shard checkpoints
    port_sup = Supervisor(
        2, str(tmp_path / "wal"), docs_per_shard=16, config=pcfg,
        backend="auto",
    ).start()
    try:
        report = port_sup.recovery_report()
        assert [r["outcome"] for r in report["shards"]] == [
            "recovered", "recovered"
        ]
        assert {r["device"] for r in report["shards"]} == {"cpu"}
        got = _observe(port_sup, sorted(rooms))
        for g in sorted(rooms):
            assert got[g][0] == want[g][0], g
            assert got[g][2] == want[g][2], g
            assert Y.merge_updates([got[g][1]]) == Y.merge_updates(
                [want[g][1]]), g
    finally:
        port_sup.close()
        mp.undo()
