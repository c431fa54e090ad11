"""The cluster's wire-compatible front door.

One TCP listener, two dialects, sniffed per connection:

- **y-websocket** — a connection starting with an HTTP ``GET`` gets the
  RFC 6455 handshake and then speaks exactly what a stock
  ``y-websocket`` client (Yjs v13.4.9) expects: binary messages whose
  first varuint is the outer type (``0`` sync, ``1`` awareness, ``3``
  query-awareness), with the 2-step sync handshake inside type 0 —
  step 1 answered with a byte-identical step 2 diff, updates applied
  and fanned out to the room.  Unknown outer types are counted and
  skipped (the y-protocols tolerance contract), awareness frames pass
  through to room members and are cached for late joiners.  The room
  name is the URL path.
- **raw session** — anything else is the enhanced session protocol over
  ``<I``-length-prefixed frames (the ``cluster/rpc.py`` transport): a
  varstring ``room`` + ``peer`` preamble, then a full server-side
  :class:`SyncSession` per connection — acked outbox, BUSY
  backpressure, digest anti-entropy, rehome on migration/failover.
  ``examples/socket_connector.py`` is the matching client.

Behind either dialect every frame routes to the room's owner shard via
the cluster facade — :class:`~yjs_tpu_torch.cluster.supervisor.Supervisor`
for real OS processes, or :class:`LocalCluster` (below) wrapping an
in-process :class:`~yjs_tpu_torch.fleet.FleetRouter` so tests and the bench
can compare the same gateway over both fabrics.  While a shard is
down the facade raises :class:`RpcBusy`; session connections answer
with the BUSY envelope (the peer retransmits — zero acked loss) and
y-websocket frames are dropped and counted (stock clients carry no ack
to lose; they re-sync on reconnect).

:class:`ProviderHost` (end of module) serves the raw dialect from one
in-process :class:`~yjs_tpu_torch.provider.TpuProvider` instead of a
cluster facade: each connection is ``provider.session(room, peer)``,
and every frame and kernel launch runs on the thread that pumps it.

Failover/migration rehoming: the facade's ``on_epoch`` fires after a
routing change; session connections :meth:`~SyncSession.rehome` (digest
→ targeted repair, not full resync) and y-websocket rooms get a fresh
step 1 so clients send back anything the dead shard never flushed.
"""

from __future__ import annotations

import base64
import hashlib
import queue
import socket
import struct
import threading
import time
from urllib.parse import unquote

from ..lib0 import decoding, encoding
from ..lib0.decoding import Decoder
from ..lib0.encoding import Encoder
from ..obs import dist as obs_dist
from ..obs import global_registry
from ..sync import protocol
from ..sync.session import SessionConfig, SyncSession, encode_busy
from .config import GatewayConfig
from .rpc import FrameConn, RpcBusy, RpcError, SocketTransport

# y-websocket outer message types (y-websocket/bin/utils.js)
MESSAGE_SYNC = 0
MESSAGE_AWARENESS = 1
MESSAGE_AUTH = 2
MESSAGE_QUERY_AWARENESS = 3

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

_OUTER_NAMES = {
    MESSAGE_SYNC: "sync",
    MESSAGE_AWARENESS: "awareness",
    MESSAGE_AUTH: "auth",
    MESSAGE_QUERY_AWARENESS: "query_awareness",
}


class _GatewayMetrics:
    """``ytpu_gateway_*`` families (process-global, re-register safe)."""

    def __init__(self):
        reg = global_registry()
        self.conns = reg.gauge(
            "ytpu_gateway_conns", "Live gateway client connections"
        )
        self.rooms = reg.gauge(
            "ytpu_gateway_rooms", "Rooms with at least one connection"
        )
        self.frames = reg.counter(
            "ytpu_gateway_frames_total",
            "Gateway frames by direction and outer kind",
            labelnames=("dir", "kind"),
        )
        self.unknown = reg.counter(
            "ytpu_gateway_unknown_total",
            "Unknown outer message types skipped (tolerance contract)",
        )
        self.busy_drops = reg.counter(
            "ytpu_gateway_busy_drops_total",
            "y-websocket frames dropped while the owner shard was "
            "unavailable (stock clients re-sync on reconnect)",
        )
        self.rehomes = reg.counter(
            "ytpu_gateway_rehomes_total",
            "Connection rehomes after a routing-epoch bump",
        )


# -- cluster-backed session host ----------------------------------------------


class _ClusterSessionHost:
    """Session host over the cluster facade — the cross-process twin of
    ``_ProviderSessionHost`` / ``_FleetSessionHost``.  Every path a
    session drives lands on the room's owner shard; shard unavailability
    surfaces as BUSY (``handle_frame``) or a stale-but-safe cached state
    vector (``state_vector``) so nothing ever escapes into the
    transport pump."""

    __slots__ = ("cluster", "guid", "peer", "_sv_cache")

    def __init__(self, cluster, guid: str, peer: str):
        self.cluster = cluster
        self.guid = guid
        self.peer = peer
        self._sv_cache = b"\x00"  # empty state vector

    def state_vector(self) -> bytes:
        try:
            sv = self.cluster.state_vector_bytes(self.guid)
        except (RpcBusy, RpcError):
            # shard mid-restart: a stale digest at worst triggers one
            # extra repair round; raising would kill the rx thread
            return self._sv_cache
        self._sv_cache = sv
        return sv

    def diff_update(self, sv: bytes | None) -> bytes:
        return self.cluster.diff_update(self.guid, sv)

    def apply_update(self, update: bytes) -> None:
        self.cluster.receive_update(self.guid, update)

    def handle_frame(self, frame: bytes) -> bytes | None:
        try:
            return self.cluster.handle_sync_message(self.guid, frame)
        except RpcBusy as e:
            # the zero-acked-loss seam: refuse instead of ack — the
            # peer keeps the frame in its outbox and retransmits once
            # the shard is back
            return encode_busy(e.retry_after)

    def dead_letter(self, payload: bytes, reason: str) -> None:
        # the refusing shard already quarantined its copy (or was down,
        # in which case the peer still holds the frame); the gateway
        # only surfaces the event
        _GatewayMetricsSingleton.get().frames.labels(
            dir="rx", kind="dead_letter"
        ).inc()

    def journal_ack(self, sid: int, seq: int) -> None:
        self.cluster.journal_ack(self.guid, self.peer, sid, seq)


class _GatewayMetricsSingleton:
    _inst = None
    _lock = threading.Lock()

    @classmethod
    def get(cls) -> _GatewayMetrics:
        with cls._lock:
            if cls._inst is None:
                cls._inst = _GatewayMetrics()
            return cls._inst


# -- in-process cluster facade ------------------------------------------------


class LocalCluster:
    """The Supervisor facade over an in-process
    :class:`~yjs_tpu_torch.fleet.FleetRouter` — same gateway, no processes.
    This is the bench baseline ("gateway over in-process fleet") and
    the fast path for wire-compat tests; it also makes the facade
    contract explicit: anything both fabrics implement is what the
    gateway may call."""

    def __init__(self, fleet):
        self.fleet = fleet
        self._lock = threading.RLock()
        self.on_update = None
        self.on_epoch = None
        # flush-emitted updates re-dispatch on a dedicated thread, the
        # same shape as Supervisor._evt_loop: the fleet fires its
        # on_update bridge synchronously inside flush() — i.e. while
        # this facade's lock is held — so calling the gateway (which
        # takes gw._lock) from here would invert the gateway's
        # gw._lock → cluster-lock order and deadlock against the tick
        # loop.  The queue keeps the facade lock a leaf for callbacks.
        self._evt_q: list[tuple[str, bytes]] = []
        self._evt_wake = threading.Condition()
        self._evt_stop = False
        self._evt_thread = threading.Thread(
            target=self._evt_loop, name="ytpu-localcluster-evt", daemon=True
        )
        fleet.on_update(self._fan)
        self._evt_thread.start()

    def _fan(self, guid: str, update: bytes) -> None:
        with self._evt_wake:
            if self._evt_stop:
                return
            self._evt_q.append((guid, bytes(update)))
            self._evt_wake.notify()

    def _evt_loop(self) -> None:
        while True:
            with self._evt_wake:
                while not self._evt_q and not self._evt_stop:
                    self._evt_wake.wait()
                if not self._evt_q and self._evt_stop:
                    return
                batch, self._evt_q[:] = list(self._evt_q), []
            cb = self.on_update
            if cb is None:
                continue
            for guid, update in batch:
                try:
                    cb(guid, update)
                except Exception:
                    pass  # a bad subscriber must not stall fan-out

    @property
    def epoch(self) -> int:
        with self._lock:
            return self.fleet.table.epoch

    def owner_of(self, guid: str):
        with self._lock:
            return self.fleet.shard_of(guid)

    def receive_update(self, guid: str, update: bytes, v2: bool = False,
                       internal: bool = False) -> bool:
        ctx = obs_dist.current_context() or obs_dist.mint_for_update(
            bytes(update)
        )
        with obs_dist.use_context(ctx):
            with self._lock:
                return self.fleet.receive_update(
                    guid, update, v2=v2, internal=internal
                )

    def handle_sync_message(self, guid: str, message: bytes) -> bytes | None:
        ctx = obs_dist.current_context()
        with obs_dist.use_context(ctx):
            with self._lock:
                return self.fleet.handle_sync_message(guid, message)

    def state_vector_bytes(self, guid: str) -> bytes:
        with self._lock:
            p = self.fleet.provider_for(guid)
            p.flush()
            return p.engine.encode_state_vector(p.doc_id(guid))

    def diff_update(self, guid: str, sv: bytes | None) -> bytes:
        with self._lock:
            return self.fleet.encode_state_as_update(guid, sv)

    def text(self, guid: str) -> str:
        with self._lock:
            return self.fleet.text(guid)

    def flush(self, guid: str | None = None) -> None:
        with self._lock:
            self.fleet.flush()

    def journal_ack(self, guid: str, peer: str, sid: int, seq: int) -> None:
        with self._lock:
            self.fleet.provider_for(guid).journal_session_ack(
                guid, peer, sid, seq
            )

    def tick(self) -> None:
        with self._lock:
            self.fleet.flush_tick()
            self.fleet.tick_sessions()

    def metrics_snapshot(self) -> dict:
        with self._lock:
            return self.fleet.metrics_snapshot()

    def recovery_report(self) -> dict:
        with self._lock:
            return self.fleet.recovery_report()

    def close(self) -> None:
        with self._evt_wake:
            self._evt_stop = True
            self._evt_wake.notify_all()
        if (
            self._evt_thread.is_alive()
            and self._evt_thread is not threading.current_thread()
        ):
            self._evt_thread.join(timeout=5.0)
        with self._lock:
            self.fleet.close()


# -- websocket plumbing (stdlib only) -----------------------------------------


def ws_accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _WS_GUID).encode("ascii")).digest()
    ).decode("ascii")


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def ws_read_message(sock: socket.socket, max_frame: int):
    """One complete (possibly fragmented) message → ``(opcode, bytes)``
    or ``None`` on EOF/protocol error.  Control frames are handled
    inline (ping answered, close echoed then ``None``)."""
    message = b""
    opcode0 = None
    while True:
        hdr = _recv_exact(sock, 2)
        if hdr is None:
            return None
        fin = hdr[0] & 0x80
        opcode = hdr[0] & 0x0F
        masked = hdr[1] & 0x80
        ln = hdr[1] & 0x7F
        if ln == 126:
            ext = _recv_exact(sock, 2)
            if ext is None:
                return None
            ln = int.from_bytes(ext, "big")
        elif ln == 127:
            ext = _recv_exact(sock, 8)
            if ext is None:
                return None
            ln = int.from_bytes(ext, "big")
        if ln > max_frame:
            return None
        mask = _recv_exact(sock, 4) if masked else None
        if mask is None and masked:
            return None
        payload = _recv_exact(sock, ln) if ln else b""
        if payload is None:
            return None
        if mask:
            payload = bytes(
                b ^ mask[i & 3] for i, b in enumerate(payload)
            )
        if opcode == 0x8:  # close: echo and stop
            ws_send_message(sock, payload, opcode=0x8)
            return None
        if opcode == 0x9:  # ping → pong
            ws_send_message(sock, payload, opcode=0xA)
            continue
        if opcode == 0xA:  # pong
            continue
        if opcode in (0x1, 0x2):
            opcode0 = opcode
            message = payload
        elif opcode == 0x0:  # continuation
            message += payload
        else:
            return None
        if fin:
            return (opcode0 if opcode0 is not None else opcode, message)


def ws_send_message(sock: socket.socket, payload: bytes,
                    opcode: int = 0x2) -> bool:
    """One unmasked (server→client) message, single frame."""
    n = len(payload)
    hdr = bytes([0x80 | opcode])
    if n < 126:
        hdr += bytes([n])
    elif n < 1 << 16:
        hdr += bytes([126]) + n.to_bytes(2, "big")
    else:
        hdr += bytes([127]) + n.to_bytes(8, "big")
    try:
        sock.sendall(hdr + payload)
        return True
    except OSError:
        return False


def encode_room_preamble(room: str, peer: str = "peer") -> bytes:
    """The raw-dialect hello: first length-prefixed frame on the wire."""
    enc = Encoder()
    encoding.write_var_string(enc, room)
    encoding.write_var_string(enc, peer)
    return enc.to_bytes()


def decode_room_preamble(frame: bytes) -> tuple[str, str | None]:
    """The raw-dialect hello's ``(room, peer)``; ``peer`` is None when
    the preamble names only the room."""
    dec = Decoder(frame)
    room = decoding.read_var_string(dec)
    peer = decoding.read_var_string(dec) if dec.has_content() else None
    return room, peer


# -- one client connection ----------------------------------------------------


class _GatewayConn:
    """One accepted client connection, either dialect."""

    def __init__(self, gateway: "Gateway", sock: socket.socket, addr):
        self.gateway = gateway
        self.sock = sock
        self.addr = addr
        self.dialect = ""  # "ws" | "raw"
        self.room = ""
        self.peer = f"{addr[0]}:{addr[1]}"
        self.session = None     # raw dialect only
        self.transport = None   # raw dialect only
        self.awareness = None   # ws dialect: last awareness payload
        self._send_lock = threading.Lock()
        self._thread = None

    # -- ws dialect ----------------------------------------------------------

    def send_ws(self, payload: bytes) -> bool:
        with self._send_lock:
            return ws_send_message(self.sock, payload)

    def _ws_handshake(self) -> bool:
        data = b""
        while b"\r\n\r\n" not in data:
            try:
                chunk = self.sock.recv(4096)
            except OSError:
                return False
            if not chunk:
                return False
            data += chunk
            if len(data) > 64 * 1024:
                return False
        head = data.split(b"\r\n\r\n", 1)[0].decode("latin-1")
        lines = head.split("\r\n")
        try:
            path = lines[0].split(" ")[1]
        except IndexError:
            return False
        key = ""
        for line in lines[1:]:
            name, _, value = line.partition(":")
            if name.strip().lower() == "sec-websocket-key":
                key = value.strip()
        if not key:
            return False
        self.room = unquote(path.lstrip("/").split("?")[0]) or "default"
        resp = (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {ws_accept_key(key)}\r\n\r\n"
        )
        try:
            self.sock.sendall(resp.encode("latin-1"))
        except OSError:
            return False
        return True

    def _ws_serve(self) -> None:
        gw = self.gateway
        if not self._ws_handshake():
            gw._drop_conn(self)
            return
        t = gw.config.send_timeout_s
        if t > 0:
            # send-side bound only (a plain settimeout would also make
            # idle recv() loops time out): a client with a full TCP
            # send buffer fails the send instead of blocking forever
            try:
                self.sock.setsockopt(
                    socket.SOL_SOCKET,
                    socket.SO_SNDTIMEO,
                    struct.pack("ll", int(t), int((t % 1.0) * 1e6)),
                )
            except (OSError, struct.error):
                pass
        gw._register(self)
        # y-websocket servers open with their step 1 (+ cached awareness)
        try:
            sv = gw.cluster.state_vector_bytes(self.room)
        except (RpcBusy, RpcError):
            sv = b"\x00"
        enc = Encoder()
        encoding.write_var_uint(enc, MESSAGE_SYNC)
        encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_1)
        encoding.write_var_uint8_array(enc, sv)
        self.send_ws(enc.to_bytes())
        gw.metrics.frames.labels(dir="tx", kind="sync").inc()
        for frame in gw._cached_awareness(self):
            self.send_ws(frame)
        while True:
            msg = ws_read_message(self.sock, gw.config.max_frame)
            if msg is None:
                break
            _, payload = msg
            if payload:
                self.handle_client_message(payload)
        gw._drop_conn(self)

    def handle_client_message(self, data: bytes) -> None:
        """The gateway's y-websocket ingress seam: adopt-or-mint the
        trace for the frame, then route the inner sync message to the
        room's owner shard through the cluster facade (which stamps the
        SLO and carries the context across the RPC hop)."""
        ctx = obs_dist.current_context() or obs_dist.mint_for_update(
            bytes(data)
        )
        with obs_dist.use_context(ctx):
            self._dispatch_client(data)

    def _dispatch_client(self, data: bytes) -> None:
        gw = self.gateway
        dec = Decoder(bytes(data))
        try:
            outer = decoding.read_var_uint(dec)
        except Exception:
            gw.metrics.unknown.inc()
            return
        kind = _OUTER_NAMES.get(outer, "unknown")
        gw.metrics.frames.labels(dir="rx", kind=kind).inc()
        if outer == MESSAGE_SYNC:
            inner = bytes(data[dec.pos:])
            # the facade serializes internally — holding gw._lock across
            # a shard call would stall every other connection for the
            # RPC's duration (and is never needed for lock ordering:
            # gw._lock → cluster is the one legal order)
            try:
                reply = gw.cluster.handle_sync_message(self.room, inner)
            except (RpcBusy, RpcError):
                # no ack concept on this dialect: count the drop; the
                # client repairs via its reconnect resync
                gw.metrics.busy_drops.inc()
                return
            if reply is not None:
                enc = Encoder()
                encoding.write_var_uint(enc, MESSAGE_SYNC)
                out = enc.to_bytes() + reply
                self.send_ws(out)
                gw.metrics.frames.labels(dir="tx", kind="sync").inc()
        elif outer == MESSAGE_AWARENESS:
            self.awareness = bytes(data)
            gw._broadcast_ws(self.room, bytes(data), exclude=self)
        elif outer == MESSAGE_QUERY_AWARENESS:
            for frame in gw._cached_awareness(self):
                self.send_ws(frame)
        elif outer == MESSAGE_AUTH:
            pass  # permissive gateway: auth frames are acknowledged noise
        else:
            # tolerance contract: unknown outer types skip, never kill
            # the connection (mirrors y-protocols readSyncMessage)
            gw.metrics.unknown.inc()

    # -- raw session dialect -------------------------------------------------

    def _raw_serve(self, first: bytes) -> None:
        gw = self.gateway
        try:
            self.room, peer = decode_room_preamble(first)
        except Exception:
            gw._drop_conn(self)
            return
        if peer is not None:
            self.peer = peer
        host = _ClusterSessionHost(gw.cluster, self.room, self.peer)
        session = SyncSession(
            host, config=gw.session_config, peer=self.peer
        )
        transport = SocketTransport(
            self.sock,
            frame_lock=gw._lock,
            max_frame=gw.config.max_frame,
            name=self.peer,
        )
        with gw._lock:
            self.session = session
            self.transport = transport
            session.attach(transport)
            # busy-guard the pump: a facade RpcBusy mid-handshake (shard
            # restarting) drops that frame — unacked, so the peer
            # retransmits — instead of killing the rx thread
            inner_frame = transport.on_frame
            def _guarded(frame, _cb=inner_frame):
                try:
                    _cb(frame)
                except (RpcBusy, RpcError):
                    gw.metrics.busy_drops.inc()
            transport.on_frame = _guarded
            inner_close = transport.on_close
            def _closed(_cb=inner_close):
                if _cb is not None:
                    _cb()
                gw._drop_conn(self)
            transport.on_close = _closed
        gw._register(self)
        gw.metrics.frames.labels(dir="rx", kind="session_hello").inc()
        transport.start()

    # -- common --------------------------------------------------------------

    def _sniff(self) -> bytes:
        """Peek the first bytes without consuming them.  TCP may hand
        the head over split (a ws client's ``GET`` can arrive as just
        ``G``), so keep peeking until ≥3 bytes, EOF, or a grace
        deadline — a single short peek would misclassify the dialect."""
        deadline = time.monotonic() + 5.0
        while True:
            try:
                head = self.sock.recv(4, socket.MSG_PEEK)
            except OSError:
                return b""
            if not head or len(head) >= 3:
                return head
            if time.monotonic() >= deadline:
                return head
            time.sleep(0.005)

    def serve(self) -> None:
        """Sniff the dialect and run the connection (its own thread)."""
        head = self._sniff()
        if not head:
            self.gateway._drop_conn(self)
            return
        if head.startswith(b"GET"):
            self.dialect = "ws"
            self._ws_serve()
        else:
            self.dialect = "raw"
            pre = FrameConn(
                self.sock, max_frame=self.gateway.config.max_frame
            )
            first = pre.recv()
            if first is None:
                self.gateway._drop_conn(self)
                return
            self._raw_serve(first)

    def close(self) -> None:
        if self.transport is not None:
            t = self.transport
            t.close()
            t.join()
        else:
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass


# -- the gateway --------------------------------------------------------------


class Gateway:
    """The y-websocket-compatible cluster endpoint (module docstring)."""

    def __init__(
        self,
        cluster,
        config: GatewayConfig | None = None,
        session_config: SessionConfig | None = None,
    ):
        self.cluster = cluster
        self.config = config if config is not None else GatewayConfig()
        self.session_config = (
            session_config if session_config is not None else SessionConfig()
        )
        self.metrics = _GatewayMetricsSingleton.get()
        self._lock = threading.RLock()
        self._conns: set = set()
        self._rooms: dict[str, set] = {}
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.config.host, self.config.port))
        self._sock.listen(64)
        self._accept = threading.Thread(
            target=self._accept_loop, name="ytpu-gateway-accept", daemon=True
        )
        self._ticker = threading.Thread(
            target=self._tick_loop, name="ytpu-gateway-tick", daemon=True
        )
        self.admin = None  # started alongside the loops in start()
        cluster.on_update = self._on_room_update
        cluster.on_epoch = self._on_epoch

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def start(self) -> "Gateway":
        self._accept.start()
        self._ticker.start()
        from ..obs.admin import AdminServer

        try:
            self.admin = AdminServer(self, role="gateway").start()
        except OSError:
            self.admin = None  # port taken; ws plane still serves
        return self

    # -- admin-plane target ---------------------------------------

    def statusz(self) -> dict:
        with self._lock:
            n_conns = len(self._conns)
            rooms = {r: len(cs) for r, cs in self._rooms.items()}
        epoch = getattr(self.cluster, "epoch", None)
        return {
            "role": "gateway",
            "port": self.port,
            "conns": n_conns,
            "rooms": rooms,
            "epoch": epoch() if callable(epoch) else epoch,
        }

    def readiness(self) -> dict:
        """Ready once the accept loop is live and the cluster facade is
        still attached — a closing gateway flips not-ready first."""
        accepting = self._accept.is_alive() and not self._stop.is_set()
        return {
            "ready": accepting,
            "checks": {"accepting": accepting},
        }

    def close(self) -> None:
        self._stop.set()
        admin = getattr(self, "admin", None)
        if admin is not None:
            admin.close()
            self.admin = None
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept.is_alive():
            self._accept.join(timeout=5.0)
        if self._ticker.is_alive():
            self._ticker.join(timeout=5.0)
        with self._lock:
            conns = list(self._conns)
            sessions = [
                c.session for c in conns if c.session is not None
            ]
            for s in sessions:
                s.close()
        for c in conns:
            c.close()

    # -- loops ---------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return
            conn = _GatewayConn(self, sock, addr)
            t = threading.Thread(
                target=conn.serve,
                name=f"ytpu-gw-{addr[1]}",
                daemon=True,
            )
            conn._thread = t
            t.start()

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.config.tick_s):
            with self._lock:
                conns = list(self._conns)
                for c in conns:
                    if c.session is not None and not c.session._closed:
                        try:
                            c.session.tick()
                        except (RpcBusy, RpcError):
                            pass  # shard mid-restart; next tick retries
                tick = getattr(self.cluster, "tick", None)
                if tick is not None:
                    try:
                        tick()
                    except Exception:
                        pass

    # -- room registry -------------------------------------------------------

    def _register(self, conn: _GatewayConn) -> None:
        with self._lock:
            self._conns.add(conn)
            self._rooms.setdefault(conn.room, set()).add(conn)
            n_conns = len(self._conns)
            n_rooms = len(self._rooms)
        self.metrics.conns.set(n_conns)
        self.metrics.rooms.set(n_rooms)

    def _drop_conn(self, conn: _GatewayConn) -> None:
        with self._lock:
            self._conns.discard(conn)
            members = self._rooms.get(conn.room)
            if members is not None:
                members.discard(conn)
                if not members:
                    self._rooms.pop(conn.room, None)
            n_conns = len(self._conns)
            n_rooms = len(self._rooms)
        self.metrics.conns.set(n_conns)
        self.metrics.rooms.set(n_rooms)

    def _room_conns(self, room: str) -> list:
        with self._lock:
            return list(self._rooms.get(room, ()))

    def _cached_awareness(self, requester: _GatewayConn) -> list[bytes]:
        if not self.config.awareness:
            return []
        return [
            c.awareness
            for c in self._room_conns(requester.room)
            if c is not requester and c.awareness is not None
        ]

    def _broadcast_ws(self, room: str, frame: bytes,
                      exclude: _GatewayConn | None = None) -> None:
        if not self.config.awareness:
            return
        for c in self._room_conns(room):
            if c is exclude or c.dialect != "ws":
                continue
            c.send_ws(frame)
            self.metrics.frames.labels(dir="tx", kind="awareness").inc()

    # -- cluster callbacks ---------------------------------------------------

    def _on_room_update(self, guid: str, update: bytes) -> None:
        """A shard flushed a merged update for ``guid``: fan it to every
        connection in the room (both dialects).  Yjs integration is
        idempotent, so echoing the originator its own merged delta is
        harmless and keeps the path branch-free.

        Session sends only enqueue to the transport's writer thread, so
        they stay under the lock; ws sends block in ``sendall``, so they
        happen OUTSIDE ``gw._lock`` — one stalled client must never
        wedge the tick loop, raw-frame delivery, or other rooms."""
        ws_conns = []
        with self._lock:
            for c in list(self._rooms.get(guid, ())):
                if c.session is not None:
                    if not c.session._closed:
                        c.session.send_update(update)
                        self.metrics.frames.labels(
                            dir="tx", kind="session_update"
                        ).inc()
                elif c.dialect == "ws":
                    ws_conns.append(c)
        if not ws_conns:
            return
        enc = Encoder()
        encoding.write_var_uint(enc, MESSAGE_SYNC)
        protocol.write_update(enc, update)
        ws_frame = enc.to_bytes()
        for c in ws_conns:
            if c.send_ws(ws_frame):
                self.metrics.frames.labels(dir="tx", kind="sync").inc()
            else:
                # send failed (dead peer or SO_SNDTIMEO expired on a
                # stalled one): sever the connection so its rx loop
                # exits instead of wedging future fan-outs
                self._drop_conn(c)
                c.close()

    def _on_epoch(self, epoch: int, shards) -> None:
        """Routing epoch bumped (restart/failover/migration): rehome
        every session (digest → targeted anti-entropy repair) and
        re-offer step 1 to y-websocket rooms so stock clients push back
        whatever the dead shard never flushed."""
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            session = c.session
            if session is not None:
                with self._lock:
                    if not session._closed:
                        session.rehome(epoch)
                self.metrics.rehomes.inc()
            elif c.dialect == "ws" and c.room:
                try:
                    sv = self.cluster.state_vector_bytes(c.room)
                except (RpcBusy, RpcError):
                    continue
                enc = Encoder()
                encoding.write_var_uint(enc, MESSAGE_SYNC)
                encoding.write_var_uint(
                    enc, protocol.MESSAGE_YJS_SYNC_STEP_1
                )
                encoding.write_var_uint8_array(enc, sv)
                c.send_ws(enc.to_bytes())
                self.metrics.rehomes.inc()

    # -- introspection -------------------------------------------------------

    def sessions_snapshot(self) -> list[dict]:
        with self._lock:
            conns = list(self._conns)
            rows = []
            for c in conns:
                if c.session is not None:
                    row = c.session.snapshot()
                    row["room"] = c.room
                    row["dialect"] = c.dialect
                    rows.append(row)
                else:
                    rows.append({
                        "peer": c.peer,
                        "room": c.room,
                        "dialect": c.dialect,
                    })
        return rows


# -- one provider's own sessions over sockets ---------------------------------


class ProviderHost:
    """Raw-dialect socket peers served by one ``TpuProvider``.

    A peer connects, sends the preamble (``room``, ``peer``), then speaks
    the session protocol to ``provider.session(room, peer)``.  The accept
    thread reads only the preamble, and each transport's rx thread only
    queues what arrives: :meth:`pump`, on the thread that owns the
    provider, attaches new peers, hands every queued frame and close to
    its session, flushes the provider and ticks the host's sessions once
    ``tick_s`` of wall time have passed.  So no kernel launches from a
    socket thread, and the session layer sees one thread, as it must."""

    def __init__(self, provider, config: SessionConfig | None = None,
                 tick_s: float = 0.05):
        self.provider = provider
        self.config = config
        self.tick_s = tick_s
        self.sessions: dict[tuple[str, str], SyncSession] = {}
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._listener: socket.socket | None = None
        self._accepter: threading.Thread | None = None
        self._stopping = False
        self._last_tick = 0.0

    def listen(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Bind, start the accept thread; returns the bound port."""
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen()
        self._listener = srv
        self._accepter = threading.Thread(
            target=self._accept_loop, name="ytpu-provider-accept",
            daemon=True,
        )
        self._accepter.start()
        return srv.getsockname()[1]

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            # FrameConn reads exactly one frame: nothing past the
            # preamble is consumed before the transport takes the socket
            try:
                room, peer = decode_room_preamble(FrameConn(sock).recv() or b"")
            except Exception:
                sock.close()
                continue
            self._inbox.put(
                ("attach", sock, (room, peer or f"{addr[0]}:{addr[1]}"))
            )

    def _attach(self, sock: socket.socket, room: str, peer: str) -> None:
        session = self.provider.session(room, peer, self.config)
        transport = SocketTransport(sock, name=peer)
        session.connect(transport)
        on_frame, on_close = transport.on_frame, transport.on_close
        box = self._inbox
        transport.on_frame = lambda f, _cb=on_frame: box.put(("frame", _cb, f))
        transport.on_close = lambda _cb=on_close: box.put(("close", _cb, None))
        self.sessions[(room, peer)] = session
        transport.start()

    def pump(self) -> int:
        """Handle everything queued, flush, and tick when due; returns
        the number of queued items handled."""
        n = 0
        while True:
            try:
                kind, a, b = self._inbox.get_nowait()
            except queue.Empty:
                break
            n += 1
            if kind == "attach":
                self._attach(a, *b)
            elif kind == "frame":
                a(b)
            elif a is not None:
                a()
        self.provider.flush()
        now = time.monotonic()
        if now - self._last_tick >= self.tick_s:
            self._last_tick = now
            for sess in list(self.sessions.values()):
                sess.tick()
        return n

    def serve(self, seconds: float) -> None:
        """Pump for ``seconds`` of wall time."""
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            if not self.pump():
                time.sleep(0.005)

    def close(self) -> None:
        """Stop accepting, close every session (each transport drains
        and joins its threads)."""
        self._stopping = True
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()
        if self._accepter is not None:
            self._accepter.join(timeout=2.0)
        for (room, peer) in list(self.sessions):
            self.provider.close_session(room, peer)
        self.sessions.clear()
