"""Socket RPC for the process-native cluster.

Inter-shard traffic — migration, replication fan-out, failover probes,
routing-epoch bumps — crosses process boundaries here, riding the SAME
type-121 envelope the session layer put on the wire, extended
with three request/response kinds the session reader tolerantly skips:

- ``K_RPC_REQ``  (8): ``121 | 8 | varint corr | varstring method |
  varuint8array payload | varuint8array trace`` — the trailing trace
  blob is the 25-byte :class:`~yjs_tpu_torch.obs.dist.TraceContext` wire form
  (empty = unsampled/uncarried), so causal traces cross the process
  boundary exactly as they cross the session DATA frames.
- ``K_RPC_RSP``  (9): ``121 | 9 | varint corr | varint status |
  varuint8array payload``.  Status 0 = ok, 1 = error (payload carries
  the message), 2 = busy (payload carries ``retry_after`` ticks) — the
  BUSY lane is how admission backpressure rides the RPC: a
  refused call surfaces as :class:`RpcBusy` and the caller's session
  leaves the frame un-acked for retransmission.
- ``K_RPC_EVT`` (10): ``121 | 10 | varstring topic | varuint8array
  payload`` — unsolicited server→client pushes (a shard's
  flush-emitted updates fanning out to the gateway).

Framing is the length-prefix (``<I``) framing
``examples/socket_connector.py`` established; payloads are canonical
JSON with base64 for binary fields (debuggable, schema-free — the
volume path is the gateway's session frames, not the RPC envelope).

:class:`SocketTransport` is the reusable threaded transport under all
of this: a :class:`~yjs_tpu_torch.sync.transport.Transport` over one TCP
socket whose writer thread drains the outbox and whose ``close()``
JOINS both threads after the drain — frames accepted before close are
on the wire before the FIN (the contract a fire-and-forget shutdown
would break).
"""

from __future__ import annotations

import base64
import itertools
import json
import socket
import struct
import threading

from ..lib0 import decoding, encoding
from ..lib0.decoding import Decoder
from ..lib0.encoding import Encoder
from ..obs import global_registry
from ..obs.dist import TraceContext, current_context
from ..sync.session import MESSAGE_YTPU_SESSION
from ..sync.transport import Transport

# envelope kinds 0..7 belong to the session layer (HELLO..BUSY); the
# RPC lane extends the same space so a misrouted frame is skipped, not
# fatal, on either side of the seam
K_RPC_REQ = 8
K_RPC_RSP = 9
K_RPC_EVT = 10

STATUS_OK = 0
STATUS_ERROR = 1
STATUS_BUSY = 2

_HDR = struct.Struct("<I")
DEFAULT_MAX_FRAME = 32 * 1024 * 1024


class RpcError(Exception):
    """The remote handler raised, or the reply was malformed."""


class RpcBusy(RpcError):
    """The remote refused the call under backpressure (an admission
    verdict or a shard mid-restart): back off ``retry_after`` ticks and
    retransmit — the refusal is loud, never a silent drop."""

    def __init__(self, retry_after: int = 1):
        super().__init__(f"busy: retry after {retry_after} ticks")
        self.retry_after = max(1, int(retry_after))


class RpcClosed(RpcError):
    """The connection died before the reply arrived."""


def b64e(raw: bytes) -> str:
    return base64.b64encode(bytes(raw)).decode("ascii")


def b64d(text: str) -> bytes:
    return base64.b64decode(text)


class _RpcMetrics:
    """``ytpu_cluster_rpc_*`` families on the process-global registry."""

    def __init__(self):
        reg = global_registry()
        self.calls = reg.counter(
            "ytpu_cluster_rpc_calls_total",
            "Cluster RPC calls completed, by method and outcome status",
            labelnames=("method", "status"),
        )
        self.events = reg.counter(
            "ytpu_cluster_rpc_events_total",
            "Cluster RPC event frames (unsolicited pushes), by topic "
            "and direction",
            labelnames=("topic", "dir"),
        )
        self.frames = reg.counter(
            "ytpu_cluster_rpc_frames_total",
            "Cluster RPC frames on the wire, by direction",
            labelnames=("dir",),
        )
        self.unknown = reg.counter(
            "ytpu_cluster_rpc_unknown_total",
            "Cluster RPC frames skipped for an unknown envelope kind "
            "(newer protocol revision tolerance)",
        )


_METRICS = None
_METRICS_LOCK = threading.Lock()


def rpc_metrics() -> _RpcMetrics:
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            _METRICS = _RpcMetrics()
        return _METRICS


# -- wire encoding ------------------------------------------------------------


def encode_request(
    corr: int, method: str, payload: dict, ctx: TraceContext | None = None
) -> bytes:
    enc = Encoder()
    encoding.write_var_uint(enc, MESSAGE_YTPU_SESSION)
    encoding.write_var_uint(enc, K_RPC_REQ)
    encoding.write_var_uint(enc, corr)
    encoding.write_var_string(enc, method)
    encoding.write_var_uint8_array(
        enc, json.dumps(payload, separators=(",", ":")).encode("utf-8")
    )
    encoding.write_var_uint8_array(
        enc, ctx.to_bytes() if ctx is not None else b""
    )
    return enc.to_bytes()


def encode_response(corr: int, status: int, payload: dict) -> bytes:
    enc = Encoder()
    encoding.write_var_uint(enc, MESSAGE_YTPU_SESSION)
    encoding.write_var_uint(enc, K_RPC_RSP)
    encoding.write_var_uint(enc, corr)
    encoding.write_var_uint(enc, status)
    encoding.write_var_uint8_array(
        enc, json.dumps(payload, separators=(",", ":")).encode("utf-8")
    )
    return enc.to_bytes()


def encode_event(topic: str, payload: dict) -> bytes:
    enc = Encoder()
    encoding.write_var_uint(enc, MESSAGE_YTPU_SESSION)
    encoding.write_var_uint(enc, K_RPC_EVT)
    encoding.write_var_string(enc, topic)
    encoding.write_var_uint8_array(
        enc, json.dumps(payload, separators=(",", ":")).encode("utf-8")
    )
    return enc.to_bytes()


def decode_frame(frame: bytes):
    """Parse one RPC frame → ``(kind, fields…)`` or ``None`` for any
    frame this reader does not understand (wrong type, session kind, a
    future kind): the caller counts and skips — one unknown frame must
    never kill the connection."""
    try:
        dec = Decoder(frame)
        if decoding.read_var_uint(dec) != MESSAGE_YTPU_SESSION:
            return None
        kind = decoding.read_var_uint(dec)
        if kind == K_RPC_REQ:
            corr = decoding.read_var_uint(dec)
            method = decoding.read_var_string(dec)
            payload = json.loads(
                decoding.read_var_uint8_array(dec).decode("utf-8")
            )
            ctx = None
            if dec.has_content():
                blob = decoding.read_var_uint8_array(dec)
                if blob:
                    ctx = TraceContext.from_bytes(blob)
            return (K_RPC_REQ, corr, method, payload, ctx)
        if kind == K_RPC_RSP:
            corr = decoding.read_var_uint(dec)
            status = decoding.read_var_uint(dec)
            payload = json.loads(
                decoding.read_var_uint8_array(dec).decode("utf-8")
            )
            return (K_RPC_RSP, corr, status, payload)
        if kind == K_RPC_EVT:
            topic = decoding.read_var_string(dec)
            payload = json.loads(
                decoding.read_var_uint8_array(dec).decode("utf-8")
            )
            return (K_RPC_EVT, topic, payload)
        return None
    except Exception:
        return None


# -- framed socket ------------------------------------------------------------


class FrameConn:
    """Length-prefixed (``<I``) frames over one blocking TCP socket.

    ``send`` is lock-serialized (many threads write one socket);
    ``recv`` is single-reader by construction.  This is a leaf lock —
    nothing else is ever taken inside it."""

    def __init__(self, sock: socket.socket, max_frame: int = DEFAULT_MAX_FRAME):
        self.sock = sock
        self.max_frame = max_frame
        self._send_lock = threading.Lock()
        self._closed = False
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass

    def send(self, payload: bytes) -> bool:
        with self._send_lock:
            if self._closed:
                return False
            try:
                self.sock.sendall(_HDR.pack(len(payload)) + bytes(payload))
                return True
            except OSError:
                return False

    def _read_exact(self, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def recv(self) -> bytes | None:
        """One whole frame, or ``None`` on EOF/error/oversize."""
        hdr = self._read_exact(_HDR.size)
        if hdr is None:
            return None
        (n,) = _HDR.unpack(hdr)
        if n > self.max_frame:
            return None
        if n == 0:
            return b""
        return self._read_exact(n)

    def close(self) -> None:
        with self._send_lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


# -- the threaded session transport ------------------------------------------


class SocketTransport(Transport):
    """A :class:`~yjs_tpu_torch.sync.transport.Transport` over one TCP
    socket with owned rx/tx threads.

    Outbound frames queue through a writer thread (the session's
    ``send`` may fire while the caller holds its doc lock — blocking in
    ``sendall`` there deadlocks two back-pressured peers).  Inbound
    frames are delivered to ``on_frame`` under ``frame_lock`` when one
    is given (the owner's doc/session lock — :class:`SyncSession` is
    not thread-safe).

    ``close()`` is the drain-then-join contract: enqueue a sentinel, JOIN
    the writer (every frame accepted before close reaches the socket
    before the FIN), then close the socket and join the reader.  Frames
    the peer never acked remain in the session outbox — the session
    retransmits them on the next attach; the transport's job is only to
    never drop what it accepted."""

    def __init__(
        self,
        sock: socket.socket,
        frame_lock=None,
        max_frame: int = DEFAULT_MAX_FRAME,
        name: str = "",
    ):
        super().__init__()
        self.conn = FrameConn(sock, max_frame=max_frame)
        self.name = name or f"fd{sock.fileno()}"
        self._frame_lock = frame_lock
        self._outbox: list = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closing = False
        self._rx = threading.Thread(
            target=self._recv_loop, name=f"ytpu-rx-{self.name}", daemon=True
        )
        self._tx = threading.Thread(
            target=self._send_loop, name=f"ytpu-tx-{self.name}", daemon=True
        )

    def start(self) -> None:
        self._rx.start()
        self._tx.start()

    # -- Transport contract --------------------------------------------------

    def send(self, frame: bytes) -> bool:
        with self._wake:
            if self._closing or not self.alive:
                return False
            self._outbox.append(bytes(frame))
            self._wake.notify()
        return True

    # -- threads -------------------------------------------------------------

    def _send_loop(self) -> None:
        while True:
            with self._wake:
                while not self._outbox and not self._closing:
                    self._wake.wait()
                if not self._outbox and self._closing:
                    return
                frame = self._outbox.pop(0)
            if frame is None:
                return
            if not self.conn.send(frame):
                # peer is gone: the reader sees the same failure and
                # emits the single on_close; just stop writing
                return

    def _recv_loop(self) -> None:
        while True:
            frame = self.conn.recv()
            if frame is None:
                break
            cb = self.on_frame
            if cb is None:
                continue
            if self._frame_lock is not None:
                with self._frame_lock:
                    cb(bytes(frame))
            else:
                cb(bytes(frame))
        with self._wake:
            quiet = self._closing
        if not quiet:
            self.close()

    # -- shutdown ------------------------------------------------------------

    def close(self) -> None:
        """Drain-then-join shutdown; safe to call from any thread
        (including the reader itself on EOF) and idempotent."""
        with self._wake:
            if self._closing:
                return
            self._closing = True
            self._wake.notify_all()
        me = threading.current_thread()
        if self._tx.is_alive() and self._tx is not me:
            self._tx.join(timeout=5.0)
        self.conn.close()
        if self._rx.is_alive() and self._rx is not me:
            self._rx.join(timeout=5.0)
        super().close()  # fires on_close exactly once (alive gate)

    @property
    def queued(self) -> int:
        with self._wake:
            return len(self._outbox)

    def join(self, timeout: float = 5.0) -> bool:
        """True when both threads exited (the shutdown pin)."""
        me = threading.current_thread()
        for t in (self._tx, self._rx):
            if t is me or not t.is_alive():
                continue
            t.join(timeout=timeout)
        return not (
            (self._tx.is_alive() and self._tx is not me)
            or (self._rx.is_alive() and self._rx is not me)
        )


# -- client -------------------------------------------------------------------


class RpcClient:
    """One connection to a shard's :class:`RpcServer`.

    ``call()`` is synchronous (correlation-id matched, many in flight
    from different threads); ``on_event`` receives unsolicited pushes
    on the reader thread.  A dead connection fails every waiter with
    :class:`RpcClosed` — callers translate that to BUSY at the session
    seam so peers retransmit instead of losing frames."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 30.0,
        max_frame: int = DEFAULT_MAX_FRAME,
        connect_timeout: float = 10.0,
    ):
        self.addr = (host, int(port))
        self.timeout = timeout
        self.on_event = None  # callable(topic: str, payload: dict)
        self._corr = itertools.count(1)
        self._lock = threading.Lock()
        self._pending: dict = {}  # corr -> [threading.Event, reply|None]
        self._alive = True
        sock = socket.create_connection(self.addr, timeout=connect_timeout)
        sock.settimeout(None)
        self.conn = FrameConn(sock, max_frame=max_frame)
        self._rx = threading.Thread(
            target=self._recv_loop, name=f"ytpu-rpc-{port}", daemon=True
        )
        self._rx.start()

    @property
    def alive(self) -> bool:
        with self._lock:
            return self._alive

    def _recv_loop(self) -> None:
        m = rpc_metrics()
        while True:
            frame = self.conn.recv()
            if frame is None:
                break
            m.frames.labels(dir="rx").inc()
            parsed = decode_frame(frame)
            if parsed is None:
                m.unknown.inc()
                continue
            if parsed[0] == K_RPC_RSP:
                _, corr, status, payload = parsed
                with self._lock:
                    slot = self._pending.get(corr)
                    if slot is not None:
                        slot[1] = (status, payload)
                        slot[0].set()
            elif parsed[0] == K_RPC_EVT:
                _, topic, payload = parsed
                m.events.labels(topic=topic, dir="rx").inc()
                cb = self.on_event
                if cb is not None:
                    try:
                        cb(topic, payload)
                    except Exception:
                        pass  # a bad event handler must not kill rx
        self._fail_all()

    def _fail_all(self) -> None:
        with self._lock:
            self._alive = False
            slots = list(self._pending.values())
            self._pending.clear()
        for slot in slots:
            slot[0].set()

    def call(
        self, method: str, payload: dict | None = None,
        timeout: float | None = None,
    ) -> dict:
        """Invoke ``method`` remotely; returns the reply payload.

        Raises :class:`RpcBusy` on a BUSY status, :class:`RpcError` on
        a remote error, :class:`RpcClosed` on connection loss or
        timeout.  The current :class:`TraceContext`, if any, rides the
        request so the remote seam adopts (not re-mints) it."""
        corr = next(self._corr)
        ev = threading.Event()
        slot = [ev, None]
        with self._lock:
            if not self._alive:
                raise RpcClosed(f"rpc connection to {self.addr} is closed")
            self._pending[corr] = slot
        frame = encode_request(
            corr, method, payload or {}, current_context()
        )
        m = rpc_metrics()
        if not self.conn.send(frame):
            with self._lock:
                self._pending.pop(corr, None)
            self._fail_all()
            m.calls.labels(method=method, status="closed").inc()
            raise RpcClosed(f"send to {self.addr} failed")
        m.frames.labels(dir="tx").inc()
        if not ev.wait(timeout if timeout is not None else self.timeout):
            with self._lock:
                self._pending.pop(corr, None)
            m.calls.labels(method=method, status="timeout").inc()
            raise RpcClosed(f"rpc {method} to {self.addr} timed out")
        with self._lock:
            self._pending.pop(corr, None)
        reply = slot[1]
        if reply is None:
            m.calls.labels(method=method, status="closed").inc()
            raise RpcClosed(f"rpc connection to {self.addr} died")
        status, body = reply
        if status == STATUS_BUSY:
            m.calls.labels(method=method, status="busy").inc()
            raise RpcBusy(int(body.get("retry_after", 1)))
        if status != STATUS_OK:
            m.calls.labels(method=method, status="error").inc()
            raise RpcError(str(body.get("error", "remote error")))
        m.calls.labels(method=method, status="ok").inc()
        return body

    def close(self) -> None:
        self.conn.close()
        self._fail_all()
        if self._rx.is_alive() and self._rx is not threading.current_thread():
            self._rx.join(timeout=5.0)


# -- server -------------------------------------------------------------------


class RpcServer:
    """Accept loop + per-connection reader threads dispatching to one
    handler object (anything with ``handle_rpc_request(method, payload,
    ctx) -> dict``; raise :class:`RpcBusy` for the backpressure lane).

    ``broadcast`` pushes an EVT frame to every live connection — the
    shard's update fan-out to supervisor/gateway subscribers."""

    def __init__(
        self,
        handler,
        host: str = "127.0.0.1",
        port: int = 0,
        max_frame: int = DEFAULT_MAX_FRAME,
    ):
        self.handler = handler
        self.max_frame = max_frame
        self._lock = threading.Lock()
        self._conns: list = []
        self._closing = False
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"ytpu-rpcsrv-{self.port}",
            daemon=True,
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            conn = FrameConn(sock, max_frame=self.max_frame)
            with self._lock:
                if self._closing:
                    conn.close()
                    return
                self._conns.append(conn)
            t = threading.Thread(
                target=self._serve_conn,
                args=(conn,),
                name=f"ytpu-rpcconn-{self.port}",
                daemon=True,
            )
            t.start()

    def _serve_conn(self, conn: FrameConn) -> None:
        m = rpc_metrics()
        while True:
            frame = conn.recv()
            if frame is None:
                break
            m.frames.labels(dir="rx").inc()
            parsed = decode_frame(frame)
            if parsed is None or parsed[0] != K_RPC_REQ:
                m.unknown.inc()
                continue
            _, corr, method, payload, ctx = parsed
            try:
                body = self.handler.handle_rpc_request(method, payload, ctx)
                status = STATUS_OK
                if body is None:
                    body = {}
                m.calls.labels(method=method, status="ok").inc()
            except RpcBusy as e:
                status, body = STATUS_BUSY, {"retry_after": e.retry_after}
                m.calls.labels(method=method, status="busy").inc()
            except Exception as e:
                status = STATUS_ERROR
                body = {"error": f"{type(e).__name__}: {e}"}
                m.calls.labels(method=method, status="error").inc()
            if conn.send(encode_response(corr, status, body)):
                m.frames.labels(dir="tx").inc()
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)
        conn.close()

    def broadcast(self, topic: str, payload: dict) -> int:
        """Push one EVT frame to every live connection; returns the
        number of peers reached."""
        frame = encode_event(topic, payload)
        with self._lock:
            conns = list(self._conns)
        m = rpc_metrics()
        sent = 0
        for conn in conns:
            if conn.send(frame):
                sent += 1
                m.events.labels(topic=topic, dir="tx").inc()
        return sent

    def close(self) -> None:
        with self._lock:
            if self._closing:
                return
            self._closing = True
            conns = list(self._conns)
            self._conns.clear()
        # closing a listening socket does not wake a thread blocked in
        # ``accept()`` on Linux; shutting it down first does, so the
        # join below returns at once instead of at its timeout
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for conn in conns:
            conn.close()
        if self._accept_thread.is_alive():
            self._accept_thread.join(timeout=5.0)
