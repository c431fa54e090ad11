"""Cluster RPC wire + transport contracts, on the PyTorch port's copy
of the cluster RPC (the cases of ``tests/test_cluster_rpc.py``).

The envelope-121 RPC kinds (K_RPC_REQ/RSP/EVT), the correlation-matched
client, BUSY propagation, trace carry across the socket, and the
:class:`SocketTransport` drain-then-join shutdown pin."""

import socket
import threading
import time

import pytest

from yjs_tpu_torch.cluster.rpc import (
    K_RPC_EVT,
    K_RPC_REQ,
    K_RPC_RSP,
    STATUS_BUSY,
    STATUS_OK,
    FrameConn,
    RpcBusy,
    RpcClient,
    RpcError,
    RpcServer,
    SocketTransport,
    decode_frame,
    encode_event,
    encode_request,
    encode_response,
)
from yjs_tpu_torch.obs import dist as obs_dist

pytestmark = pytest.mark.cluster


# -- wire ---------------------------------------------------------------------


def test_request_roundtrip_with_trace():
    ctx = obs_dist.mint_for_update(b"seed")
    frame = encode_request(7, "sync", {"guid": "room-a"}, ctx)
    kind, corr, method, payload, got = decode_frame(frame)
    assert kind == K_RPC_REQ
    assert (corr, method) == (7, "sync")
    assert payload == {"guid": "room-a"}
    assert got is not None and got.trace_id == ctx.trace_id


def test_response_and_event_roundtrip():
    rsp = decode_frame(encode_response(9, STATUS_OK, {"ok": 1}))
    assert rsp == (K_RPC_RSP, 9, STATUS_OK, {"ok": 1})
    evt = decode_frame(encode_event("update", {"guid": "g"}))
    assert evt == (K_RPC_EVT, "update", {"guid": "g"})


def test_unknown_kind_and_garbage_skip():
    # a future kind inside the 121 envelope decodes to None (skip), as
    # does non-envelope garbage — the tolerance contract
    assert decode_frame(bytes([121, 99, 1, 2, 3])) is None
    assert decode_frame(b"\x00\xffgarbage") is None
    assert decode_frame(b"") is None


# -- client/server ------------------------------------------------------------


class _Handler:
    def __init__(self):
        self.seen = []

    def handle_rpc_request(self, method, payload, ctx):
        self.seen.append((method, payload, ctx))
        if method == "busy":
            raise RpcBusy(5)
        if method == "boom":
            raise ValueError("deliberate")
        return {"echo": payload, "method": method}


def test_rpc_call_busy_error_and_trace_carry():
    handler = _Handler()
    server = RpcServer(handler, host="127.0.0.1", port=0)
    client = RpcClient("127.0.0.1", server.port, timeout=10.0)
    try:
        body = client.call("hello", {"x": 1})
        assert body == {"echo": {"x": 1}, "method": "hello"}

        # the current TraceContext rides the request: the remote seam
        # adopts the SAME trace id instead of re-minting
        ctx = obs_dist.mint_for_update(b"traced-update")
        with obs_dist.use_context(ctx):
            client.call("traced", {})
        got = handler.seen[-1][2]
        assert got is not None and got.trace_id == ctx.trace_id

        try:
            client.call("busy", {})
            raise AssertionError("expected RpcBusy")
        except RpcBusy as e:
            assert e.retry_after == 5

        try:
            client.call("boom", {})
            raise AssertionError("expected RpcError")
        except RpcError:
            pass
        # the connection survives handler errors
        assert client.call("after", {})["method"] == "after"
    finally:
        client.close()
        server.close()


def test_rpc_event_broadcast():
    handler = _Handler()
    server = RpcServer(handler, host="127.0.0.1", port=0)
    client = RpcClient("127.0.0.1", server.port, timeout=10.0)
    got = []
    ev = threading.Event()

    def on_event(topic, payload):
        got.append((topic, payload))
        ev.set()

    client.on_event = on_event
    try:
        client.call("hello", {})  # ensures the conn is registered
        assert server.broadcast("update", {"guid": "g"}) >= 1
        assert ev.wait(5.0)
        assert got[0] == ("update", {"guid": "g"})
    finally:
        client.close()
        server.close()


def test_dead_server_fails_pending_with_closed():
    handler = _Handler()
    server = RpcServer(handler, host="127.0.0.1", port=0)
    client = RpcClient("127.0.0.1", server.port, timeout=10.0)
    server.close()
    deadline = time.time() + 5
    while client.alive and time.time() < deadline:
        time.sleep(0.02)
    try:
        client.call("hello", {})
        raise AssertionError("expected a closed-connection error")
    except Exception as e:
        assert type(e).__name__ in ("RpcClosed", "RpcError")
    finally:
        client.close()


def test_server_close_wakes_the_accept_thread():
    """``close`` shuts the listener down, so the thread blocked in
    ``accept()`` exits at once (a plain close leaves it blocked until the
    join's 5 s timeout) and the port refuses new connections."""
    server = RpcServer(_Handler(), host="127.0.0.1", port=0)
    client = RpcClient("127.0.0.1", server.port, timeout=10.0)
    assert client.call("hello", {})["method"] == "hello"
    t0 = time.perf_counter()
    server.close()
    took = time.perf_counter() - t0
    client.close()
    assert not server._accept_thread.is_alive()
    assert took < 1.0, f"close took {took:.3f}s"
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", server.port), timeout=2.0)


# -- SocketTransport shutdown pin --------------------------------------------


def test_socket_transport_drains_outbox_before_close():
    """Every frame accepted by ``send()`` before ``close()`` reaches the
    wire, and both transport threads join — the drain-then-join contract."""
    a, b = socket.socketpair()
    tx = SocketTransport(a, name="tx")
    got = []
    done = threading.Event()

    def reader():
        conn = FrameConn(b)
        while True:
            frame = conn.recv()
            if frame is None:
                break
            got.append(frame)
        done.set()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    tx.start()
    frames = [bytes([i % 251]) * (i + 1) for i in range(200)]
    for f in frames:
        assert tx.send(f)
    tx.close()  # must drain all 200 queued frames first
    assert tx.join(timeout=5.0), "transport threads did not exit"
    assert done.wait(5.0), "reader never saw EOF"
    assert got == frames, (
        f"dropped {len(frames) - len(got)} of {len(frames)} frames on close"
    )
    t.join(timeout=5.0)
    b.close()


def test_socket_transport_close_idempotent_and_queued_gauge():
    a, b = socket.socketpair()
    tr = SocketTransport(a, name="idem")
    tr.start()
    assert tr.queued == 0
    tr.send(b"x")
    tr.close()
    tr.close()  # second close is a no-op
    assert tr.join(timeout=5.0)
    assert not tr.send(b"late"), "send after close must be refused"
    b.close()


def test_socket_transport_peer_eof_fires_on_close_once():
    a, b = socket.socketpair()
    tr = SocketTransport(a, name="eof")
    closes = []
    tr.on_close = lambda: closes.append(1)
    tr.start()
    b.close()  # peer vanishes
    deadline = time.time() + 5
    while not closes and time.time() < deadline:
        time.sleep(0.02)
    assert closes == [1]
    assert tr.join(timeout=5.0)
