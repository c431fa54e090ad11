"""The cases of the JAX package's ``tests/test_connector.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``), against
``examples/torch_socket_connector.py``.  The provider-host cases hold
``yjs_tpu_torch.cluster.gateway.ProviderHost`` (a port ``TpuProvider``
serving socket peers, every frame handled on the thread that pumps it,
the example's ``--provider`` side) to the same convergence contract.

AbstractConnector contract + the SocketConnector transport example
(reference src/utils/AbstractConnector.js:16-26; y-protocols sync flow)."""

import socket
import sys
import time
from pathlib import Path

import yjs_tpu_torch as Y
from yjs_tpu_torch.utils.abstract_connector import AbstractConnector

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
from torch_socket_connector import SocketConnector  # noqa: E402
from torch_service import TpuProvider  # noqa: E402
from yjs_tpu_torch.cluster.gateway import (  # noqa: E402
    ProviderHost,
    decode_room_preamble,
    encode_room_preamble,
)


def test_abstract_connector_contract():
    d = Y.Doc()
    c = AbstractConnector(d, awareness={"user": "x"})
    assert c.doc is d
    assert c.awareness == {"user": "x"}
    got = []
    c.on("synced", lambda v: got.append(v))
    c.emit("synced", [True])
    assert got == [True]
    # exported at the package root like the reference index.js contract
    assert Y.AbstractConnector is AbstractConnector


def test_socket_connector_two_peer_convergence():
    a_sock, b_sock = socket.socketpair()
    da = Y.Doc(gc=False)
    da.client_id = 1
    db = Y.Doc(gc=False)
    db.client_id = 2
    da.get_text("text").insert(0, "A-offline. ")
    db.get_text("text").insert(0, "B-offline. ")

    ca = SocketConnector(da, a_sock)
    cb = SocketConnector(db, b_sock)
    ca.connect()
    cb.connect()
    def texts():
        # doc reads share each connector's lock with its rx thread
        with ca.lock:
            ta = da.get_text("text").to_string()
        with cb.lock:
            tb = db.get_text("text").to_string()
        return ta, tb

    deadline = time.time() + 10
    while time.time() < deadline:
        ta, tb = texts()
        if ta == tb and ta != "":
            break
        time.sleep(0.05)
    ta, tb = texts()
    assert ta == tb, "handshake did not converge"

    # live incremental updates after the handshake (doc mutations share
    # the connector's doc lock with its receive thread)
    with ca.lock:
        da.get_text("text").insert(0, "[live-A]")
    with cb.lock:
        db.get_map("meta").set("k", 7)
    def maps():
        with ca.lock:
            ma = da.get_map("meta").to_json()
        with cb.lock:
            mb = db.get_map("meta").to_json()
        return ma, mb

    deadline = time.time() + 10
    while time.time() < deadline:
        ta, tb = texts()
        ma, mb = maps()
        if ta == tb and ma == mb:
            break
        time.sleep(0.05)
    ta, tb = texts()
    ma, mb = maps()
    assert ta == tb
    assert ma == mb == {"k": 7}
    ca.close()
    cb.close()


def test_socket_connector_close_joins_threads_without_dropping_frames():
    """The satellite-1 shutdown pin: ``close()`` drains every frame the
    session handed the transport before the FIN hits the wire, and the
    ticker plus both transport threads JOIN — no leaked threads, no
    dropped unacked frames."""
    a_sock, b_sock = socket.socketpair()
    da = Y.Doc(gc=False)
    da.client_id = 1
    db = Y.Doc(gc=False)
    db.client_id = 2

    ca = SocketConnector(da, a_sock)
    cb = SocketConnector(db, b_sock)
    ca.connect()
    cb.connect()
    deadline = time.time() + 10
    while time.time() < deadline:
        with ca.lock:
            live = ca.session.state == "live"
        if live:
            break
        time.sleep(0.02)
    with ca.lock:
        assert ca.session.state == "live"

    # edit, then close immediately: the DATA frame is in the transport
    # outbox, not yet on the wire — close must flush it, not drop it
    with ca.lock:
        da.get_text("text").insert(0, "final words")
    ca.close()

    assert ca.join(timeout=5.0), "connector threads did not join on close"
    assert not ca._transport._tx.is_alive()
    assert not ca._transport._rx.is_alive()
    assert not ca._ticker.is_alive()
    assert ca._transport.queued == 0, "close dropped queued frames"

    # the peer (still open) receives the pre-close frame
    deadline = time.time() + 10
    while time.time() < deadline:
        with cb.lock:
            tb = db.get_text("text").to_string()
        if tb == "final words":
            break
        time.sleep(0.05)
    assert tb == "final words", f"peer saw {tb!r}"
    cb.close()
    assert cb.join(timeout=5.0)


# -- the port's provider side ---------------------------------------------------


def test_room_preamble_round_trips():
    assert decode_room_preamble(encode_room_preamble("room-7", "alice")) == (
        "room-7", "alice",
    )


def _pump_until(host, cond, seconds=15.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        host.pump()
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def test_provider_host_serves_socket_clients_on_the_pumping_thread():
    """Two socket clients in two rooms of one port provider: both
    converge with the provider's own edit, every session frame is
    handled on the test's thread (the one that pumps), and a client's
    close leaves the provider's room intact."""
    import threading

    prov = TpuProvider(4, backend="auto")
    seen_threads = set()
    inner = prov.handle_sync_message

    def spy(guid, frame):
        seen_threads.add(threading.get_ident())
        return inner(guid, frame)

    prov.handle_sync_message = spy
    host = ProviderHost(prov)
    port = host.listen(0)
    edit = Y.Doc(gc=False)
    edit.client_id = 1
    edit.get_text("text").insert(0, "server. ")
    prov.receive_update("r0", Y.encode_state_as_update(edit))
    clients = []
    for k, room in enumerate(("r0", "r1")):
        d = Y.Doc(gc=False)
        d.client_id = 10 + k
        d.get_text("text").insert(0, f"client {k}. ")
        sock = socket.create_connection(("127.0.0.1", port))
        c = SocketConnector(d, sock, room=room, peer=f"c{k}")
        c.connect()
        clients.append((room, d, c))

    def converged():
        for room, d, c in clients:
            with c.lock:
                t = d.get_text("text").to_string()
            if t != prov.text(room) or c.session.state != "live":
                return False
        return True

    assert _pump_until(host, converged), [
        (prov.text(r), d.get_text("text").to_string()) for r, d, _ in clients
    ]
    assert "server." in prov.text("r0") and "client 0." in prov.text("r0")
    assert prov.text("r1") == "client 1. "
    assert seen_threads == {threading.get_ident()}
    assert sorted(host.sessions) == [("r0", "c0"), ("r1", "c1")]
    # a live edit after the handshake reaches the provider
    room, d, c = clients[1]
    with c.lock:
        d.get_text("text").insert(0, "[live]")
    assert _pump_until(host, lambda: prov.text("r1").startswith("[live]"))
    for _room, _d, c in clients:
        c.close()
        assert c.join(timeout=5.0)
    host.close()
    assert prov.text("r1") == "[live]client 1. "


def test_provider_host_without_a_card_raises():
    import pytest
    import torch

    from yjs_tpu_torch.ops._cuda import KernelError
    from yjs_tpu_torch.provider import TpuProvider as CardProvider

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card's provider builds")
    with pytest.raises(KernelError):
        ProviderHost(CardProvider(2))
