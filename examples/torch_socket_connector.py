"""SocketConnector on the PyTorch port: a TCP transport on the
AbstractConnector base, carried by the port's session layer
(``yjs_tpu_torch.sync.session``).

The port's copy of ``examples/socket_connector.py``: each peer binds one
``Y.Doc`` to a length-prefixed TCP framing of the sync messages, riding
a :class:`~yjs_tpu_torch.sync.session.SyncSession` (ack-based
retransmission, heartbeat/liveness, backpressure coalescing, the
anti-entropy repair loop) over the port cluster's
:class:`~yjs_tpu_torch.cluster.rpc.SocketTransport`, whose ``close()``
drains the outbox and joins both threads.  Passing ``room=`` sends the
raw-dialect preamble (``yjs_tpu_torch.cluster.gateway``), which makes the
connector a client of the cluster gateway and of the gateway module's
:class:`~yjs_tpu_torch.cluster.gateway.ProviderHost`.

The ``--provider`` side this example adds is that host: a port
:class:`~yjs_tpu_torch.provider.TpuProvider` whose room tables live on
the CUDA device (``--device cpu`` runs the kernels' plain versions)
serves socket peers, one provider session a connection
(``provider.session(room, peer).connect(transport)``).  The transport's
threads only queue what arrives; every frame is handled, and every
kernel launched, on the thread that calls ``ProviderHost.pump``.

Run in two terminals (the first becomes the listener):

    python examples/torch_socket_connector.py server 47800
    python examples/torch_socket_connector.py client 47800

or with the provider as the listener, on the card (``--device cpu`` for
the CPU), and a client naming its room:

    python examples/torch_socket_connector.py server 47800 --provider
    python examples/torch_socket_connector.py client 47800 --room demo

Both processes make concurrent edits and print the converged text.  The
Doc-to-Doc flow runs the CPU core on both sides and does no device work;
only ``--provider`` places tables, and without ``--device cpu`` it wants
the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import yjs_tpu_torch as Y
from yjs_tpu_torch.cluster.gateway import ProviderHost, encode_room_preamble
from yjs_tpu_torch.cluster.rpc import SocketTransport
from yjs_tpu_torch.sync.session import DocSessionHost, SessionConfig, SyncSession
from yjs_tpu_torch.utils.abstract_connector import AbstractConnector

# seconds of wall time per session tick: with the default knobs that
# makes a heartbeat every ~0.4s, a liveness timeout after ~1.6s of
# silence, and first retransmission of a lost frame after ~0.1s
TICK_SECONDS = 0.05


class SocketConnector(AbstractConnector):
    """Bind one doc to one TCP peer through a resumable session.

    The Doc is NOT thread-safe; the transport delivers frames and the
    ticker thread drives the session under ``self.lock``, and local
    edits from other threads must take the same lock (see ``_demo``)."""

    def __init__(
        self, ydoc: Y.Doc, sock: socket.socket, awareness=None,
        config: SessionConfig | None = None,
        room: str | None = None, peer: str | None = None,
    ):
        super().__init__(ydoc, awareness)
        self._sock = sock
        #: guards every doc access (remote applies, local edits, reads)
        self.lock = threading.RLock()
        self._closed = False
        peer_name = peer or f"fd{sock.fileno()}"
        # the transport owns the rx/tx threads; inbound frames are
        # delivered under self.lock (the session is not thread-safe)
        self._transport = SocketTransport(
            sock, frame_lock=self.lock, name=peer_name
        )
        self.room = room
        self.session = SyncSession(
            DocSessionHost(ydoc, origin=self),
            config=config,
            peer=peer_name,
        )
        ydoc.on("update", self._on_local_update)
        self._ticker = threading.Thread(target=self._tick_loop, daemon=True)

    # -- sync flow ----------------------------------------------------------

    def connect(self) -> None:
        """Start the session handshake and the transport/ticker threads."""
        with self.lock:
            if self.room is not None:
                # the raw-dialect hello MUST be the first frame on the
                # wire; it is queued ahead of the HELLO that attach()
                # emits, and the drained-in-order tx thread keeps that
                self._transport.send(encode_room_preamble(
                    self.room, self.session.peer
                ))
            self.session.connect(self._transport)
            inner_close = self._transport.on_close
            def _closed(_cb=inner_close):
                if _cb is not None:
                    _cb()
                self.emit("close", [])
                self.on_disconnect("eof")
            self._transport.on_close = _closed
        self._transport.start()
        self._ticker.start()
        self.on_connect()

    def _on_local_update(self, update: bytes, origin, doc) -> None:
        if origin is self or self._closed:
            return  # don't echo remote updates back
        # the editor already holds self.lock (RLock: re-entry is fine)
        with self.lock:
            self.session.send_update(update)

    def _tick_loop(self) -> None:
        # session time advances on a fixed wall cadence; everything the
        # tick drives (retransmit backoff, heartbeats, liveness, the
        # anti-entropy digests) counts in these ticks
        while True:
            time.sleep(TICK_SECONDS)
            with self.lock:
                if self._closed:
                    break
                self.session.tick()

    def close(self) -> None:
        """Shutdown contract: stop the ticker, stop inbound delivery,
        then let the transport drain its outbox to the wire and JOIN
        both of its threads — nothing accepted before close is dropped.
        Frames the peer never acked stay in the session outbox for the
        next attach."""
        with self.lock:
            if self._closed:
                return
            self._closed = True
        self.doc.off("update", self._on_local_update)
        me = threading.current_thread()
        if self._ticker.is_alive() and self._ticker is not me:
            self._ticker.join(timeout=2.0)
        with self.lock:
            # no more inbound deliveries race the teardown; the rx
            # thread drains to EOF on its own
            self._transport.on_frame = None
        # session.close() closes the transport: drain outbox → join tx
        # → close socket → join rx → single on_close
        self.session.close()
        self.on_disconnect("closed")

    def join(self, timeout: float = 2.0) -> bool:
        """True when the ticker and both transport threads exited."""
        me = threading.current_thread()
        if self._ticker.is_alive() and self._ticker is not me:
            self._ticker.join(timeout=timeout)
        transport_done = self._transport.join(timeout=timeout)
        return transport_done and not (
            self._ticker.is_alive() and self._ticker is not me
        )


def _demo(role: str, port: int, room: str | None = None) -> None:
    doc = Y.Doc(gc=False)
    doc.client_id = 1 if role == "server" else 2
    text = doc.get_text("text")
    if role == "server":
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(1)
        text.insert(0, "listener says hi. ")
        conn, _ = srv.accept()
    else:
        conn = socket.create_connection(("127.0.0.1", port))
        text.insert(0, "joiner says hi. ")

    connector = SocketConnector(doc, conn, room=room)
    connector.connect()

    time.sleep(1.0)  # let the handshake settle
    with connector.lock:  # doc access shares the lock with the rx thread
        text.insert(len(text.to_string()), f"[{role} concurrent edit]")
    time.sleep(1.0)
    with connector.lock:
        print(f"{role}: {text.to_string()!r}")
        print(f"{role}: sv={Y.encode_state_vector(doc).hex()}")
        print(f"{role}: session={connector.session.snapshot()}")
    connector.close()


def _provider_demo(port: int, device: str | None, room: str = "demo",
                   seconds: float = 2.0) -> None:
    """The listener as a port provider: its own edit of ``room`` lands
    through ``receive_update``; socket peers edit the same room."""
    from yjs_tpu_torch.provider import TpuProvider

    provider = TpuProvider(8, device=device)
    host = ProviderHost(provider, tick_s=TICK_SECONDS)
    host.listen(port)
    edit = Y.Doc(gc=False)
    edit.client_id = 1
    edit.get_text("text").insert(0, "provider says hi. ")
    provider.receive_update(room, Y.encode_state_as_update(edit))
    # wait for the first peer, then serve it
    while not host.sessions:
        host.pump()
        time.sleep(0.01)
    host.serve(seconds)
    print(f"provider: {provider.text(room)!r}")
    print(f"provider: sv={provider.engine.encode_state_vector(provider.doc_id(room)).hex()}")
    print(f"provider: device={provider.engine.device}")
    for (g, peer), sess in sorted(host.sessions.items()):
        print(f"provider: session {g}/{peer}={sess.snapshot()}")
    host.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_socket_connector", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("role", choices=("server", "client"))
    ap.add_argument("port", nargs="?", type=int, default=47800)
    ap.add_argument("--provider", action="store_true",
                    help="server only: the listener is a port TpuProvider "
                         "serving session peers (clients pass --room)")
    ap.add_argument("--device", default=None,
                    help="with --provider: 'cpu' runs the kernels' plain "
                         "versions; by default the CUDA device, and no "
                         "card is an error")
    ap.add_argument("--room", default=None,
                    help="client: send the raw-dialect preamble for this "
                         "room (a --provider server or the cluster "
                         "gateway needs it); server --provider: the room "
                         "its own edit goes to (default 'demo')")
    args = ap.parse_args(argv)
    if args.provider:
        if args.role != "server":
            ap.error("--provider is the listener's side: use it with server")
        _provider_demo(args.port, args.device, args.room or "demo")
        return 0
    _demo(args.role, args.port, room=args.room)
    return 0


if __name__ == "__main__":
    sys.exit(main())
