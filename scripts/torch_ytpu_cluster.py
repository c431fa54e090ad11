#!/usr/bin/env python
"""Launch the PyTorch port's process-native cluster from the CLI.

Spawns N shard processes (``python -m yjs_tpu_torch.cluster.shard``)
under a :class:`~yjs_tpu_torch.cluster.Supervisor` and fronts them with
the y-websocket-compatible :class:`~yjs_tpu_torch.cluster.Gateway`, then
runs until SIGINT/SIGTERM.  ``--device`` places every shard's engine:
the CUDA device by default (each child is its own CUDA context on the
card, and a child that finds no CUDA device fails its spawn), or
``cpu`` for the kernels' plain PyTorch versions.  ``--backend`` defaults
to ``auto``, the provider's own default, so every room reaches the
engine; ``--backend cpu`` keeps rooms on the CPU core, as the JAX
launcher does by default.

Shape of a run::

    python scripts/torch_ytpu_cluster.py --shards 3 --gateway 8765 \
        --device cuda
    python scripts/torch_ytpu_cluster.py --config cluster.json
    python scripts/torch_ytpu_cluster.py --shards 1 --smoke --device cpu

``--config`` takes a **docker-compose-shaped** JSON file, so the same
topology description moves between this launcher and a real compose
deployment without translation::

    {
      "services": {
        "shard": {
          "deploy": {"replicas": 3},
          "environment": {"YTPU_CLUSTER_HEARTBEAT_S": "0.25"}
        },
        "gateway": {
          "ports": ["8765:8765"],
          "environment": {"YTPU_GATEWAY_TICK_S": "0.05"}
        }
      }
    }

``services.shard.deploy.replicas`` is the shard count,
``services.gateway.ports[0]`` ("HOST:CONTAINER" or a bare port) is the
gateway port, and each service's ``environment`` map is applied to
``os.environ`` before the ``YTPU_CLUSTER_*`` / ``YTPU_GATEWAY_*``
configs are constructed (shard children inherit it).  CLI flags win
over the config file.

``--smoke`` connects one raw-session client (:class:`SessionClient`,
the port's :class:`~yjs_tpu_torch.sync.session.SyncSession` over the
cluster's :class:`~yjs_tpu_torch.cluster.rpc.SocketTransport`) through
the gateway, makes an edit, waits for the acked round-trip, verifies
the text server-side, then curls every spawned process's admin plane
(``/healthz``, ``/statusz``, and a well-formed ``/metrics`` exposition
on the supervisor, each shard child, and the gateway), and exits 0/1.
:class:`WsClient` is the y-websocket dialect's client, for programs that
import this file.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_compose(cfg: dict) -> dict:
    """Flatten a docker-compose-shaped dict into launcher settings:
    ``{"shards": int | None, "gateway_port": int | None, "env": dict}``.
    Unknown services/keys are ignored (the file may drive a real
    compose deployment with more in it)."""
    out = {"shards": None, "gateway_port": None, "env": {}}
    services = cfg.get("services") or {}
    shard = services.get("shard") or {}
    deploy = shard.get("deploy") or {}
    if "replicas" in deploy:
        out["shards"] = int(deploy["replicas"])
    gateway = services.get("gateway") or {}
    ports = gateway.get("ports") or []
    if ports:
        # compose publishes "HOST:CONTAINER"; the host side is ours
        host_port = str(ports[0]).split(":", 1)[0]
        out["gateway_port"] = int(host_port)
    for svc in (shard, gateway):
        env = svc.get("environment") or {}
        if isinstance(env, list):  # compose's KEY=VALUE list form
            env = dict(e.split("=", 1) for e in env if "=" in e)
        out["env"].update({str(k): str(v) for k, v in env.items()})
    return out


import re

# a Prometheus exposition sample line: name{labels} value [timestamp]
_EXPO_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})?"
    r" [-+]?([0-9.eE+-]+|NaN|Inf)( [0-9]+)?$"
)


def _check_admin(name: str, base: str) -> list[str]:
    """Curl one process's admin plane: /healthz, /statusz, and a
    well-formed /metrics exposition.  Returns failure strings."""
    import urllib.request

    fails = []
    for ep in ("/healthz", "/statusz", "/metrics"):
        try:
            with urllib.request.urlopen(base + ep, timeout=10) as r:
                body = r.read().decode("utf-8", "replace")
                if r.status != 200:
                    fails.append(f"{name}{ep}: HTTP {r.status}")
                    continue
        except OSError as e:
            fails.append(f"{name}{ep}: {e}")
            continue
        if ep == "/statusz":
            try:
                json.loads(body)
            except ValueError:
                fails.append(f"{name}{ep}: malformed JSON")
        elif ep == "/metrics":
            bad = [
                ln for ln in body.splitlines()
                if ln and not ln.startswith("#")
                and not _EXPO_LINE.match(ln)
            ]
            if bad:
                fails.append(
                    f"{name}{ep}: malformed exposition: {bad[0]!r}"
                )
            if "ytpu_" not in body:
                fails.append(f"{name}{ep}: no ytpu_ families")
    return fails


def _smoke_admin(gw, sup) -> list[str]:
    """Hit every spawned process's admin endpoints: the supervisor,
    each shard child, and the gateway."""
    fails = []
    urls = dict(sup.admin_urls())
    if "supervisor" not in urls:
        fails.append("supervisor: admin plane not serving")
    want_shards = {f"shard-{r['shard']:03d}"
                   for r in sup.recovery_report()["shards"]}
    missing = want_shards - set(urls)
    fails.extend(f"{m}: admin plane not serving" for m in sorted(missing))
    if gw.admin is not None and gw.admin.port:
        urls["gateway"] = gw.admin.url
    else:
        fails.append("gateway: admin plane not serving")
    for name, base in sorted(urls.items()):
        fails.extend(_check_admin(name, base))
    return fails


class SessionClient:
    """One port :class:`~yjs_tpu_torch.core.Doc` bound to a cluster
    gateway room through the raw session dialect: the room preamble,
    then a :class:`~yjs_tpu_torch.sync.session.SyncSession` (acks,
    retransmission, BUSY backoff) over a
    :class:`~yjs_tpu_torch.cluster.rpc.SocketTransport`.

    The doc is not thread-safe: inbound frames and the session ticker
    run under ``self.lock``, and local edits must take it too."""

    def __init__(self, port: int, room: str, peer: str, doc=None,
                 host: str = "127.0.0.1", tick_s: float = 0.05,
                 config=None):
        import socket as socketlib
        import threading

        import yjs_tpu_torch as Y
        from yjs_tpu_torch.cluster.gateway import encode_room_preamble
        from yjs_tpu_torch.cluster.rpc import SocketTransport
        from yjs_tpu_torch.sync.session import DocSessionHost, SyncSession

        self.doc = doc if doc is not None else Y.Doc(gc=False)
        self.room = room
        self.tick_s = tick_s
        self.lock = threading.RLock()
        self._closed = threading.Event()
        sock = socketlib.create_connection((host, port), timeout=30)
        self._transport = SocketTransport(
            sock, frame_lock=self.lock, name=peer
        )
        self.session = SyncSession(
            DocSessionHost(self.doc, origin=self), config=config, peer=peer
        )
        self.doc.on("update", self._on_local_update)
        self._ticker = threading.Thread(
            target=self._tick_loop, name=f"ytpu-client-{peer}", daemon=True
        )
        with self.lock:
            # the preamble must be the first frame on the wire: it is
            # queued before the session's HELLO
            self._transport.send(encode_room_preamble(room, peer))
            self.session.connect(self._transport)
        self._transport.start()
        self._ticker.start()

    def _on_local_update(self, update: bytes, origin, doc) -> None:
        if origin is self or self._closed.is_set():
            return  # a remote update, or after close
        with self.lock:
            self.session.send_update(update)

    def _tick_loop(self) -> None:
        while not self._closed.wait(self.tick_s):
            with self.lock:
                self.session.tick()

    def text(self, name: str = "text") -> str:
        with self.lock:
            return self.doc.get_text(name).to_string()

    def close(self) -> None:
        """Stop the ticker, then drain the transport and join its
        threads; unacked frames stay in the session's outbox."""
        if self._closed.is_set():
            return
        self._closed.set()
        self.doc.off("update", self._on_local_update)
        if self._ticker.is_alive():
            self._ticker.join(timeout=2.0)
        with self.lock:
            self._transport.on_frame = None
        self.session.close()


class WsClient:
    """One port :class:`~yjs_tpu_torch.core.Doc` bound to a cluster
    gateway room through the y-websocket dialect (RFC 6455, v13.4.9
    sync frames): step 1 on connect, every local edit as an update
    frame, every inbound sync frame applied.  A reader thread applies
    inbound frames under ``self.lock``; local edits must take it too.
    The dialect has no acks: an edit the gateway refuses is not resent."""

    def __init__(self, port: int, room: str, doc=None,
                 host: str = "127.0.0.1"):
        import base64
        import socket as socketlib
        import threading

        import yjs_tpu_torch as Y
        from yjs_tpu_torch.cluster.gateway import ws_accept_key

        self.doc = doc if doc is not None else Y.Doc(gc=False)
        self.room = room
        self.lock = threading.RLock()
        self._send_lock = threading.Lock()
        self._closed = threading.Event()
        self.sock = socketlib.create_connection((host, port), timeout=30)
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        self.sock.sendall((
            f"GET /{room} HTTP/1.1\r\nHost: {host}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n"
        ).encode("ascii"))
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("websocket handshake: EOF")
            resp += chunk
        head, _, self._buf = resp.partition(b"\r\n\r\n")
        if b" 101 " not in head.split(b"\r\n")[0] + b" ":
            raise ConnectionError(f"websocket handshake refused: {head!r}")
        if ws_accept_key(key).encode() not in head:
            raise ConnectionError("websocket handshake: bad accept key")
        self.sock.settimeout(None)
        self.doc.on("update", self._on_local_update)
        self._reader = threading.Thread(
            target=self._read_loop, name=f"ytpu-ws-{room}", daemon=True
        )
        self._reader.start()
        with self.lock:
            self._send_sync(self._step1())

    def _step1(self) -> bytes:
        import yjs_tpu_torch as Y
        from yjs_tpu_torch.lib0 import encoding
        from yjs_tpu_torch.lib0.encoding import Encoder
        from yjs_tpu_torch.sync import protocol

        enc = Encoder()
        encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_1)
        encoding.write_var_uint8_array(enc, Y.encode_state_vector(self.doc))
        return enc.to_bytes()

    def _send_sync(self, inner: bytes) -> None:
        from yjs_tpu_torch.cluster.gateway import MESSAGE_SYNC
        from yjs_tpu_torch.lib0 import encoding
        from yjs_tpu_torch.lib0.encoding import Encoder

        enc = Encoder()
        encoding.write_var_uint(enc, MESSAGE_SYNC)
        payload = enc.to_bytes() + bytes(inner)
        mask = os.urandom(4)
        masked = bytes(b ^ mask[i & 3] for i, b in enumerate(payload))
        n = len(payload)
        if n < 126:
            hdr = bytes([0x82, 0x80 | n])
        elif n < 1 << 16:
            hdr = bytes([0x82, 0x80 | 126]) + n.to_bytes(2, "big")
        else:
            hdr = bytes([0x82, 0x80 | 127]) + n.to_bytes(8, "big")
        with self._send_lock:
            self.sock.sendall(hdr + mask + masked)

    def _on_local_update(self, update: bytes, origin, doc) -> None:
        if origin is self or self._closed.is_set():
            return
        from yjs_tpu_torch.lib0 import encoding
        from yjs_tpu_torch.lib0.encoding import Encoder
        from yjs_tpu_torch.sync import protocol

        enc = Encoder()
        encoding.write_var_uint(enc, protocol.MESSAGE_YJS_UPDATE)
        encoding.write_var_uint8_array(enc, update)
        try:
            self._send_sync(enc.to_bytes())
        except OSError:
            pass  # the connection is gone; the dialect has no resend

    def _recv_exact(self, n: int) -> bytes | None:
        while len(self._buf) < n:
            try:
                chunk = self.sock.recv(65536)
            except OSError:
                return None
            if not chunk:
                return None
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_loop(self) -> None:
        from yjs_tpu_torch.cluster.gateway import MESSAGE_SYNC
        from yjs_tpu_torch.lib0 import decoding
        from yjs_tpu_torch.lib0.decoding import Decoder
        from yjs_tpu_torch.lib0.encoding import Encoder
        from yjs_tpu_torch.sync import protocol

        while not self._closed.is_set():
            hdr = self._recv_exact(2)
            if hdr is None:
                return
            opcode, n = hdr[0] & 0x0F, hdr[1] & 0x7F
            if n == 126:
                ext = self._recv_exact(2)
                n = int.from_bytes(ext or b"", "big")
            elif n == 127:
                ext = self._recv_exact(8)
                n = int.from_bytes(ext or b"", "big")
            payload = self._recv_exact(n) if n else b""
            if payload is None or opcode == 0x8:
                return
            if opcode not in (0x1, 0x2):
                continue  # ping/pong: the gateway needs no answer
            dec = Decoder(payload)
            if decoding.read_var_uint(dec) != MESSAGE_SYNC:
                continue  # awareness traffic
            enc = Encoder()
            with self.lock:
                protocol.read_sync_message(dec, enc, self.doc, self)
            reply = enc.to_bytes()
            if reply:
                try:
                    self._send_sync(reply)
                except OSError:
                    return

    def text(self, name: str = "text") -> str:
        with self.lock:
            return self.doc.get_text(name).to_string()

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self.doc.off("update", self._on_local_update)
        try:
            self.sock.close()
        except OSError:
            pass
        self._reader.join(timeout=2.0)


def _smoke_launches(sup) -> dict:
    """Every live shard's kernel launch counts (the ``launches`` RPC),
    summed: ``apply_lanes`` above 0 shows the edit reached the engine
    on the card; with ``--device cpu`` or ``--backend cpu`` every count
    is 0."""
    total: dict = {}
    for row in sup.recovery_report()["shards"]:
        if row["state"] != "live":
            continue
        got = sup._client_of(row["shard"]).call("launches", {})
        for name, n in got["launches"].items():
            total[name] = total.get(name, 0) + int(n)
    return total


def _smoke(gw, sup) -> int:
    """One edit through the gateway's session dialect, verified
    server-side, plus an admin-plane probe of every process — exits
    nonzero unless both land."""
    room, text = "smoke-room", "cluster smoke ok"
    conn = SessionClient(gw.port, room, "smoke-client")
    doc = conn.doc
    try:
        with conn.lock:
            doc.get_text("text").insert(0, text)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                if sup.text(room) == text:
                    break
            except Exception:
                pass
            time.sleep(0.1)
        else:
            print("smoke: FAILED (edit never landed)", file=sys.stderr)
            return 1
        with conn.lock:
            snap = conn.session.snapshot()
        if snap.get("outbox_depth"):
            time.sleep(0.5)  # let the ack drain before judging
            with conn.lock:
                snap = conn.session.snapshot()
        admin_fails = _smoke_admin(gw, sup)
        if admin_fails:
            for f in admin_fails:
                print(f"smoke: admin FAILED {f}", file=sys.stderr)
            return 1
        launches = _smoke_launches(sup)
        print("smoke: launches " + json.dumps(launches, sort_keys=True))
        print(
            "smoke: OK room=%r text=%r outbox=%s admin=ok apply_lanes=%d"
            % (room, text, snap.get("outbox_depth"),
               launches.get("apply_lanes", 0))
        )
        return 0
    finally:
        conn.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--shards", type=int, default=None,
                    help="shard process count (default 3)")
    ap.add_argument("--gateway", type=int, default=None, metavar="PORT",
                    help="gateway TCP port (default 0 = ephemeral)")
    ap.add_argument("--config", default=None, metavar="FILE",
                    help="docker-compose-shaped JSON topology file")
    ap.add_argument("--wal-root", default=None, metavar="DIR",
                    help="per-shard WAL root (default: a temp dir)")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="federated snapshot dir for ytpu_top --cluster")
    ap.add_argument("--docs-per-shard", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="every shard's engine device (default: the "
                         "CUDA device; 'cpu' runs the plain kernels)")
    ap.add_argument("--backend", default="auto",
                    help="every shard provider's backend (default "
                         "'auto': rooms on the engine; 'cpu' keeps them "
                         "on the CPU core)")
    ap.add_argument("--smoke", action="store_true",
                    help="one edit round-trip through the gateway, "
                         "then exit 0/1")
    args = ap.parse_args(argv)

    shards, gw_port = args.shards, args.gateway
    if args.config:
        with open(args.config) as f:
            compose = parse_compose(json.load(f))
        os.environ.update(compose["env"])
        if shards is None:
            shards = compose["shards"]
        if gw_port is None:
            gw_port = compose["gateway_port"]
    shards = 3 if shards is None else shards
    if shards < 1:
        ap.error("--shards must be >= 1")

    # env must be settled before the configs read it
    from yjs_tpu_torch.cluster import (
        ClusterConfig, Gateway, GatewayConfig, Supervisor,
    )

    wal_root = args.wal_root or tempfile.mkdtemp(prefix="ytpu-cluster-")
    cconfig = ClusterConfig(
        snapshot_dir=args.snapshot_dir
        if args.snapshot_dir is not None else None,
    )
    gconfig = GatewayConfig(port=gw_port)

    sup = Supervisor(
        shards, wal_root, docs_per_shard=args.docs_per_shard,
        config=cconfig, backend=args.backend, device=args.device,
    ).start()
    gw = Gateway(sup, config=gconfig).start()
    print(
        "ytpu-cluster: %d shard(s) up, gateway on %s:%d, wal-root %s"
        % (shards, gw.config.host, gw.port, wal_root)
    )
    for row in sup.recovery_report()["shards"]:
        print(
            "  shard %(shard)d: %(state)s pid=%(pid)s port=%(port)s "
            "device=%(device)s" % row
        )

    if args.smoke:
        try:
            return _smoke(gw, sup)
        finally:
            gw.close()
            sup.close()

    stop = []
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.append(1))
    try:
        while not stop:
            time.sleep(0.25)
    finally:
        print("ytpu-cluster: shutting down")
        gw.close()
        sup.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
