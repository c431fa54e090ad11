"""Supervisor: spawn, monitor, restart, and fail over real shard
processes.

The supervisor owns the cluster's control plane in the gateway process:

- **Topology** — the fleet's :class:`HashRing` + versioned
  :class:`RoutingTable` place rooms on shard ids exactly as the
  in-process :class:`FleetRouter` does; the data plane just crosses a
  socket now (``cluster/rpc.py``) instead of a method call.
- **Supervision** — a monitor thread watches every child with
  ``proc.poll()`` (a ``kill -9`` is visible immediately) plus an RPC
  heartbeat probe for hangs.  A dead shard restarts into the SAME WAL
  directory through ``TpuProvider.recover`` — journaled (= acked)
  updates replay, resume floors re-arm — up to
  ``YTPU_CLUSTER_RESTART_MAX`` times; past the budget the shard is
  declared lost and its rooms fail over to the ring-walk successor,
  whose WAL holds the journal-only replica records (replication fan-out
  over RPC) and materializes them by a recover-restart.  Either way the
  routing epoch bumps and ``on_epoch`` fires so the gateway rehomes
  live sessions (digest → targeted repair, not full resync).
- **Recovery report** — every restart/failover appends a
  structured event: per-shard outcome (``recovered`` / ``fenced`` /
  ``aborted`` / ``failover``), replay counts from the shard's ready
  line, and the ownership resolution (completed/aborted migrations,
  fenced stale claims).  ``recovery_report()`` returns the merged view
  ``ytpu_top --cluster`` renders; ``dump_snapshots()`` writes it next
  to the per-shard metric snapshots for the federated dashboard
  (``obs/federate.py`` file-drop format).

While a shard is down, calls targeting its rooms raise
:class:`RpcBusy` — the gateway session replies with the session layer's BUSY
envelope, the peer keeps the frame in its outbox, and zero acked
updates are lost across the outage window.

``device`` places every shard child's engine: each child runs
``python -m yjs_tpu_torch.cluster.shard --device D``, at start, at a
restart and at a successor's recover-restart alike.  ``None`` (the
default) is the CUDA device, and a child that finds none fails its
spawn; ``device="cpu"`` runs the kernels' plain PyTorch versions in
every child.  On one card every child is its own CUDA context on that
card.  Each child's ready line reports the device it took, kept in
``recovery_report()``'s shard rows.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

from ..fleet.hashring import HashRing, RoutingTable
from ..lib0 import decoding
from ..lib0.decoding import Decoder
from ..obs import dist as obs_dist
from ..obs import global_registry
from ..obs.expo import registry_snapshot
from ..obs.federate import federate_snapshots
from ..obs.slo import ConvergenceTracker
from ..persistence import KIND_UPDATE
from ..sync import protocol
from .config import ClusterConfig
from .rpc import RpcBusy, RpcClient, RpcClosed, RpcError, b64d, b64e

READY_PREFIX = "YTPU_SHARD_READY "


class _ShardProc:
    """Supervisor-side record of one shard child process."""

    __slots__ = (
        "shard_id", "wal_dir", "proc", "port", "pid", "client",
        "restarts", "state", "recovery", "probe_fails", "admin_port",
        "device",
    )

    def __init__(self, shard_id: int, wal_dir: str):
        self.shard_id = shard_id
        self.wal_dir = wal_dir
        self.proc = None
        self.port = 0
        self.pid = 0
        self.client = None
        self.restarts = 0
        self.state = "starting"  # starting|live|restarting|lost
        self.recovery = {}
        self.probe_fails = 0  # consecutive unanswered heartbeat probes
        self.admin_port = 0  # the child's introspection-plane port
        self.device = ""  # the engine's device, from the ready line

    def row(self) -> dict:
        return {
            "shard": self.shard_id,
            "state": self.state,
            "pid": self.pid,
            "port": self.port,
            "admin_port": self.admin_port,
            "device": self.device,
            "restarts": self.restarts,
            "outcome": self.recovery.get("outcome", ""),
            "records_applied": self.recovery.get("records_applied", 0),
        }


class _ClusterMetrics:
    """``ytpu_cluster_*`` supervision families (process-global)."""

    def __init__(self):
        reg = global_registry()
        self.restarts = reg.counter(
            "ytpu_cluster_restarts_total",
            "Shard process restarts, by outcome (recovered = WAL "
            "replayed; failover = replica successor promoted)",
            labelnames=("outcome",),
        )
        self.shards_live = reg.gauge(
            "ytpu_cluster_shards_live",
            "Shard processes currently serving RPC",
        )
        self.resolutions = reg.counter(
            "ytpu_cluster_resolutions_total",
            "Per-room ownership resolutions after a restart/failover "
            "(completed/aborted migrations, fenced stale claims)",
            labelnames=("kind",),
        )
        self.unavailable_s = reg.gauge(
            "ytpu_cluster_unavailable_seconds",
            "Length of the last shard outage window (death detected "
            "to serving again)",
        )


class Supervisor:
    """Process-per-shard fleet behind the FleetRouter-shaped facade
    (see module docstring)."""

    def __init__(
        self,
        n_shards: int,
        wal_root: str,
        docs_per_shard: int = 64,
        config: ClusterConfig | None = None,
        backend: str = "auto",
        shard_tick_s: float = 0.05,
        device=None,
    ):
        self.config = config if config is not None else ClusterConfig()
        self.wal_root = str(wal_root)
        self.docs_per_shard = docs_per_shard
        self.backend = backend
        self.device = "cuda" if device is None else str(device)
        self.shard_tick_s = shard_tick_s
        self.ring = HashRing(range(n_shards))
        self.table = RoutingTable()
        self.slo = ConvergenceTracker(global_registry())
        self.metrics = _ClusterMetrics()
        self._lock = threading.RLock()
        self._shards: dict[int, _ShardProc] = {
            k: _ShardProc(
                k, os.path.join(self.wal_root, f"shard-{k:03d}")
            )
            for k in range(n_shards)
        }
        self._events: list[dict] = []
        self._stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="ytpu-supervisor", daemon=True
        )
        # shard events re-dispatch on a dedicated thread: the RPC rx
        # thread must never block on a subscriber lock, or it starves
        # the responses that subscriber's own call() is waiting for
        self._evt_q: list[tuple[str, bytes]] = []
        self._evt_wake = threading.Condition()
        self._evt_thread = threading.Thread(
            target=self._evt_loop, name="ytpu-supervisor-evt", daemon=True
        )
        self.on_update = None  # callable(guid: str, update: bytes)
        self.on_epoch = None   # callable(epoch: int, shards: list[int])
        # inter-region replication: a GeoReplicator attached
        # via attach_geo is ticked by the monitor loop and fed routing-
        # epoch bumps so WAN links rehome when a shard fails over
        self.geo = None
        # the supervisor's own introspection plane: serves
        # the FEDERATED cluster view at /metrics.json, so one scrape of
        # the supervisor renders the whole cluster
        self.admin = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Supervisor":
        from ..obs.admin import AdminServer

        with self._lock:
            shards = list(self._shards.values())
        for sp in shards:
            self._spawn(sp)
        self._monitor.start()
        self._evt_thread.start()
        try:
            self.admin = AdminServer(self, role="supervisor").start()
        except OSError:
            self.admin = None
        return self

    def _spawn(self, sp: _ShardProc) -> None:
        """Start (or re-start) one shard child and connect its RPC."""
        os.makedirs(sp.wal_dir, exist_ok=True)
        cmd = [
            sys.executable, "-m", "yjs_tpu_torch.cluster.shard",
            "--id", str(sp.shard_id),
            "--wal-dir", sp.wal_dir,
            "--docs", str(self.docs_per_shard),
            "--host", self.config.host,
            "--port", "0",
            "--backend", self.backend,
            "--device", self.device,
            "--tick-s", str(self.shard_tick_s),
            # every child gets an ephemeral admin port: a fixed
            # YTPU_ADMIN_PORT in the supervisor's env must not make N
            # children fight over one socket (YTPU_ADMIN_DISABLED=1
            # still turns the plane off)
            "--admin-port", "0",
        ]
        env = dict(os.environ)
        proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
            env=env,
        )
        ready = self._read_ready(proc)
        client = RpcClient(
            self.config.host,
            ready["port"],
            timeout=self.config.rpc_timeout_s,
        )
        client.on_event = self._on_shard_event
        with self._lock:
            sp.proc = proc
            sp.port = ready["port"]
            sp.pid = ready["pid"]
            sp.client = client
            sp.recovery = ready.get("recovery") or {}
            sp.admin_port = int(ready.get("admin_port") or 0)
            sp.device = str(ready.get("device") or "")
            sp.state = "live"
            sp.probe_fails = 0
            live = sum(
                1 for s in self._shards.values() if s.state == "live"
            )
        self.metrics.shards_live.set(live)

    def _read_ready(self, proc) -> dict:
        """The ready line, under a real deadline, from a thread that
        then owns the child's stdout for its whole lifetime.

        A plain ``readline()`` would block past ``spawn_timeout_s`` on
        a child that starts but never prints (hung import), wedging the
        caller — which during a restart is the monitor thread, i.e. all
        supervision.  And once ready, the pipe still needs a reader:
        stdout chatter from the shard or its libraries would otherwise
        fill the 64KB pipe buffer and block the shard process."""
        slot: list = []
        got = threading.Event()

        def _pump(out=proc.stdout):
            try:
                for line in out:
                    if not got.is_set() and line.startswith(READY_PREFIX):
                        try:
                            slot.append(
                                json.loads(line[len(READY_PREFIX):])
                            )
                        except ValueError:
                            pass
                        got.set()
                    # post-ready lines: drained and discarded
            except (OSError, ValueError):
                pass
            finally:
                got.set()  # EOF before ready: wake the waiter now

        threading.Thread(
            target=_pump,
            name=f"ytpu-shard-stdout-{proc.pid}",
            daemon=True,
        ).start()
        got.wait(self.config.spawn_timeout_s)
        if slot:
            return slot[0]
        if got.is_set():
            # EOF without a ready line: the child is on its way out —
            # reap it so the error carries the real exit code
            try:
                rc = proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                rc = None
            if rc is not None:
                raise RuntimeError(
                    f"shard process exited before ready (rc={rc})"
                )
        proc.kill()
        proc.wait()
        raise RuntimeError("shard ready line timed out")

    def close(self) -> None:
        self._stop.set()
        if self.admin is not None:
            self.admin.close()
            self.admin = None
        with self._evt_wake:
            self._evt_wake.notify_all()
        if self._monitor.is_alive():
            self._monitor.join(timeout=5.0)
        if self._evt_thread.is_alive():
            self._evt_thread.join(timeout=5.0)
        with self._lock:
            shards = list(self._shards.values())
        for sp in shards:
            client, proc = sp.client, sp.proc
            if client is not None and client.alive:
                try:
                    client.call("shutdown", timeout=2.0)
                except RpcError:
                    pass
                client.close()
            if proc is not None and proc.poll() is None:
                try:
                    proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    proc.terminate()
                    try:
                        proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()

    # -- routing -------------------------------------------------------------

    def owner_of(self, guid: str) -> int:
        with self._lock:
            k = self.table.lookup(guid)
            if k is None:
                k = self.ring.owner(guid)
                self.table.assign(guid, k)
            return k

    def replica_of(self, guid: str) -> int | None:
        """Ring-walk successor after the owner."""
        with self._lock:
            owner = self.owner_of(guid)
            for k in self.ring.walk(guid):
                if k != owner:
                    return k
            return None

    @property
    def epoch(self) -> int:
        with self._lock:
            return self.table.epoch

    def _client_of(self, k: int):
        with self._lock:
            sp = self._shards.get(k)
            if sp is None:
                raise RpcError(f"no shard {k}")
            if sp.state != "live" or sp.client is None:
                raise RpcBusy(self.config.busy_retry_ticks)
            return sp.client

    def _call(self, k: int, method: str, payload: dict) -> dict:
        """One routed RPC; a dead/mid-restart shard surfaces as BUSY so
        session peers hold and retransmit instead of losing frames."""
        client = self._client_of(k)
        try:
            return client.call(method, payload)
        except RpcBusy:
            raise
        except (RpcClosed, RpcError):
            # connection died mid-call (the kill window): the monitor
            # restarts the shard; meanwhile the room is backpressured
            raise RpcBusy(self.config.busy_retry_ticks)

    # -- data-plane ingress seams -------------------------------------------

    def receive_update(self, guid: str, update: bytes, v2: bool = False,
                       internal: bool = False) -> bool:
        """Cluster ingress for one room update: adopts-or-mints the
        trace, stamps the gateway-side convergence SLO (the e2e
        number ``bench_cluster`` reports), routes to the owner shard
        over RPC, and fans a replica record to the ring successor
        (fleet replication over sockets)."""
        ctx = obs_dist.current_context() or obs_dist.mint_for_update(
            bytes(update)
        )
        with obs_dist.use_context(ctx):
            key = self.slo.receive(update, v2=v2, guid=guid, trace=ctx)
            k = self.owner_of(guid)
            try:
                body = self._call(k, "update", {
                    "guid": guid,
                    "update": b64e(update),
                    "v2": bool(v2),
                    "internal": bool(internal),
                })
            except RpcBusy:
                self.slo.rejected(key)
                raise
            accepted = bool(body.get("accepted"))
            if accepted:
                self.slo.integrated(key)
                self._fan_replica(guid, update, v2)
            else:
                self.slo.rejected(key)
            return accepted

    def handle_sync_message(self, guid: str, message: bytes) -> bytes | None:
        """Cluster ingress for one v13.4.9 sync frame: update/step-2
        payloads stamp the gateway-side SLO, then the whole frame
        forwards to the owner shard's own ``handle_sync_message`` seam
        (validation, WAL, admission — unchanged semantics)."""
        ctx = obs_dist.current_context()
        key = None
        inner = self._frame_update_payload(message)
        if inner is not None:
            if ctx is None:
                ctx = obs_dist.mint_for_update(inner)
            key = self.slo.receive(inner, guid=guid, trace=ctx)
        with obs_dist.use_context(ctx):
            k = self.owner_of(guid)
            try:
                body = self._call(k, "sync", {
                    "guid": guid, "frame": b64e(message),
                })
            except RpcBusy:
                if key is not None:
                    self.slo.rejected(key)
                raise
            if key is not None:
                self.slo.integrated(key)
            if inner is not None:
                self._fan_replica(guid, inner, False)
            reply = body.get("reply")
            return b64d(reply) if reply else None

    @staticmethod
    def _frame_update_payload(message: bytes) -> bytes | None:
        """The update payload of a step-2/update sync frame (the SLO
        unit), or ``None`` for step-1/envelope/unknown frames."""
        try:
            dec = Decoder(bytes(message))
            t = decoding.read_var_uint(dec)
            if t in (
                protocol.MESSAGE_YJS_SYNC_STEP_2,
                protocol.MESSAGE_YJS_UPDATE,
            ):
                return decoding.read_var_uint8_array(dec)
        except Exception:
            return None
        return None

    def _fan_replica(self, guid: str, update: bytes, v2: bool) -> None:
        """Journal one replica record on the ring successor's WAL
        (best-effort: replication is a durability bonus on top of the
        owner's own WAL, never a request blocker)."""
        r = self.replica_of(guid)
        if r is None:
            return
        try:
            self._call(r, "repl_record", {
                "kind": KIND_UPDATE,
                "guid": guid,
                "payload": b64e(update),
                "v2": bool(v2),
            })
        except RpcError:
            pass

    # -- read/session facade -------------------------------------------------

    def state_vector_bytes(self, guid: str) -> bytes:
        return b64d(self._call(
            self.owner_of(guid), "sv", {"guid": guid}
        )["sv"])

    def diff_update(self, guid: str, sv: bytes | None) -> bytes:
        return b64d(self._call(self.owner_of(guid), "diff", {
            "guid": guid, "sv": b64e(sv) if sv else None,
        })["update"])

    def text(self, guid: str) -> str:
        return self._call(
            self.owner_of(guid), "text", {"guid": guid}
        )["text"]

    def flush(self, guid: str | None = None) -> None:
        if guid is not None:
            self._call(self.owner_of(guid), "flush", {})
            return
        with self._lock:
            ids = [
                sp.shard_id for sp in self._shards.values()
                if sp.state == "live"
            ]
        for k in ids:
            try:
                self._call(k, "flush", {})
            except RpcError:
                pass

    def journal_ack(self, guid: str, peer: str, sid: int, seq: int) -> None:
        """Durable resume floor on the owner's WAL (best-effort: a
        missed floor costs a resume, never data)."""
        try:
            self._call(self.owner_of(guid), "journal_ack", {
                "guid": guid, "peer": peer, "sid": sid, "seq": seq,
            })
        except RpcError:
            pass

    def _on_shard_event(self, topic: str, payload: dict) -> None:
        if topic != "update":
            return
        try:
            item = (payload["guid"], b64d(payload["update"]))
        except (KeyError, ValueError):
            return
        with self._evt_wake:
            self._evt_q.append(item)
            self._evt_wake.notify()

    def _evt_loop(self) -> None:
        while True:
            with self._evt_wake:
                while not self._evt_q and not self._stop.is_set():
                    self._evt_wake.wait()
                if not self._evt_q and self._stop.is_set():
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

    # -- geo replication ------------------------------------------

    def attach_geo(self, replicator) -> None:
        """Join this cluster into a geo mesh: the replicator (a
        :class:`yjs_tpu_torch.geo.GeoReplicator` built over this supervisor
        facade) is driven from the monitor loop — one geo tick per
        heartbeat interval — and fencing epochs follow routing-epoch
        bumps via the replicator's own ``epoch`` poll."""
        self.geo = replicator

    def _geo_tick(self) -> None:
        rep = self.geo
        if rep is None:
            return
        try:
            rep.tick()
        except Exception:
            pass  # a WAN-side fault must never stall shard supervision

    # -- supervision ---------------------------------------------------------

    def _monitor_loop(self) -> None:
        next_snap = time.monotonic() + self.config.snapshot_s
        # the hang lane: a shard whose process is alive and socket open
        # but which stopped serving (e.g. deadlocked under its provider
        # lock) is invisible to poll()/alive — only an unanswered
        # heartbeat RPC convicts it.  Probes run at a coarser cadence
        # than the poll loop; each one blocks this thread for at most
        # probe_timeout_s.
        probe_every = max(
            self.config.heartbeat_s, self.config.probe_timeout_s / 2.0
        )
        next_probe: dict[int, float] = {}
        while not self._stop.wait(self.config.heartbeat_s):
            self._geo_tick()
            if self.config.snapshot_dir and time.monotonic() >= next_snap:
                next_snap = time.monotonic() + self.config.snapshot_s
                try:
                    self.dump_snapshots()
                except (OSError, ValueError):
                    pass
            with self._lock:
                shards = list(self._shards.values())
            for sp in shards:
                with self._lock:
                    live = sp.state == "live"
                    proc = sp.proc
                if not live or proc is None:
                    continue
                dead = proc.poll() is not None
                if not dead:
                    client = sp.client
                    dead = client is None or not client.alive
                if (
                    not dead
                    and time.monotonic()
                    >= next_probe.get(sp.shard_id, 0.0)
                ):
                    next_probe[sp.shard_id] = (
                        time.monotonic() + probe_every
                    )
                    dead = not self._probe(sp)
                if dead and not self._stop.is_set():
                    self._handle_death(sp)

    def _probe(self, sp: _ShardProc) -> bool:
        """One heartbeat RPC against a live-looking shard; False means
        hung.  Two consecutive unanswered probes (timeout or connection
        loss) convict — a remote *error* is still an answer, and one
        slow response (checkpoint, first-flush compile) gets a second
        chance before a restart is forced."""
        client = sp.client
        if client is None:
            return False
        try:
            client.call("heartbeat", timeout=self.config.probe_timeout_s)
        except RpcClosed:
            sp.probe_fails += 1
            return sp.probe_fails < 2
        except RpcError:
            pass
        sp.probe_fails = 0
        return True

    def _handle_death(self, sp: _ShardProc) -> None:
        """Restart through recover, or fail over past the budget."""
        t0 = time.monotonic()
        with self._lock:
            if sp.state != "live":
                return
            sp.state = "restarting"
            restarts = sp.restarts = sp.restarts + 1
            budget_left = restarts <= self.config.restart_max
        old_client = sp.client
        if old_client is not None:
            old_client.close()
        if budget_left:
            time.sleep(self.config.restart_backoff_s)
            try:
                self._spawn(sp)
            except (RpcError, RuntimeError, OSError):
                with self._lock:
                    sp.state = "live"  # re-enter death handling
                return
            resolution = self._resolve_after_restart(sp)
            self.metrics.restarts.labels(outcome="recovered").inc()
            event = {
                "event": "restart",
                "shard": sp.shard_id,
                "outcome": "recovered",
                "restarts": restarts,
                "recovery": sp.recovery,
                "resolution": resolution,
            }
        else:
            event = self._fail_over(sp)
        dt = time.monotonic() - t0
        self.metrics.unavailable_s.set(dt)
        with self._lock:
            epoch = self.table.bump()
            event["epoch"] = epoch
            event["unavailable_s"] = round(dt, 4)
            self._events.append(event)
        # publish the post-resolution epoch to every live shard: a
        # fenced restartee saw epoch E in its demotion frames and is
        # reporting /readyz 503 until this push tells it E+1 is current
        # (fencing-epoch readiness)
        self._broadcast_epoch(epoch)
        cb = self.on_epoch
        if cb is not None:
            try:
                cb(epoch, [sp.shard_id])
            except Exception:
                pass

    def _broadcast_epoch(self, epoch: int) -> None:
        with self._lock:
            ids = [
                sp.shard_id for sp in self._shards.values()
                if sp.state == "live"
            ]
        for k in ids:
            try:
                self._call(k, "epoch", {"epoch": int(epoch)})
            except RpcError:
                pass  # a shard mid-restart learns it on the next bump

    def _resolve_after_restart(self, sp: _ShardProc) -> dict:
        """Mirror ``FleetRouter.recover``'s ownership resolution across
        processes: complete or abort the restarted shard's pending
        migration intents, and fence any room claim the routing table
        reassigned (at a higher epoch) during the outage."""
        out = {"completed": 0, "aborted": 0, "fenced": 0}
        pending = list(sp.recovery.get("migrations_pending") or [])
        for guid in pending:
            with self._lock:
                dst = self.table.lookup(guid)
            if dst is None or dst == sp.shard_id:
                out["aborted"] += 1
                self.metrics.resolutions.labels(kind="aborted").inc()
                continue
            try:
                dst_guids = self._call(dst, "guids", {})["guids"]
                if guid in dst_guids:
                    final = b64d(self._call(
                        sp.shard_id, "release", {"guid": guid}
                    )["update"])
                    self._call(dst, "update", {
                        "guid": guid, "update": b64e(final),
                        "internal": True,
                    })
                    out["completed"] += 1
                    self.metrics.resolutions.labels(
                        kind="completed"
                    ).inc()
                else:
                    out["aborted"] += 1
                    self.metrics.resolutions.labels(kind="aborted").inc()
            except RpcError:
                out["aborted"] += 1
                self.metrics.resolutions.labels(kind="aborted").inc()
        # fencing: rooms this shard still holds but the table moved to
        # another owner while it was dead (failover won the race) —
        # fold the stale copy into the new owner and release it
        try:
            held = self._call(sp.shard_id, "guids", {})["guids"]
        except RpcError:
            held = []
        for guid in held:
            with self._lock:
                owner = self.table.lookup(guid)
            if owner is None or owner == sp.shard_id:
                continue
            try:
                final = b64d(self._call(
                    sp.shard_id, "release", {"guid": guid}
                )["update"])
                self._call(owner, "update", {
                    "guid": guid, "update": b64e(final), "internal": True,
                })
                self._call(sp.shard_id, "journal_repl_role", {
                    "guid": guid, "role": "replica",
                    "epoch": self.epoch, "primary": owner,
                })
                out["fenced"] += 1
                self.metrics.resolutions.labels(kind="fenced").inc()
            except RpcError:
                pass
        return out

    def _fail_over(self, sp: _ShardProc) -> dict:
        """Permanent shard loss: promote the ring successor by a
        recover-restart (its WAL materializes the journal-only replica
        records), reassign the dead shard's rooms, and fence the loser
        out of the ring."""
        with self._lock:
            self.ring.remove(sp.shard_id)
            sp.state = "lost"
            moved = self.table.docs_on(sp.shard_id)
            successors = {
                guid: next(iter(self.ring.walk(guid)), None)
                for guid in moved
            }
            live = sum(
                1 for s in self._shards.values() if s.state == "live"
            )
        self.metrics.shards_live.set(live)
        promote_on = sorted(
            {k for k in successors.values() if k is not None}
        )
        for k in promote_on:
            with self._lock:
                succ = self._shards.get(k)
                ok = succ is not None and succ.state == "live"
            if not ok:
                continue
            # graceful recover-restart of the successor: replica
            # KIND_UPDATE records replay into its engine (promotion by
            # materialization)
            client = succ.client
            try:
                if client is not None:
                    client.call("shutdown", timeout=2.0)
            except RpcError:
                pass
            if client is not None:
                client.close()
            proc = succ.proc
            if proc is not None:
                try:
                    proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    proc.terminate()
                    proc.wait(timeout=5.0)
            self._spawn(succ)
        promoted = 0
        with self._lock:
            epoch = self.table.epoch + 1
        for guid, k in sorted(successors.items()):
            if k is None:
                continue
            with self._lock:
                self.table.assign(guid, k)
            try:
                self._call(k, "journal_repl_role", {
                    "guid": guid, "role": "primary", "epoch": epoch,
                })
                promoted += 1
            except RpcError:
                pass
        self.metrics.restarts.labels(outcome="failover").inc()
        return {
            "event": "failover",
            "shard": sp.shard_id,
            "outcome": "failover",
            "restarts": sp.restarts,
            "promoted": promoted,
            "successors": {g: k for g, k in successors.items()},
            "recovery": sp.recovery,
            "resolution": {"completed": 0, "aborted": 0, "fenced": 0},
        }

    # -- observability (recovery report + federation) ----------------------

    def heartbeat(self, k: int) -> dict:
        return self._call(k, "heartbeat", {})

    def recovery_report(self) -> dict:
        """One structured per-shard view of everything supervision did
        (the shape ``ytpu_top --cluster`` renders and
        ``FleetRouter.recovery_report`` mirrors in-process)."""
        with self._lock:
            rows = [
                self._shards[k].row() for k in sorted(self._shards)
            ]
            events = list(self._events)
            epoch = self.table.epoch
        outcomes = {"recovered": 0, "failover": 0}
        totals = {"completed": 0, "aborted": 0, "fenced": 0}
        for ev in events:
            outcomes[ev["outcome"]] = outcomes.get(ev["outcome"], 0) + 1
            for kind, n in (ev.get("resolution") or {}).items():
                totals[kind] = totals.get(kind, 0) + n
        return {
            "kind": "cluster",
            "epoch": epoch,
            "shards": rows,
            "events": events,
            "outcomes": outcomes,
            "resolution": totals,
        }

    def scrape_sources(self) -> list[dict]:
        """One federation source per shard, scraped over the admin
        plane's HTTP ``/metrics.json`` with the RPC
        ``metrics`` call as fallback for admin-disabled children.  A
        dead/hung shard yields a stale-marked empty source under the
        per-target ``scrape_timeout_s`` — partial failure renders as a
        blank row, never a federation error."""
        from ..obs.federate import scrape_endpoints

        with self._lock:
            targets = [
                (k, self._shards[k].admin_port, self._shards[k].state)
                for k in sorted(self._shards)
            ]
        sources = []
        for k, admin_port, state in targets:
            label = f"shard-{k:03d}"
            if admin_port:
                src = scrape_endpoints(
                    [f"http://{self.config.host}:{admin_port}"],
                    timeout_s=self.config.scrape_timeout_s,
                )[0]
                src["label"] = label
                src["role"] = src["role"] or "primary"
            else:
                snap: dict = {}
                stale = True
                if state == "live":
                    try:
                        snap = self._call(k, "metrics", {})["snapshot"]
                        stale = False
                    except RpcError:
                        snap = {}
                src = {
                    "label": label,
                    "role": "primary",
                    "snapshot": snap,
                    "stale": stale,
                }
            sources.append(src)
        return sources

    def metrics_snapshot(self) -> dict:
        """Federated view over every shard's registry (HTTP scrape,
        RPC fallback) plus the supervisor's own process-global
        families."""
        return federate_snapshots(
            self.scrape_sources(),
            global_snapshot=registry_snapshot(global_registry()),
        )

    def dump_snapshots(
        self, path: str | None = None, sources: list[dict] | None = None
    ) -> str:
        """Write per-shard ``shard-K.json`` metric snapshots plus the
        ``cluster.json`` recovery report into the snapshot dir — the
        ``obs/federate.py`` file-drop format ``ytpu_top <dir>`` tails
        and the HTTP-scrape mode is byte-equivalent with (both paths
        dump/serve the same shard payload).  ``sources`` reuses an
        existing scrape; stale sources keep the last good file."""
        out = path or self.config.snapshot_dir
        if not out:
            raise ValueError(
                "no snapshot dir (YTPU_CLUSTER_SNAPSHOT_DIR or path=)"
            )
        os.makedirs(out, exist_ok=True)
        if sources is None:
            sources = self.scrape_sources()
        for src in sources:
            if src.get("stale"):
                continue
            name = str(src["label"])
            tmp = os.path.join(out, f".{name}.json.tmp")
            with open(tmp, "w") as f:
                json.dump(src["snapshot"], f)
            os.replace(tmp, os.path.join(out, f"{name}.json"))
        report = self.recovery_report()
        tmp = os.path.join(out, ".cluster.json.tmp")
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, os.path.join(out, "cluster.json"))
        return out

    # -- admin-plane target ---------------------------------------

    def admin_urls(self) -> dict[str, str]:
        """Every process's admin base URL: the supervisor's own plus
        one per live shard child (the smoke harness curls them all)."""
        urls: dict[str, str] = {}
        if self.admin is not None and self.admin.port:
            urls["supervisor"] = self.admin.url
        with self._lock:
            for k in sorted(self._shards):
                sp = self._shards[k]
                if sp.admin_port:
                    urls[f"shard-{k:03d}"] = (
                        f"http://{self.config.host}:{sp.admin_port}"
                    )
        return urls

    def tsdb_query(self, params: dict) -> dict:
        """Federated ``/query``: fan the range query out to
        every live shard child's embedded TSDB over the admin plane and
        merge the per-shard points into one cross-fleet series (dead
        shards contribute a stale-marked empty result, never an
        error).  ``?agg=`` doubles as the cross-shard combiner —
        ``sum`` for fleet totals, ``avg``/``min``/``max`` for spread."""
        from ..obs.tsdb import merge_points, query_endpoints, tsdb

        urls = {
            label: url
            for label, url in self.admin_urls().items()
            if label != "supervisor"
        }
        agg = params.get("agg") or "avg"
        per_shard = query_endpoints(
            urls, params, timeout_s=self.config.scrape_timeout_s
        )
        merged = merge_points(
            {k: v.get("points", []) for k, v in per_shard.items()},
            agg=agg,
            bucket_s=max(1.0, tsdb().config.interval_s),
        )
        return {
            "name": params.get("name", ""),
            "labels": params.get("labels", "") or "",
            "agg": agg,
            "tier": params.get("tier") or "auto",
            "federated": True,
            "shards": sorted(urls),
            "stale": sorted(
                k for k, v in per_shard.items() if v.get("stale")
            ),
            "points": merged,
        }

    def statusz(self) -> dict:
        report = self.recovery_report()
        return {
            "role": "supervisor",
            "epoch": report["epoch"],
            "shards": report["shards"],
            "outcomes": report["outcomes"],
            "resolution": report["resolution"],
            "events": len(report["events"]),
            "geo": None if self.geo is None else self.geo.snapshot(),
        }

    def readiness(self) -> dict:
        """``/readyz`` for the control plane: every shard settled (live
        or failed-over) and at least one serving — a shard mid-restart
        flips the cluster not-ready until recovery resolves."""
        with self._lock:
            states = [sp.state for sp in self._shards.values()]
        live = sum(1 for s in states if s == "live")
        settled = all(s in ("live", "lost") for s in states)
        return {
            "ready": live > 0 and settled,
            "checks": {
                "live_shards": live,
                "all_settled": settled,
                "states": {
                    s: states.count(s) for s in sorted(set(states))
                },
            },
        }
