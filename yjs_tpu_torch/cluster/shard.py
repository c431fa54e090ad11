"""One cluster shard = one OS process wrapping one :class:`TpuProvider`.

Run as ``python -m yjs_tpu_torch.cluster.shard --id K --wal-dir D
[--port 0] [--docs N] [--device cuda|cpu]``.  On start the process
either builds a fresh provider or — when the WAL directory already
holds segments — rebuilds through the
existing ``TpuProvider.recover`` snapshot-then-tail path, so a
supervisor restart after ``kill -9`` replays every journaled update
(WAL appends flush to the OS page cache per record, which survives
process death; see ``persistence/wal.py``).  It then prints ONE ready
line to stdout::

    YTPU_SHARD_READY {"shard": K, "port": P, "pid": …, "device": …,
                      "recovery": …}

and serves the cluster RPC (``cluster/rpc.py``) until told to shut
down.  All provider access is serialized under one process-wide RLock —
RPC connections are one thread each and the provider is not
thread-safe.  Flush cadence is driven by a local ticker thread through
the adaptive ``flush_tick``.

Every flush-emitted update broadcasts to all connected RPC peers as an
``update`` event — the supervisor/gateway subscribe and fan rooms out
to client connections.

``device`` places the provider's engine, as in
:class:`~yjs_tpu_torch.provider.TpuProvider`: ``None`` (the default, and
``--device``'s) is the CUDA device, and a process that finds none fails
before its ready line instead of coming up on the CPU; ``device="cpu"``
runs the kernels' plain PyTorch versions.  The ready line's ``device``
is the engine's :class:`torch.device`.  A :class:`KernelError` (a kernel
that does not build or launch) is never swallowed: raised in the tick
loop or in an RPC call, it stops the shard, and :func:`main` exits
non-zero, so the supervisor sees a death.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

from ..obs import dist as obs_dist
from ..obs.admin import AdminConfig, AdminServer
from ..ops.kernels import KernelError
from .config import ClusterConfig
from .rpc import RpcBusy, RpcServer, b64d, b64e


class ShardServer:
    """RPC facade over one provider process (see module docstring)."""

    def __init__(
        self,
        shard_id: int,
        wal_dir: str,
        n_docs: int = 64,
        host: str | None = None,
        port: int = 0,
        backend: str = "auto",
        tick_s: float = 0.05,
        config: ClusterConfig | None = None,
        admin_port: int | None = None,
        device=None,
    ):
        from ..provider import TpuProvider

        self.shard_id = int(shard_id)
        self.config = config if config is not None else ClusterConfig()
        self.tick_s = tick_s
        self._plock = threading.RLock()
        self._stop = threading.Event()
        # the KernelError that stopped the shard, if one did
        self.fault: KernelError | None = None
        # fencing-epoch currency: the highest
        # fleet epoch any control frame carried, vs the epoch the
        # supervisor last TOLD us is current.  A fence (demotion to
        # replica at epoch E) raises _epoch_seen past routing_epoch,
        # and /readyz answers 503 until the post-resolution epoch push
        # catches us up — the "fenced corpse" window.
        self.routing_epoch = 0
        self._epoch_seen = 0
        self._init_done = False
        # the admin plane starts BEFORE the provider is built so
        # /healthz answers (and /readyz says 503 "recovering") during a
        # long WAL replay — exactly the window probes care about
        self.admin: AdminServer | None = None
        try:
            self.admin = AdminServer(
                self,
                role="shard",
                config=AdminConfig(port=admin_port),
            ).start()
        except OSError:
            self.admin = None  # port taken: serve data plane anyway
        has_wal = os.path.isdir(wal_dir) and any(
            os.scandir(wal_dir)
        )
        if has_wal:
            self.provider = TpuProvider.recover(
                wal_dir, n_docs=n_docs, backend=backend, device=device
            )
            stats = self.provider.last_recovery or {}
            self.recovery = {
                "outcome": "recovered",
                "records_applied": stats.get("records_applied", 0),
                "session_acks": stats.get("session_acks", 0),
                "migrations_pending": sorted(
                    (stats.get("migrations_pending") or {}).keys()
                ),
                "repl_roles": {
                    g: info.get("role", "")
                    for g, info in (stats.get("repl_roles") or {}).items()
                },
            }
        else:
            self.provider = TpuProvider(
                n_docs, backend=backend, wal_dir=wal_dir, device=device
            )
            self.recovery = {"outcome": "fresh"}
        self.provider.shard_id = self.shard_id
        # journal-only replica copies (replication fan-out over
        # sockets): the engine never sees these, so WAL compaction would
        # destroy them — checkpoints fold only engine-resident docs.  Track them
        # host-side and re-journal after every checkpoint, the same
        # durability interplay ReplicationManager.rejournal_after_
        # checkpoint handles for the in-process fleet.
        self._replica_records: dict[str, list[tuple[int, bytes, bool]]] = {}
        self._replica_roles: dict[str, dict] = {}
        self.server = RpcServer(
            self,
            host=host if host is not None else self.config.host,
            port=port,
        )
        self.provider.on_update(self._on_flush_update)
        self._ticker = threading.Thread(
            target=self._tick_loop,
            name=f"ytpu-shard-tick-{self.shard_id}",
            daemon=True,
        )
        self._ticker.start()
        self._init_done = True

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def device(self) -> str:
        """The engine's device, as the ready line reports it."""
        return str(self.provider.engine.device)

    @property
    def admin_port(self) -> int:
        return self.admin.port if self.admin is not None else 0

    # -- admin-plane target ---------------------------------------

    def metrics_text(self) -> str:
        prov = getattr(self, "provider", None)
        if prov is None:
            from ..obs import global_registry, prometheus_text

            return prometheus_text(global_registry())
        return prov.metrics_text()

    def metrics_snapshot(self) -> dict:
        """The federation payload: the provider's full snapshot plus
        the shard identity keys — byte-identical to what the supervisor
        writes as ``shard-K.json``, so HTTP-scrape and file-drop
        federation merge the exact same input."""
        prov = getattr(self, "provider", None)
        if prov is None:
            snap = {}
        else:
            with self._plock:
                snap = prov.metrics_snapshot()
        snap["shard"] = self.shard_id
        snap["pid"] = os.getpid()
        snap["label"] = f"shard-{self.shard_id:03d}"
        snap["role"] = "primary"
        return snap

    def statusz(self) -> dict:
        prov = getattr(self, "provider", None)
        if prov is None:
            status = {"recovering": True}
        else:
            with self._plock:
                status = prov.statusz()
        status.update({
            "role": "shard",
            "shard": self.shard_id,
            "rpc_port": self.server.port if self._init_done else 0,
            "routing_epoch": self.routing_epoch,
            "epoch_seen": self._epoch_seen,
            "recovery": getattr(self, "recovery", {}),
        })
        return status

    def readiness(self) -> dict:
        """``/readyz``: not ready while the provider is still being
        built/recovered, while brownout rejects writes, or while this
        shard's routing epoch lags a fence it witnessed (a stale
        primary must not take traffic until the supervisor publishes
        the post-resolution epoch).  Lock-free on purpose — reads are
        plain attributes, so a wedged provider lock cannot wedge the
        probe (liveness stays /healthz's job)."""
        prov = getattr(self, "provider", None)
        recovering = (
            not self._init_done
            or prov is None
            or getattr(prov, "recovering", False)
        )
        level = (
            prov.admission.brownout.level if prov is not None else 0
        )
        current = self.routing_epoch >= self._epoch_seen
        ready = (not recovering) and level < 3 and current
        return {
            "ready": ready,
            "checks": {
                "recovery_complete": not recovering,
                "brownout_level": level,
                "accepting_writes": level < 3,
                "epoch_current": current,
                "routing_epoch": self.routing_epoch,
                "epoch_seen": self._epoch_seen,
            },
        }

    def trace_events(self) -> list:
        prov = getattr(self, "provider", None)
        if prov is None:
            return []
        return prov.trace_events()

    def _on_flush_update(self, guid: str, update: bytes) -> None:
        # flush-emitted merged update: push to every RPC subscriber
        # (the gateway fans it to the room's client connections)
        self.server.broadcast(
            "update", {"guid": guid, "update": b64e(update)}
        )

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            with self._plock:
                try:
                    self.provider.flush_tick()
                    self.provider.tick_sessions()
                except KernelError as e:
                    # a kernel that does not build or launch is no
                    # passing fault: stop serving, so the process exits
                    # non-zero and the supervisor sees a death
                    self.fault = e
                    self._stop.set()
                    return
                except Exception:
                    pass  # a failed tick retries next round

    # -- RPC ingress seam ----------------------------------------------------

    def handle_rpc_request(self, method: str, payload: dict, ctx):
        """The shard's ingress seam: every cross-process frame enters
        here.  Adopts the carried :class:`TraceContext` before
        dispatch, so provider-side spans join the gateway's trace, and
        delegates data traffic to the provider's own seams
        (``receive_update`` / ``handle_sync_message``) which feed the
        WAL, admission, and SLO pipelines."""
        with obs_dist.use_context(ctx):
            with self._plock:
                try:
                    return self._dispatch(method, payload)
                except KernelError as e:
                    # the caller gets the error reply, and the shard
                    # stops as after a failed tick
                    self.fault = e
                    self._stop.set()
                    raise

    def _dispatch(self, method: str, payload: dict):
        from ..admission import AdmissionRejected
        from ..provider import ProviderFullError

        prov = self.provider
        if method == "hello":
            return {
                "shard": self.shard_id,
                "pid": os.getpid(),
                "port": self.server.port,
                "recovery": self.recovery,
            }
        if method == "heartbeat":
            return prov.heartbeat()
        if method == "sync":
            guid = payload["guid"]
            frame = b64d(payload["frame"])
            try:
                reply = prov.handle_sync_message(guid, frame)
            except ProviderFullError:
                prov.admission.note_full("provider")
                raise RpcBusy(prov.admission.retry_after)
            return {"reply": b64e(reply) if reply is not None else None}
        if method == "update":
            guid = payload["guid"]
            update = b64d(payload["update"])
            try:
                ok = prov.receive_update(
                    guid,
                    update,
                    v2=bool(payload.get("v2")),
                    internal=bool(payload.get("internal")),
                )
            except AdmissionRejected as e:
                raise RpcBusy(e.retry_after)
            except ProviderFullError:
                prov.admission.note_full("provider")
                raise RpcBusy(prov.admission.retry_after)
            return {"accepted": bool(ok)}
        if method == "sv":
            prov.flush()
            sv = prov.engine.encode_state_vector(prov.doc_id(payload["guid"]))
            return {"sv": b64e(sv)}
        if method == "diff":
            sv = payload.get("sv")
            diff = prov.encode_state_as_update(
                payload["guid"], b64d(sv) if sv else None
            )
            return {"update": b64e(diff)}
        if method == "text":
            prov.flush()
            return {"text": prov.text(payload["guid"])}
        if method == "guids":
            return {"guids": prov.guids()}
        if method == "flush":
            prov.flush()
            return {}
        if method == "checkpoint":
            return {"checkpoint": bool(self._checkpoint())}
        if method == "metrics":
            # same payload the admin plane serves at /metrics.json —
            # RPC fallback and HTTP scrape federate identical input
            # (_plock is an RLock; re-entering here is fine)
            return {"snapshot": self.metrics_snapshot()}
        if method == "journal_ack":
            prov.journal_session_ack(
                payload["guid"], payload["peer"],
                int(payload["sid"]), int(payload["seq"]),
            )
            return {}
        if method == "ack_hints":
            # journaled resume floors recovered from the WAL: the
            # gateway re-arms surviving sessions with these so a
            # restarted shard resumes retransmission, not full resync
            hints = {}
            for (guid, peer), (sid, seq) in getattr(
                prov, "_recovered_acks", {}
            ).items():
                hints.setdefault(guid, {})[peer] = [sid, seq]
            return {"hints": hints}
        if method == "journal_migration":
            prov.journal_migration(
                payload["guid"], int(payload["dst"]), int(payload["epoch"])
            )
            return {}
        if method == "journal_repl_role":
            guid = payload["guid"]
            role = payload["role"]
            prov.journal_repl_role(
                guid,
                role,
                int(payload["epoch"]),
                primary=payload.get("primary"),
            )
            # witnessing a fleet epoch ahead of our routing epoch (a
            # fence/demotion decided while we were dead) flips /readyz
            # until the supervisor's post-resolution epoch push
            self._epoch_seen = max(self._epoch_seen, int(payload["epoch"]))
            self._replica_roles[guid] = {
                "role": str(role),
                "epoch": int(payload["epoch"]),
                "primary": payload.get("primary"),
            }
            if role == "primary":
                # promotion: the doc is (or is about to be) engine-
                # resident, so checkpoints fold it from the engine now
                self._replica_records.pop(guid, None)
            return {}
        if method == "repl_record":
            # replication fan-out target (fleet replication over sockets):
            # journal-only on the replica's own WAL — promotion
            # materializes by restart-with-recover
            guid = payload["guid"]
            kind = int(payload["kind"])
            data = b64d(payload["payload"])
            v2 = bool(payload.get("v2"))
            ok = prov.journal_replica_record(kind, guid, data, v2=v2)
            if ok:
                self._track_replica_record(guid, kind, data, v2)
            return {"journaled": bool(ok)}
        if method == "release":
            guid = payload["guid"]
            final = prov.release_doc(guid)
            # the release record clears the WAL claim; drop the mirror
            self._replica_records.pop(guid, None)
            self._replica_roles.pop(guid, None)
            return {"update": b64e(final)}
        if method == "epoch":
            # routing-epoch bump (fencing): a shard holding a
            # lower epoch than the fleet's learns it here — this is
            # the "you are current again" signal that restores /readyz
            # after a fence raised _epoch_seen
            self.routing_epoch = max(
                self.routing_epoch, int(payload["epoch"])
            )
            self._epoch_seen = max(self._epoch_seen, self.routing_epoch)
            return {"epoch": self.routing_epoch}
        if method == "shutdown":
            self._stop.set()
            return {"stopping": True}
        if method == "launches":
            # the kernel wrappers' launch counts in this process, each
            # counted where its CUDA kernel launches; ``reset`` zeroes
            # them after the read
            from ..ops import kernels

            counts = dict(kernels.launches)
            if payload.get("reset"):
                kernels.reset_launches()
            return {"launches": counts}
        raise ValueError(f"unknown rpc method: {method}")

    # -- replica-record durability ---------------------------

    def _track_replica_record(
        self, guid: str, kind: int, data: bytes, v2: bool
    ) -> None:
        """Mirror one journal-only record host-side so it survives WAL
        compaction.  Plain v1 update records coalesce through
        ``merge_updates`` past a small threshold — the mirror stays
        bounded by doc-state size, not fan-out volume."""
        from ..persistence import KIND_UPDATE

        recs = self._replica_records.setdefault(guid, [])
        recs.append((kind, bytes(data), v2))
        mergeable = [
            p for k, p, r2 in recs if k == KIND_UPDATE and not r2
        ]
        if len(mergeable) > 16:
            from ..updates import merge_updates

            rest = [
                e for e in recs if not (e[0] == KIND_UPDATE and not e[2])
            ]
            self._replica_records[guid] = rest + [
                (KIND_UPDATE, merge_updates(mergeable), False)
            ]

    def _rejournal_replicas(self) -> int:
        """Re-append every mirrored replica record + role marker after
        a checkpoint compacted the segments they lived in (the cluster-
        process twin of ``ReplicationManager.rejournal_after_
        checkpoint``)."""
        n = 0
        for guid in sorted(self._replica_roles):
            info = self._replica_roles[guid]
            self.provider.journal_repl_role(
                guid, info["role"], info["epoch"],
                primary=info.get("primary"),
            )
            n += 1
        for guid in sorted(self._replica_records):
            for kind, data, v2 in self._replica_records[guid]:
                if self.provider.journal_replica_record(
                    kind, guid, data, v2=v2
                ):
                    n += 1
        return n

    def _checkpoint(self) -> dict | None:
        res = self.provider.checkpoint()
        if res is not None:
            self._rejournal_replicas()
        return res

    # -- lifecycle -----------------------------------------------------------

    def run_forever(self) -> None:
        """Serve until told to stop; re-raises the :class:`KernelError`
        that stopped the shard, if one did."""
        while not self._stop.wait(0.2):
            pass
        with self._plock:
            fault = self.fault
        if fault is not None:
            raise fault

    def close(self, checkpoint: bool = True) -> None:
        self._stop.set()
        if self._ticker.is_alive():
            self._ticker.join(timeout=2.0)
        if self.admin is not None:
            self.admin.close()
        self.server.close()
        with self._plock:
            try:
                if self.fault is not None:
                    # the kernels failed: no closing flush or checkpoint
                    # (each would launch them again); the WAL already
                    # holds every acked update for the next recover
                    if self.provider.wal is not None:
                        self.provider.wal.close()
                elif checkpoint and self.provider.wal is not None:
                    # checkpoint through the rejournal wrapper: the
                    # final compaction must not destroy journal-only
                    # replica copies a successor's recover will need
                    self._checkpoint()
                    self.provider.close(checkpoint=False)
                else:
                    self.provider.close(checkpoint=checkpoint)
            except KernelError:
                raise  # a closing checkpoint whose kernel failed
            except Exception:
                pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one y-tpu cluster shard process"
    )
    ap.add_argument("--id", type=int, required=True)
    ap.add_argument("--wal-dir", required=True)
    ap.add_argument("--docs", type=int, default=64)
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument(
        "--backend", default="auto",
        help="the provider's backend (default 'auto', rooms on the "
        "engine; 'cpu' keeps them on the CPU core)",
    )
    ap.add_argument("--tick-s", type=float, default=0.05)
    ap.add_argument(
        "--device", default=None,
        help="the engine's device (default: the CUDA device; the "
        "process fails without one)",
    )
    ap.add_argument(
        "--admin-port", type=int, default=None,
        help="admin-plane HTTP port (default: YTPU_ADMIN_PORT or 0; "
        "YTPU_ADMIN_DISABLED=1 turns the plane off)",
    )
    args = ap.parse_args(argv)

    shard = ShardServer(
        args.id,
        args.wal_dir,
        n_docs=args.docs,
        host=args.host,
        port=args.port,
        backend=args.backend,
        tick_s=args.tick_s,
        admin_port=args.admin_port,
        device=args.device,
    )
    ready = {
        "shard": shard.shard_id,
        "port": shard.port,
        "pid": os.getpid(),
        "device": shard.device,
        "admin_port": shard.admin_port,
        "recovery": shard.recovery,
    }
    sys.stdout.write(
        "YTPU_SHARD_READY " + json.dumps(ready, separators=(",", ":")) + "\n"
    )
    sys.stdout.flush()

    def _term(signum, frame):
        shard._stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    code = 0
    try:
        shard.run_forever()
    except KernelError as e:
        sys.stderr.write(f"shard {shard.shard_id}: kernel failure: {e}\n")
        code = 1
    finally:
        shard.close(checkpoint=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
