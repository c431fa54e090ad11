"""FleetRouter: N TpuProvider shards behind one provider facade.

One provider caps the deployment at single-device slot capacity
(``ProviderFullError``).  The fleet is the architectural unlock the
ROADMAP names: docs are placed onto shards by the bounded-load
consistent-hash ring (:mod:`yjs_tpu_torch.fleet.hashring`), each shard runs
its own :class:`~yjs_tpu_torch.provider.TpuProvider` — optionally on its own
device mesh from :func:`yjs_tpu_torch.parallel.shard_meshes` — and the router
speaks the same surface a single provider does (``receive_update`` /
``handle_sync_message`` / ``session`` / ``text`` / ``checkpoint``), so
callers scale out by swapping the constructor.

``device`` places every shard's engine, as in
:class:`~yjs_tpu_torch.provider.TpuProvider`: ``None`` (default) is the
CUDA device, and building a shard raises without one; ``device="cpu"``
runs the kernels' plain PyTorch versions.  Every provider the fleet
builds takes it: the constructor's, :meth:`FleetRouter.add_shard`'s,
:meth:`FleetRouter.revive_shard`'s and :meth:`FleetRouter.recover`'s.
A shard given a mesh runs on the mesh's devices instead.  On one card
:func:`yjs_tpu_torch.parallel.shard_meshes` gives no meshes, so every
shard's engine shares that card.

**Live migration** rides the seams earlier PRs built, in an order that
makes a crash at ANY point recoverable to exactly one owner:

1. the source journals a ``KIND_MIGRATE`` intent (crash here: the
   destination never saw the doc → recovery aborts, source keeps it);
2. the source's full state is exported and applied to the destination,
   which journals it as ordinary updates (crash here: both WALs hold the
   doc + a pending intent → recovery completes the handoff, transferring
   the source's final state so no tail update is lost);
3. the *double-delivery window* opens: in-flight updates and session
   frames are delivered to BOTH shards — the CRDT's idempotent,
   commutative merge dedupes, so nothing is dropped or reordered;
4. ``release_doc()`` on the source journals the release (the durable
   "handoff complete" marker), its final export is re-applied to the
   destination, the routing table bumps its epoch, and live sessions
   ``rehome()`` — an immediate anti-entropy digest repairs anything that
   raced the window.

The :class:`~yjs_tpu_torch.fleet.rebalance.Rebalancer` ticks on shard
occupancy to migrate docs off shards approaching full and to drain a
shard for removal.  Knobs: ``YTPU_FLEET_VNODES``,
``YTPU_FLEET_LOAD_FACTOR``, ``YTPU_FLEET_REBALANCE_HIGH``,
``YTPU_FLEET_REBALANCE_TARGET``, ``YTPU_FLEET_REBALANCE_BATCH``.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

from ..admission import AdmissionController
from ..obs import dist as obs_dist
from ..obs import global_registry
from ..obs.admin import maybe_start_admin
from ..obs.blackbox import flight_recorder
from ..obs.expo import prometheus_text, registry_snapshot
from ..obs.federate import FederationMetrics, federate_snapshots
from ..provider import ProviderFullError, TpuProvider
from ..sync.session import (
    SessionConfig,
    SessionMetrics,
    SyncSession,
    encode_busy,
)
from .hashring import (
    FleetFullError,
    HashRing,
    RoutingTable,
    _env_float,
    _env_int,
)
from .failover import (
    DeadShard,
    FailoverCoordinator,
    FailoverMetrics,
    FailureDetector,
    ShardDownError,
)
from .rebalance import Rebalancer
from .replication import ReplicationManager

__all__ = ["FleetConfig", "FleetMetrics", "FleetRouter", "FleetFullError"]


def _shard_device(device, mesh):
    """The ``device=`` a shard's provider is built with: a shard's mesh,
    where one is given, decides its devices."""
    return None if mesh is not None else device


class FleetConfig:
    """Resolved fleet knobs (constructor args beat ``YTPU_FLEET_*`` env
    beats defaults, same precedence as SessionConfig/WalConfig)."""

    __slots__ = (
        "vnodes", "load_factor", "rebalance_high", "rebalance_target",
        "rebalance_batch",
    )

    def __init__(
        self,
        vnodes: int | None = None,
        load_factor: float | None = None,
        rebalance_high: float | None = None,
        rebalance_target: float | None = None,
        rebalance_batch: int | None = None,
    ):
        def pick(v, env, default, conv):
            return v if v is not None else conv(env, default)

        self.vnodes = pick(vnodes, "YTPU_FLEET_VNODES", 64, _env_int)
        self.load_factor = pick(
            load_factor, "YTPU_FLEET_LOAD_FACTOR", 1.25, _env_float
        )
        self.rebalance_high = pick(
            rebalance_high, "YTPU_FLEET_REBALANCE_HIGH", 0.85, _env_float
        )
        self.rebalance_target = pick(
            rebalance_target, "YTPU_FLEET_REBALANCE_TARGET", 0.6, _env_float
        )
        self.rebalance_batch = pick(
            rebalance_batch, "YTPU_FLEET_REBALANCE_BATCH", 4, _env_int
        )


class FleetMetrics:
    """The ``ytpu_fleet_*`` instrument bundle.

    Registered on the process-global registry by default: provider
    exposition already merges the global registry, so every shard's
    ``metrics_text()`` carries the fleet families without extra wiring
    (and re-registration is a cheap name-dedup no-op)."""

    def __init__(self, registry=None):
        r = registry if registry is not None else global_registry()
        self.registry = r
        self.shards = r.gauge(
            "ytpu_fleet_shards",
            "Live (non-retired) shards in the fleet",
        )
        self.docs = r.gauge(
            "ytpu_fleet_docs",
            "Docs currently admitted across all shards",
        )
        self.shard_docs = r.gauge(
            "ytpu_fleet_shard_docs",
            "Docs admitted on one shard",
            labelnames=("shard",),
        )
        self.shard_occupancy = r.gauge(
            "ytpu_fleet_shard_occupancy",
            "Admitted docs / slot capacity of one shard (1.0 = next "
            "admission raises ProviderFullError)",
            labelnames=("shard",),
        )
        self.epoch = r.gauge(
            "ytpu_fleet_routing_epoch",
            "Routing-table version; bumps on every ownership or "
            "membership change",
        )
        self.placements = r.counter(
            "ytpu_fleet_placements_total",
            "First-touch doc placements, by kind (ring = natural owner, "
            "shed = bounded-load diverted off a hot shard)",
            labelnames=("kind",),
        )
        self.migrations = r.counter(
            "ytpu_fleet_migrations_total",
            "Completed doc migrations, by reason (manual / rebalance / "
            "drain / recovery-complete / recovery-abort / "
            "recovery-dedupe)",
            labelnames=("reason",),
        )
        self.migration_seconds = r.histogram(
            "ytpu_fleet_migration_seconds",
            "Wall time of one live doc migration (intent + export + "
            "apply + release)",
            unit="s",
        )
        self.double_delivered = r.counter(
            "ytpu_fleet_double_delivered_total",
            "Updates/frames delivered to both shards inside a "
            "migration's double-delivery window (deduped by CRDT "
            "idempotence)",
        )
        self.rebalance = r.counter(
            "ytpu_fleet_rebalance_decisions_total",
            "Rebalancer tick decisions, by action (move / stuck)",
            labelnames=("action",),
        )


class _FleetSessionHost:
    """Session host that resolves the OWNING shard per call, so a live
    :class:`SyncSession` rides a migration without reconnecting: the
    facade re-points, the seq spaces survive, and frames inside the
    double-delivery window reach both shards."""

    __slots__ = ("fleet", "guid", "peer")

    def __init__(self, fleet: "FleetRouter", guid: str, peer: str):
        self.fleet = fleet
        self.guid = guid
        self.peer = peer

    def _prov(self) -> TpuProvider:
        return self.fleet.provider_for(self.guid)

    def state_vector(self) -> bytes:
        p = self._prov()
        p.flush()
        return p.engine.encode_state_vector(p.doc_id(self.guid))

    def diff_update(self, sv: bytes | None) -> bytes:
        return self._prov().encode_state_as_update(self.guid, sv)

    def apply_update(self, update: bytes) -> None:
        self.fleet.receive_update(self.guid, update)

    def handle_frame(self, frame: bytes) -> bytes | None:
        fleet = self.fleet
        try:
            return fleet._handle_frame_routed(self.guid, frame)
        except (ProviderFullError, FleetFullError) as e:
            # Capacity exhaustion must not escape into the transport
            # pump: feed the admission controller (brownout signal +
            # tiering headroom), keep the bytes as replicated typed
            # dead-letter evidence, push back on the peer with BUSY.
            kind = "fleet" if isinstance(e, FleetFullError) else "provider"
            fleet.admission.note_full(kind)
            full_reason = f"admission-full: {e} (peer {self.peer})"
            fleet.repl.enqueue_dlq(
                self.guid, bytes(frame), False, full_reason
            )
            own = fleet.owner_of(self.guid)
            if own is not None and not fleet._is_stub(own):
                try:
                    fleet.shards[own].engine._dead_letter(
                        -1, bytes(frame), False, full_reason
                    )
                except ShardDownError:
                    fleet.detector.report_down(own)
            return encode_busy(fleet.admission.retry_after)

    def dead_letter(self, payload: bytes, reason: str) -> None:
        full_reason = f"{reason} (peer {self.peer})"
        try:
            p = self._prov()
            try:
                doc = p.doc_id(self.guid)
            except ProviderFullError:
                self.fleet.admission.note_full("provider")
                doc = -1
            p.engine._dead_letter(
                doc, bytes(payload), False, full_reason,
            )
        except FleetFullError:
            self.fleet.admission.note_full("fleet")
        except ShardDownError:
            own = self.fleet.owner_of(self.guid)
            if own is not None:
                self.fleet.detector.report_down(own)
        # quarantined evidence is replicated: it must survive the shard
        # that quarantined it
        self.fleet.repl.enqueue_dlq(
            self.guid, bytes(payload), False, full_reason
        )

    def journal_ack(self, sid: int, seq: int) -> None:
        try:
            self._prov().journal_session_ack(
                self.guid, self.peer, sid, seq
            )
        except ShardDownError:
            own = self.fleet.owner_of(self.guid)
            if own is not None:
                self.fleet.detector.report_down(own)
        # receive floors fan out too — a promoted replica's WAL must
        # let surviving peers resume, not resync
        self.fleet.repl.enqueue_ack(self.guid, self.peer, sid, seq)


class FleetRouter:
    """Doc-sharded provider fleet behind a single provider facade."""

    def __init__(
        self,
        n_shards: int | None = None,
        docs_per_shard: int | None = None,
        root_name: str = "text",
        gc: bool = False,
        backend: str = "auto",
        wal_dir=None,
        wal_config=None,
        meshes=None,
        config: FleetConfig | None = None,
        registry=None,
        providers: list[TpuProvider] | None = None,
        tier_config=None,
        repl_config=None,
        failover_config=None,
        admission_config=None,
        device=None,
    ):
        self.config = config if config is not None else FleetConfig()
        # ONE admission controller shared by every shard: per-tenant
        # buckets and the brownout level are fleet-wide, and the fleet
        # tick drives the clock (claim_ticker below)
        self.admission = AdmissionController(
            admission_config, registry=registry
        )
        self._root_name = root_name
        self._gc = gc
        self._backend = backend
        self._device = device
        self._wal_config = wal_config
        self._tier_config = tier_config
        if wal_dir is None:
            wal_dir = os.environ.get("YTPU_WAL_DIR")
        self.wal_root = Path(wal_dir) if wal_dir else None

        if providers is not None:
            if n_shards is not None and n_shards != len(providers):
                raise ValueError("n_shards conflicts with providers list")
            self.shards = list(providers)
            self._docs_per_shard = docs_per_shard or max(
                (p.engine.n_docs for p in self.shards), default=1
            )
        else:
            if n_shards is None or n_shards < 1:
                raise ValueError(f"need n_shards >= 1, got {n_shards}")
            if docs_per_shard is None or docs_per_shard < 1:
                raise ValueError(
                    f"need docs_per_shard >= 1, got {docs_per_shard}"
                )
            self._docs_per_shard = docs_per_shard
            self.shards = [
                TpuProvider(
                    docs_per_shard,
                    root_name=root_name,
                    mesh=meshes[k] if meshes else None,
                    gc=gc,
                    backend=backend,
                    # "" (not None) when fleet-level journaling is off:
                    # None would make every shard fall back to
                    # YTPU_WAL_DIR and share one directory
                    wal_dir=self._shard_wal_dir(k),
                    wal_config=wal_config,
                    tier_config=tier_config,
                    admission=self.admission,
                    device=_shard_device(
                        device, meshes[k] if meshes else None
                    ),
                )
                for k in range(n_shards)
            ]

        self.ring = HashRing(
            range(len(self.shards)), vnodes=self.config.vnodes
        )
        self.table = RoutingTable()
        self.metrics = FleetMetrics(registry)
        self._session_metrics = SessionMetrics(self.metrics.registry)
        self._sessions: dict[tuple[str, str], SyncSession] = {}
        self._update_listeners: list = []
        # guid -> {"src", "dst", "reason", "t0"} while a migration's
        # double-delivery window is open
        self._migrating: dict[str, dict] = {}
        # shards drained out of placement (still indexable: shard ids
        # are positional and must stay stable)
        self._retired: set[int] = set()
        # per-shard migration traffic for the ytpu_top fleet table
        self._mig_in: dict[int, int] = {}
        self._mig_out: dict[int, int] = {}
        # stats of the replay that built this fleet (recover())
        self.last_recovery: dict | None = None
        # shards whose machine is gone (failed over, fenced out of the
        # ring); distinct from _retired, which is a graceful drain
        self._down: set[int] = set()
        # killed providers kept for revival (the chaos/fencing path)
        self._corpses: dict[int, TpuProvider] = {}
        for k, prov in enumerate(self.shards):
            prov.shard_id = k
            self._attach_bridge(k, prov)
            # externally-built providers (recover(), tests) arrive with
            # private controllers: rebind them onto the shared one
            if prov.admission is not self.admission:
                prov.admission.detach(prov)
                prov.admission = self.admission
            self.admission.attach(prov)
        self.admission.claim_ticker(self)
        # cross-shard metrics federation: ytpu_fed_* families
        # register at construction so the schema checker sees them
        self.fed_metrics = FederationMetrics(self.metrics.registry)
        self.failover_metrics = FailoverMetrics(self.metrics.registry)
        self.detector = FailureDetector(
            range(len(self.shards)),
            config=failover_config,
            metrics=self.failover_metrics,
        )
        self.repl = ReplicationManager(self, config=repl_config)
        self.failover = FailoverCoordinator(
            self, metrics=self.failover_metrics
        )
        self.rebalancer = Rebalancer(self)
        # admin plane: ONE endpoint for the whole fleet —
        # shard providers that auto-started their own (YTPU_ADMIN_PORT
        # set) hand the plane over to the router's federated view
        for prov in self.shards:
            if getattr(prov, "admin", None) is not None:
                prov.admin.close()
                prov.admin = None
        self.admin = maybe_start_admin(self, "fleet")
        self._refresh_gauges()

    # -- construction helpers ------------------------------------------------

    def _shard_wal_dir(self, k: int) -> str:
        return str(self.wal_root / f"shard-{k:03d}") if self.wal_root else ""

    def _is_stub(self, k: int) -> bool:
        return isinstance(self.shards[k], DeadShard)

    def _unhealthy(self) -> set[int]:
        """Shards no placement, replication, or migration may target:
        gracefully retired, confirmed down, or currently suspect."""
        return (
            self._retired | self._down | set(self.detector.suspects())
        )

    def shard_healthy(self, k: int) -> bool:
        """True when the shard is a valid migration/placement
        destination (the rebalancer's gate)."""
        return k not in self._unhealthy() and not self._is_stub(k)

    def _attach_bridge(self, k: int, prov: TpuProvider) -> None:
        """Fan this shard's flush-emitted updates out to fleet sessions
        and listeners.  Inside a doc's double-delivery window the
        DESTINATION's emissions are suppressed: the source is still the
        owner of record, and forwarding both would send every peer each
        delta twice (harmless to the CRDT, wasteful on the wire)."""

        def bridge(guid, update, _k=k):
            mig = self._migrating.get(guid)
            if mig is not None and mig["dst"] == _k:
                return
            if mig is None:
                own = self.table.lookup(guid)
                if own is not None and own != _k:
                    # fencing at the wire: a shard that lost ownership
                    # (failover promoted a replica while it was gone)
                    # keeps its engine state but its emissions go
                    # nowhere — exactly-one-owner seen by every peer
                    return
            for (g, _peer), sess in list(self._sessions.items()):
                if g == guid:
                    sess.send_update(update)
            for cb in self._update_listeners:
                cb(guid, update)

        prov.on_update(bridge)

    # -- routing -------------------------------------------------------------

    def shard_of(self, guid: str) -> int:
        """The owning shard id, placing the doc on first touch."""
        mig = self._migrating.get(guid)
        if mig is not None:
            return mig["src"]
        s = self.table.lookup(guid)
        if s is not None:
            return s
        return self._place(guid)

    def owner_of(self, guid: str) -> int | None:
        """Current owner per the routing table; None if never placed.
        No placement side effect (assertions and dashboards)."""
        mig = self._migrating.get(guid)
        if mig is not None:
            return mig["src"]
        return self.table.lookup(guid)

    def provider_for(self, guid: str) -> TpuProvider:
        return self.shards[self.shard_of(guid)]

    def _load(self, s: int) -> int:
        # resident (hot+warm+cold), not slot occupancy: a tiered shard
        # is "loaded" by what it owns, not by what fits on device
        if self._is_stub(s):
            return 0
        return self.shards[s].resident_docs

    def _capacity(self, s: int) -> int:
        if self._is_stub(s):
            # a dead shard the detector hasn't convicted yet: zero
            # capacity keeps bounded-load placement off it without
            # letting the corpse raise mid-scoring
            return 0
        p = self.shards[s]
        n = p.engine.n_docs
        if p.tiers.enabled:
            return n * p.tiers.config.overcommit
        return n

    def _place(self, guid: str) -> int:
        try:
            s, shed = self.ring.place(
                guid,
                self._load,
                self._capacity,
                self.config.load_factor,
                exclude=self._unhealthy(),
            )
        except FleetFullError:
            self.metrics.placements.labels(kind="full").inc()
            raise
        self.table.assign(guid, s)
        self.metrics.placements.labels(
            kind="shed" if shed else "ring"
        ).inc()
        return s

    # -- provider facade -----------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def live_shards(self) -> list[int]:
        return [
            k for k in range(len(self.shards))
            if k not in self._retired and k not in self._down
        ]

    @property
    def doc_count(self) -> int:
        # resident across tiers (equals slot count with tiering off)
        return sum(
            p.resident_docs for k, p in enumerate(self.shards)
            if not self._is_stub(k)
        )

    @property
    def capacity(self) -> int:
        return sum(
            self._capacity(k) for k in self.live_shards
        )

    def receive_update(
        self, guid: str, update: bytes, v2: bool = False,
        undoable: bool = False, internal: bool = False,
    ) -> bool:
        """Queue one room update on its owning shard.  Inside a
        migration window the update is double-delivered (source AND
        destination journal + integrate it); the CRDT merge is
        idempotent, so the duplicate is free and the handoff can never
        drop an in-flight edit.  ``internal`` marks fleet-generated
        traffic (migration/failover/recovery state transfers) that must
        bypass admission control — it was already admitted once."""
        mig = self._migrating.get(guid)
        k = self.shard_of(guid)
        # the fleet seam is an ingress: adopt (or mint) the update's
        # trace context HERE so the replication fan-out and migration
        # double-delivery below run under the same causal identity the
        # owning shard stamps on its spans
        ctx = obs_dist.current_context()
        if ctx is None:
            ctx = obs_dist.mint_for_update(bytes(update))
        with obs_dist.use_context(ctx):
            try:
                accepted = self.shards[k].receive_update(
                    guid, update, v2=v2, undoable=undoable,
                    internal=internal,
                )
            except ShardDownError:
                # the primary's machine is gone but the detector hasn't
                # convicted it yet: the update is accepted ONLY if it
                # can be journaled synchronously on a replica — an ack
                # we hand out must never depend on the corpse alone
                self.detector.report_down(k)
                if not self.repl.absorb(guid, update, v2=v2):
                    raise
                accepted = True
            else:
                if accepted:
                    self.repl.enqueue_update(guid, update, v2=v2)
            if mig is not None:
                try:
                    # the primary already admitted this update;
                    # re-gating the duplicate would double-charge the
                    # tenant's bucket
                    self.shards[mig["dst"]].receive_update(
                        guid, update, v2=v2, internal=True
                    )
                    self.metrics.double_delivered.inc()
                except ShardDownError:
                    self.detector.report_down(mig["dst"])
        return accepted

    def _handle_frame_routed(self, guid: str, frame: bytes):
        mig = self._migrating.get(guid)
        k = self.shard_of(guid)
        try:
            reply = self.shards[k].handle_sync_message(guid, frame)
        except ShardDownError:
            # drop the frame: the session layer's ack/retransmit and
            # the post-failover rehome digest repair anything lost in
            # the unavailability window
            self.detector.report_down(k)
            reply = None
        if mig is not None:
            # the destination sees the same frame (updates journal on
            # its WAL; read frames produce a reply we discard)
            try:
                self.shards[mig["dst"]].handle_sync_message(guid, frame)
                self.metrics.double_delivered.inc()
            except ShardDownError:
                self.detector.report_down(mig["dst"])
        return reply

    def handle_sync_message(self, guid: str, message: bytes):
        return self._handle_frame_routed(guid, message)

    def sync_step1(self, guid: str) -> bytes:
        return self.provider_for(guid).sync_step1(guid)

    def text(self, guid: str) -> str:
        return self.provider_for(guid).text(guid)

    def state_vector(self, guid: str) -> dict[int, int]:
        return self.provider_for(guid).state_vector(guid)

    def encode_state_as_update(
        self, guid: str, target_sv: bytes | None = None
    ) -> bytes:
        return self.provider_for(guid).encode_state_as_update(
            guid, target_sv
        )

    def flush(self) -> None:
        for k in self.live_shards:
            if not self._is_stub(k):
                self.shards[k].flush()

    def flush_tick(self, now: float | None = None) -> bool:
        """Adaptive flush tick fan-out: each live shard's
        provider applies its own batch window, so a shard under brownout
        coalesces while a burning shard flushes every tick.  Returns
        True if any shard flushed."""
        flushed = False
        for k in self.live_shards:
            if not self._is_stub(k):
                flushed = self.shards[k].flush_tick(now) or flushed
        return flushed

    def health(self) -> dict:
        return {
            "shards": [
                {"shard": k, "state": "down"} if self._is_stub(k)
                else p.health()
                for k, p in enumerate(self.shards)
            ],
            "fleet": self.fleet_snapshot(),
        }

    def dead_letters(self, guid: str | None = None) -> list[dict]:
        if guid is not None:
            return self.provider_for(guid).dead_letters(guid)
        out = []
        for k, p in enumerate(self.shards):
            if not self._is_stub(k):
                out.extend(p.dead_letters())
        return out

    def checkpoint(self) -> list[dict | None]:
        """Checkpoint every shard's WAL, then re-journal any still-open
        migration intents (compaction drops the segments they lived in;
        a crash after the checkpoint must still see the window), and
        reseed replica copies the same way — compaction folds only
        OWNED docs, so each replica pair gets one fresh full-state
        record from its live owner."""
        out = [
            None if self._is_stub(k) else p.checkpoint()
            for k, p in enumerate(self.shards)
        ]
        for guid, mig in sorted(self._migrating.items()):
            if self._is_stub(mig["src"]):
                continue
            self.shards[mig["src"]].journal_migration(
                guid, mig["dst"], self.table.epoch
            )
        self.repl.rejournal_after_checkpoint()
        return out

    def close(self, checkpoint: bool = True) -> None:
        if getattr(self, "admin", None) is not None:
            self.admin.close()
            self.admin = None
        for k, p in enumerate(self.shards):
            if not self._is_stub(k):
                p.close(checkpoint=checkpoint)

    # -- sessions ------------------------------------------------------------

    def session(
        self, guid: str, peer: str = "peer",
        config: SessionConfig | None = None,
    ) -> SyncSession:
        """Get-or-create the fleet-level peer session for (room, peer).
        Same contract as ``TpuProvider.session`` — admission atomic
        with registration — but the host re-resolves the owning shard
        per call, so the session survives live migration."""
        key = (guid, str(peer))
        sess = self._sessions.get(key)
        if sess is not None:
            if not sess._closed:
                return sess
            del self._sessions[key]
        # place + admit first: a veto must leave no registry entry
        prov = self.provider_for(guid)
        prov.doc_id(guid)
        host = _FleetSessionHost(self, guid, str(peer))
        sess = SyncSession(
            host, config=config, metrics=self._session_metrics,
            peer=str(peer),
        )
        # arm the journaled receive floor, same as TpuProvider.session:
        # a recovered/promoted owner's WAL knows how far this peer got,
        # so the reconnect handshake RESUMES instead of full-resyncing
        hint = prov._recovered_acks.get(key)
        if hint is not None:
            sess.set_resume_hint(*hint)
        sess.policy = self.admission
        sess.routing_epoch = self.table.epoch
        self._sessions[key] = sess
        return sess

    def close_session(self, guid: str, peer: str) -> None:
        sess = self._sessions.pop((guid, str(peer)), None)
        if sess is not None:
            sess.close()
        self._session_metrics.set_state_gauges(self._sessions.values())

    def tick_sessions(self) -> None:
        for (guid, _peer), sess in list(self._sessions.items()):
            try:
                sess.tick()
            except ShardDownError:
                # the session's home shard died inside the conviction
                # window: skip this tick (ack/retransmit repairs once
                # failover rehomes the session) and feed the detector
                # so conviction isn't gated on the next probe
                k = self.table.lookup(guid)
                if k is not None:
                    self.detector.report_down(k)
        self._session_metrics.set_state_gauges(self._sessions.values())

    def sessions_snapshot(self) -> list[dict]:
        rows = []
        for (guid, _peer), sess in sorted(self._sessions.items()):
            row = sess.snapshot()
            row["guid"] = guid
            row["shard"] = self.owner_of(guid)
            rows.append(row)
        self._session_metrics.set_state_gauges(self._sessions.values())
        return rows

    def on_update(self, callback) -> None:
        """Register ``callback(guid, update_bytes)`` across the whole
        fleet (the per-shard bridges fan into it)."""
        self._update_listeners.append(callback)

    # -- live migration ------------------------------------------------------

    def begin_migration(
        self, guid: str, dst: int, reason: str = "manual"
    ) -> None:
        """Open the double-delivery window: journal the intent on the
        source, seed the destination with the source's full state.
        From here until :meth:`complete_migration`, updates and session
        frames for the doc reach BOTH shards."""
        if guid in self._migrating:
            raise RuntimeError(f"{guid!r} is already migrating")
        src = self.shard_of(guid)
        if dst == src:
            raise ValueError(f"{guid!r} already lives on shard {dst}")
        if (
            not (0 <= dst < len(self.shards))
            or not self.shard_healthy(dst)
        ):
            raise ValueError(f"shard {dst} is not a live destination")
        src_p, dst_p = self.shards[src], self.shards[dst]
        src_p.doc_id(guid)  # KeyError-grade misuse surfaces as admission
        t0 = time.perf_counter()
        # intent FIRST: recovery treats "intent without release" as the
        # open window and resolves by whether dst journaled the doc.  If
        # the seed transfer below vetoes (destination full), the stale
        # intent is harmless — dst never admitted the doc, so recovery
        # aborts to the source.
        src_p.journal_migration(guid, dst, self.table.epoch)
        src_p.flush()
        state = src_p.encode_state_as_update(guid)
        dst_p.receive_update(guid, state, internal=True)
        self._migrating[guid] = {
            "src": src, "dst": dst, "reason": reason, "t0": t0,
        }
        flight_recorder().record(
            "fleet", "migration_begin", guid=guid, shard=src,
            dst=dst, reason=reason, epoch=self.table.epoch,
        )

    def complete_migration(self, guid: str) -> None:
        """Close the window: release on the source (journals the
        durable handoff marker + frees the slot), re-apply the final
        export to the destination (idempotent), bump the routing epoch,
        re-home live sessions."""
        mig = self._migrating.get(guid)
        if mig is None:
            raise RuntimeError(f"{guid!r} is not migrating")
        src, dst = mig["src"], mig["dst"]
        # the doc's heat travels with it — a hot doc must not land on
        # the destination looking like the coldest room there
        self.shards[dst].tiers.adopt_heat(
            guid, self.shards[src].tiers.heat_of(guid)
        )
        final = self.shards[src].release_doc(guid)
        self.shards[dst].receive_update(guid, final, internal=True)
        del self._migrating[guid]
        self.table.assign(guid, dst)
        epoch = self.table.bump()
        # ownership changed: the destination journals a primary role
        # marker under the new epoch (recovery's fencing tiebreaker),
        # sheds any replica-copy bookkeeping it had for the doc, and
        # re-journals the live sessions' receive floors so a crash of
        # the NEW owner still resumes peers instead of resyncing them
        self.shards[dst].journal_repl_role(guid, "primary", epoch)
        self.repl.owner_changed(guid, dst)
        self.repl.rejournal_acks(guid, dst)
        self._mig_out[src] = self._mig_out.get(src, 0) + 1
        self._mig_in[dst] = self._mig_in.get(dst, 0) + 1
        self.metrics.migrations.labels(reason=mig["reason"]).inc()
        self.metrics.migration_seconds.observe(
            time.perf_counter() - mig["t0"]
        )
        self.metrics.epoch.set(epoch)
        flight_recorder().record(
            "fleet", "migration_complete", guid=guid, shard=dst,
            src=src, reason=mig["reason"], epoch=epoch,
        )
        for (g, _peer), sess in sorted(self._sessions.items()):
            if g == guid:
                sess.rehome(epoch)

    def migrate_doc(
        self, guid: str, dst: int, reason: str = "manual"
    ) -> None:
        """One-shot live migration (begin + complete)."""
        self.begin_migration(guid, dst, reason=reason)
        self.complete_migration(guid)

    def drain_shard(self, shard: int) -> int:
        """Migrate every doc off ``shard`` and retire it from placement
        (scale-in / maintenance).  Returns docs moved.  The shard id
        stays valid — ids are positional — but the ring stops proposing
        it and the rebalancer stops reading it."""
        if not (0 <= shard < len(self.shards)):
            raise ValueError(f"unknown shard {shard}")
        if shard in self._retired:
            return 0
        # fail BEFORE retiring anything: a drain that would wedge
        # mid-way (no free slots for the remainder) must not leave the
        # fleet half-mutated
        # suspect/dead shards are not drain destinations:
        # count free capacity on HEALTHY shards only, so the
        # fail-fast math can't promise slots a dying shard won't honor
        free_elsewhere = sum(
            self._capacity(k) - self._load(k)
            for k in self.live_shards
            if k != shard and self.shard_healthy(k)
        )
        need = self.shards[shard].resident_docs
        if need > free_elsewhere:
            raise FleetFullError(
                f"cannot drain shard {shard}: {need} docs to move but "
                f"only {free_elsewhere} free slots elsewhere — "
                "add_shard() first"
            )
        self.ring.remove(shard)
        self._retired.add(shard)
        moved = 0
        # resident_guids, not guids(): demoted (warm/cold) docs must
        # leave a retiring shard too — migration promotes them first
        for guid in self.shards[shard].tiers.resident_guids():
            if guid in self._migrating:
                continue
            dst, _shed = self.ring.place(
                guid, self._load, self._capacity,
                self.config.load_factor, exclude=self._unhealthy(),
            )
            self.migrate_doc(guid, dst, reason="drain")
            moved += 1
        self.table.bump()
        self._refresh_gauges()
        return moved

    def add_shard(self, docs: int | None = None, mesh=None) -> int:
        """Scale out: append a fresh shard, join it to the ring.  Only
        ~1/N of FUTURE placements land on it by consistent hashing; the
        rebalancer migrates existing load over as occupancy demands."""
        k = len(self.shards)
        prov = TpuProvider(
            docs or self._docs_per_shard,
            root_name=self._root_name,
            mesh=mesh,
            gc=self._gc,
            backend=self._backend,
            wal_dir=self._shard_wal_dir(k),
            wal_config=self._wal_config,
            tier_config=self._tier_config,
            admission=self.admission,
            device=_shard_device(self._device, mesh),
        )
        prov.shard_id = k
        self.shards.append(prov)
        self._attach_bridge(k, prov)
        self.ring.add(k)
        self.detector.add(k)
        self.table.bump()
        self._refresh_gauges()
        return k

    # -- ticking + introspection --------------------------------------------

    def tick(self) -> list[dict]:
        """One fleet tick: session time, one failure-detector probe
        round (confirmed deaths fail over immediately), a replication
        drain, then a rebalancer pass.  Returns the rebalance
        decisions."""
        self.tick_sessions()
        self.admission.tick()
        for k, _old, new in self.detector.tick(self._probe):
            if new == "dead":
                self.fail_over(k)
        self.repl.drain()
        decisions = self.rebalancer.tick()
        for k in self.live_shards:
            if not self._is_stub(k):
                self.shards[k].tick_tiering()
        self._refresh_gauges()
        return decisions

    def _probe(self, k: int) -> bool:
        try:
            self.shards[k].heartbeat()
            return True
        except ShardDownError:
            return False

    # -- failure detection + failover ---------------------------------------

    def fail_over(self, shard: int, reason: str = "heartbeat") -> dict:
        """Promote replicas for every doc the shard owns and fence it
        out of routing (called by ``tick()`` on a confirmed death, or
        directly by an operator)."""
        return self.failover.fail_over(shard, reason=reason)

    def kill_shard(self, shard: int) -> None:
        """Chaos: the shard's machine vanishes NOW — no flush, no
        checkpoint, WAL left as a killed process would leave it
        (``abandon``).  Every subsequent call into the shard raises
        :class:`ShardDownError` until the detector convicts it and
        ``tick()`` fails it over."""
        if not (0 <= shard < len(self.shards)):
            raise ValueError(f"unknown shard {shard}")
        if self._is_stub(shard):
            return
        prov = self.shards[shard]
        if prov.wal is not None:
            prov.wal.abandon()
        # its queued admission entries die with it — they were journaled
        # + replicated at enqueue, so failover recovers them
        self.admission.detach(prov)
        self._corpses[shard] = prov
        self.shards[shard] = DeadShard(shard)
        flight_recorder().record(
            "fleet", "shard_killed", severity="warning", shard=shard,
        )

    def revive_shard(self, shard: int) -> dict:
        """Bring a failed-over shard back as an EMPTY primary-less
        member (fresh provider, same WAL directory — the journal
        indices continue).  Fencing: any doc the corpse still held in
        memory that now belongs elsewhere is merge-released into the
        current owner (CRDT-idempotent, so a tail the corpse accepted
        right before death is recovered, never double-applied); a doc
        failover declared LOST (no replica) is re-placed from the
        corpse's copy.  The revived shard never resumes ownership by
        itself — that is the split-brain the fencing epoch exists to
        prevent.

        The fresh provider takes the fleet's ``device`` and no mesh,
        whatever mesh the killed shard had."""
        corpse = self._corpses.pop(shard, None)
        if corpse is None or not self._is_stub(shard):
            raise ValueError(f"shard {shard} was not killed")
        fresh = TpuProvider(
            self._docs_per_shard,
            root_name=self._root_name,
            gc=self._gc,
            backend=self._backend,
            wal_dir=self._shard_wal_dir(shard),
            wal_config=self._wal_config,
            tier_config=self._tier_config,
            admission=self.admission,
            device=self._device,
        )
        fresh.shard_id = shard
        self.shards[shard] = fresh
        self._attach_bridge(shard, fresh)
        self._down.discard(shard)
        if shard not in self._retired:
            self.ring.add(shard)
        self.detector.revive(shard)
        fenced: list[str] = []
        readopted: list[str] = []
        for guid in corpse.guids():
            try:
                corpse.flush()
                state = corpse.encode_state_as_update(guid)
            except Exception:
                # the corpse's in-memory copy is unreadable (mid-flush
                # kill); the replicas already carried everything acked
                continue
            own = self.owner_of(guid)
            if own is None:
                # failover declared it lost (no replica existed): the
                # corpse's copy is the only one — re-place it fresh
                self.receive_update(guid, state, internal=True)
                readopted.append(guid)
            elif own != shard:
                self.shards[own].receive_update(guid, state, internal=True)
                self.failover_metrics.fenced.inc()
                fenced.append(guid)
        epoch = self.table.bump()
        self.metrics.epoch.set(epoch)
        self._refresh_gauges()
        flight_recorder().record(
            "fleet", "shard_revived", shard=shard, epoch=epoch,
            fenced=len(fenced), readopted=len(readopted),
        )
        return {
            "shard": shard,
            "epoch": epoch,
            "fenced": sorted(fenced),
            "readopted": sorted(readopted),
        }

    def _refresh_gauges(self) -> None:
        m = self.metrics
        m.shards.set(len(self.live_shards))
        m.docs.set(self.doc_count)
        m.epoch.set(self.table.epoch)
        for k, p in enumerate(self.shards):
            lab = str(k)
            if self._is_stub(k):
                m.shard_docs.labels(shard=lab).set(0)
                m.shard_occupancy.labels(shard=lab).set(0.0)
                continue
            m.shard_docs.labels(shard=lab).set(len(p._guids))
            m.shard_occupancy.labels(shard=lab).set(round(p.occupancy, 6))

    def _shard_role(self, k: int) -> str:
        """One word for the ytpu_top ROLE column: what this shard IS
        to the docs it touches right now."""
        if self._is_stub(k) or k in self._down:
            return "dead"
        if self.detector.state_of(k) == "suspect":
            return "suspect"
        if k in self._retired:
            return "retired"
        if self.table.docs_on(k):
            return "primary"
        if self.repl.copies_on(k):
            return "replica"
        return "idle"

    def fleet_snapshot(self) -> dict:
        """JSON-able fleet state — the ``ytpu_top`` fleet-table feed."""
        self._refresh_gauges()
        rows = []
        migrating_by_shard: dict[int, int] = {}
        for mig in self._migrating.values():
            for s in (mig["src"], mig["dst"]):
                migrating_by_shard[s] = migrating_by_shard.get(s, 0) + 1
        for k, p in enumerate(self.shards):
            dead = self._is_stub(k)
            if dead:
                state = "down"
            elif k in self._down:
                state = "down"
            elif k in self._retired:
                state = "retired"
            else:
                state = "live"
            rows.append({
                "shard": k,
                "docs": 0 if dead else len(p._guids),
                "capacity": 0 if dead else p.engine.n_docs,
                "occupancy": 0.0 if dead else round(p.occupancy, 4),
                "resident": 0 if dead else p.resident_docs,
                "warm": 0 if dead else len(p.tiers.warm),
                "cold": 0 if dead else len(p.tiers.cold),
                "state": state,
                "role": self._shard_role(k),
                "dlq": 0 if dead else len(p.engine.dead_letters),
                "sessions": sum(
                    1 for (g, _pr) in self._sessions
                    if self.owner_of(g) == k
                ),
                "migrating": migrating_by_shard.get(k, 0),
                "mig_in": self._mig_in.get(k, 0),
                "mig_out": self._mig_out.get(k, 0),
                "repl_docs": len(self.repl.copies_on(k)),
                "repl_lag": self.repl.lag(k),
            })
        return {
            "epoch": self.table.epoch,
            "n_shards": len(self.shards),
            "live_shards": len(self.live_shards),
            "docs": self.doc_count,
            "capacity": self.capacity,
            "migrations_active": len(self._migrating),
            "replication": self.repl.snapshot(),
            "admission": self.admission.snapshot(),
            "shards": rows,
        }

    def metrics_snapshot(self) -> dict:
        """FEDERATED fleet snapshot: every live shard's
        engine-local registry is merged — counters sum across shards,
        gauges keep per-shard ``shard=<k>,role=<role>`` series plus the
        summed unlabeled aggregate, histograms merge count-weighted —
        and the process-global registry (fleet/replication/failover/
        admission families every shard shares) is layered in ONCE,
        un-summed.  The first live shard still contributes the
        non-registry keys (``slo``, ``tiers``, ``flush`` history), and
        the structured ``fleet`` / ``sessions`` / ``admission`` feeds
        ride along as before."""
        base: dict = {}
        sources = []
        for k, p in enumerate(self.shards):
            if self._is_stub(k):
                continue
            if not base:
                base = p.metrics_snapshot()
            sources.append({
                "label": str(k),
                "role": self._shard_role(k),
                "snapshot": registry_snapshot(p.engine.obs.registry),
            })
        # observe BEFORE scraping the global registry so the federation
        # families in this very snapshot are current
        self.fed_metrics.observe(len(sources))
        snap = dict(base)
        snap.update(federate_snapshots(
            sources, global_snapshot=registry_snapshot(global_registry())
        ))
        snap["fleet"] = self.fleet_snapshot()
        snap["sessions"] = self.sessions_snapshot()
        snap["admission"] = self.admission.snapshot()
        return snap

    # -- admin-plane surface -------------------------------------

    def metrics_text(self) -> str:
        """Prometheus exposition over every live shard's registry plus
        the process-global families — the fleet's ``/metrics`` body."""
        regs = [
            p.engine.obs.registry
            for k, p in enumerate(self.shards)
            if not self._is_stub(k)
        ]
        regs.append(global_registry())
        return prometheus_text(*regs)

    def statusz(self) -> dict:
        """The fleet's ``/statusz`` page: topology epoch, per-shard
        occupancy rows, session table, and admission verdict."""
        fs = self.fleet_snapshot()
        adm = fs["admission"]
        return {
            "role": "fleet",
            "epoch": fs["epoch"],
            "n_shards": fs["n_shards"],
            "live_shards": fs["live_shards"],
            "docs": fs["docs"],
            "capacity": fs["capacity"],
            "migrations_active": fs["migrations_active"],
            "shards": fs["shards"],
            "sessions": self.sessions_snapshot(),
            "admission": {
                "level": adm["level"],
                "level_name": adm["level_name"],
                "queue_depth": adm["queue_depth"],
            },
            # inter-region replication: present when a
            # GeoReplicator is attached over this fleet facade
            "geo": (
                None if getattr(self, "geo", None) is None
                else self.geo.snapshot()
            ),
        }

    def readiness(self) -> dict:
        """``/readyz`` for the in-process fleet: at least one live
        shard, no shard mid-recovery, brownout below reject-writes."""
        live = len(self.live_shards)
        recovering = any(
            getattr(p, "recovering", False)
            for k, p in enumerate(self.shards)
            if not self._is_stub(k)
        )
        level = self.admission.brownout.level
        ready = live > 0 and not recovering and level < 3
        return {
            "ready": ready,
            "checks": {
                "live_shards": live,
                "recovery_complete": not recovering,
                "brownout_level": level,
                "accepting_writes": level < 3,
            },
        }

    def recovery_report(self) -> dict:
        """Per-shard recovery outcomes in the SAME structured shape the
        JAX package's cluster supervisor reports: one row per shard with
        its replay outcome, plus the ownership-resolution totals from the
        last :meth:`recover`.  A fleet built fresh reports every shard as
        ``fresh`` with zeroed resolutions — ``ytpu_top --cluster``
        renders both identically."""
        rec = self.last_recovery or {}
        shard_stats = rec.get("shards") or []
        rows = []
        for k, p in enumerate(self.shards):
            stats = (
                shard_stats[k] if k < len(shard_stats) else None
            ) or p.last_recovery or {}
            if self._is_stub(k):
                state = "lost"
            elif k in self._down:
                state = "down"
            else:
                state = "live"
            rows.append({
                "shard": k,
                "state": state,
                "pid": os.getpid(),
                "port": 0,
                "restarts": 0,
                "outcome": "recovered" if stats else "fresh",
                # replayed work: tail records plus checkpoint snapshots
                # (a gracefully-closed shard restores from its snapshot)
                "records_applied": stats.get("records_applied", 0)
                + stats.get("snapshots_applied", 0),
            })
        resolution = dict(rec.get("resolution") or {})
        for kind in ("completed", "aborted", "fenced"):
            resolution.setdefault(kind, 0)
        recovered = sum(1 for r in rows if r["outcome"] == "recovered")
        return {
            "kind": "fleet",
            "epoch": self.table.epoch,
            "shards": rows,
            "events": [],
            "outcomes": {"recovered": recovered, "failover": 0},
            "resolution": resolution,
        }

    # -- recovery ------------------------------------------------------------

    @classmethod
    def recover(
        cls,
        wal_root,
        docs_per_shard: int | None = None,
        root_name: str = "text",
        gc: bool = False,
        backend: str = "auto",
        wal_config=None,
        meshes=None,
        config: FleetConfig | None = None,
        registry=None,
        tier_config=None,
        device=None,
    ) -> "FleetRouter":
        """Rebuild a fleet from a crashed predecessor's WAL root
        (``shard-000/``, ``shard-001/``, ... subdirectories).

        Each shard replays snapshot-then-tail via
        ``TpuProvider.recover``; then ownership is resolved to exactly
        one shard per doc: a pending migration intent whose destination
        journaled the doc is COMPLETED (the source's final state is
        transferred, then released — the crash landed inside the
        double-delivery window, so the destination may be missing the
        source's tail but never the reverse after the transfer); an
        intent whose destination never admitted the doc is ABORTED (the
        source keeps it).  Both resolutions journal durably, so
        re-crashing mid-recovery re-converges to the same owner.

        ``device`` places every recovered shard, as in the constructor;
        the WAL format is the JAX package's, so a root either package
        wrote recovers here."""
        root = Path(wal_root)
        by_idx: dict[int, Path] = {}
        for d in root.iterdir():
            if not (d.is_dir() and d.name.startswith("shard-")):
                continue
            try:
                by_idx[int(d.name.split("-", 1)[1])] = d
            except ValueError:
                continue
        if not by_idx:
            raise ValueError(f"no shard-*/ WAL directories under {root}")
        recovered: dict[int, TpuProvider] = {
            k: TpuProvider.recover(
                d,
                n_docs=docs_per_shard,
                root_name=root_name,
                mesh=meshes[k] if meshes else None,
                gc=gc,
                backend=backend,
                wal_config=wal_config,
                tier_config=tier_config,
                device=_shard_device(device, meshes[k] if meshes else None),
            )
            for k, d in sorted(by_idx.items())
        }
        # shard ids are positional: a WAL directory lost with its
        # machine leaves a gap, filled by an empty member at the same
        # id (its docs live on as replica copies on surviving shards,
        # promoted by the role resolution below)
        n_docs_fill = docs_per_shard or max(
            (p.engine.n_docs for p in recovered.values()), default=1
        )
        shards = [
            recovered.get(k) or TpuProvider(
                n_docs_fill,
                root_name=root_name,
                mesh=meshes[k] if meshes else None,
                gc=gc,
                backend=backend,
                wal_dir=str(root / f"shard-{k:03d}"),
                wal_config=wal_config,
                tier_config=tier_config,
                device=_shard_device(device, meshes[k] if meshes else None),
            )
            for k in range(max(by_idx) + 1)
        ]
        fleet = cls(
            docs_per_shard=docs_per_shard,
            root_name=root_name,
            gc=gc,
            backend=backend,
            wal_dir=str(root),
            wal_config=wal_config,
            config=config,
            registry=registry,
            providers=shards,
            tier_config=tier_config,
            device=device,
        )
        resolved = {"completed": 0, "aborted": 0, "deduped": 0}
        for k, p in enumerate(shards):
            pending = (p.last_recovery or {}).get(
                "migrations_pending"
            ) or {}
            for guid, intent in sorted(pending.items()):
                dst = intent.get("dst", -1)
                dst_ok = 0 <= dst < len(shards) and dst != k
                # tier_of, not has_doc: a recovered doc may have landed
                # warm/cold — it is still owned by that shard
                src_has = p.tiers.tier_of(guid) is not None
                dst_has = (
                    dst_ok
                    and shards[dst].tiers.tier_of(guid) is not None
                )
                if src_has and dst_has:
                    # window was open: destination journaled state, so
                    # complete the handoff — transfer the source's
                    # final export (it may hold a tail the destination
                    # missed), then release
                    final = p.release_doc(guid)
                    shards[dst].receive_update(guid, final, internal=True)
                    fleet.metrics.migrations.labels(
                        reason="recovery-complete"
                    ).inc()
                    resolved["completed"] += 1
                elif src_has:
                    # destination never admitted the doc: abort to src
                    fleet.metrics.migrations.labels(
                        reason="recovery-abort"
                    ).inc()
                    resolved["aborted"] += 1
                # dst-only / neither: the release record already
                # replayed — the migration finished before the crash
        resolved["fenced"] = 0
        resolved["replicas_folded"] = 0
        resolved["replica_promoted"] = 0
        # journaled role markers per shard: guid -> {"role", "epoch"}
        roles = [
            ((p.last_recovery or {}).get("repl_roles") or {})
            for p in shards
        ]
        claims: dict[str, list[tuple[int, str | None, int]]] = {}
        for k, p in enumerate(shards):
            for guid in p.guids():
                info = roles[k].get(guid) or {}
                claims.setdefault(guid, []).append(
                    (k, info.get("role"), int(info.get("epoch", 0)))
                )
        for guid, cs in sorted(claims.items()):
            # fencing-epoch rules: replica-marked holders are never
            # owner candidates while any primary claim survives;
            # conflicting primary claims resolve to the HIGHEST
            # journaled epoch (the latest failover/migration won), ties
            # and unmarked holders (epoch 0) to the lowest shard id
            primaries = sorted(
                ((e, k) for (k, role, e) in cs if role != "replica"),
                key=lambda t: (-t[0], t[1]),
            )
            if primaries:
                owner = primaries[0][1]
            else:
                # only replica copies survived (the primary's WAL
                # directory is gone): promote the freshest-marked one
                owner = sorted(
                    ((e, k) for (k, role, e) in cs),
                    key=lambda t: (-t[0], t[1]),
                )[0][1]
                fleet.failover_metrics.promotions.labels(
                    outcome="recovered"
                ).inc()
                resolved["replica_promoted"] += 1
            fleet.table.assign(guid, owner)
            for (k, role, _e) in cs:
                if k == owner:
                    continue
                # fold the losing copy into the owner, then release it
                # (CRDT-idempotent merge: a tail only the loser held is
                # recovered, shared state dedupes)
                final = shards[k].release_doc(guid)
                shards[owner].receive_update(guid, final, internal=True)
                if role == "replica":
                    reason = "recovery-replica"
                    resolved["replicas_folded"] += 1
                elif primaries and primaries[0][0] > _e:
                    # a primary claim (marked, or an original unmarked
                    # owner at epoch 0) outlived by a higher fencing
                    # epoch: the stale primary is fenced, not deduped
                    reason = "recovery-fenced"
                    resolved["fenced"] += 1
                else:
                    reason = "recovery-dedupe"
                    resolved["deduped"] += 1
                fleet.metrics.migrations.labels(reason=reason).inc()
        fleet.table.bump()
        fleet.repl.repair_all()
        fleet.last_recovery = {
            "shards": [p.last_recovery for p in shards],
            "resolution": resolved,
        }
        fleet._refresh_gauges()
        return fleet
