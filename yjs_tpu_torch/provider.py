"""The y-tpu Provider: the gating boundary of BASELINE.json's north star.

A Provider owns a fleet of documents (think: a collaboration server holding
thousands of rooms).  Pending binary updates are marshalled per doc and
integrated in one batched device step at ``flush()``; docs whose traffic
falls outside the device path's scope are transparently served by the CPU
reference core (the same wire bytes, the same sync contract — reference
README.md:101-137 describes the provider seam this implements).

Speaks the y-protocols sync framing via :mod:`yjs_tpu_torch.sync.protocol`:
step 1 (state vector) / step 2 (diff update) / incremental updates.
"""

from __future__ import annotations

import base64
import json
import os
import time
from collections import deque

from .admission import AdmissionController, AdmissionRejected
from .lib0.decoding import Decoder
from .lib0.encoding import Encoder
from .lib0 import decoding, encoding
from .obs import dist as obs_dist
from .obs.admin import maybe_start_admin
from .obs.cost import CostLedger
from .obs.slo import ConvergenceTracker
from .obs.tsdb import maybe_attach_tsdb
from .ops.engine import BatchEngine
from .ops.kernels import KernelError
from .persistence import (
    KIND_ACK,
    KIND_ADM,
    KIND_DLQ,
    KIND_GEO,
    KIND_MIGRATE,
    KIND_RELEASE,
    KIND_REPL,
    KIND_UPDATE,
    WalConfig,
    WalMetrics,
    WriteAheadLog,
)
from .sync import protocol
from .sync.session import (
    SessionConfig,
    SessionMetrics,
    SyncSession,
    encode_busy,
)
from .tiering import TierManager
from .updates import validate_update


class ProviderFullError(ValueError):
    """Raised when every engine slot is taken and a new guid arrives.

    Subclasses ``ValueError`` so older callers catching the old
    bare ``ValueError("provider is full")`` keep working; new callers
    can catch the typed error and :meth:`TpuProvider.release_doc` a
    cold room to free a slot."""


class _ProviderSessionHost:
    """Session host over one provider room (the shape
    :class:`yjs_tpu_torch.sync.session.SyncSession` drives): state vectors
    and diffs are served by the engine flush-first so they reflect
    pending traffic, and inbound frames route through
    ``handle_sync_message`` — the validation / WAL / SLO / dead-letter
    seam a session must not bypass."""

    __slots__ = ("provider", "guid", "peer")

    def __init__(self, provider: "TpuProvider", guid: str, peer: str):
        self.provider = provider
        self.guid = guid
        self.peer = peer

    def state_vector(self) -> bytes:
        p = self.provider
        p.flush()
        return p.engine.encode_state_vector(p.doc_id(self.guid))

    def diff_update(self, sv: bytes | None) -> bytes:
        return self.provider.encode_state_as_update(self.guid, sv)

    def apply_update(self, update: bytes) -> None:
        self.provider.receive_update(self.guid, update)

    def handle_frame(self, frame: bytes) -> bytes | None:
        p = self.provider
        p.cost.session_frame(self.guid)
        try:
            return p.handle_sync_message(self.guid, frame)
        except ProviderFullError as e:
            # Capacity exhaustion is an overload condition, not a
            # transport fault: record it for the admission controller
            # (which demotes cold docs to make headroom), keep the bytes
            # in the DLQ with a typed reason, and push back on the peer
            # instead of letting the error escape into its pump loop.
            p.admission.note_full("provider")
            p.engine._dead_letter(
                -1, bytes(frame), False,
                f"admission-full: {e} (peer {self.peer})",
            )
            return encode_busy(p.admission.retry_after)

    def dead_letter(self, payload: bytes, reason: str) -> None:
        p = self.provider
        try:
            doc = p.doc_id(self.guid)
        except ProviderFullError:
            p.admission.note_full("provider")
            doc = -1
        p.engine._dead_letter(
            doc, bytes(payload), False,
            f"{reason} (peer {self.peer})",
        )

    def journal_ack(self, sid: int, seq: int) -> None:
        self.provider.journal_session_ack(self.guid, self.peer, sid, seq)


class FlushTickController:
    """Adaptive flush batch window: how long a provider lets
    traffic coalesce before the next :meth:`TpuProvider.flush_tick`
    actually flushes.

    Inputs, per tick:

    - the SLO burn-rate verdict (``ConvergenceTracker.state()``):
      any non-"ok" state snaps the window to the minimum — visibility
      latency is the thing being violated, so stop batching;
    - the brownout level via
      ``AdmissionController.flush_interval_scale`` — the window is
      multiplied by the brownout scale so an overloaded shard coalesces
      flushes instead of thrashing the device, and ``force_coalesce``
      pins the window to the maximum outright;
    - idleness: a tick that found nothing dirty widens the window
      geometrically (x ``YTPU_FLUSH_TICK_GROW``) up to the maximum —
      bigger batches amortize dispatch better when nobody is waiting.

    Knobs: ``YTPU_FLUSH_TICK_MIN_MS`` (default 2), ``YTPU_FLUSH_TICK_MAX_MS``
    (default 64), ``YTPU_FLUSH_TICK_GROW`` (default 2).  Explicit
    :meth:`TpuProvider.flush` calls bypass the window entirely."""

    def __init__(self, registry=None):
        def _env(name, default):
            try:
                return float(os.environ.get(name, default))
            except ValueError:
                return float(default)

        self.min_ms = max(0.0, _env("YTPU_FLUSH_TICK_MIN_MS", 2.0))
        self.max_ms = max(self.min_ms, _env("YTPU_FLUSH_TICK_MAX_MS", 64.0))
        self.grow = max(1.0, _env("YTPU_FLUSH_TICK_GROW", 2.0))
        # current base window; starts tight so a fresh provider is
        # responsive and only widens by observing idleness
        self.window_ms = self.min_ms
        # applied windows (ms) — bench_flush reads p50/p99 from here
        self.windows: deque = deque(maxlen=512)
        self._last: float | None = None
        self._g_window = self._h_window = None
        if registry is not None:
            self._g_window = registry.gauge(
                "ytpu_flush_tick_window_ms",
                "Current adaptive flush batch window",
            )
            self._h_window = registry.histogram(
                "ytpu_flush_tick_window_seconds",
                "Adaptive flush batch windows as applied per tick",
                unit="s",
            )

    def window(self, slo_state: str, scale: float = 1.0,
               coalesce: bool = False) -> float:
        """Effective window (ms) for this tick from the SLO verdict +
        brownout inputs; mutates the base window on a burn verdict."""
        if slo_state != "ok":
            self.window_ms = self.min_ms
        w = self.max_ms if coalesce else self.window_ms
        return w * max(1.0, scale)

    def due(self, now: float, window_ms: float) -> bool:
        return self._last is None or (now - self._last) * 1000.0 >= window_ms

    def applied(self, now: float, window_ms: float, busy: bool) -> None:
        """Book one elapsed tick; idle ticks widen the base window."""
        self._last = now
        self.windows.append(window_ms)
        if self._g_window is not None:
            self._g_window.set(window_ms)
            self._h_window.observe(window_ms / 1000.0)
        if not busy:
            self.window_ms = min(
                self.max_ms, max(self.window_ms, self.min_ms, 0.001) * self.grow
            )

    def percentiles(self) -> dict:
        """p50/p99 of recently applied windows (ms) — the bench surface."""
        if not self.windows:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        xs = sorted(self.windows)
        return {
            "p50_ms": xs[len(xs) // 2],
            "p99_ms": xs[min(len(xs) - 1, int(len(xs) * 0.99))],
        }


class TpuProvider:
    """Batched multi-doc provider backed by :class:`BatchEngine`.

    ``backend`` is the selector the north star puts at the Provider
    boundary (BASELINE.json: "the Provider plugin boundary gates whether
    applyUpdate dispatches to the JS path or the TPU batch path"):

    - ``"auto"`` (default): device path, transparently demoting docs whose
      traffic is out of scope (subdocuments) to the CPU core.
    - ``"cpu"``: every doc on the CPU reference core (the interactive
      path; no device work at all).
    - ``"device"``: device path with demotion FORBIDDEN — out-of-scope
      traffic raises instead, for deployments that must not absorb CPU
      work silently.

    Durability: pass ``wal_dir`` (or set ``YTPU_WAL_DIR``) to
    journal every accepted update to a checksummed write-ahead log
    before it reaches the engine; :meth:`checkpoint` compacts the log
    into per-doc snapshots, and :meth:`recover` rebuilds a provider
    from a crashed predecessor's directory.  See
    :mod:`yjs_tpu_torch.persistence` and README "Durability".

    ``device`` places the engine's tables: ``None`` (default) is the
    CUDA device, and the constructor raises without one; pass
    ``device="cpu"`` to run the kernels' plain PyTorch versions on the
    CPU.  ``mesh=`` (a :class:`yjs_tpu_torch.parallel.DocMesh`) shards
    the engine's doc batch over its devices, as in :class:`BatchEngine`,
    whose device is then the mesh's first; :meth:`recover` takes the
    same ``mesh=``.
    """

    def __init__(
        self,
        n_docs: int,
        root_name: str = "text",
        mesh=None,
        gc: bool = False,
        backend: str = "auto",
        wal_dir=None,
        wal_config: WalConfig | None = None,
        tier_config=None,
        admission: AdmissionController | None = None,
        admission_config=None,
        device=None,
    ):
        self.backend = backend
        self.engine = BatchEngine(
            n_docs, root_name=root_name, mesh=mesh, gc=gc, policy=backend,
            device=device,
        )
        self._guids: dict[str, int] = {}
        self._guid_of: dict[int, str] = {}
        self._next = 0
        self._dirty = False
        # per-room server-side undo stacks (opt-in; see enable_undo)
        self._undo: dict[str, object] = {}
        self._undo_settings: dict[str, tuple] = {}
        # memoized attribution views (see user_data)
        self._user_data: dict[tuple[str, str], object] = {}
        # provider-level counters live on the ENGINE's registry so one
        # exposition call (metrics_text / metrics_snapshot) covers the
        # whole stack; all are no-ops under YTPU_OBS_DISABLED=1
        r = self.engine.obs.registry
        self._m_updates_rx = r.counter(
            "ytpu_provider_updates_received_total",
            "Updates queued via receive_update",
        )
        self._m_ingress_bytes = r.counter(
            "ytpu_provider_update_ingress_bytes_total",
            "Bytes of update payloads ingested (receive_update + sync "
            "step2/update frames)",
            unit="bytes",
        )
        self._m_step1 = r.counter(
            "ytpu_provider_sync_step1_total",
            "Sync step-1 messages produced (sync_step1)",
        )
        self._m_step2 = r.counter(
            "ytpu_provider_sync_step2_total",
            "Sync step-2 replies produced (handle_sync_message + batch)",
        )
        self._m_step2_bytes = r.counter(
            "ytpu_provider_sync_step2_bytes_total",
            "Bytes of framed sync step-2 replies",
            unit="bytes",
        )
        self._m_sync_msgs = r.counter(
            "ytpu_provider_sync_messages_total",
            "Sync messages handled by handle_sync_message, by frame type",
            labelnames=("type",),
        )
        self._m_undo = r.counter(
            "ytpu_provider_undo_total",
            "Server-side undo-stack operations that reverted something",
            labelnames=("op",),
        )
        self._m_events = r.counter(
            "ytpu_provider_events_delivered_total",
            "Observe-bridge events delivered to callbacks (post path "
            "filter)",
        )
        self._m_evicted = r.counter(
            "ytpu_provider_docs_evicted_total",
            "Docs released from their engine slot (release_doc + "
            "recovered release records)",
        )
        # slots freed by release_doc, reused before _next advances
        self._free: list[int] = []
        # end-to-end convergence SLO tracker: updates are keyed
        # by their natural (client, clock) first-struct id, so origin /
        # receive / integrate / visible timestamps need ZERO wire changes
        self.slo = ConvergenceTracker(r, tracer=self.engine.obs.tracer)
        # WAL metric families register unconditionally (exposition and
        # the schema checker must see them WAL or no WAL); the journal
        # itself attaches only when a directory is configured
        self._wal_metrics = WalMetrics(r)
        if wal_dir is None:
            wal_dir = os.environ.get("YTPU_WAL_DIR")
        self.wal: WriteAheadLog | None = (
            WriteAheadLog(
                wal_dir, wal_config, self._wal_metrics,
                tracer=self.engine.obs.tracer,
            )
            if wal_dir
            else None
        )
        # stats dict of the replay that built this provider (recover())
        self.last_recovery: dict | None = None
        # per-peer session layer: sessions keyed by
        # (room guid, peer name); families register unconditionally so
        # exposition and the schema checker see the full surface
        self._session_metrics = SessionMetrics(r)
        self._sessions: dict[tuple[str, str], SyncSession] = {}
        self._sessions_bridged = False
        # (guid, peer) -> (peer sid, recv floor) journaled ack facts
        # collected by replay_wal; armed onto sessions as resume hints
        self._recovered_acks: dict[tuple[str, str], tuple[int, int]] = {}
        # geo replication: region -> {"sid", "seq", "epoch"}
        # link floors collected by replay_wal; the attached GeoReplicator
        # (if any) arms them onto its WAN links as resume hints
        self._recovered_geo: dict[str, dict] = {}
        self.geo = None  # set by GeoReplicator.__init__ when attached
        # fleet membership: set by FleetRouter so admission
        # errors and dashboards name the shard, None standalone
        self.shard_id: int | None = None
        # doc lifecycle tiering: the manager (and its
        # ytpu_tier_* families) exists unconditionally, but demotion /
        # auto-eviction / promotion only activate when the config says
        # enabled — default-off keeps the hard ProviderFullError cap
        self.tiers = TierManager(self, tier_config)
        # admission control + brownout: a FLEET injects one
        # shared controller into every shard (fleet-wide tenant buckets
        # and one brownout level); standalone providers get a private
        # one.  Families register unconditionally; default-off config
        # keeps every seam check to a single attribute read.
        self.admission = (
            admission
            if admission is not None
            else AdmissionController(admission_config, registry=r)
        )
        self.admission.attach(self)
        # adaptive flush tick: paces flush_tick() callers by
        # SLO burn verdict + brownout level; explicit flush() ignores it
        self.flush_ticks = FlushTickController(r)
        # cost attribution + telemetry history: the ledger
        # rides the ingress/flush/WAL seams below; the embedded TSDB
        # sampler (one per process) adopts this provider's registry so
        # its families — ytpu_cost_* included — gain history.  Neither
        # touches engine state: output is byte-identical on or off.
        self.cost = CostLedger(r)
        self.tsdb = maybe_attach_tsdb(r)
        # mid-recovery flag the admin plane's /readyz keys off: recover() raises it around the WAL replay
        self.recovering = False
        # per-process HTTP introspection plane: opt-in for
        # library-constructed providers — serves only when
        # YTPU_ADMIN_PORT is set, so tests building hundreds of
        # providers open zero sockets.  Cluster processes embed their
        # own AdminServer around the whole shard/gateway instead.
        self.admin = maybe_start_admin(self, "provider")

    # -- doc management -----------------------------------------------------

    def doc_id(self, guid: str) -> int:
        """The engine slot for a doc guid (allocating on first use;
        slots freed by :meth:`release_doc` are reused first).

        With tiering enabled this is the demand-promotion and
        auto-eviction seam: a demoted guid is promoted back into a slot
        (warm hydrates columns, cold replays journaled state), and a
        full provider demotes its coldest eligible hot doc instead of
        raising :class:`ProviderFullError`."""
        i = self._guids.get(guid)
        if i is None:
            tiers = self.tiers
            if tiers.enabled and tiers.tier_of(guid) is not None:
                i = tiers.promote(guid)
                tiers.touch(guid)
                return i
            if self._free:
                i = self._free.pop()
            elif self._next < self.engine.n_docs:
                i = self._next
                self._next += 1
            elif tiers.enabled and tiers.make_room():
                i = self._free.pop()
            else:
                where = (
                    f"shard {self.shard_id}"
                    if self.shard_id is not None
                    else "provider"
                )
                # capacity exhaustion is a black-box moment:
                # the rejected guid and the in-flight trace land in the
                # flight recorder, and a dump ships the forensics (the
                # recorder dedupes, so a rejection burst emits one file)
                ctx = obs_dist.current_context()
                if ctx is not None:
                    ctx.force("provider_full")
                bb = self.engine.obs.blackbox
                bb.record(
                    "provider", "full", severity="error", guid=guid,
                    shard=self.shard_id,
                    trace=ctx.trace_hex if ctx is not None else None,
                    n_docs=self.engine.n_docs,
                )
                bb.dump("provider_full", guid=guid, shard=self.shard_id)
                raise ProviderFullError(
                    f"{where} is full ({self.engine.n_docs} docs); "
                    "release_doc() a cold room to admit "
                    f"{guid!r}"
                )
            self._guids[guid] = i
            self._guid_of[i] = guid
        self.tiers.touch(guid)
        return i

    def has_doc(self, guid: str) -> bool:
        """Whether the guid currently holds an engine slot (no
        allocation side effect, unlike :meth:`doc_id`)."""
        return guid in self._guids

    def guids(self) -> list[str]:
        """The rooms currently admitted, sorted (stable for the fleet
        rebalancer's deterministic candidate ordering)."""
        return sorted(self._guids)

    @property
    def occupancy(self) -> float:
        """Admitted docs / slot capacity — the gauge the fleet
        rebalancer ticks on (1.0 means the next new guid raises
        :class:`ProviderFullError`)."""
        n = self.engine.n_docs
        return (len(self._guids) / n) if n else 1.0

    @property
    def resident_docs(self) -> int:
        """Docs this provider owns across ALL tiers — hot slots plus
        warm/cold demoted rooms.  With tiering disabled this equals
        ``len(self._guids)``; the fleet router balances on this, not on
        slot occupancy, so tiered shards are compared by what they
        actually hold."""
        return self.tiers.resident_count()

    def on_update(self, callback) -> None:
        """Register ``callback(guid, update_bytes)``: the flush-emitted
        incremental update per room — the server's broadcast-to-peers seam
        (a transport pushes these as MESSAGE_YJS_UPDATE frames)."""
        def bridge(doc, update):
            # stamp the ORIGIN timestamp the moment the update is born:
            # a peer provider receiving these bytes measures end-to-end
            # convergence from here (obs/slo.py; in-process floor)
            self.slo.origin(update)
            callback(self._guid_of[doc], update)

        self.engine.on_update(bridge)

    def observe(self, guid: str, path, callback):
        """Register ``callback(guid, event)`` for events whose path starts
        with ``path`` (a sequence; ``[]`` = every type in the room;
        ``["text"]`` = the root text).  Events are YEvent-shaped dicts
        ``{"path", "delta", "keys"}`` computed from each flush's step plan
        (reference observe/observeDeep + YEvent.changes) — the server-side
        "what changed in room X" seam without replaying into a CPU doc.
        Returns an unsubscribe callable.

        Numeric list positions in ``path`` match the reference getPathTo
        (YEvent.js:207-228): one per undeleted item before the target,
        with mirror rows grouped into CPU-merged-item runs so the count
        equals what a CPU doc reports (ops/events._path_of; parity pinned
        by tests/test_engine_events.py::test_event_path_parity_*)."""
        prefix = list(path)

        def bridge(doc, events, g=guid):
            for ev in events:
                if ev["path"][: len(prefix)] == prefix:
                    self._m_events.inc()
                    callback(g, ev)

        doc = self.doc_id(guid)
        self.engine.observe(doc, bridge)

        def unobserve():
            self.engine.unobserve(doc, bridge)

        return unobserve

    # -- update plumbing ----------------------------------------------------

    def _trace_ingress(self, update: bytes) -> "obs_dist.TraceContext":
        """Establish the causal trace context for one ingress update
       : adopt the in-flight context when a session envelope
        or fleet seam already installed one, else mint deterministically
        from the update bytes — every provider hashing the same bytes
        computes the same trace id and sampling verdict."""
        ctx = obs_dist.current_context()
        origin = "adopted"
        if ctx is None:
            ctx = obs_dist.mint_for_update(bytes(update))
            origin = "minted"
        m = obs_dist.trace_metrics()
        m.contexts.labels(origin=origin).inc()
        if ctx.sampled:
            m.sampled.inc()
        return ctx

    def receive_update(
        self, guid: str, update: bytes, v2: bool = False,
        undoable: bool = False, internal: bool = False,
    ) -> bool:
        """Queue one room update.  ``undoable=True`` marks it for the
        room's undo stack when :meth:`enable_undo` is active (the server
        decides which origins' edits count — reference trackedOrigins,
        UndoManager.js:19-41).

        Returns True when the update was accepted.  False means it was
        diverted to the engine's dead-letter queue instead (the room is
        quarantined, or a CPU-served apply failed) — recoverable via
        :meth:`replay_dead_letters`; the undo replica is only fed
        accepted updates so it cannot diverge from the room.

        With admission control enabled the update passes the
        per-tenant/per-doc token buckets first: over-rate traffic is
        journaled and parked in the weighted-fair queue (still True —
        it WILL integrate, on a later flush drain), and a rejected
        update raises the typed
        :class:`~yjs_tpu_torch.admission.AdmissionRejected` before any state
        changes — internal traffic (migration, failover, recovery)
        bypasses the gate with ``internal=True``."""
        adm = self.admission
        verdict = "admit"
        if adm.enabled and not internal:
            # gate BEFORE doc_id: a rejected writer must not allocate a
            # slot, and a queued update takes its slot at drain time
            verdict = adm.admit_update(self, guid, len(update))
        ctx = self._trace_ingress(update)
        if verdict == "queue":
            if self.wal is not None:
                # journaled at ENQUEUE: the queue is host memory, and
                # zero acked-update loss must hold across a crash.  SLO
                # bookkeeping waits for the drain — queue age is traffic
                # the controller chose to shed, and letting it page the
                # interactive SLO would feed the brownout its own
                # shedding as an overload signal (self-sustaining
                # degradation, the flap hysteresis exists to prevent)
                self.wal.append(KIND_UPDATE, guid, update, v2=v2)
                self.cost.wal_bytes(guid, len(update))
            self._m_updates_rx.inc()
            self._m_ingress_bytes.inc(len(update))
            adm.enqueue(
                self, guid, bytes(update), v2, undoable, None, trace=ctx
            )
            return True
        doc = self.doc_id(guid)
        with obs_dist.use_context(ctx), self.engine.obs.tracer.span(
            "ytpu.provider.receive_update", guid=guid,
            **({"trace": ctx.trace_hex} if ctx.sampled else {}),
        ):
            key = self.slo.receive(update, v2=v2, guid=guid, trace=ctx)
            if self.wal is not None:
                # journal BEFORE integrating (write-ahead): a crash between
                # append and flush replays the update; the reverse order
                # could integrate state the log never saw
                self.wal.append(KIND_UPDATE, guid, update, v2=v2)
                self.cost.wal_bytes(guid, len(update))
            accepted = self.engine.queue_update(doc, update, v2=v2)
            self._m_updates_rx.inc()
            self._m_ingress_bytes.inc(len(update))
            if not accepted:
                self.slo.rejected(key)
                return False
            self.slo.integrated(key)
            self.cost.staged(guid, len(update))
            self._dirty = True
            ru = self._undo.get(guid)
            if ru is not None:
                ru.apply_update(update, tracked=undoable, v2=v2)
            return True

    def _integrate_admitted(
        self, guid: str, update: bytes, v2: bool, undoable: bool, slo_key
    ) -> bool:
        """Integrate one update popped from the admission queue.  The
        update was journaled at enqueue; it enters the SLO window only
        now (``slo_key=None``), so shed traffic's queue age is invisible
        to the interactive convergence verdict."""
        if slo_key is None:
            ctx = obs_dist.current_context() or obs_dist.mint_for_update(
                bytes(update)
            )
            slo_key = self.slo.receive(update, v2=v2, guid=guid, trace=ctx)
        try:
            doc = self.doc_id(guid)
        except ProviderFullError as e:
            self.admission.note_full("provider")
            self.slo.rejected(slo_key)
            self.engine._dead_letter(
                -1, update, v2, f"admission-full: {e}"
            )
            return False
        if not self.engine.queue_update(doc, update, v2=v2):
            self.slo.rejected(slo_key)
            return False
        self.slo.integrated(slo_key)
        # journaled (and WAL-costed) at enqueue; staged bytes count now,
        # when the update actually enters the next flush's batch
        self.cost.staged(guid, len(update))
        self._dirty = True
        ru = self._undo.get(guid)
        if ru is not None:
            ru.apply_update(update, tracked=undoable, v2=v2)
        return True

    # -- server-side undo ---------------------------------------------------

    def enable_undo(
        self,
        guid: str,
        scopes=None,
        capture_timeout: float = 500,
        delete_filter=None,
    ) -> "RoomUndoHandle":
        """Attach a server-side undo/redo stack to one room (reference
        UndoManager semantics, run against an opt-in CPU replica — see
        utils/server_undo.py for the design rationale).  The room itself
        stays device-resident.  Idempotent for identical settings; a
        repeat call with DIFFERENT settings raises."""
        from .utils.server_undo import RoomUndo

        norm_scopes = (
            tuple(scopes) if scopes is not None
            else (("text", self.engine.root_name),)
        )
        # idempotency compares scopes/capture_timeout only: callables have
        # no useful equality (a lambda re-created at each call site would
        # spuriously fail an identity check), so a repeat call may pass any
        # delete_filter — the one from the first call stays in effect
        settings = (norm_scopes, capture_timeout)
        if guid in self._undo:
            if self._undo_settings[guid] != settings:
                raise ValueError(
                    f"undo already enabled for {guid!r} with different "
                    "settings; disable_undo() first to reconfigure"
                )
            return RoomUndoHandle(self, guid)
        self.flush()
        i = self.doc_id(guid)
        ru = RoomUndo(
            self.engine.encode_state_as_update(i),
            scopes=norm_scopes,
            capture_timeout=capture_timeout,
            delete_filter=delete_filter,
        )
        self._undo[guid] = ru
        self._undo_settings[guid] = settings
        return RoomUndoHandle(self, guid)

    def disable_undo(self, guid: str) -> None:
        """Detach and free the room's undo replica (the room itself is
        unaffected).  No-op if undo was never enabled."""
        self._undo.pop(guid, None)
        self._undo_settings.pop(guid, None)

    def _room_undo(self, guid: str):
        ru = self._undo.get(guid)
        if ru is None:
            raise ValueError(f"undo not enabled for room {guid!r}")
        return ru

    def undo(self, guid: str) -> bytes | None:
        """Revert the room's last undoable change.  The reverting update
        is applied to the device-resident room through the normal flush
        path — peers receive it via the ``on_update`` broadcast seam like
        any other change; do NOT also send the returned bytes.  The
        return value reports what was reverted (None = nothing to
        undo)."""
        ru = self._room_undo(guid)
        u = ru.undo()
        if u is not None:
            self._m_undo.labels(op="undo").inc()
            doc = self.doc_id(guid)
            if self.wal is not None:
                # the reverting bytes are room traffic like any other:
                # recovery must replay the undo, not resurrect the text
                self.wal.append(KIND_UPDATE, guid, u)
            self.engine.queue_update(doc, u)
            self._dirty = True
            self.flush()
        return u

    def redo(self, guid: str) -> bytes | None:
        ru = self._room_undo(guid)
        u = ru.redo()
        if u is not None:
            self._m_undo.labels(op="redo").inc()
            doc = self.doc_id(guid)
            if self.wal is not None:
                self.wal.append(KIND_UPDATE, guid, u)
            self.engine.queue_update(doc, u)
            self._dirty = True
            self.flush()
        return u

    def flush(self) -> None:
        """Run one batched device integration step over all pending docs.

        Under ``backend='device'`` this raises while ANY demoted doc
        exists (not just on the flush that demoted it): the demoted docs
        stay served by the CPU core so no data is lost, but the operator
        is alerted on every flush until they act."""
        adm = self.admission
        if adm.enabled:
            # integrate queued over-rate traffic first (weighted-fair,
            # bounded batch) so it rides this flush's device step
            adm.drain_for(self)
        if self._dirty:
            # reset BEFORE the engine call and restore only if it fails:
            # raising after the engine integrated (as the device-policy
            # check below does) must not leave the provider re-flushing
            # already-integrated work forever
            self._dirty = False
            tracer = self.engine.obs.tracer
            try:
                with tracer.span("ytpu.provider.flush"):
                    self.engine.flush()
                    # visibility stamps (and the flow-arrow landings)
                    # belong INSIDE the flush span: this is the moment
                    # the queued updates became readable
                    self.slo.visible(tracer=tracer)
                # cost attribution: split this flush's
                # device/host seconds across the docs staged since the
                # last one, weighted by staged bytes
                self.cost.on_flush(self.engine.last_flush_metrics)
            except Exception as e:
                self._dirty = True  # flush incomplete: retry next call
                # an unhandled flush exception is exactly what the
                # black box exists for: snapshot the ring before the
                # error unwinds into the caller
                bb = self.engine.obs.blackbox
                bb.record(
                    "provider", "flush_exception", severity="error",
                    shard=self.shard_id,
                    error=f"{type(e).__name__}: {e}",
                )
                bb.dump("flush_exception", shard=self.shard_id)
                raise
        if self.backend == "device" and self.engine.fallback:
            d = self.engine.demotions[0]
            raise RuntimeError(
                f"backend='device' forbids CPU fallback: doc "
                f"{self._guid_of.get(d['doc'], d['doc'])!r} demoted "
                f"({d['reason']}); {len(self.engine.fallback)} doc(s) on "
                f"the CPU path"
            )

    def flush_tick(self, now: float | None = None) -> bool:
        """Adaptive flush tick: flush only when the current
        batch window has elapsed.

        The window comes from :class:`FlushTickController` — tightened
        to the minimum while the SLO burn verdict is not "ok", widened
        geometrically while ticks find nothing dirty, and scaled (or
        pinned to the maximum under ``force_coalesce``) by the brownout
        level.  ``now`` is injectable for deterministic tests.  Returns
        True when a flush actually ran."""
        if now is None:
            now = time.monotonic()
        ticks = self.flush_ticks
        adm = self.admission
        scale = float(getattr(adm, "flush_interval_scale", 1.0))
        coalesce = bool(getattr(adm, "force_coalesce", False))
        w = ticks.window(self.slo.state(), scale, coalesce)
        if not ticks.due(now, w):
            return False
        if adm.enabled:
            adm.drain_for(self)
        busy = self._dirty
        if busy:
            self.flush()
        ticks.applied(now, w, busy)
        return busy

    # -- y-protocols sync framing ------------------------------------------

    def sync_step1(self, guid: str) -> bytes:
        """Message announcing this doc's state vector (sync step 1)."""
        enc = Encoder()
        encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_1)
        encoding.write_var_uint8_array(enc, self.engine.encode_state_vector(self.doc_id(guid)))
        self._m_step1.inc()
        return enc.to_bytes()

    def handle_sync_message(self, guid: str, message: bytes) -> bytes | None:
        """Process one sync message for a doc; returns the reply, if any.

        Integrates pending traffic before answering step 1 so the emitted
        diff reflects everything received so far.
        """
        dec = Decoder(message)
        doc = self.doc_id(guid)
        try:
            msg_type = decoding.read_var_uint(dec)
        except Exception as e:
            self._m_sync_msgs.labels(type="bad").inc()
            self.engine._dead_letter(
                doc, message, False, f"bad-frame: {type(e).__name__}: {e}"
            )
            return None
        if msg_type == protocol.MESSAGE_YJS_SYNC_STEP_1:
            self._m_sync_msgs.labels(type="step1").inc()
            self.flush()
            try:
                remote_sv = decoding.read_var_uint8_array(dec)
                diff = self.engine.encode_state_as_update(doc, remote_sv)
            except KernelError:
                raise  # a dead kernel is no fault of the frame
            except Exception as e:
                # truncated frame or garbage state vector: dead-letter
                # and stay silent — the peer re-requests on reconnect
                self._m_sync_msgs.labels(type="bad").inc()
                self.engine._dead_letter(
                    doc, message, False,
                    f"bad-frame: {type(e).__name__}: {e}",
                )
                return None
            enc = Encoder()
            encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_2)
            encoding.write_var_uint8_array(enc, diff)
            reply = enc.to_bytes()
            self._m_step2.inc()
            self._m_step2_bytes.inc(len(reply))
            return reply
        if msg_type in (protocol.MESSAGE_YJS_SYNC_STEP_2, protocol.MESSAGE_YJS_UPDATE):
            self._m_sync_msgs.labels(
                type="step2"
                if msg_type == protocol.MESSAGE_YJS_SYNC_STEP_2
                else "update"
            ).inc()
            try:
                u = decoding.read_var_uint8_array(dec)
                validate_update(u)
            except Exception as e:
                # truncated frame or undecodable payload: the transport
                # handed us damage — keep the whole frame recoverable in
                # the dead-letter queue and keep serving the room (the
                # peer's next sync step repairs the gap).  Validating at
                # the network seam keeps transport damage out of the
                # engine entirely: no rollback, no demotion.
                self._m_sync_msgs.labels(type="bad").inc()
                self.engine._dead_letter(
                    doc, message, False,
                    f"bad-frame: {type(e).__name__}: {e}",
                )
                return None
            self._m_ingress_bytes.inc(len(u))
            ctx = self._trace_ingress(u)
            adm = self.admission
            if adm.enabled:
                # the admission seam for session DATA / plain update
                # frames: a veto becomes a BUSY/retry-after envelope
                # reply (enhanced peers back off and coalesce; plain
                # y-protocols readers skip it) — never a silent drop
                try:
                    verdict = adm.admit_update(self, guid, len(u))
                except AdmissionRejected as e:
                    self._m_sync_msgs.labels(type="rejected").inc()
                    return encode_busy(e.retry_after)
                if verdict == "queue":
                    # journaled now (durability), SLO-received at drain
                    # (shed traffic must not page the interactive SLO)
                    if self.wal is not None:
                        self.wal.append(KIND_UPDATE, guid, u)
                    adm.enqueue(
                        self, guid, bytes(u), False, False, None,
                        trace=ctx,
                    )
                    return None
            with obs_dist.use_context(ctx):
                key = self.slo.receive(u, guid=guid, trace=ctx)
                if self.wal is not None:
                    # journal the PAYLOAD, post-validation: transport
                    # damage (dead-lettered above) never enters the
                    # durable log
                    self.wal.append(KIND_UPDATE, guid, u)
                if self.engine.queue_update(doc, u):
                    self._dirty = True
                    self.slo.integrated(key)
                else:
                    self.slo.rejected(key)
            return None
        # unknown frame type (newer protocol revision, or a corrupted
        # type varint): count and skip — a hostile peer must not be able
        # to crash the room by sending one unknown frame
        self._m_sync_msgs.labels(type="unknown").inc()
        self.engine._dead_letter(
            doc, message, False, f"unknown-frame: type {msg_type}"
        )
        return None

    def handle_sync_step1_batch(
        self, messages: list[tuple[str, bytes]]
    ) -> list[bytes]:
        """Answer many concurrent sync-step-1 messages with ONE device
        dispatch (the server's fan-in moment: N clients reconnect, N diffs
        computed by one ``diff_mask_kernel`` call).  Returns the framed
        step-2 reply per message."""
        from .updates import decode_state_vector

        self.flush()
        requests = []
        for guid, message in messages:
            dec = Decoder(message)
            msg_type = decoding.read_var_uint(dec)
            if msg_type != protocol.MESSAGE_YJS_SYNC_STEP_1:
                raise ValueError("batch handler only accepts sync step 1")
            remote_sv = decode_state_vector(decoding.read_var_uint8_array(dec))
            requests.append((self.doc_id(guid), remote_sv))
        updates = self.engine.sync_step2_batch(requests)
        replies = []
        for u in updates:
            enc = Encoder()
            encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_2)
            encoding.write_var_uint8_array(enc, u)
            replies.append(enc.to_bytes())
        self._m_sync_msgs.labels(type="step1").inc(len(messages))
        self._m_step2.inc(len(replies))
        self._m_step2_bytes.inc(sum(len(rep) for rep in replies))
        return replies

    # -- peer sessions --------------------------------------------

    def _ensure_session_bridge(self) -> None:
        """Lazily register the flush-emitted-update → sessions fan-out
        (only providers that actually host sessions pay the listener)."""
        if self._sessions_bridged:
            return
        self._sessions_bridged = True

        def bridge(doc, update):
            g = self._guid_of.get(doc)
            if g is None:
                return
            self.slo.origin(update)
            for (sg, _peer), sess in list(self._sessions.items()):
                if sg == g:
                    sess.send_update(update)

        self.engine.on_update(bridge)

    def session(
        self, guid: str, peer: str = "peer",
        config: SessionConfig | None = None,
    ) -> SyncSession:
        """Get-or-create the :class:`SyncSession` for (room, peer).

        The session shares the provider's ``ytpu_net_*`` metric
        families, receives the room's flush-emitted updates, routes
        inbound frames through :meth:`handle_sync_message`, journals
        ack floors to the WAL, and — after :meth:`recover` — starts
        armed with the journaled resume hint so its first HELLO asks
        the surviving peer for delta catch-up, not a full resync.
        Attach a transport with ``session.connect(transport)`` and
        drive :meth:`tick_sessions` at the server's cadence."""
        key = (guid, str(peer))
        sess = self._sessions.get(key)
        if sess is not None:
            if not sess._closed:
                return sess
            # drop the closed carcass BEFORE admission: if doc_id vetoes
            # below, the registry must hold nothing for this key — a
            # half-registered peer would be ticked/snapshotted forever
            del self._sessions[key]
        # admission is atomic with registration: doc_id either allocates
        # the slot or raises ProviderFullError with no bridge registered
        # and no registry entry left behind
        self.doc_id(guid)  # allocate (or veto: ProviderFullError) now
        # an attached peer is a stronger liveness signal than a stray
        # read: weight the touch so sessioned rooms out-heat idle ones
        self.tiers.touch(guid, self.tiers.config.session_weight)
        self._ensure_session_bridge()
        host = _ProviderSessionHost(self, guid, str(peer))
        sess = SyncSession(
            host, config=config, metrics=self._session_metrics,
            peer=str(peer),
        )
        hint = self._recovered_acks.get(key)
        if hint is not None:
            sess.set_resume_hint(*hint)
        # sessions read the live brownout flags (coalesce, anti-entropy
        # pause) straight off the controller every tick
        sess.policy = self.admission
        self._sessions[key] = sess
        return sess

    def close_session(self, guid: str, peer: str) -> None:
        sess = self._sessions.pop((guid, str(peer)), None)
        if sess is not None:
            sess.close()
        self._session_metrics.set_state_gauges(self._sessions.values())

    def tick_sessions(self) -> None:
        """One session-time tick for every peer session (retransmit
        backoff, heartbeats, liveness, anti-entropy) + gauge refresh.
        Also advances the admission/brownout clock when this provider
        owns it (a fleet claims the tick for itself)."""
        self.admission.maybe_tick(self)
        for sess in list(self._sessions.values()):
            sess.tick()
        self._session_metrics.set_state_gauges(self._sessions.values())

    def sessions_snapshot(self) -> list[dict]:
        """Per-peer session rows (guid, state, outbox depth,
        retransmits, last-ack age, ...) — the ``ytpu_top`` feed."""
        rows = []
        for (guid, _peer), sess in sorted(self._sessions.items()):
            row = sess.snapshot()
            row["guid"] = guid
            rows.append(row)
        self._session_metrics.set_state_gauges(self._sessions.values())
        return rows

    def journal_session_ack(
        self, guid: str, peer: str, sid: int, seq: int
    ) -> None:
        """Journal "room ``guid`` holds peer session ``sid`` up to
        ``seq``" (KIND_ACK).  Recovery replays these into resume hints:
        a rebuilt provider's sessions resume retransmission from the
        floor instead of forcing a full resync."""
        if self.wal is None or not sid:
            return
        payload = json.dumps(
            {"peer": peer, "sid": sid, "seq": seq}
        ).encode("utf-8")
        self.wal.append(KIND_ACK, guid, payload)

    def journal_geo_link(
        self, peer: str, sid: int, seq: int, epoch: int
    ) -> None:
        """Journal a geo link floor (KIND_GEO): "our WAN session with
        region ``peer`` holds ``sid`` up to ``seq`` at fencing epoch
        ``epoch``".  Region-scoped (empty guid); the last record per
        peer stands.  Recovery replays the floors into
        ``_recovered_geo`` so a kill -9'd region's GeoReplicator
        resumes its links instead of full-resyncing the doc space."""
        if self.wal is None or not sid:
            return
        payload = json.dumps(
            {"peer": str(peer), "sid": int(sid), "seq": int(seq),
             "epoch": int(epoch)},
            separators=(",", ":"),
        ).encode("utf-8")
        self.wal.append(KIND_GEO, "", payload)

    def journal_migration(self, guid: str, dst: int, epoch: int) -> None:
        """Journal a migration intent (KIND_MIGRATE): "room ``guid`` is
        moving to shard ``dst`` at routing epoch ``epoch``".  Written by
        the fleet BEFORE any state reaches the destination; the later
        release record marks the handoff complete.  Recovery surfaces
        intents with no matching release as ``migrations_pending`` so
        a fleet router's ``recover`` can resolve ownership
        to exactly one shard (no-op without a WAL — migration is then
        safe only against in-process failures, same as every other
        journal seam)."""
        if self.wal is None:
            return
        payload = json.dumps(
            {"dst": int(dst), "epoch": int(epoch)}
        ).encode("utf-8")
        self.wal.append(KIND_MIGRATE, guid, payload)

    def journal_repl_role(
        self, guid: str, role: str, epoch: int, primary: int | None = None
    ) -> None:
        """Journal a replication role marker (KIND_REPL): "this WAL
        holds ``guid`` as a ``replica`` copy" or "this shard owns
        ``guid`` as of fencing epoch ``epoch``" (promotion).  The last
        marker for a guid stands; a release record clears it.  Recovery
        surfaces the markers so replica journals are never mistaken for
        split-brain owners and a stale primary's claim loses to a newer
        promotion epoch."""
        if self.wal is None:
            return
        info: dict = {"role": str(role), "epoch": int(epoch)}
        if primary is not None:
            info["primary"] = int(primary)
        self.wal.append(
            KIND_REPL, guid,
            json.dumps(info, separators=(",", ":")).encode("utf-8"),
        )

    def journal_admission(
        self, level: str, reason: str, tick: int
    ) -> None:
        """Journal a brownout level transition (KIND_ADM): "the
        admission controller entered ``level`` at controller tick
        ``tick`` because ``reason``".  Fleet-scoped (empty guid);
        recovery surfaces a count and the last level for forensics —
        the live level always restarts at normal."""
        if self.wal is None:
            return
        payload = json.dumps(
            {"level": str(level), "reason": str(reason), "tick": int(tick)},
            separators=(",", ":"),
        ).encode("utf-8")
        self.wal.append(KIND_ADM, "", payload)

    def journal_replica_record(
        self, kind: int, guid: str, payload: bytes, v2: bool = False
    ) -> bool:
        """Append one fanned-out replication record to this shard's WAL
        without touching the engine (replica copies are journal-only
        until promotion materializes them).  Returns False when the
        shard has no WAL — the caller then falls back to its in-memory
        mirror so availability survives journal-less fleets."""
        if self.wal is None:
            return False
        self.wal.append(kind, guid, payload, v2=v2)
        return True

    def heartbeat(self) -> dict:
        """Cheap liveness probe for the fleet failure detector: touches
        no engine state, answers from host-side bookkeeping only.  A
        dead shard's stub raises instead."""
        return {
            "shard": self.shard_id,
            "docs": len(self._guids),
            "resident": self.resident_docs,
        }

    def _journal_ack_floors(self) -> None:
        """Re-append every known ack floor (live sessions win over
        recovered hints) — called after checkpoint compaction drops the
        journaled history the floors lived in."""
        if self.wal is None:
            return
        floors = dict(self._recovered_acks)
        for (guid, peer), sess in self._sessions.items():
            if sess._peer_sid:
                floors[(guid, peer)] = (sess._peer_sid, sess._recv_cum)
        for (guid, peer), (sid, seq) in sorted(floors.items()):
            payload = json.dumps(
                {"peer": peer, "sid": sid, "seq": seq}
            ).encode("utf-8")
            self.wal.append(KIND_ACK, guid, payload)

    def _journal_geo_floors(self) -> None:
        """Re-append every known geo link floor (live links win over
        recovered hints) after checkpoint compaction — same idiom as
        :meth:`_journal_ack_floors`."""
        if self.wal is None:
            return
        floors = dict(self._recovered_geo)
        if self.geo is not None:
            floors.update(self.geo.link_floors())
        for peer, f in sorted(floors.items()):
            self.journal_geo_link(
                peer, f.get("sid", 0), f.get("seq", 0), f.get("epoch", 0)
            )

    # -- state accessors ----------------------------------------------------

    def text(self, guid: str) -> str:
        self.flush()
        return self.engine.text(self.doc_id(guid))

    def to_delta(
        self,
        guid: str,
        snapshot=None,
        prev_snapshot=None,
        compute_ychange=None,
    ) -> list:
        """Attributed rich-text delta of the room's root text (reference
        YText.toDelta) — served from the mirror, no CPU replay.  With
        ``snapshot``/``prev_snapshot``, the point-in-time / two-snapshot
        diff view with ychange attribution (YText.js:936-1030)."""
        self.flush()
        return self.engine.to_delta(
            self.doc_id(guid),
            snapshot=snapshot,
            prev_snapshot=prev_snapshot,
            compute_ychange=compute_ychange,
        )

    def snapshot(self, guid: str):
        """Capture the room's point-in-time Snapshot (SV + DS) without
        demoting it off the device (reference Snapshot.js snapshot())."""
        self.flush()
        return self.engine.snapshot(self.doc_id(guid))

    def create_doc_from_snapshot(self, guid: str, snap, new_doc=None):
        """Rewind the room to ``snap`` as a standalone CPU Doc (reference
        Snapshot.js:162-202); the device-resident room is untouched."""
        self.flush()
        return self.engine.create_doc_from_snapshot(
            self.doc_id(guid), snap, new_doc
        )

    # -- user attribution (PermanentUserData queries) -----------------------

    def user_data(self, guid: str, store_name: str = "users"):
        """Attribution view over the room's PermanentUserData map
        (reference src/utils/PermanentUserData.js:15-142), served from
        mirror columns — the room stays device-resident.

        Deployment model (same as the reference's): editing CLIENTS call
        setUserMapping on their own docs, so the ``users`` map arrives as
        ordinary update traffic and the mirror hosts it like any root
        type.  The server answers ``user_by_client_id`` /
        ``user_by_deleted_id`` by reading the map straight out of the
        mirror (ids arrays, encoded-DeleteSet blobs) — no CPU doc, no
        observers, no replica.  The handle is memoized per (guid,
        store_name) so the per-query call pattern
        ``prov.user_data(g).user_by_client_id(c)`` actually hits the
        content_gen parse cache."""
        key = (guid, store_name)
        rud = self._user_data.get(key)
        if rud is None:
            rud = RoomUserData(self, guid, store_name)
            self._user_data[key] = rud
        return rud

    # -- cursors (relative positions) ---------------------------------------

    def create_relative_position(self, guid: str, index: int,
                                 name: str | None = None):
        """Stable cursor at ``index`` of the room's root type ``name``
        (reference createRelativePositionFromTypeIndex,
        RelativePosition.js:85-104), computed from the device-resident
        room's mirror columns — no CPU-doc materialization per keystroke.
        The result is wire/JSON compatible with JS peers
        (encode_relative_position / to_json)."""
        self.flush()
        return self.engine.relative_position_from_index(
            self.doc_id(guid), index, name
        )

    def resolve_relative_position(self, guid: str, rpos) -> int | None:
        """Resolve a cursor to the current index (reference
        createAbsolutePositionFromRelativePosition,
        RelativePosition.js:214-262).  None = anchor unknown/GC'd.

        Rooms with server-side undo enabled resolve through their CPU
        replica, which runs the reference follow-redone walk verbatim —
        cursors anchored in undone-then-redone content land on the
        redone items.  ``redone`` pointers exist ONLY where an
        UndoManager performed the redo (they are never on the wire), so
        rooms without undo have no chains to follow and resolve straight
        from mirror columns."""
        from .utils.relative_position import (
            create_absolute_position_from_relative_position,
        )

        self.flush()
        ru = self._undo.get(guid)
        if ru is not None:
            a = create_absolute_position_from_relative_position(
                rpos, ru.replica
            )
            return None if a is None else a.index
        return self.engine.absolute_index_from_relative(
            self.doc_id(guid), rpos
        )

    def xml_string(self, guid: str) -> str:
        """XML serialization of the room's root fragment (reference
        YXmlFragment.toString) — served from the mirror."""
        self.flush()
        return self.engine.xml_string(self.doc_id(guid))

    def state_vector(self, guid: str) -> dict[int, int]:
        self.flush()
        return self.engine.state_vector(self.doc_id(guid))

    def encode_state_as_update(self, guid: str, target_sv: bytes | None = None) -> bytes:
        self.flush()
        return self.engine.encode_state_as_update(self.doc_id(guid), target_sv)

    @property
    def n_fallback_docs(self) -> int:
        return len(self.engine.fallback)

    @property
    def demotions(self) -> list[dict]:
        """Every device→CPU demotion with its reason, keyed by room guid —
        scope gaps are measurable, not silent."""
        return [
            {"guid": self._guid_of.get(d["doc"], d["doc"]),
             "reason": d["reason"]}
            for d in self.engine.demotions
        ]

    @property
    def metrics(self) -> dict | None:
        """Host per-phase timers + batch stats of the last flush, as a
        DEFENSIVE COPY (mutating the returned dict cannot corrupt the
        engine's flush history; before this was the live dict).

        The key set is stable across every flush mode (apply / levels /
        seq / ``YTPU_NO_NATIVE_PLAN``) and is exactly
        ``yjs_tpu_torch.obs.FLUSH_METRICS_SCHEMA``: counts ``n_docs_flushed``,
        ``n_demoted``, ``n_rolled_back``, ``n_fallback_docs``, ``n_rows_max``,
        ``n_sched_entries``, ``n_levels``, ``level_width``,
        ``n_pending_docs``, ``pending_depth``, ``plan_threads``; the
        ``schedule_occupancy`` ratio; and the per-phase second timers
        ``t_compact_s``, ``t_plan_s``, ``t_pack_s``, ``t_dispatch_s``,
        ``t_emit_s``, ``t_total_s``.  ``None`` before the first flush."""
        m = self.engine.last_flush_metrics
        return None if m is None else dict(m)

    @property
    def metrics_history(self) -> list[dict]:
        """Per-flush metric dicts, oldest to newest (copies), for the last
        ``YTPU_OBS_HISTORY`` flushes."""
        return self.engine.obs.history.snapshot()

    def metrics_text(self) -> str:
        """Prometheus exposition-format dump of the whole stack: provider
        counters, engine flush metrics, sync-protocol frame counters."""
        return self.engine.metrics_text()

    def metrics_snapshot(self) -> dict:
        """JSON-able snapshot of the whole stack (see
        BatchEngine.metrics_snapshot), plus the provider's convergence
        SLO state under ``"slo"``."""
        # tier snapshot FIRST: it refreshes the ytpu_tier_* gauges the
        # engine snapshot is about to read
        tiers = self.tiers.snapshot()
        snap = self.engine.metrics_snapshot()
        snap["slo"] = self.slo.snapshot()
        snap["sessions"] = self.sessions_snapshot()
        snap["tiers"] = tiers
        snap["admission"] = self.admission.snapshot()
        snap["cost"] = self.cost.snapshot()
        if self.geo is not None:
            snap["geo"] = self.geo.snapshot()
        return snap

    def slo_snapshot(self) -> dict:
        """Convergence-SLO state: target, per-window burn rates, and the
        ok/warning/page verdict (see :class:`yjs_tpu_torch.obs.slo.ConvergenceTracker`)."""
        return self.slo.snapshot()

    # -- admin-plane surface -------------------------------------

    def residue_fraction(self) -> float | None:
        """Fraction of last-flush planned structs handed to the
        sequential YATA conflict fallback (``None`` before the first
        flush with planner work) — the ROADMAP's top hot-spot number."""
        m = self.engine.last_flush_metrics or {}
        planned = (
            m.get("plan_segment_fast", 0) + m.get("plan_segment_residue", 0)
        )
        if not planned:
            return None
        return m.get("plan_segment_residue", 0) / planned

    def statusz(self) -> dict:
        """The one-page JSON status the admin plane serves at
        ``/statusz``: identity, occupancy across tiers, session table,
        SLO verdict, brownout level, plan-cache hit rate, and the
        segment-residue fraction."""
        from .obs import global_registry

        reg = global_registry()

        def _val(name):
            return getattr(reg.get(name), "value", 0)

        hits = _val("ytpu_plan_cache_hits_total")
        probes = hits + _val("ytpu_plan_cache_misses_total")
        adm = self.admission.snapshot()
        rec = self.last_recovery or {}
        frac = self.residue_fraction()
        return {
            "role": "provider" if self.shard_id is None else "shard",
            "shard": self.shard_id,
            "docs": len(self._guids),
            "capacity": self.engine.n_docs,
            "occupancy": round(self.occupancy, 4),
            "resident_docs": self.resident_docs,
            "fallback_docs": self.n_fallback_docs,
            "tiers": self.tier_snapshot(),
            "sessions": self.sessions_snapshot(),
            "slo": self.slo_snapshot(),
            "health": self.health(),
            "admission": {
                "level": adm["level"],
                "level_name": adm["level_name"],
                "queue_depth": adm["queue_depth"],
            },
            "plan_cache_hit_rate": (
                round(hits / probes, 4) if probes else None
            ),
            "residue_fraction": (
                None if frac is None else round(frac, 4)
            ),
            "recovering": self.recovering,
            "recovered_records": rec.get("records_applied", 0),
            "geo": None if self.geo is None else self.geo.snapshot(),
        }

    def readiness(self) -> dict:
        """The ``/readyz`` verdict: ready iff recovery is complete and
        the brownout ladder sits below reject-writes.  Reads only plain
        attributes — a readiness probe must never contend on engine
        locks (liveness is ``/healthz``'s job; this answers "should you
        route traffic here")."""
        level = self.admission.brownout.level
        ready = (not self.recovering) and level < 3
        return {
            "ready": ready,
            "checks": {
                "recovery_complete": not self.recovering,
                "brownout_level": level,
                "accepting_writes": level < 3,
            },
        }

    def trace_events(self) -> list[dict]:
        """Bounded recent-span dump for the admin plane's
        ``/debug/trace``."""
        return self.engine.obs.tracer.trace_events()

    # -- tiering surface ------------------------------------------

    def demote_doc(self, guid: str, tier: str = "warm") -> bool:
        """Manually push a hot room down a tier (``"warm"`` exports its
        columns to host and frees the slot; ``"cold"`` additionally folds
        it into a WAL tier record).  The room stays addressable — the
        next :meth:`doc_id` touch promotes it back.  Raises KeyError for
        an unknown guid, ValueError for an undemotable one (CPU-fallback
        or observed rooms are slot-bound)."""
        return self.tiers.demote(guid, tier)

    def tick_tiering(self) -> None:
        """Periodic tier maintenance: enforce the warm-tier bound and
        run one tombstone/GC compaction pass over eligible hot docs.
        No-op when tiering is disabled; the fleet router calls this from
        its own ``tick()``."""
        self.tiers.tick()

    def tier_snapshot(self) -> dict:
        """JSON-able tier occupancy: per-tier doc counts, host/cold
        byte footprints, and the active ``YTPU_TIER_*`` config."""
        return self.tiers.snapshot()

    # -- resilience surface ---------------------------------------

    def health(self, guid: str | None = None) -> dict:
        """Health of one room (``{"state", "consecutive_failures", ...}``;
        rooms never seen failing report healthy), or — with no guid —
        the fleet summary ``{"degraded", "quarantined", "tick"}``."""
        h = self.engine.health
        if guid is None:
            return h.summary()
        rec = h.record(self.doc_id(guid))
        rec["guid"] = guid
        return rec

    def dead_letters(self, guid: str | None = None) -> list[dict]:
        """Dead letters (oldest-first, JSON-able views), optionally for
        one room.  Raw bytes stay in the engine's queue — replay them
        with :meth:`replay_dead_letters`."""
        doc = None if guid is None else self.doc_id(guid)
        out = []
        for e in self.engine.dead_letters.list(doc=doc):
            d = e.as_dict()
            d["guid"] = self._guid_of.get(e.doc)
            out.append(d)
        return out

    def replay_dead_letters(
        self, guid: str | None = None, seqs=None, repair=None,
        readmit: bool = True, max_letters: int | None = None,
    ) -> dict:
        """Re-inject dead letters (one room, or all) through the normal
        ingestion path after a fix — see
        :meth:`BatchEngine.replay_dead_letters`.  ``readmit`` defaults
        to True here: an operator replaying a room's letters means "I
        fixed it", which should override the quarantine backoff."""
        doc = None if guid is None else self.doc_id(guid)
        if self.wal is not None:
            # replayed letters re-enter via engine.queue_update, below
            # the provider's journal seam — wrap the repair hook so the
            # bytes actually replayed are journaled like fresh traffic
            inner = repair

            def repair(e, _inner=inner):
                fixed = _inner(e) if _inner is not None else e.update
                if fixed is not None:
                    g = self._guid_of.get(e.doc)
                    if g is not None:
                        self.wal.append(
                            KIND_UPDATE, g, bytes(fixed), v2=e.v2
                        )
                return fixed

        res = self.engine.replay_dead_letters(
            doc=doc, seqs=seqs, repair=repair, readmit=readmit,
            max_letters=max_letters,
        )
        if res["replayed"]:
            self._dirty = True
        return res

    def resilience_snapshot(self) -> dict:
        """JSON-able failure-isolation state with room guids attached."""
        snap = self.engine.resilience_snapshot()
        for rec in snap["docs"]:
            rec["guid"] = self._guid_of.get(rec["doc"])
        return snap

    # -- durability surface ---------------------------------------

    def checkpoint(self) -> dict | None:
        """Fold the WAL into per-doc snapshots + the DLQ dump and
        truncate the journaled history (see
        :meth:`yjs_tpu_torch.persistence.WriteAheadLog.checkpoint`).  One
        batched ``encode_states_batched`` dispatch snapshots the whole
        fleet.  Returns the compaction stats (None without a WAL)."""
        if self.wal is None:
            return None
        self.flush()
        docs = sorted(self._guid_of)
        snaps = self.engine.encode_states_batched(docs)
        pairs = [(self._guid_of[i], s) for i, s in zip(docs, snaps)]
        # demoted docs join the checkpoint too (materializing cold
        # locators BEFORE compaction deletes the segments they point at)
        pairs.extend(self.tiers.demoted_snapshots())
        res = self.wal.checkpoint(pairs, self._dump_dlq())
        # compaction dropped the segments the session ack floors lived
        # in: re-journal them so a crash after this checkpoint still
        # resumes peer retransmission instead of full-resyncing
        self._journal_ack_floors()
        self._journal_geo_floors()
        # same idiom for the tier demote markers + cold locators
        self.tiers.rejournal()
        return res

    def close(self, checkpoint: bool = True) -> None:
        """Orderly shutdown: flush, write a final checkpoint (so restart
        recovery is one snapshot read, no tail replay), seal the WAL.
        Safe without a WAL (just flushes)."""
        self.flush()
        if self.wal is not None:
            if checkpoint:
                self.checkpoint()
            self.wal.close()
        if self.admin is not None:
            self.admin.close()

    def release_doc(self, guid: str) -> bytes:
        """Evict a room and free its engine slot for reuse (the typed
        answer to :class:`ProviderFullError`).  The room's final state
        is snapshotted, journaled as a release record (recovery then
        knows the room left DELIBERATELY and must not resurrect it),
        and returned — the caller archives it or hands it to another
        provider.  The slot's dead letters are PRESERVED (they
        were once silently dropped): each is re-tagged
        to the unattributed doc=-1 with the room named in its reason —
        never misattributed to the slot's next tenant, never lost — and
        the re-tagged set rides a journaled DLQ record so recovery
        keeps it too.  A demoted room releases from its tier the same
        way, without ever touching a slot."""
        i = self._guids.get(guid)
        if i is None:
            # the room may be demoted: release from its tier
            released = self.tiers.release(guid)
            if released is None:
                raise KeyError(f"unknown room {guid!r}")
            final, letters = released
            if self.wal is not None:
                self.wal.append(KIND_RELEASE, guid, final)
            self._preserve_released_letters(guid, letters)
            self._undo.pop(guid, None)
            self._undo_settings.pop(guid, None)
            self._user_data = {
                k: v for k, v in self._user_data.items() if k[0] != guid
            }
            self._m_evicted.inc()
            return final
        self.flush()
        final = self.engine.encode_state_as_update(i)
        if self.wal is not None:
            self.wal.append(KIND_RELEASE, guid, final)
        letters = [
            {
                "v2": bool(e.v2),
                "reason": e.reason,
                "update": base64.b64encode(e.update).decode("ascii"),
            }
            for e in self.engine.dead_letters.take(doc=i)
        ]
        self._preserve_released_letters(guid, letters)
        self.engine.reset_doc(i)
        del self._guids[guid]
        del self._guid_of[i]
        self._undo.pop(guid, None)
        self._undo_settings.pop(guid, None)
        self._user_data = {
            k: v for k, v in self._user_data.items() if k[0] != guid
        }
        self._free.append(i)
        self.tiers.forget(guid)
        self._m_evicted.inc()
        return final

    def _preserve_released_letters(
        self, guid: str, letters: list[dict]
    ) -> None:
        """Re-enqueue an evicted room's dead letters unattributed
        (doc=-1, room named in the reason) and journal them (KIND_DLQ)
        so recovery preserves the set past the release record."""
        if not letters:
            return
        dlq = self.engine.dead_letters
        dumped = []
        for e in letters:
            reason = f"evicted {guid!r}: {e.get('reason', '')}"
            dlq.append(
                -1, base64.b64decode(e.get("update", "")),
                bool(e.get("v2")),
                reason,
            )
            dumped.append(
                {"v2": bool(e.get("v2")), "reason": reason,
                 "update": e.get("update", "")}
            )
        if self.wal is not None:
            # guid-less letters restore to doc=-1 (see _restore_dlq)
            self.wal.append(
                KIND_DLQ, "",
                json.dumps({"schema": 1, "letters": dumped}).encode(
                    "utf-8"
                ),
            )

    def _apply_release_record(self, guid: str) -> None:
        """Recovery saw a release record: forget the room (its snapshot
        payload is the archived state, not live traffic).  The slot's
        replay-time letters are re-tagged unattributed, mirroring
        :meth:`release_doc` (the journaled KIND_DLQ record that follows
        a live release re-adds the originals)."""
        i = self._guids.pop(guid, None)
        if i is None:
            return
        for e in self.engine.dead_letters.take(doc=i):
            self.engine.dead_letters.append(
                -1, e.update, e.v2, f"evicted {guid!r}: {e.reason}"
            )
        self.engine.reset_doc(i)
        del self._guid_of[i]
        self._free.append(i)
        self.tiers.forget(guid)
        self._m_evicted.inc()

    def _dump_dlq(self) -> dict:
        """Checkpoint-grade DLQ dump with doc slots translated to guids
        (slot numbers are not stable across a recovery)."""
        state = self.engine.dead_letters.snapshot(letters=True)
        for e in state.get("letters") or []:
            e["guid"] = self._guid_of.get(e.pop("doc"))
        return state

    def _restore_dlq(self, state: dict) -> int:
        """Re-enqueue a checkpoint's DLQ dump, mapping guids back to
        this process's slots (letters for unknown/evicted rooms keep
        doc=-1, same as other unattributable letters)."""
        for e in state.get("letters") or []:
            g = e.pop("guid", None)
            if g is None:
                e["doc"] = -1
                continue
            try:
                e["doc"] = self.doc_id(g)
            except ProviderFullError:
                e["doc"] = -1
        return self.engine.dead_letters.restore(state)

    @classmethod
    def recover(
        cls,
        path,
        n_docs: int | None = None,
        root_name: str = "text",
        mesh=None,
        gc: bool = False,
        backend: str = "auto",
        wal_config: WalConfig | None = None,
        tier_config=None,
        admission_config=None,
        device=None,
    ) -> "TpuProvider":
        """Rebuild a provider from a crashed predecessor's WAL directory.

        Replays snapshot-then-tail (see
        :func:`yjs_tpu_torch.persistence.replay_wal`): torn final-segment
        tails are truncated, mid-log corrupt records are dead-lettered,
        and the rebuilt provider journals onward into the SAME
        directory (its appends start a fresh segment past the replayed
        history).  ``n_docs=None`` sizes the fleet from the distinct
        guids in the log.  The replay stats land in
        ``provider.last_recovery``."""
        from .persistence import count_guids, replay_wal

        if n_docs is None:
            n_docs = max(1, count_guids(path))
        prov = cls(
            n_docs,
            root_name=root_name,
            mesh=mesh,
            gc=gc,
            backend=backend,
            wal_dir=path,
            wal_config=wal_config,
            tier_config=tier_config,
            admission_config=admission_config,
            device=device,
        )
        prov.recovering = True
        try:
            prov.last_recovery = replay_wal(
                prov, path, exclude_from=prov.wal.first_index
            )
        finally:
            prov.recovering = False
        return prov


class RoomUndoHandle:
    """Guid-bound view of one room's server-side undo stack.

    All reverting operations route through the provider so the
    device-resident room and the undo replica can never diverge — the
    raw RoomUndo's own undo()/redo() would revert only the replica."""

    __slots__ = ("_provider", "_guid")

    def __init__(self, provider: TpuProvider, guid: str):
        self._provider = provider
        self._guid = guid

    def undo(self) -> bytes | None:
        return self._provider.undo(self._guid)

    def redo(self) -> bytes | None:
        return self._provider.redo(self._guid)

    @property
    def can_undo(self) -> bool:
        return self._provider._room_undo(self._guid).can_undo

    @property
    def can_redo(self) -> bool:
        return self._provider._room_undo(self._guid).can_redo

    def stop_capturing(self) -> None:
        self._provider._room_undo(self._guid).stop_capturing()

    def clear(self) -> None:
        self._provider._room_undo(self._guid).clear()

    @property
    def manager(self):
        """The underlying reference UndoManager (event subscription —
        stack-item-added / stack-item-popped)."""
        return self._provider._room_undo(self._guid).manager


class RoomUserData:
    """Read-side twin of the reference PermanentUserData
    (PermanentUserData.js:15-142) for a device-resident room: the
    ``users`` map — ``{description: {"ids": [clientid...],
    "ds": [encoded DeleteSet...]}}``, written by editing clients with
    setUserMapping — is read from mirror columns on demand.

    The parse is cached against the mirror's change counter
    (``content_gen``), which bumps on every integrated mutation —
    delete-only updates and compaction included.

    Deviation (documented): the reference PermanentUserData accumulates
    mappings in observer-fed dicts and never forgets them, so a deleted
    users-map entry still resolves there; this view reads the CURRENT
    map, so deleting a user's entry removes the attribution.  Reading
    live state is the defensible server behavior (the reference marks
    PermanentUserData @experimental); the difference is pinned in
    tests/test_permanent_user_data.py."""

    __slots__ = ("_provider", "_guid", "_store", "_gen_seen", "_clients",
                 "_dss")

    def __init__(self, provider: TpuProvider, guid: str, store_name: str):
        self._provider = provider
        self._guid = guid
        self._store = store_name
        self._gen_seen = -1
        self._clients: dict[int, str] = {}
        self._dss: dict = {}

    def _refresh(self) -> None:
        from .coding import DSDecoderV1
        from .core import DeleteSet, merge_delete_sets, read_delete_set
        from .lib0.decoding import Decoder

        prov = self._provider
        prov.flush()
        i = prov.doc_id(self._guid)
        eng = prov.engine
        fb = eng.fallback.get(i)
        if fb is None:
            gen = eng.mirrors[i].content_gen()
            if gen == self._gen_seen:
                return
        else:
            # demoted room: no cheap change counter — always reparse
            gen = -1
        users = (
            fb.get_map(self._store).to_json()
            if fb is not None
            else eng.map_json(i, self._store)
        )
        clients: dict[int, str] = {}
        dss: dict = {}
        for desc, rec in users.items():
            if not isinstance(rec, dict):
                continue
            for cid in rec.get("ids") or []:
                if isinstance(cid, int):
                    clients[cid] = desc
            sets = [
                read_delete_set(DSDecoderV1(Decoder(bytes(b))))
                for b in rec.get("ds") or []
                if isinstance(b, (bytes, bytearray))
            ]
            dss[desc] = merge_delete_sets(sets) if sets else DeleteSet()
        self._clients = clients
        self._dss = dss
        self._gen_seen = gen

    def user_by_client_id(self, clientid: int) -> str | None:
        """reference getUserByClientId (PermanentUserData.js:126-128)."""
        self._refresh()
        return self._clients.get(clientid)

    def user_by_deleted_id(self, id) -> str | None:
        """reference getUserByDeletedId (PermanentUserData.js:134-141)."""
        from .core import is_deleted

        self._refresh()
        for desc, ds in self._dss.items():
            if is_deleted(ds, id):
                return desc
        return None

    @property
    def clients(self) -> dict[int, str]:
        self._refresh()
        return dict(self._clients)

    @property
    def dss(self) -> dict:
        self._refresh()
        return dict(self._dss)
