"""Fleet-wide admission controller.

One ``AdmissionController`` instance is shared by every provider in a
fleet (the :class:`~yjs_tpu.fleet.FleetRouter` creates it and injects it
into each shard), so per-tenant token buckets and the brownout level are
*fleet-wide*: a hot tenant hammering shard 3 is throttled on shard 0 too.
A standalone :class:`~yjs_tpu.provider.TpuProvider` gets a private one.

Responsibilities:

- **Rate limiting** — per-tenant and per-doc token buckets at the
  provider seam (``receive_update`` / ``handle_sync_message`` / session
  DATA).  Over-rate traffic is *queued* (weighted-fair, per tenant)
  rather than dropped; queued entries are WAL-journaled at enqueue time,
  so a crash cannot lose an acked update (they enter the SLO window only
  when drained — intentionally-shed traffic must not page the
  interactive SLO the brownout reads as its own signal).  When the
  queue itself fills — or brownout reaches ``reject-writes`` — the caller
  gets a typed :class:`AdmissionRejected` (session paths turn it into a
  BUSY/retry-after envelope frame; it is never silently dropped).
- **Brownout** — a per-tick :class:`BrownoutController` driven by the
  worst attached provider's SLO burn-rate verdict, flush-queue depth,
  device-slot occupancy, admission-queue fill and provider/fleet-full
  events.  Level transitions are journaled (``KIND_ADM`` WAL records on
  every attached provider) and metered.
- **Memory pressure** — before ``ProviderFullError`` can surface on a
  tiered provider, the tick loop calls ``tiers.make_room()`` to keep a
  configured free-slot headroom, demoting the coldest docs first.

Everything is tick-deterministic: the controller owns a tick counter
advanced by exactly one owner (the fleet router when present, else the
first attached provider's ``tick_sessions``), and buckets refill lazily
from tick deltas.  Default off (``YTPU_ADM_ENABLED``): with admission
disabled every seam check is a single attribute read.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from ..obs import global_registry
from .brownout import (
    COALESCE,
    FLUSH_SCALE,
    LEVEL_NAMES,
    NORMAL,
    REJECT_WRITES,
    SHED_BACKGROUND,
    BrownoutController,
)
from .limiter import AdmissionRejected, TokenBucket, WeightedFairQueue

__all__ = ["AdmissionConfig", "AdmissionController", "AdmissionRejected"]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class AdmissionConfig:
    """Admission/brownout knobs (env-derived defaults, constructor wins).

    - ``YTPU_ADM_ENABLED`` — master switch (default off: every seam
      check degenerates to one attribute read);
    - ``YTPU_ADM_TENANT_RATE`` / ``YTPU_ADM_TENANT_BURST`` — per-tenant
      token bucket: sustained updates/tick and burst depth (64 / 256);
    - ``YTPU_ADM_DOC_RATE`` / ``YTPU_ADM_DOC_BURST`` — per-doc bucket
      (32 / 128) so one hot doc cannot spend its tenant's whole budget;
    - ``YTPU_ADM_QUEUE_MAX`` — fleet-wide cap on weighted-fair-queued
      updates before ``queue-full`` rejections start (1024);
    - ``YTPU_ADM_DRAIN_BATCH`` — queued updates integrated per provider
      flush, in weighted-fair order (256);
    - ``YTPU_ADM_UP_TICKS`` / ``YTPU_ADM_DOWN_TICKS`` — brownout
      hysteresis: consecutive overloaded ticks to escalate one level
      (2) / calm ticks to recover one level (8 — recovery is slow on
      purpose so it cannot flap);
    - ``YTPU_ADM_QUEUE_HIGH`` — queue-fill fraction that targets
      ``coalesce`` (0.5); ``YTPU_ADM_QUEUE_FULL`` — fraction that
      targets ``reject-writes`` (0.95);
    - ``YTPU_ADM_PENDING_HIGH`` — flush-queue pending-update depth that
      targets ``shed-background`` (4096);
    - ``YTPU_ADM_OCCUPANCY_HIGH`` — device-slot occupancy that targets
      ``shed-background`` and arms tiering demotion (0.9);
    - ``YTPU_ADM_HEADROOM`` — free device slots the tick loop maintains
      via ``tiers.make_room()`` under pressure (1);
    - ``YTPU_ADM_RETRY_AFTER`` — retry-after ticks carried by
      rejections and BUSY frames (8).
    """

    __slots__ = (
        "enabled", "tenant_rate", "tenant_burst", "doc_rate", "doc_burst",
        "queue_max", "drain_batch", "up_ticks", "down_ticks",
        "queue_high", "queue_full", "pending_high", "occupancy_high",
        "headroom", "retry_after",
    )

    def __init__(
        self,
        enabled: bool | None = None,
        tenant_rate: float | None = None,
        tenant_burst: float | None = None,
        doc_rate: float | None = None,
        doc_burst: float | None = None,
        queue_max: int | None = None,
        drain_batch: int | None = None,
        up_ticks: int | None = None,
        down_ticks: int | None = None,
        queue_high: float | None = None,
        queue_full: float | None = None,
        pending_high: int | None = None,
        occupancy_high: float | None = None,
        headroom: int | None = None,
        retry_after: int | None = None,
    ):
        if enabled is None:
            enabled = os.environ.get("YTPU_ADM_ENABLED", "0") in (
                "1", "true", "yes",
            )
        self.enabled = bool(enabled)
        if tenant_rate is None:
            tenant_rate = _env_float("YTPU_ADM_TENANT_RATE", 64.0)
        self.tenant_rate = max(0.0, float(tenant_rate))
        if tenant_burst is None:
            tenant_burst = _env_float("YTPU_ADM_TENANT_BURST", 256.0)
        self.tenant_burst = max(1.0, float(tenant_burst))
        if doc_rate is None:
            doc_rate = _env_float("YTPU_ADM_DOC_RATE", 32.0)
        self.doc_rate = max(0.0, float(doc_rate))
        if doc_burst is None:
            doc_burst = _env_float("YTPU_ADM_DOC_BURST", 128.0)
        self.doc_burst = max(1.0, float(doc_burst))
        if queue_max is None:
            queue_max = _env_int("YTPU_ADM_QUEUE_MAX", 1024)
        self.queue_max = max(0, int(queue_max))
        if drain_batch is None:
            drain_batch = _env_int("YTPU_ADM_DRAIN_BATCH", 256)
        self.drain_batch = max(1, int(drain_batch))
        if up_ticks is None:
            up_ticks = _env_int("YTPU_ADM_UP_TICKS", 2)
        self.up_ticks = max(1, int(up_ticks))
        if down_ticks is None:
            down_ticks = _env_int("YTPU_ADM_DOWN_TICKS", 8)
        self.down_ticks = max(1, int(down_ticks))
        if queue_high is None:
            queue_high = _env_float("YTPU_ADM_QUEUE_HIGH", 0.5)
        self.queue_high = min(1.0, max(0.0, float(queue_high)))
        if queue_full is None:
            queue_full = _env_float("YTPU_ADM_QUEUE_FULL", 0.95)
        self.queue_full = min(1.0, max(self.queue_high, float(queue_full)))
        if pending_high is None:
            pending_high = _env_int("YTPU_ADM_PENDING_HIGH", 4096)
        self.pending_high = max(1, int(pending_high))
        if occupancy_high is None:
            occupancy_high = _env_float("YTPU_ADM_OCCUPANCY_HIGH", 0.9)
        self.occupancy_high = min(1.0, max(0.0, float(occupancy_high)))
        if headroom is None:
            headroom = _env_int("YTPU_ADM_HEADROOM", 1)
        self.headroom = max(0, int(headroom))
        if retry_after is None:
            retry_after = _env_int("YTPU_ADM_RETRY_AFTER", 8)
        self.retry_after = max(1, int(retry_after))

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class AdmissionMetrics:
    """``ytpu_adm_*`` families; registration is idempotent, so a shared
    controller on the global registry is safe."""

    def __init__(self, registry=None) -> None:
        r = registry if registry is not None else global_registry()
        self.registry = r
        self.level = r.gauge(
            "ytpu_adm_brownout_level",
            "Current brownout degradation level "
            "(0=normal 1=shed-background 2=coalesce 3=reject-writes)",
        )
        self.transitions = r.counter(
            "ytpu_adm_transitions_total",
            "Brownout level transitions, labeled by entered level",
            labelnames=("level",),
        )
        self.admitted = r.counter(
            "ytpu_adm_admitted_total",
            "Updates accepted by admission control, by disposition "
            "(admit=straight through, queued=weighted-fair queue)",
            labelnames=("disposition",),
        )
        self.rejected = r.counter(
            "ytpu_adm_rejected_total",
            "Updates refused by admission control, by typed reason",
            labelnames=("reason",),
        )
        self.queue_depth = r.gauge(
            "ytpu_adm_queue_depth",
            "Updates currently held in the weighted-fair admission queue",
        )
        self.drained = r.counter(
            "ytpu_adm_drained_total",
            "Queued updates integrated by provider flush drains",
        )
        self.demotions = r.counter(
            "ytpu_adm_demotions_total",
            "Tiering demotions forced by admission memory-pressure "
            "headroom maintenance",
        )
        self.full_events = r.counter(
            "ytpu_adm_full_events_total",
            "ProviderFullError/FleetFullError events observed and "
            "absorbed by the admission layer",
            labelnames=("kind",),
        )


def _slo_state(provider) -> str:
    try:
        return provider.slo.state()
    except Exception:
        return "ok"


_STATE_RANK = {"ok": 0, "warning": 1, "page": 2}


class AdmissionController:
    """Shared admission/brownout state machine (see module docstring)."""

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        registry=None,
    ) -> None:
        self.config = config or AdmissionConfig()
        self.metrics = AdmissionMetrics(registry)
        self.brownout = BrownoutController(
            up_ticks=self.config.up_ticks,
            down_ticks=self.config.down_ticks,
            on_transition=self._on_transition,
        )
        self._tick = 0
        self._ticker: Any = None
        self._providers: list = []
        self._tenants: dict[str, TokenBucket] = {}
        self._docs: dict[str, TokenBucket] = {}
        self._weights: dict[str, float] = {}
        # per-provider WFQ sub-queues so each flush drains only its own
        # shard's backlog (keyed by id(); entries die with the provider)
        self._queues: dict[int, WeightedFairQueue] = {}
        self._queued_total = 0
        self._full_events = 0
        self._draining = False
        # plain-int counters kept alongside obs so snapshots work with
        # YTPU_OBS_DISABLED (same idiom as DeadLetterQueue)
        self.n_offered = 0
        self.n_admitted = 0
        self.n_queued = 0
        self.n_drained = 0
        self.n_rejected: dict[str, int] = {}
        self.n_demotions = 0
        self.n_full = {"provider": 0, "fleet": 0}

    # -- wiring ------------------------------------------------------------

    def attach(self, provider) -> None:
        """Register a provider; the first attached becomes the tick
        owner unless a fleet claims it via :meth:`claim_ticker`."""
        if provider not in self._providers:
            self._providers.append(provider)
        if self._ticker is None:
            self._ticker = provider

    def detach(self, provider) -> None:
        """Drop a (killed) provider; its in-memory queue entries are
        discarded — they were WAL-journaled and replicated at enqueue,
        so failover recovery replays them on the survivor."""
        if provider in self._providers:
            self._providers.remove(provider)
        q = self._queues.pop(id(provider), None)
        if q is not None:
            self._queued_total -= len(q)
            self.metrics.queue_depth.set(self._queued_total)
        if self._ticker is provider:
            self._ticker = self._providers[0] if self._providers else None

    def claim_ticker(self, owner) -> None:
        """A fleet router owns the tick (its ``tick()`` calls
        :meth:`tick` directly; shard ``tick_sessions`` become no-ops)."""
        self._ticker = owner

    def maybe_tick(self, caller) -> int:
        if caller is self._ticker:
            return self.tick()
        return self.brownout.level

    # -- level-effect properties (read by sessions and hosts) --------------

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    @property
    def level(self) -> int:
        return self.brownout.level

    @property
    def level_name(self) -> str:
        return self.brownout.level_name

    @property
    def antientropy_paused(self) -> bool:
        return self.config.enabled and self.brownout.level >= SHED_BACKGROUND

    @property
    def force_coalesce(self) -> bool:
        return self.config.enabled and self.brownout.level >= COALESCE

    @property
    def rejecting_writes(self) -> bool:
        return self.config.enabled and self.brownout.level >= REJECT_WRITES

    @property
    def flush_interval_scale(self) -> float:
        """Advisory flush-cadence multiplier for hosts that own their
        flush tick (loadgen, external tickers)."""
        if not self.config.enabled:
            return 1.0
        return FLUSH_SCALE[self.brownout.level]

    @property
    def retry_after(self) -> int:
        return self.config.retry_after

    # -- tenancy -----------------------------------------------------------

    @staticmethod
    def tenant_of(guid: str) -> str:
        """Tenant = guid prefix before the first ``/`` (whole guid when
        unscoped), matching the ``tenant/doc`` naming convention."""
        i = guid.find("/")
        return guid[:i] if i > 0 else guid

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Fair-share weight for queue drains (default 1.0; heavier
        drains proportionally faster)."""
        self._weights[tenant] = max(1e-6, float(weight))

    # -- admission seam ----------------------------------------------------

    def admit_update(self, provider, guid: str, nbytes: int) -> str:
        """Gate one inbound update.  Returns ``"admit"`` (integrate now)
        or ``"queue"`` (caller journals + enqueues via :meth:`enqueue`);
        raises :class:`AdmissionRejected` otherwise."""
        cfg = self.config
        if not cfg.enabled:
            return "admit"
        self.n_offered += 1
        tenant = self.tenant_of(guid)
        if self.brownout.level >= REJECT_WRITES:
            self._reject(guid, tenant, "reject-writes")
        tb = self._tenants.get(tenant)
        if tb is None:
            tb = self._tenants[tenant] = TokenBucket(
                cfg.tenant_rate, cfg.tenant_burst, self._tick
            )
        db = self._docs.get(guid)
        if db is None:
            db = self._docs[guid] = TokenBucket(
                cfg.doc_rate, cfg.doc_burst, self._tick
            )
        tb.refill_to(self._tick)
        db.refill_to(self._tick)
        if tb.peek() and db.peek():
            tb.take()
            db.take()
            self.n_admitted += 1
            self.metrics.admitted.labels(disposition="admit").inc()
            return "admit"
        # over rate: queue (weighted-fair) unless the queue is full
        if self._queued_total >= cfg.queue_max:
            self._reject(guid, tenant, "queue-full")
        self.n_queued += 1
        self.metrics.admitted.labels(disposition="queued").inc()
        return "queue"

    def _reject(self, guid: str, tenant: str, reason: str) -> None:
        self.n_rejected[reason] = self.n_rejected.get(reason, 0) + 1
        self.metrics.rejected.labels(reason=reason).inc()
        raise AdmissionRejected(guid, tenant, reason, self.config.retry_after)

    def enqueue(
        self,
        provider,
        guid: str,
        update: bytes,
        v2: bool,
        undoable: bool,
        slo_key,
        trace=None,
    ) -> None:
        """Park an already-journaled, SLO-received update for a later
        weighted-fair drain on ``provider``'s flush.  ``trace`` is the
        ingress :class:`~yjs_tpu.obs.dist.TraceContext`: it
        rides the queue entry with the enqueue tick so the drain can
        attribute the queue wait to the update's trace."""
        tenant = self.tenant_of(guid)
        q = self._queues.get(id(provider))
        if q is None:
            q = self._queues[id(provider)] = WeightedFairQueue()
        q.push(
            tenant,
            (guid, update, v2, undoable, slo_key, trace, self._tick),
            weight=self._weights.get(tenant, 1.0),
        )
        self._queued_total += 1
        self.metrics.queue_depth.set(self._queued_total)

    def drain_for(self, provider) -> int:
        """Integrate up to ``drain_batch`` queued updates for this
        provider, oldest virtual-finish first.  Called from
        ``provider.flush()``; re-entrant calls (flush inside a drain's
        tiering demotion) are no-ops."""
        if self._draining:
            return 0
        q = self._queues.get(id(provider))
        if not q:
            return 0
        from ..obs.dist import use_context

        n = 0
        self._draining = True
        try:
            while len(q) and n < self.config.drain_batch:
                _tenant, item = q.pop()
                self._queued_total -= 1
                n += 1
                guid, update, v2, undoable, slo_key, trace, enq_tick = item
                if trace is not None and trace.sampled:
                    # the queue-wait span of the sampled trace: ticks
                    # parked in the weighted-fair queue before this
                    # drain picked the update up
                    provider.engine.obs.tracer.instant(
                        "ytpu.adm.queue_wait",
                        guid=guid,
                        trace=trace.trace_hex,
                        wait_ticks=max(0, self._tick - enq_tick),
                    )
                with use_context(trace):
                    provider._integrate_admitted(
                        guid, update, v2, undoable, slo_key
                    )
        finally:
            self._draining = False
            if n:
                self.n_drained += n
                self.metrics.drained.inc(n)
                self.metrics.queue_depth.set(self._queued_total)
        return n

    def note_full(self, kind: str = "provider") -> None:
        """Feed a Provider/Fleet-full event into the brownout signal
        (counted even when admission is disabled)."""
        self._full_events += 1
        self.n_full[kind] = self.n_full.get(kind, 0) + 1
        self.metrics.full_events.labels(kind=kind).inc()

    # -- tick / brownout ---------------------------------------------------

    def _signals(self) -> dict:
        slo = "ok"
        pending = 0
        occupancy = 0.0
        for p in self._providers:
            st = _slo_state(p)
            if _STATE_RANK.get(st, 0) > _STATE_RANK.get(slo, 0):
                slo = st
            try:
                fm = p.engine.last_flush_metrics
                if fm:
                    pending = max(pending, int(fm.get("pending_depth", 0)))
                occupancy = max(occupancy, float(p.occupancy))
            except Exception:
                continue
        queue_frac = (
            self._queued_total / self.config.queue_max
            if self.config.queue_max
            else 0.0
        )
        return {
            "slo": slo,
            "pending_depth": pending,
            "occupancy": occupancy,
            "queue_frac": queue_frac,
            "full_events": self._full_events,
        }

    def _target_level(self, s: dict) -> tuple[int, str]:
        cfg = self.config
        target, reason = NORMAL, ""
        if s["slo"] == "warning":
            target, reason = SHED_BACKGROUND, "slo-warning"
        if s["pending_depth"] >= cfg.pending_high:
            target, reason = (
                max(target, SHED_BACKGROUND),
                reason or "flush-backlog",
            )
        if s["occupancy"] >= cfg.occupancy_high:
            target, reason = (
                max(target, SHED_BACKGROUND),
                reason or "memory-pressure",
            )
        if s["slo"] == "page":
            target, reason = COALESCE, "slo-page"
        if s["queue_frac"] >= cfg.queue_high:
            target, reason = max(target, COALESCE), "queue-high"
        if s["full_events"] > 0:
            target, reason = max(target, COALESCE), "full-events"
        if s["queue_frac"] >= cfg.queue_full:
            target, reason = REJECT_WRITES, "queue-full"
        return target, reason

    def tick(self) -> int:
        """Advance one tick: refill clocks, evaluate brownout signals,
        and relieve memory pressure via tiering demotion."""
        self._tick += 1
        cfg = self.config
        if not cfg.enabled:
            return NORMAL
        s = self._signals()
        target, reason = self._target_level(s)
        level = self.brownout.observe(target, reason)
        self.metrics.level.set(level)
        self._full_events = 0
        # memory pressure: demote coldest docs to keep free-slot headroom
        # so ProviderFullError never surfaces on a tiered provider
        if cfg.headroom and (
            level >= SHED_BACKGROUND or s["occupancy"] >= cfg.occupancy_high
        ):
            for p in self._providers:
                self._make_headroom(p)
        return level

    def _make_headroom(self, provider) -> None:
        try:
            tiers = provider.tiers
            if not tiers.enabled:
                return
            n_docs = provider.engine.n_docs
            free = len(provider._free) + max(0, n_docs - provider._next)
            while free < self.config.headroom:
                if not tiers.make_room():
                    return
                self.n_demotions += 1
                self.metrics.demotions.inc()
                free = len(provider._free) + max(0, n_docs - provider._next)
        except Exception:
            return

    # -- introspection -----------------------------------------------------

    def queue_depth(self) -> int:
        return self._queued_total

    def snapshot(self) -> dict:
        by_tenant: dict[str, int] = {}
        for q in self._queues.values():
            for t, n in q.snapshot()["by_tenant"].items():
                by_tenant[t] = by_tenant.get(t, 0) + n
        return {
            "enabled": self.config.enabled,
            "tick": self._tick,
            "level": self.brownout.level,
            "level_name": self.brownout.level_name,
            "queue_depth": self._queued_total,
            "queue_max": self.config.queue_max,
            "queued_by_tenant": dict(sorted(by_tenant.items())),
            "tenants": len(self._tenants),
            "offered": self.n_offered,
            "admitted": self.n_admitted,
            "queued": self.n_queued,
            "drained": self.n_drained,
            "rejected": dict(sorted(self.n_rejected.items())),
            "demotions": self.n_demotions,
            "full_events": dict(self.n_full),
            "brownout": self.brownout.snapshot(),
        }

    # -- journaling --------------------------------------------------------

    def _on_transition(
        self, old: int, new: int, reason: str, tick: int
    ) -> None:
        self.metrics.transitions.labels(level=LEVEL_NAMES[new]).inc()
        self.metrics.level.set(new)
        # brownout transitions are flight-recorder material:
        # a post-mortem must see the degradation ladder around a failure
        from ..obs.blackbox import flight_recorder

        flight_recorder().record(
            "admission", "brownout_transition",
            severity="warning" if new > old else "info",
            level=LEVEL_NAMES[new], previous=LEVEL_NAMES[old],
            reason=reason, tick=tick,
        )
        for p in self._providers:
            try:
                journal = getattr(p, "journal_admission", None)
                if journal is not None:
                    journal(LEVEL_NAMES[new], reason, tick)
            except Exception:
                continue
