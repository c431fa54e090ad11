"""yjs_tpu.obs: observability for the engine/provider stack.

Four pieces:

- :mod:`.registry` — zero-dependency counters/gauges/log-bucketed
  histograms, cheap enough to stay on in the flush hot path;
- :mod:`.history` — the bounded flush-history ring superseding the
  overwrite-only ``last_flush_metrics`` (which remains as a
  compatibility view of the newest entry);
- :mod:`.trace` — host-side phase spans exported as Chrome-trace JSON,
  layered on the existing ``jax.profiler.TraceAnnotation`` wrappers;
- :mod:`.expo` — Prometheus text dump + JSON snapshot.

Fleet-wide observability:

- :mod:`.dist` — deterministic cross-provider trace contexts
  (``YTPU_TRACE_SAMPLE`` head sampling, envelope carry, hash-derived
  flow ids);
- :mod:`.blackbox` — the always-on black-box flight recorder
  (``YTPU_BLACKBOX{,_CAP,_DIR}``), auto-dumped on quarantine /
  failover / ``ProviderFullError`` / flush exceptions;
- :mod:`.federate` — N-shard metric federation (counters sum, gauges
  keep per-shard series, histograms merge) shared by
  ``FleetRouter.metrics_snapshot``, ``ytpu_top`` and ``ytpu_stats``.

Env knobs: ``YTPU_OBS_DISABLED=1`` (no-op registry + tracer; the flush
history stays on so ``last_flush_metrics`` keeps its contract),
``YTPU_OBS_HISTORY`` (ring size, default 128), ``YTPU_TRACE_PATH``
(write a merged Chrome trace at interpreter exit), ``YTPU_TRACE_EVENTS``
(per-tracer event cap, default 200k).
"""

from __future__ import annotations

import os

from .expo import prometheus_text, registry_snapshot  # noqa: F401
from .history import FlushHistory  # noqa: F401
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NOOP_METRIC,
)
from .trace import Tracer  # noqa: F401
from .blackbox import (  # noqa: F401
    FlightRecorder,
    flight_recorder,
    reset_flight_recorder,
)
from .dist import (  # noqa: F401
    TraceContext,
    current_context,
    flow_id_for,
    mint_for_update,
    trace_metrics,
    use_context,
)
from .federate import (  # noqa: F401
    FederationMetrics,
    fed_metrics,
    federate_snapshots,
    merge_summaries,
    read_snapshot_dir,
    scrape_endpoints,
)
from .admin import (  # noqa: F401
    AdminConfig,
    AdminServer,
    maybe_start_admin,
)
from .tsdb import (  # noqa: F401
    Tsdb,
    TsdbConfig,
    maybe_attach_tsdb,
    tsdb,
    tsdb_enabled,
    tsdb_metrics,
    tsdb_window,
)
from .cost import CostLedger, cost_enabled  # noqa: F401
from .capacity import (  # noqa: F401
    CapacityConfig,
    ramp_capacity,
    read_knee,
    sessions_per_device,
)

SNAPSHOT_SCHEMA_VERSION = 1

# -- the per-flush metrics schema -------------------------------------------
# ONE constructor for every flush exit (apply / levels / seq / batched /
# empty-early-return): the paths previously shared these keys by
# convention only, and a drift was silent until a consumer KeyError'd.
# tests/test_obs.py pins identical key sets across all modes.
FLUSH_METRICS_SCHEMA: dict = {
    "n_docs_flushed": 0,
    "n_demoted": 0,
    # docs transactionally rolled back (and demoted) by failure
    # isolation during this flush — always <= n_demoted
    "n_rolled_back": 0,
    "n_fallback_docs": 0,
    "n_rows_max": 0,
    "n_sched_entries": 0,
    "n_levels": 0,
    "level_width": 0,
    "schedule_occupancy": 0.0,
    "n_pending_docs": 0,
    "pending_depth": 0,
    # planner fan-out this flush actually used: the native planner's
    # worker-pool width (min(pool width, docs in the batch);
    # YTPU_PLAN_THREADS overrides the pool), or — on the Python path
    # under YTPU_PLAN_SEGMENT=device — the number of cold docs
    # co-planned by one whole-chunk segment-planner call.
    # 1 = fully serial per-doc planning.
    "plan_threads": 1,
    # frontier-keyed plan cache: probes served from cache /
    # planned cold this flush, and structs placed by the segment-sorted
    # fast path instead of the sequential YATA walk
    "plan_cache_hits": 0,
    "plan_cache_misses": 0,
    "plan_fastpath_structs": 0,
    # device-authoritative segment planner: structs
    # integrated straight from device-computed ranks (fast set) vs
    # handed to the sequential YATA conflict fallback (residue)
    "plan_segment_fast": 0,
    "plan_segment_residue": 0,
    "t_compact_s": 0.0,
    "t_plan_s": 0.0,
    # t_plan_s split: snapshot-adoption time for cache hits vs cold
    # prepare time (t_plan_cached_s + t_plan_cold_s <= t_plan_s)
    "t_plan_cached_s": 0.0,
    "t_plan_cold_s": 0.0,
    "t_pack_s": 0.0,
    "t_dispatch_s": 0.0,
    "t_emit_s": 0.0,
    "t_total_s": 0.0,
    # pipelined flush: host pack time that overlapped an
    # in-flight device dispatch, and host time spent blocked on the
    # device (staging-buffer reuse guards + YTPU_FLUSH_PIPELINE=0's
    # per-dispatch barrier).  Pipeline-off, overlap is 0 and the wait
    # is the full device time; pipeline-on, pack overlap is the payoff
    # and wait shrinks to the true dependency stalls.
    "t_pack_overlap_s": 0.0,
    "t_device_wait_s": 0.0,
    # 1 when every device dispatch of this flush updated donated
    # resident tables in place (no table growth/reallocation since the
    # previous flush); realloc_bytes is the growth cost when it is 0
    "flush_donated": 0,
    "realloc_bytes": 0,
    # max device dispatches in flight at once (0 = no dispatch or
    # synchronous mode; the double-buffered staging pair bounds it)
    "pipeline_depth": 0,
}

FLUSH_PHASES = ("compact", "plan", "pack", "dispatch", "emit")


def new_flush_metrics(**overrides) -> dict:
    """A fresh flush-metrics dict with every schema key present.

    Unknown keys raise: a new metric must be added to the schema (and
    the README table) first, so the exposed key set cannot drift."""
    unknown = set(overrides) - set(FLUSH_METRICS_SCHEMA)
    if unknown:
        raise KeyError(
            f"not in FLUSH_METRICS_SCHEMA: {sorted(unknown)}"
        )
    m = dict(FLUSH_METRICS_SCHEMA)
    m.update(overrides)
    return m


def obs_enabled() -> bool:
    return os.environ.get("YTPU_OBS_DISABLED") != "1"


# -- process-global registry -------------------------------------------------
# Serves module-level consumers with no engine handle (the y-protocols
# sync framing).  Engine/provider exposition merges it in.

_GLOBAL: MetricsRegistry | None = None


def global_registry() -> MetricsRegistry:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MetricsRegistry(enabled=obs_enabled())
        # pre-register the protocol family so exposition (and the schema
        # checker) sees it before the first frame is read/written
        _GLOBAL.counter(
            "ytpu_sync_messages_total",
            "y-protocols sync frames processed by yjs_tpu.sync.protocol",
            labelnames=("dir", "type"),
        )
        _GLOBAL.counter(
            "ytpu_chaos_faults_total",
            "Faults injected by the chaos harness, by fault kind",
            labelnames=("fault",),
        )
    return _GLOBAL


class EngineObs:
    """Per-engine observability bundle: registry + flush ring + tracer.

    Every instrument the flush hot path touches is pre-created here so
    recording is attribute access + arithmetic — no name resolution, no
    label resolution (phase children are pre-resolved)."""

    def __init__(self, history_len: int | None = None):
        self.enabled = obs_enabled()
        self.registry = MetricsRegistry(enabled=self.enabled)
        self.history = FlushHistory(maxlen=history_len)
        self.tracer = Tracer(enabled=self.enabled)
        # the process-global black box records even with metrics
        # disabled (it is forensics, not telemetry); trace metrics are
        # registered here so the schema checker sees the families after
        # one provider construction
        self.blackbox = flight_recorder()
        self.blackbox._obs()
        trace_metrics()
        r = self.registry
        self._flushes = r.counter(
            "ytpu_engine_flushes_total", "Engine flushes run"
        )
        self._docs_flushed = r.counter(
            "ytpu_engine_docs_flushed_total",
            "Docs integrated with visible work, summed over flushes",
        )
        self._updates_emitted = r.counter(
            "ytpu_engine_updates_emitted_total",
            "Incremental updates emitted via doc.on('update')",
        )
        self._egress_bytes = r.counter(
            "ytpu_engine_update_egress_bytes_total",
            "Bytes of emitted incremental updates",
            unit="bytes",
        )
        self._demotions = r.counter(
            "ytpu_engine_demotions_total",
            "Device->CPU demotions by reason",
            labelnames=("reason",),
        )
        self._fallback_docs = r.gauge(
            "ytpu_engine_fallback_docs", "Docs currently on the CPU core"
        )
        self._pending_docs = r.gauge(
            "ytpu_engine_pending_docs",
            "Docs with parked (causally unready) traffic after last flush",
        )
        self._pending_depth = r.gauge(
            "ytpu_engine_pending_depth",
            "Total parked struct depth after last flush",
        )
        self._occupancy = r.gauge(
            "ytpu_engine_schedule_occupancy",
            "Real fraction of dispatched schedule/lane slots, last flush",
            unit="ratio",
        )
        self._plan_threads = r.gauge(
            "ytpu_engine_plan_threads", "Native planner worker-pool width"
        )
        self._row_capacity = r.gauge(
            "ytpu_engine_row_capacity",
            "Device row capacity (per doc) after last flush",
            unit="rows",
        )
        # segment-planner residue: the live number
        # the residue-elimination work drives against — fraction of
        # planned structs the device fast path could NOT place and
        # handed to the sequential YATA conflict fallback
        self._segment_residue_fraction = r.gauge(
            "ytpu_plan_segment_residue_fraction",
            "Fraction of planned structs handed to the sequential YATA "
            "conflict fallback, last flush with planner work "
            "(residue / (fast + residue))",
            unit="ratio",
        )
        self._flush_seconds = r.histogram(
            "ytpu_engine_flush_seconds", "End-to-end flush wall time",
            unit="s",
        )
        self._phase_seconds = r.histogram(
            "ytpu_engine_phase_seconds",
            "Per-phase flush wall time",
            unit="s",
            labelnames=("phase",),
        )
        self._phase_children = {
            ph: self._phase_seconds.labels(phase=ph) for ph in FLUSH_PHASES
        }
        self._native_prepare_seconds = r.histogram(
            "ytpu_native_prepare_many_seconds",
            "One ymx_prepare_many batch (stage + plan), per call",
            unit="s",
        )
        self._native_prepare_docs = r.histogram(
            "ytpu_native_prepare_many_docs",
            "Docs planned per ymx_prepare_many call",
            unit="docs",
        )
        self._rollbacks = r.counter(
            "ytpu_resilience_rollbacks_total",
            "Per-doc transactional flush rollbacks by reason",
            labelnames=("reason",),
        )
        self._dead_letters = r.counter(
            "ytpu_resilience_dead_letters_total",
            "Updates diverted to the dead-letter queue by reason",
            labelnames=("reason",),
        )
        self._dlq_depth = r.gauge(
            "ytpu_resilience_dead_letter_depth",
            "Dead letters currently held in the bounded queue",
        )
        self._dlq_dropped = r.counter(
            "ytpu_resilience_dead_letters_dropped_total",
            "Dead letters evicted (oldest-first) by the capacity bound",
        )
        self._docs_degraded = r.gauge(
            "ytpu_resilience_docs_degraded",
            "Docs currently in the degraded health state",
        )
        self._docs_quarantined = r.gauge(
            "ytpu_resilience_docs_quarantined",
            "Docs currently quarantined (traffic diverted to dead letters)",
        )
        self._readmissions = r.counter(
            "ytpu_resilience_readmissions_total",
            "Quarantined docs re-admitted after backoff expiry",
        )
        self._replayed = r.counter(
            "ytpu_resilience_replayed_total",
            "Dead letters successfully re-integrated by replay()",
        )
        self._replay_truncated = r.counter(
            "ytpu_resilience_dlq_replay_truncated_total",
            "Matching dead letters left queued by the per-invocation "
            "replay batch cap (YTPU_DLQ_REPLAY_BATCH)",
        )
        # device-memory cost attribution: refreshed once per
        # flush from the engine's persistent device buffers
        self._device_table_bytes = r.gauge(
            "ytpu_prof_device_table_bytes",
            "Live device bytes per persistent doc-table column group",
            unit="bytes",
            labelnames=("table",),
        )
        self._device_bytes_total = r.gauge(
            "ytpu_prof_device_bytes_total",
            "Total live persistent device bytes, by backend platform",
            unit="bytes",
            labelnames=("backend",),
        )
        self._slot_occupancy = r.gauge(
            "ytpu_prof_slot_occupancy",
            "Fraction of engine doc slots holding live rows",
            unit="ratio",
        )
        # pipelined flush: overlap/donation accounting
        self._flush_pipeline_depth = r.gauge(
            "ytpu_flush_pipeline_depth",
            "Max device dispatches in flight during the last flush "
            "(0 = synchronous / no dispatch)",
        )
        self._flush_pack_overlap = r.histogram(
            "ytpu_flush_pack_overlap_seconds",
            "Host pack time spent while a device dispatch was "
            "outstanding (not yet blocked on), per flush",
            unit="s",
        )
        self._flush_device_wait = r.histogram(
            "ytpu_flush_device_wait_seconds",
            "Host time blocked waiting on device dispatches, per flush",
            unit="s",
        )
        self._flush_donated = r.counter(
            "ytpu_flush_donated_total",
            "Flushes whose dispatches all updated donated device tables "
            "in place (zero table reallocation)",
        )
        self._flush_realloc_bytes = r.counter(
            "ytpu_flush_realloc_bytes_total",
            "Device bytes allocated by resident-table growth (the cost "
            "a donated steady-state flush avoids)",
            unit="bytes",
        )

    # -- hot-path recording hooks -------------------------------------

    def record_flush(self, metrics: dict, row_capacity: int = 0) -> None:
        """One flush finished: ring append + registry update."""
        self.history.append(metrics)
        if not self.enabled:
            return
        self._flushes.inc()
        self._docs_flushed.inc(metrics["n_docs_flushed"])
        self._fallback_docs.set(metrics["n_fallback_docs"])
        self._pending_docs.set(metrics["n_pending_docs"])
        self._pending_depth.set(metrics["pending_depth"])
        self._occupancy.set(metrics["schedule_occupancy"])
        self._plan_threads.set(metrics["plan_threads"])
        self._row_capacity.set(row_capacity)
        self._flush_seconds.observe(metrics["t_total_s"])
        for ph, child in self._phase_children.items():
            child.observe(metrics[f"t_{ph}_s"])
        planned = (
            metrics["plan_segment_fast"] + metrics["plan_segment_residue"]
        )
        if planned:
            # idle flushes keep the last real verdict on the gauge
            self._segment_residue_fraction.set(
                metrics["plan_segment_residue"] / planned
            )
        self._flush_pipeline_depth.set(metrics["pipeline_depth"])
        self._flush_pack_overlap.observe(metrics["t_pack_overlap_s"])
        self._flush_device_wait.observe(metrics["t_device_wait_s"])
        if metrics["flush_donated"]:
            self._flush_donated.inc()
        if metrics["realloc_bytes"]:
            self._flush_realloc_bytes.inc(metrics["realloc_bytes"])

    def demoted(self, doc: int, reason: str) -> None:
        ctx = current_context()
        self.blackbox.record(
            "engine", "demote", guid=None, doc=doc, reason=reason,
            trace=ctx.trace_hex if ctx else None,
        )
        if not self.enabled:
            return
        self._demotions.labels(reason=reason).inc()
        self.tracer.instant("ytpu.demote", doc=doc, reason=reason)

    def update_emitted(self, n_bytes: int) -> None:
        if not self.enabled:
            return
        self._updates_emitted.inc()
        self._egress_bytes.inc(n_bytes)

    def native_prepare(self, n_docs: int, dt_s: float) -> None:
        if not self.enabled:
            return
        self._native_prepare_seconds.observe(dt_s)
        self._native_prepare_docs.observe(n_docs)

    def device_memory(
        self, tables: dict, backend: str, occupancy: float
    ) -> None:
        """Per-table live device bytes + slot occupancy (post-flush)."""
        if not self.enabled:
            return
        total = 0
        for table, nbytes in tables.items():
            self._device_table_bytes.labels(table=table).set(nbytes)
            total += nbytes
        self._device_bytes_total.labels(backend=backend).set(total)
        self._slot_occupancy.set(occupancy)

    # -- resilience hooks ----------------------------------------------

    def rollback(self, doc: int, reason: str) -> None:
        ctx = current_context()
        if ctx is not None:
            ctx.force("rollback")
        self.blackbox.record(
            "engine", "rollback", severity="warning", doc=doc,
            reason=reason, trace=ctx.trace_hex if ctx else None,
        )
        if not self.enabled:
            return
        self._rollbacks.labels(reason=reason).inc()
        self.tracer.instant(
            "ytpu.rollback", doc=doc, reason=reason,
            **({"trace": ctx.trace_hex} if ctx else {}),
        )

    def dead_lettered(self, reason: str, depth: int, dropped: int) -> None:
        ctx = current_context()
        if ctx is not None:
            ctx.force("dlq")
        self.blackbox.record(
            "resilience", "dead_letter", severity="warning",
            reason=reason, depth=depth,
            trace=ctx.trace_hex if ctx else None,
        )
        if not self.enabled:
            return
        # group by the reason's stable prefix so a poison storm with
        # per-byte exception detail cannot explode label cardinality
        self._dead_letters.labels(reason=reason.split(":", 1)[0]).inc()
        self._dlq_depth.set(depth)
        # `dropped` is the queue's monotonic total; counters only inc,
        # so mirror the delta since the last call
        seen = getattr(self, "_dlq_dropped_seen", 0)
        if dropped > seen:
            self._dlq_dropped.inc(dropped - seen)
            self._dlq_dropped_seen = dropped

    def health_gauges(self, degraded: int, quarantined: int) -> None:
        if not self.enabled:
            return
        self._docs_degraded.set(degraded)
        self._docs_quarantined.set(quarantined)

    def readmitted(self) -> None:
        if not self.enabled:
            return
        self._readmissions.inc()

    def replayed(self, n: int) -> None:
        if not self.enabled or n <= 0:
            return
        self._replayed.inc(n)

    def replay_truncated(self, n: int) -> None:
        if not self.enabled or n <= 0:
            return
        self._replay_truncated.inc(n)

    # -- exposition ----------------------------------------------------

    def metrics_text(self) -> str:
        return prometheus_text(self.registry, global_registry())

    def snapshot(self) -> dict:
        snap = registry_snapshot(self.registry, global_registry())
        snap["schema"] = SNAPSHOT_SCHEMA_VERSION
        latest = self.history.latest
        snap["flush"] = dict(latest) if latest is not None else None
        snap["flush_history"] = self.history.snapshot()
        snap["n_flushes_recorded"] = self.history.total
        return snap


class TierMetrics:
    """The ``ytpu_tier_*`` families: doc-lifecycle tiering.

    Registered unconditionally at provider construction (the schema
    checker instantiates ``TpuProvider(1)`` and expects every family
    live) on the provider's engine registry, so per-shard fleets get
    per-shard tier series like every other engine family."""

    TIERS = ("hot", "warm", "cold")

    def __init__(self, registry: MetricsRegistry):
        r = registry
        self._docs = r.gauge(
            "ytpu_tier_docs",
            "Docs resident per lifecycle tier (hot=device slot, "
            "warm=detached host columns, cold=WAL tier record)",
            labelnames=("tier",),
        )
        self._bytes = r.gauge(
            "ytpu_tier_bytes",
            "Approximate bytes held by demoted docs, per tier "
            "(warm: host mirrors; cold: encoded state blobs/records)",
            unit="bytes",
            labelnames=("tier",),
        )
        self._transitions = r.counter(
            "ytpu_tier_transitions_total",
            "Tier transitions, by source and destination tier",
            labelnames=("src", "dst"),
        )
        self._promote_seconds = r.histogram(
            "ytpu_tier_promote_seconds",
            "Wall time to promote one doc back into a device slot, "
            "by source tier",
            unit="s",
            labelnames=("src",),
        )
        self._demote_seconds = r.histogram(
            "ytpu_tier_demote_seconds",
            "Wall time to demote one doc, by destination tier",
            unit="s",
            labelnames=("dst",),
        )
        self._evictions = r.counter(
            "ytpu_tier_evictions_total",
            "Hot docs auto-demoted to admit another doc (the path that "
            "previously raised ProviderFullError)",
        )
        self._gc_passes = r.counter(
            "ytpu_tier_gc_passes_total",
            "Forced tombstone/GC compaction passes over hot docs",
        )
        self._gc_rows = r.counter(
            "ytpu_tier_gc_reclaimed_rows_total",
            "Packed-column rows dropped by tier GC compaction",
        )
        self._gc_bytes = r.counter(
            "ytpu_tier_gc_reclaimed_bytes_total",
            "Approximate host-mirror bytes reclaimed by tier GC "
            "compaction",
            unit="bytes",
        )
        # pre-resolve label children: transitions/demotes run inside the
        # admission path
        self._docs_by_tier = {
            t: self._docs.labels(tier=t) for t in self.TIERS
        }
        self._bytes_by_tier = {
            t: self._bytes.labels(tier=t) for t in self.TIERS
        }

    def occupancy(self, counts: dict, nbytes: dict) -> None:
        for t in self.TIERS:
            self._docs_by_tier[t].set(counts.get(t, 0))
            self._bytes_by_tier[t].set(nbytes.get(t, 0))

    def transition(self, src: str, dst: str) -> None:
        self._transitions.labels(src=src, dst=dst).inc()

    def promoted(self, src: str, dt_s: float) -> None:
        self._promote_seconds.labels(src=src).observe(dt_s)

    def demoted(self, dst: str, dt_s: float) -> None:
        self._demote_seconds.labels(dst=dst).observe(dt_s)

    def evicted(self) -> None:
        self._evictions.inc()

    def gc(self, rows: int, nbytes: int) -> None:
        self._gc_passes.inc()
        if rows > 0:
            self._gc_rows.inc(rows)
        if nbytes > 0:
            self._gc_bytes.inc(nbytes)
