"""Per-doc / per-tenant cost attribution.

The fleet can say *how much* device time a flush burned (
profiler) and *how many* bytes the WAL wrote, but not **who** caused
it.  The :class:`CostLedger` rides the seams where attribution is
cheap and unambiguous:

- **ingress** (``receive_update`` / admitted-queue drain / session
  frames): stages each doc's pending bytes;
- **flush** (the unified flush seam): splits the flush's
  device time (``t_dispatch_s``) and host pack/plan time
  (``t_compact_s + t_plan_s + t_pack_s + t_emit_s``) across the staged
  docs proportionally to their staged bytes;
- **WAL append**, **replication fan-out**, **session frames**, and the
  **geo links** each add their own dimension at the call
  site.

Tenants derive from the ``tenant/doc`` guid convention (the admission controller's
``AdmissionController.tenant_of``).  Cardinality stays bounded the
Monarch way — **top-K exact + sampled tail**: up to
``YTPU_COST_MAX_DOCS`` docs (and ``YTPU_COST_MAX_TENANTS`` tenants)
are tracked exactly; when the map overflows to twice the cap it is
compacted to the K heaviest and everything else folds into one
``__other__`` bucket, whose updates may additionally be 1-in-N sampled
(``YTPU_COST_TAIL_SAMPLE``, recorded scaled so totals stay unbiased).

Per-tenant totals are exported as ``ytpu_cost_*`` counter families on
the provider's registry, so they flow into the embedded TSDB
(``obs/tsdb.py``) automatically — "who burned the device last hour"
is one ``/query``.  ``YTPU_COST_DISABLED=1`` freezes accumulation
(families still register: the exposition surface is part of the
schema contract); the ledger touches no engine state either way, so
engine output is byte-identical on or off.
"""

from __future__ import annotations

import os
import threading
from collections import deque

__all__ = ["CostLedger", "DIMS", "cost_enabled"]


def cost_enabled() -> bool:
    """Accumulation toggle — ``YTPU_COST_DISABLED=1`` freezes the
    ledger (families still register; engine state untouched either
    way)."""
    return os.environ.get("YTPU_COST_DISABLED", "") != "1"

# accumulator dimensions, in storage order
DIMS = (
    "device_s", "host_s", "wal_bytes", "repl_bytes",
    "session_frames", "geo_bytes",
)
_D_DEVICE, _D_HOST, _D_WAL, _D_REPL, _D_FRAMES, _D_GEO = range(6)
_OTHER = "__other__"
# flush epochs queued before the proportional distribution settles (it
# also settles at every read).  Keeps the flush seam itself O(1) and
# lets one settling pass run its loop cache-hot across the whole batch;
# 32 flushes is still well inside one sampler tick at any realistic
# flush cadence, so the exported families never lag a visible sample
_DRAIN_EVERY = 32


def _env_int(name: str, default: int, lo: int = 1) -> int:
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        return default
    return max(lo, v)


_tenant_fn = None


def _tenant_of(guid: str) -> str:
    # resolved once: a per-call import sits on the flush seam and costs
    # more than the accounting itself (admission imports obs, so the
    # lazy first call also breaks the cycle)
    global _tenant_fn
    if _tenant_fn is None:
        from ..admission import AdmissionController

        _tenant_fn = AdmissionController.tenant_of
    return _tenant_fn(guid)


class CostLedger:
    """Bounded per-doc / per-tenant cost accumulators (module
    docstring).  All mutation is lock-guarded: the admin plane
    snapshots concurrently with the flush path."""

    def __init__(
        self,
        registry,
        max_docs: int | None = None,
        max_tenants: int | None = None,
        tail_sample: int | None = None,
    ):
        self.max_docs = (
            max_docs
            if max_docs is not None
            else _env_int("YTPU_COST_MAX_DOCS", 512)
        )
        self.max_tenants = (
            max_tenants
            if max_tenants is not None
            else _env_int("YTPU_COST_MAX_TENANTS", 64)
        )
        self.tail_sample = (
            tail_sample
            if tail_sample is not None
            else _env_int("YTPU_COST_TAIL_SAMPLE", 1)
        )
        self.disabled = not cost_enabled()
        self._lock = threading.Lock()
        # guid -> [6 floats, tenant]; tenant -> [6 floats].  The doc
        # row carries its resolved tenant as a 7th element so the
        # flush-seam drain does one dict hit per doc, not two
        self._docs: dict = {}
        self._tenants: dict = {}
        self._tail = [0.0] * 6  # docs folded out of the exact map
        # recently-folded guids (bounded FIFO): contributions for these
        # take the sampled-tail path instead of re-entering the exact
        # map, damping fold/unfold churn under doc cardinality storms
        self._folded_ring: deque = deque(maxlen=4 * self.max_docs)
        self._folded_set: set = set()
        # bytes staged per doc since the last flush (attribution weights)
        self._staged: dict = {}
        # queued flush epochs: (staged map, device_s, host_s) awaiting
        # batched distribution (see on_flush)
        self._pending: list = []
        self._n_folded = 0
        self._tail_skip = 0  # deterministic 1-in-N tail sampling state
        # families register unconditionally (schema contract); the
        # tenant label set is bounded by the tenant cap + __other__
        r = registry
        self.m_device = r.counter(
            "ytpu_cost_device_seconds_total",
            "Device (dispatch) seconds attributed per tenant via the "
            "flush seam, staged-bytes weighted",
            labelnames=("tenant",), unit="seconds",
        )
        self.m_host = r.counter(
            "ytpu_cost_host_seconds_total",
            "Host compact+plan+pack+emit seconds attributed per tenant",
            labelnames=("tenant",), unit="seconds",
        )
        self.m_wal = r.counter(
            "ytpu_cost_wal_bytes_total",
            "WAL bytes journaled per tenant (update ingress)",
            labelnames=("tenant",), unit="bytes",
        )
        self.m_repl = r.counter(
            "ytpu_cost_repl_bytes_total",
            "Intra-fleet replication fan-out bytes enqueued per tenant",
            labelnames=("tenant",), unit="bytes",
        )
        self.m_frames = r.counter(
            "ytpu_cost_session_frames_total",
            "Session-layer frames handled per tenant",
            labelnames=("tenant",),
        )
        self.m_geo = r.counter(
            "ytpu_cost_geo_link_bytes_total",
            "Geo WAN link bytes per peer region: shipped payloads and "
            "budget-deferred bytes (counted when they finally ship)",
            labelnames=("peer", "kind"), unit="bytes",
        )
        self.m_tracked = r.gauge(
            "ytpu_cost_tracked_docs",
            "Docs currently tracked exactly by the cost ledger "
            "(bounded by YTPU_COST_MAX_DOCS)",
        )
        self.m_folded = r.counter(
            "ytpu_cost_folded_docs_total",
            "Docs folded into the sampled __other__ tail bucket by "
            "top-K compaction",
        )
        # labeled-child cache: (dim, tenant) -> counter child.  labels()
        # rebuilds a key tuple per call, which dominates the flush-seam
        # hot path; cardinality is bounded by the tenant cap x 5 dims
        self._dim_fams = (self.m_device, self.m_host, self.m_wal,
                          self.m_repl, self.m_frames)
        self._mchild: dict = {}
        # guid -> tenant memo (the staged set repeats every flush);
        # cleared wholesale when it outgrows the doc bound
        self._tenant_memo: dict = {}
        # when set (on_flush only), _metric_for accumulates here and the
        # export collapses to one inc per (dim, tenant) after the loop
        self._defer: dict | None = None

    # -- attribution hooks ---------------------------------------------------

    def staged(self, guid: str, nbytes: int) -> None:
        """One ingress update staged for the next flush (the
        attribution weight for that flush's device/host time).

        Lock-free by design: dict get/set are GIL-atomic, and the only
        concurrent reader is ``on_flush``'s swap — a write racing the
        swap can land in the outgoing dict and lose one update's
        attribution WEIGHT (never any cost: the flush's seconds are
        fully distributed over the weights that remain).  That bounded
        imprecision buys the hot ingress path out of a lock acquire."""
        if self.disabled:
            return
        s = self._staged  # ytpu-lint: disable=lock-discipline -- GIL-atomic dict ops; a racing flush swap loses at most one update's attribution weight, never cost (see docstring)
        s[guid] = s.get(guid, 0) + int(nbytes)

    def wal_bytes(self, guid: str, nbytes: int) -> None:
        if self.disabled:
            return
        self._add(guid, _D_WAL, float(nbytes))

    def repl_bytes(self, guid: str, nbytes: int) -> None:
        if self.disabled:
            return
        self._add(guid, _D_REPL, float(nbytes))

    def session_frame(self, guid: str, n: int = 1) -> None:
        if self.disabled:
            return
        self._add(guid, _D_FRAMES, float(n))

    def geo_bytes(self, peer: str, nbytes: int, kind: str = "shipped"
                  ) -> None:
        """Per-link WAN bytes: ``kind`` is
        ``shipped`` for payloads sent or ``deferred`` for bytes the
        budget held back (counted when they eventually ship)."""
        if self.disabled:
            return
        self.m_geo.labels(peer=str(peer), kind=kind).inc(int(nbytes))

    def on_flush(self, flush_metrics: dict | None) -> None:
        """Record one flush's device/host seconds against the docs
        staged since the previous flush; the staging map resets either
        way.

        The flush seam itself is O(1): each flush enqueues an epoch
        (its own staged map + its own seconds), and the proportional
        distribution settles in batches — every ``_DRAIN_EVERY`` flushes
        and at every read (:meth:`totals` / :meth:`snapshot`).  Each
        epoch keeps its own weights, so the settled numbers are
        bit-identical to distributing synchronously; only the exported
        per-tenant counter families can lag by up to the batch depth."""
        if self.disabled or not flush_metrics:
            return
        device = float(flush_metrics.get("t_dispatch_s", 0.0) or 0.0)
        host = sum(
            float(flush_metrics.get(k, 0.0) or 0.0)
            for k in ("t_compact_s", "t_plan_s", "t_pack_s", "t_emit_s")
        )
        with self._lock:
            staged, self._staged = self._staged, {}
            if not staged:
                return
            self._pending.append((staged, device, host))
            if len(self._pending) >= _DRAIN_EVERY:
                self._drain_pending()

    def _drain_pending(self) -> None:
        """Settle queued flush epochs (caller holds the lock).

        One lock hold for the whole batch (2 dims x N docs per epoch):
        per-doc locking doubles the cost for zero benefit.  The
        tracked-doc common case is inlined — two bound-method dict hits
        per doc instead of two full _add_locked calls — and the metric
        export collapses to one inc per (dim, tenant): the doc count
        per batch is unbounded but the tenant set is capped."""
        if not self._pending:  # ytpu-lint: disable=lock-discipline -- caller holds the lock: _drain_pending is only reached from on_flush's / the readers' locked sections
            return
        pending, self._pending = self._pending, []  # ytpu-lint: disable=lock-discipline -- caller holds the lock: _drain_pending is only reached from on_flush's / the readers' locked sections
        # tenant -> [device_s, host_s]: one exported inc per family
        # and tenant at the end; while the drain is active _metric_for
        # feeds the same map (only ever with the two flush dims, which
        # index the pair directly)
        defer = self._defer = {}
        docs_get = self._docs.get
        tenants_get = self._tenants.get
        defer_get = defer.get
        add_locked = self._add_locked
        D, H = _D_DEVICE, _D_HOST
        try:
            for staged, device, host in pending:
                total = sum(staged.values())
                if not total:
                    continue
                dev_u = device / total  # seconds per staged byte
                host_u = host / total
                last_tenant = trow = pair = None
                for guid, nbytes in staged.items():
                    a_dev = dev_u * nbytes
                    a_host = host_u * nbytes
                    row = docs_get(guid)
                    if row is None:
                        # new or folded doc: full bookkeeping path
                        # (compaction trigger, folded-tail sampling,
                        # tenant resolution) — it feeds `defer` itself
                        add_locked(guid, D, a_dev)
                        add_locked(guid, H, a_host)
                        continue
                    tenant = row[6]
                    row[D] += a_dev
                    row[H] += a_host
                    if tenant != last_tenant:
                        # staged maps run in guid order, so same-tenant
                        # docs cluster; one short string compare skips
                        # both lookups for the rest of the run
                        trow = tenants_get(tenant)
                        if trow is None:
                            # tenant-cap fold lives in _bump_tenant
                            eff = self._bump_tenant(tenant, D, a_dev)
                            self._bump_tenant(eff, H, a_host)
                            p = defer_get(eff)
                            if p is None:
                                defer[eff] = [a_dev, a_host]
                            else:
                                p[0] += a_dev
                                p[1] += a_host
                            last_tenant = None
                            continue
                        pair = defer_get(tenant)
                        if pair is None:
                            pair = defer[tenant] = [0.0, 0.0]
                        last_tenant = tenant
                    trow[D] += a_dev
                    trow[H] += a_host
                    pair[0] += a_dev
                    pair[1] += a_host
        finally:
            self._defer = None
            for tenant, (a_dev, a_host) in defer.items():
                self._metric_for(D, tenant, a_dev)
                self._metric_for(H, tenant, a_host)
        self.m_tracked.set(len(self._docs))

    # -- bounded accumulation ------------------------------------------------

    def _add(self, guid: str, dim: int, amount: float) -> None:
        if amount == 0.0:
            return
        with self._lock:
            self._add_locked(guid, dim, amount)
            self.m_tracked.set(len(self._docs))

    def _add_locked(self, guid: str, dim: int, amount: float) -> None:
        """Caller holds the lock (``on_flush`` batches the whole
        distribution under one hold; ``_add`` wraps for the hooks)."""
        if amount == 0.0:
            return
        row = self._docs.get(guid)
        if row is not None:
            row[dim] += amount
            eff = self._bump_tenant(row[6], dim, amount)
            self._metric_for(dim, eff, amount)
            return
        # untracked doc: resolve the tenant (memoized — folded docs
        # keep hitting this path, one per contribution)
        tenant = self._tenant_memo.get(guid)
        if tenant is None:
            if len(self._tenant_memo) >= 8 * self.max_docs:
                self._tenant_memo.clear()
            tenant = self._tenant_memo[guid] = _tenant_of(guid)
        if guid in self._folded_set:
            # a previously-folded doc: sampled tail, scaled so the
            # expected total stays unbiased (exact at N=1)
            self._tail_skip += 1
            if self._tail_skip >= self.tail_sample:
                self._tail_skip = 0
                self._tail[dim] += amount * self.tail_sample
            eff = self._bump_tenant(tenant, dim, amount)
            self._metric_for(dim, eff, amount)
            return
        if len(self._docs) >= 2 * self.max_docs:
            self._compact_docs()
        row = self._docs[guid] = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, tenant]
        row[dim] += amount
        eff = self._bump_tenant(tenant, dim, amount)
        self._metric_for(dim, eff, amount)

    def _bump_tenant(self, tenant: str, dim: int, amount: float) -> str:
        """Caller holds the lock.  Returns the effective tenant label
        (``__other__`` once the tenant cap is hit), which also bounds
        the exported families' label cardinality."""
        row = self._tenants.get(tenant)
        if row is None:
            if tenant not in self._tenants and (
                len(self._tenants) >= self.max_tenants
            ):
                tenant = _OTHER
                row = self._tenants.get(_OTHER)
            if row is None:
                row = self._tenants[tenant] = [0.0] * 6
        row[dim] += amount
        return tenant

    def _compact_docs(self) -> None:
        """Top-K compaction (caller holds the lock): keep the
        ``max_docs`` heaviest docs, fold the rest into the tail and
        remember them in the bounded folded ring."""
        ranked = sorted(
            self._docs.items(),
            key=lambda kv: (kv[1][_D_DEVICE] + kv[1][_D_HOST],
                            sum(kv[1][:6]), kv[0]),
            reverse=True,
        )
        folded = 0
        for guid, row in ranked[self.max_docs:]:
            del self._docs[guid]
            if len(self._folded_ring) == self._folded_ring.maxlen:
                self._folded_set.discard(self._folded_ring[0])
            self._folded_ring.append(guid)
            self._folded_set.add(guid)
            for d in range(6):
                self._tail[d] += row[d]
            folded += 1
        self._n_folded += folded
        self.m_folded.inc(folded)
        self.m_tracked.set(len(self._docs))

    def _metric_for(self, dim: int, tenant: str, amount: float) -> None:
        # per-tenant exported families: label cardinality bounded by
        # the tenant cap (overflow tenants land on __other__ above,
        # but the label here follows the exact tenant until then)
        if dim >= len(self._dim_fams):  # geo_bytes is metric-only
            return
        if self._defer is not None:
            # drain-active: only the two flush dims reach here, and
            # they index the [device_s, host_s] pair directly
            pair = self._defer.get(tenant)
            if pair is None:
                self._defer[tenant] = pair = [0.0, 0.0]
            pair[dim] += amount
            return
        child = self._mchild.get((dim, tenant))
        if child is None:
            child = self._dim_fams[dim].labels(tenant=tenant)
            self._mchild[(dim, tenant)] = child
        child.inc(amount if dim <= _D_HOST else int(amount))

    # -- read side -----------------------------------------------------------

    def totals(self) -> dict:
        """Conservation check surface: exact per-doc sums + tail, per
        dimension (the 10k-doc churn test pins tracked+tail == fed)."""
        with self._lock:
            self._drain_pending()
            rows = list(self._docs.values())
            tail = list(self._tail)
        return {
            dim: sum(r[i] for r in rows) + tail[i]
            for i, dim in enumerate(DIMS)
        }

    def snapshot(self, top: int = 10) -> dict:
        """JSON-able ledger view: top docs by device+host burn, every
        tracked tenant, the folded tail, and the caps."""
        with self._lock:
            self._drain_pending()
            docs = sorted(
                self._docs.items(),
                key=lambda kv: (kv[1][_D_DEVICE] + kv[1][_D_HOST],
                                sum(kv[1][:6]), kv[0]),
                reverse=True,
            )[:max(0, top)]
            tenants = {
                t: dict(zip(DIMS, row))
                for t, row in sorted(self._tenants.items())
            }
            tail = dict(zip(DIMS, self._tail))
            n_docs = len(self._docs)
            n_folded = self._n_folded
        return {
            "tracked_docs": n_docs,
            "folded_docs": n_folded,
            "max_docs": self.max_docs,
            "max_tenants": self.max_tenants,
            "tail_sample": self.tail_sample,
            "disabled": self.disabled,
            "top": [
                {"guid": g, "tenant": row[6],
                 **dict(zip(DIMS, row))}
                for g, row in docs
            ],
            "tenants": tenants,
            "tail": tail,
        }
