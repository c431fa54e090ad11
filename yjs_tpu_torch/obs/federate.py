"""Cross-shard metrics federation.

Merges N shard/provider metric snapshots (the
:func:`~yjs_tpu.obs.expo.registry_snapshot` shape) into ONE labeled
view:

- **counters sum** across sources per labels-key (events are additive
  across shards);
- **gauges keep per-shard series** — each source's series re-labeled
  with ``shard=<label>,role=<role>`` — plus a summed aggregate under
  the original labels-key so single-provider dashboards (``ytpu_top``
  columns, ``collect_row``) keep reading the unlabeled series;
- **histograms merge**: counts and sums add, min/max widen, and
  quantiles are count-weighted across sources (the snapshot shape
  carries summaries, not raw buckets — the weighted estimate is exact
  for count/sum/min/max and a documented approximation for p50/p95/p99).

Three input paths share the merge:

- **in-process** (``FleetRouter.metrics_snapshot``): per-shard
  engine-local registries, with the process-global registry layered in
  once, un-summed — global families are shared by every shard, so
  summing them would multiply by N;
- **file scrape** (:func:`read_snapshot_dir`): a directory of per-shard
  snapshot JSON files, one process each — what ``ytpu_top <dir>`` and
  ``ytpu_stats --merge`` consume, and the supervisor's fallback when
  the admin plane is disabled;
- **HTTP scrape** (:func:`scrape_endpoints`): GET each
  process's ``/metrics.json`` admin endpoint — the mode multi-host
  clusters use, since remote shards share no filesystem.

Both scrape paths are hardened against mid-write / mid-death races: a
file deleted between listdir and open, a truncated JSON body, or an
endpoint closing the socket mid-response all yield a **stale-marked
empty source** (counted in ``ytpu_fed_scrape_errors_total{mode}``),
never an exception — a dying shard renders a blank row, it does not
take the dashboard down with it.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import urllib.parse
import urllib.request
from typing import Iterable, Optional

__all__ = [
    "federate_snapshots",
    "read_snapshot_dir",
    "scrape_endpoints",
    "merge_summaries",
    "FederationMetrics",
    "fed_metrics",
]


def _labels_join(base: str, extra: str) -> str:
    if not base:
        return extra
    if not extra:
        return base
    return f"{base},{extra}"


def merge_summaries(parts: Iterable[dict]) -> dict:
    """Merge histogram summaries: exact count/sum/min/max, count-weighted
    quantile estimates."""
    count = 0
    total = 0.0
    mn = None
    mx = None
    q = {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    for s in parts:
        c = int(s.get("count", 0))
        if not c:
            continue
        count += c
        total += float(s.get("sum", 0.0))
        smn, smx = float(s.get("min", 0.0)), float(s.get("max", 0.0))
        mn = smn if mn is None else min(mn, smn)
        mx = smx if mx is None else max(mx, smx)
        for k in q:
            q[k] += c * float(s.get(k, 0.0))
    if not count:
        return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                "p50": 0.0, "p95": 0.0, "p99": 0.0}
    out = {"count": count, "sum": total, "min": mn, "max": mx}
    for k, v in q.items():
        out[k] = min(max(v / count, mn), mx)
    return out


def federate_snapshots(sources: list[dict],
                       global_snapshot: Optional[dict] = None) -> dict:
    """Merge per-shard snapshots into one federated snapshot.

    ``sources`` is a list of ``{"label": str, "role": str,
    "snapshot": dict}`` entries (``role`` optional).  The result keeps
    the ``{counters, gauges, histograms}`` snapshot shape (so every
    existing renderer works on it) plus a ``federation`` block naming
    the sources merged.  ``global_snapshot``, when given, is layered in
    once without summing — for in-process fleets whose shards all share
    the process-global registry."""
    counters: dict = {}
    gauges: dict = {}
    histograms: dict = {}
    hist_parts: dict = {}
    roles: dict = {}

    for src in sources:
        label = str(src.get("label", "?"))
        role = str(src.get("role", "") or "")
        snap = src.get("snapshot") or {}
        roles[label] = role
        shard_labels = f"shard={label}" + (f",role={role}" if role else "")
        for name, series in (snap.get("counters") or {}).items():
            dst = counters.setdefault(name, {})
            for lk, v in series.items():
                dst[lk] = dst.get(lk, 0) + v
        for name, series in (snap.get("gauges") or {}).items():
            dst = gauges.setdefault(name, {})
            for lk, v in series.items():
                dst[_labels_join(lk, shard_labels)] = v
                dst[lk] = dst.get(lk, 0) + v
        for name, series in (snap.get("histograms") or {}).items():
            dst = hist_parts.setdefault(name, {})
            for lk, s in series.items():
                dst.setdefault(lk, []).append(s)

    for name, series in hist_parts.items():
        histograms[name] = {
            lk: merge_summaries(parts) for lk, parts in series.items()
        }

    if global_snapshot:
        for section, dst in (("counters", counters), ("gauges", gauges),
                             ("histograms", histograms)):
            for name, series in (global_snapshot.get(section) or {}).items():
                if name not in dst:
                    dst[name] = dict(series)

    return {
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "federation": {
            "sources": len(sources),
            "roles": roles,
            "stale": sorted(
                str(s.get("label", "?")) for s in sources if s.get("stale")
            ),
        },
    }


def read_snapshot_dir(path: str, cache: dict | None = None) -> list[dict]:
    """Load every ``*.json`` metrics snapshot in a directory as a
    federation source (label = file stem, role from the snapshot's own
    ``role`` key when present).  Unreadable files — deleted between
    listdir and open, or caught mid-write — contribute a stale-marked
    empty snapshot and count in
    ``ytpu_fed_scrape_errors_total{mode="file"}``: a dying shard
    renders a blank row, never crashes the dashboard.

    ``cache`` (caller-owned dict, e.g. one per ytpu_top watcher) skips
    re-parsing files whose ``(mtime_ns, size)`` did not change since
    the previous call — a ``--watch`` against a large fleet dir stops
    re-reading every snapshot every frame.
    Entries for files that vanished are pruned."""
    sources = []
    try:
        names = sorted(
            n for n in os.listdir(path) if n.endswith(".json")
        )
    except OSError:
        return sources
    seen = set()
    for n in names:
        label = n[: -len(".json")]
        full = os.path.join(path, n)
        seen.add(full)
        stamp = None
        if cache is not None:
            try:
                st = os.stat(full)
                stamp = (st.st_mtime_ns, st.st_size)
            except OSError:
                stamp = None
            hit = cache.get(full)
            if hit is not None and stamp is not None and hit[0] == stamp:
                sources.append(hit[1])
                continue
        snap: dict = {}
        stale = False
        try:
            with open(full) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            snap = {}
            stale = True
        if not isinstance(snap, dict):
            snap = {}
            stale = True
        if stale:
            fed_metrics().scrape_error("file")
        source = {
            "label": label,
            "role": str(snap.get("role", "") or ""),
            "snapshot": snap,
            "stale": stale,
        }
        # never cache a stale read: the writer may be mid-replace and
        # the next frame should retry the parse
        if cache is not None and stamp is not None and not stale:
            cache[full] = (stamp, source)
        sources.append(source)
    if cache is not None:
        for k in [k for k in cache if k not in seen]:
            del cache[k]
    return sources


def _endpoint_label(url: str) -> str:
    """A stable source label for one admin endpoint: host:port of the
    URL (the snapshot's own ``label`` key wins when present)."""
    try:
        parts = urllib.parse.urlsplit(url)
        return parts.netloc or url
    except ValueError:
        return url


def scrape_endpoints(
    urls: Iterable[str], timeout_s: float = 2.0
) -> list[dict]:
    """GET each admin endpoint's ``/metrics.json`` as a federation
    source (HTTP scrape mode).

    Each target gets its own ``timeout_s`` budget; a dead, hung, or
    mid-death endpoint (refused connection, timeout, socket closed
    mid-body, torn JSON) yields a **stale-marked empty source** and a
    ``ytpu_fed_scrape_errors_total{mode="http"}`` increment — partial
    failure is a rendering state, never a federation error.  ``urls``
    may be bare ``host:port``, a base URL, or a full ``…/metrics.json``
    path."""
    sources = []
    for url in urls:
        u = str(url).rstrip("/")
        if "://" not in u:
            u = "http://" + u
        if not u.endswith("/metrics.json"):
            u = u + "/metrics.json"
        snap: dict = {}
        stale = False
        try:
            with urllib.request.urlopen(u, timeout=timeout_s) as resp:
                body = resp.read()
            snap = json.loads(body.decode("utf-8"))
        except (OSError, ValueError, http.client.HTTPException):
            # URLError subclasses OSError (refused/timeout/reset);
            # a socket closed mid-body with a Content-Length promised
            # surfaces as http.client.IncompleteRead
            snap = {}
            stale = True
        if not isinstance(snap, dict):
            snap = {}
            stale = True
        if stale:
            fed_metrics().scrape_error("http")
        label = snap.get("label") or _endpoint_label(u)
        sources.append({
            "label": str(label),
            "role": str(snap.get("role", "") or ""),
            "snapshot": snap,
            "stale": stale,
            "url": str(url),
        })
    return sources


class FederationMetrics:
    """``ytpu_fed_*`` families on the process-global registry."""

    def __init__(self, registry=None) -> None:
        if registry is None:
            from . import global_registry

            registry = global_registry()
        self.sources = registry.gauge(
            "ytpu_fed_sources",
            "Shard/provider metric sources merged by the last "
            "federation pass",
        )
        self.merges = registry.counter(
            "ytpu_fed_merges_total",
            "Federated metric merges performed (fleet snapshots + file "
            "scrapes)",
        )
        self.scrape_errors = registry.counter(
            "ytpu_fed_scrape_errors_total",
            "Federation sources skipped as stale (unreadable snapshot "
            "file, or an admin endpoint that died mid-scrape), by "
            "scrape mode",
            labelnames=("mode",),
        )

    def observe(self, n_sources: int) -> None:
        self.sources.set(int(n_sources))
        self.merges.inc()

    def scrape_error(self, mode: str) -> None:
        self.scrape_errors.labels(mode=mode).inc()


_FED_METRICS: Optional[FederationMetrics] = None
_FED_LOCK = threading.Lock()


def fed_metrics() -> FederationMetrics:
    """Process-wide :class:`FederationMetrics` singleton — the module
    scrape functions have no registry handle of their own."""
    # cold path (one call per scrape pass): plain lock, like rpc_metrics
    global _FED_METRICS
    with _FED_LOCK:
        if _FED_METRICS is None:
            _FED_METRICS = FederationMetrics()
        return _FED_METRICS
