#!/usr/bin/env python
"""ytpu_top on the PyTorch port: live fleet dashboard over provider metrics.

The port's copy of ``scripts/ytpu_top.py``: the same sources, columns and
frames (given the same snapshots the two scripts print the same text),
over the port's ``obs.federate`` and ``obs.tsdb``; ``--demo`` drives
port providers, on the CUDA device unless ``--device cpu`` is given (no
card is then an error).  The file, directory, ``--url``, ``--cluster``
and ``--range`` modes only read snapshots and touch no device.

A `top`-style view of one or more providers: flush throughput, queued
work, convergence latency percentiles, SLO burn-rate verdicts, and the
resilience / durability counters that page an operator (DLQ depth,
quarantined rooms, WAL fsync debt).

Sources (one row per provider):

    python scripts/torch_ytpu_top.py snapA.json snapB.json
        Poll metrics-snapshot JSON files (as written by
        ``provider.metrics_snapshot()`` — e.g. a sidecar dumping the
        snapshot to a wellknown path every second).  Files are re-read
        every ``--interval`` seconds; rates are derived from consecutive
        reads.

    python scripts/torch_ytpu_top.py /path/to/snapshot-dir/
        Federated mode: the directory's ``*.json`` files are treated as
        per-shard snapshots (the file-based scrape mode a multi-process
        fleet writes) and merged via ``yjs_tpu_torch.obs.federate`` — one
        leading ``FLEET`` aggregate row (counters summed, histograms
        merged) above the per-shard rows.

    python scripts/torch_ytpu_top.py --url http://127.0.0.1:9464 [--url ...]
        Live scrape mode: poll each process's admin-plane
        ``/metrics.json`` over HTTP.  Several ``--url`` flags federate
        under a leading ``FLEET`` row; a dead endpoint renders as a
        stale blank row.

    python scripts/torch_ytpu_top.py --demo
        Run two in-process providers exchanging sync traffic, one frame
        of fresh edits per poll — the zero-to-dashboard smoke test.

    python scripts/torch_ytpu_top.py --cluster /path/to/snapshot-dir/
        Cluster mode: the directory is a supervisor snapshot
        drop (``Supervisor.dump_snapshots`` / YTPU_CLUSTER_SNAPSHOT_DIR)
        — ``shard-K.json`` metric snapshots federate as in directory
        mode, and ``cluster.json`` (the structured recovery report)
        renders as a supervision panel above them: per-shard process
        state, restart counts, replay outcomes, and the event tail.

    python scripts/torch_ytpu_top.py --url ... --range ytpu_engine_pending_docs
        History mode: one-shot query of each endpoint's
        embedded-TSDB ``/query`` (``--last`` seconds, ``--agg``
        combiner; a supervisor URL answers the federated cross-shard
        series), rendered as min/max/last plus a sparkline.

Renders with curses on a tty, plain text otherwise (or with ``--plain``);
``--once`` prints a single frame and exits (scripting / CI).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

COLUMNS = (
    ("provider", 14),
    ("flushes", 8),
    ("docs/s", 8),
    ("pend", 6),
    ("conv p50", 9),
    ("conv p99", 9),
    ("slo", 8),
    ("burn", 7),
    ("dlq", 5),
    ("quar", 5),
    ("wal rec", 8),
    ("occup", 6),
    ("ovlp", 6),
    ("residue", 8),
    ("plnhit", 7),
    ("hot", 5),
    ("warm", 5),
    ("cold", 5),
    ("brownout", 9),
    ("trend", 10),
)

# sparkline glyphs, low to high (the "trend" column and --range mode)
_SPARK = "▁▂▃▄▅▆▇█"
# docs/s polls kept per provider row for the trend sparkline
_TREND_LEN = 10


def sparkline(values, width: int | None = None) -> str:
    """Render a value series as a fixed-width unicode sparkline
    (newest-last; empty/constant series render as a flat line)."""
    vals = [float(v) for v in values]
    if width is not None:
        vals = vals[-width:]
    if not vals:
        return "-"
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[min(len(_SPARK) - 1, int((v - lo) / span * len(_SPARK)))]
        for v in vals
    )

# per-shard fleet rows (rendered when a snapshot carries a "fleet"
# block — see FleetRouter.fleet_snapshot / metrics_snapshot)
FLEET_COLUMNS = (
    ("provider", 14),
    ("shard", 6),
    ("docs", 6),
    ("cap", 5),
    ("occup", 6),
    ("warm", 5),
    ("cold", 5),
    ("state", 8),
    ("role", 8),
    ("dlq", 5),
    ("sess", 5),
    ("migr", 5),
    ("in", 4),
    ("out", 4),
    ("repl", 5),
    ("rlag", 5),
)

# per-peer session rows (rendered as a second table when any provider
# snapshot carries a "sessions" list — see provider.sessions_snapshot)
SESSION_COLUMNS = (
    ("provider", 14),
    ("room", 10),
    ("peer", 10),
    ("state", 12),
    ("outbox", 7),
    ("rtx", 6),
    ("ack age", 8),
    ("resumes", 8),
    ("shed", 5),
)

# per-link geo rows (rendered when a snapshot carries a "geo" block —
# see GeoReplicator.snapshot, surfaced by provider.metrics_snapshot and
# the fleet/cluster statusz pages)
GEO_COLUMNS = (
    ("provider", 14),
    ("region", 8),
    ("link", 8),
    ("state", 12),
    ("health", 8),
    ("outbox", 7),
    ("dirty", 6),
    ("lag B", 7),
    ("lag s", 7),
    ("reconn", 7),
    ("resume", 7),
    ("resync", 7),
    ("dl", 4),
    ("ship B", 8),
    ("defer B", 8),
)

_STATE_NAMES = {0: "ok", 1: "warning", 2: "page"}

# brownout degradation levels, abbreviated to fit the column
_ADM_NAMES = {0: "normal", 1: "shed-bg", 2: "coalesce", 3: "rej-write"}


def _counter(snap: dict, name: str, labels_key: str = "") -> float:
    return float(snap.get("counters", {}).get(name, {}).get(labels_key, 0))


def _gauge(snap: dict, name: str, labels_key: str = "") -> float:
    return float(snap.get("gauges", {}).get(name, {}).get(labels_key, 0))


def _hist(snap: dict, name: str, labels_key: str = "") -> dict | None:
    return snap.get("histograms", {}).get(name, {}).get(labels_key)


def _counter_sum(snap: dict, name: str) -> float:
    return float(sum(snap.get("counters", {}).get(name, {}).values()))


def collect_row(
    name: str, snap: dict, prev: dict | None, interval: float
) -> dict:
    """One dashboard row from a provider snapshot.  ``prev`` is the
    previous poll's row (its ``totals``) so rates survive file sources
    that only expose monotonic counters."""
    flushes = _counter(snap, "ytpu_engine_flushes_total")
    docs_flushed = _counter(snap, "ytpu_engine_docs_flushed_total")
    docs_rate = 0.0
    if prev is not None and interval > 0:
        docs_rate = max(0.0, docs_flushed - prev["totals"]["docs_flushed"])
        docs_rate /= interval
    conv = _hist(snap, "ytpu_convergence_latency_seconds")
    # per-row docs/s history feeding the trend sparkline (carried
    # poll-to-poll through the prev row like the rate totals)
    history = list((prev or {}).get("history") or ())
    history = (history + [docs_rate])[-_TREND_LEN:]
    slo = snap.get("slo") or {}
    state = slo.get("state")
    if state is None:
        state = _STATE_NAMES.get(int(_gauge(snap, "ytpu_slo_state")), "?")
    burns = slo.get("burn_rates") or {}
    burn = max(burns.values()) if burns else 0.0
    return {
        "provider": name,
        "flushes": int(flushes),
        "docs/s": f"{docs_rate:.1f}",
        "pend": int(_gauge(snap, "ytpu_engine_pending_docs")),
        "conv p50": f"{conv['p50'] * 1e3:.1f}ms" if conv else "-",
        "conv p99": f"{conv['p99'] * 1e3:.1f}ms" if conv else "-",
        "slo": state,
        "burn": f"{burn:.1f}",
        "dlq": int(_gauge(snap, "ytpu_resilience_dead_letter_depth")),
        "quar": int(_gauge(snap, "ytpu_resilience_docs_quarantined")),
        "wal rec": int(_counter_sum(snap, "ytpu_wal_records_appended_total")),
        "occup": f"{_gauge(snap, 'ytpu_prof_slot_occupancy'):.2f}",
        # flush-pipeline overlap fraction: share of host pack
        # time hidden behind an in-flight device dispatch ("-" until the
        # pipeline has packed at least one overlapped stage)
        "ovlp": (
            f"{_ov['sum'] / _pk['sum']:.2f}"
            if (_pk := _hist(snap, "ytpu_engine_phase_seconds",
                             "phase=pack"))
            and (_ov := _hist(snap, "ytpu_flush_pack_overlap_seconds"))
            and _pk["sum"] > 0
            else "-"
        ),
        # planner residue fraction: share of planned structs
        # handed to the sequential YATA conflict fallback on the last
        # flush with planner work ("-" until the planner has run)
        "residue": (
            f"{_re:.2f}"
            if (_re := snap.get("gauges", {})
                .get("ytpu_plan_segment_residue_fraction", {})
                .get("")) is not None
            else "-"
        ),
        # plan-cache hit rate (process-global counters; "-" before the
        # first planned flush)
        "plnhit": (
            f"{_counter(snap, 'ytpu_plan_cache_hits_total') / _pl:.2f}"
            if (_pl := _counter(snap, "ytpu_plan_cache_hits_total")
                + _counter(snap, "ytpu_plan_cache_misses_total"))
            else "-"
        ),
        "hot": int(_gauge(snap, "ytpu_tier_docs", "tier=hot")),
        "warm": int(_gauge(snap, "ytpu_tier_docs", "tier=warm")),
        "cold": int(_gauge(snap, "ytpu_tier_docs", "tier=cold")),
        "brownout": (
            "off"
            if not (snap.get("admission") or {}).get("enabled")
            else _ADM_NAMES.get(
                int((snap.get("admission") or {}).get("level", 0)), "?"
            )
        ),
        "trend": sparkline(history, _TREND_LEN),
        "history": history,
        "sessions": [
            {
                "provider": name,
                "room": str(s.get("guid", "?")),
                "peer": str(s.get("peer", "?")),
                "state": str(s.get("state", "?")),
                "outbox": int(s.get("outbox_depth", 0)),
                "rtx": int(s.get("retransmits", 0)),
                "ack age": int(s.get("last_ack_age", 0)),
                "resumes": int(s.get("resumes", 0)),
                "shed": int(s.get("shed", 0)),
            }
            for s in (snap.get("sessions") or [])
        ],
        "fleet": [
            {
                "provider": name,
                "shard": int(sh.get("shard", -1)),
                "docs": int(sh.get("docs", 0)),
                "cap": int(sh.get("capacity", 0)),
                "occup": f"{float(sh.get('occupancy', 0)):.2f}",
                "warm": int(sh.get("warm", 0)),
                "cold": int(sh.get("cold", 0)),
                "state": str(sh.get("state", "?")),
                "role": str(sh.get("role", "?")),
                "dlq": int(sh.get("dlq", 0)),
                "sess": int(sh.get("sessions", 0)),
                "migr": int(sh.get("migrating", 0)),
                "in": int(sh.get("mig_in", 0)),
                "out": int(sh.get("mig_out", 0)),
                "repl": int(sh.get("repl_docs", 0)),
                "rlag": int(sh.get("repl_lag", 0)),
            }
            for sh in (snap.get("fleet") or {}).get("shards", [])
        ],
        "fleet_head": (
            {
                "epoch": int((snap.get("fleet") or {}).get("epoch", 0)),
                "docs": int((snap.get("fleet") or {}).get("docs", 0)),
                "capacity": int(
                    (snap.get("fleet") or {}).get("capacity", 0)
                ),
                "live": int(
                    (snap.get("fleet") or {}).get("live_shards", 0)
                ),
                "migrating": int(
                    (snap.get("fleet") or {}).get("migrations_active", 0)
                ),
            }
            if snap.get("fleet")
            else None
        ),
        "geo": [
            {
                "provider": name,
                "region": str((snap.get("geo") or {}).get("region", "?")),
                "link": str(ln.get("link", "?")),
                "state": str(ln.get("state", "?")),
                "health": str(ln.get("detector", "?")),
                "outbox": int(ln.get("outbox", 0)),
                "dirty": int(ln.get("dirty_docs", 0)),
                "lag B": int(ln.get("lag_bytes", 0)),
                "lag s": f"{float(ln.get('lag_seconds', 0)):.1f}",
                "reconn": int(ln.get("reconnects", 0)),
                "resume": int(ln.get("resumes", 0)),
                "resync": int(ln.get("full_resyncs", 0)),
                "dl": int(ln.get("dead_letters", 0)),
                "ship B": int(ln.get("shipped_bytes", 0)),
                "defer B": int(ln.get("deferred_bytes", 0)),
            }
            for ln in (snap.get("geo") or {}).get("links", [])
        ],
        "geo_head": (
            {
                "region": str(snap["geo"].get("region", "?")),
                "epoch": int(snap["geo"].get("epoch", 0)),
                "links": len(snap["geo"].get("links", [])),
            }
            if snap.get("geo")
            else None
        ),
        "totals": {"docs_flushed": docs_flushed},
    }


def render(rows: list[dict], interval: float) -> str:
    """One plain-text frame: header line, column bar, one line per
    provider, and a worst-verdict footer."""
    stamp = time.strftime("%H:%M:%S")
    out = [
        f"ytpu_top  {stamp}  providers={len(rows)}  "
        f"interval={interval:g}s"
    ]
    out.append("  ".join(f"{title:>{w}}" for title, w in COLUMNS))
    worst = "ok"
    for row in rows:
        out.append(
            "  ".join(f"{str(row[title]):>{w}}" for title, w in COLUMNS)
        )
        order = {"ok": 0, "warning": 1, "page": 2}
        if order.get(row["slo"], 0) > order.get(worst, 0):
            worst = row["slo"]
    fleet_rows = [s for row in rows for s in row.get("fleet", [])]
    if fleet_rows:
        heads = [
            r["fleet_head"] for r in rows if r.get("fleet_head")
        ]
        out.append("")
        if heads:
            h = heads[0]
            out.append(
                f"fleet: epoch={h['epoch']}  docs={h['docs']}/"
                f"{h['capacity']}  live_shards={h['live']}  "
                f"migrating={h['migrating']}"
            )
        out.append(
            "  ".join(f"{title:>{w}}" for title, w in FLEET_COLUMNS)
        )
        for s in fleet_rows:
            out.append(
                "  ".join(
                    f"{str(s[title]):>{w}}" for title, w in FLEET_COLUMNS
                )
            )
    geo_rows = [g for row in rows for g in row.get("geo", [])]
    if geo_rows:
        heads = [r["geo_head"] for r in rows if r.get("geo_head")]
        out.append("")
        if heads:
            out.append(
                "geo: " + "  ".join(
                    f"region={h['region']} epoch={h['epoch']} "
                    f"links={h['links']}"
                    for h in heads
                )
            )
        out.append(
            "  ".join(f"{title:>{w}}" for title, w in GEO_COLUMNS)
        )
        for g in geo_rows:
            out.append(
                "  ".join(
                    f"{str(g[title]):>{w}}" for title, w in GEO_COLUMNS
                )
            )
    sess_rows = [s for row in rows for s in row.get("sessions", [])]
    if sess_rows:
        out.append("")
        out.append(
            "  ".join(f"{title:>{w}}" for title, w in SESSION_COLUMNS)
        )
        for s in sess_rows:
            out.append(
                "  ".join(
                    f"{str(s[title]):>{w}}" for title, w in SESSION_COLUMNS
                )
            )
    out.append(f"fleet verdict: {worst}")
    return "\n".join(out) + "\n"


# -- sources -----------------------------------------------------------------


class FileSource:
    """Polls snapshot JSON files (one provider per file), re-parsing
    only files whose ``(mtime_ns, size)`` changed since the previous
    frame — ``--watch``-style loops against slow-moving sidecar dumps
    stop burning a core re-reading identical JSON."""

    def __init__(self, paths: list[str]):
        self.paths = [Path(p) for p in paths]
        self._cache: dict = {}  # path -> ((mtime_ns, size), snapshot)

    def poll(self) -> list[tuple[str, dict]]:
        out = []
        for p in self.paths:
            stamp = None
            try:
                st = p.stat()
                stamp = (st.st_mtime_ns, st.st_size)
            except OSError:
                pass
            hit = self._cache.get(p)
            if hit is not None and stamp is not None and hit[0] == stamp:
                out.append((p.stem, hit[1]))
                continue
            try:
                with open(p) as f:
                    snap = json.load(f)
            except (OSError, ValueError):
                out.append((p.stem, {}))  # unreadable: render an empty row
                continue
            if stamp is not None:
                self._cache[p] = (stamp, snap)
            out.append((p.stem, snap))
        return out


class DirSource:
    """Federated file mode: every poll reads each ``*.json`` in the
    directory as one shard's snapshot and prepends a ``FLEET`` row
    merged across them (``ytpu_top <dir>``).  Unchanged files are
    served from an mtime/size cache (``read_snapshot_dir``'s) so a watch over a large fleet dir skips the re-parse."""

    def __init__(self, path: str):
        self.path = str(path)
        self._cache: dict = {}

    def poll(self) -> list[tuple[str, dict]]:
        from yjs_tpu_torch.obs.federate import (
            federate_snapshots,
            read_snapshot_dir,
        )

        sources = read_snapshot_dir(self.path, cache=self._cache)
        out = [("FLEET", federate_snapshots(sources))]
        for src in sources:
            out.append(
                (str(src.get("label", "?")), src.get("snapshot") or {})
            )
        return out


CLUSTER_COLUMNS = (
    ("shard", 6),
    ("state", 11),
    ("pid", 8),
    ("port", 6),
    ("restarts", 9),
    ("outcome", 10),
    ("replayed", 9),
)


def render_cluster(report: dict) -> str:
    """The supervision panel: one row per shard process plus the
    resolution totals and the last few restart/failover events."""
    if not report:
        return "cluster: no cluster.json yet\n"
    out = [
        f"cluster epoch {report.get('epoch', 0)}  "
        f"outcomes {report.get('outcomes', {})}  "
        f"resolution {report.get('resolution', {})}"
    ]
    out.append(
        "  ".join(f"{title:>{w}}" for title, w in CLUSTER_COLUMNS)
    )
    for row in report.get("shards", ()):
        vals = {
            "shard": row.get("shard", "?"),
            "state": row.get("state", "?"),
            "pid": row.get("pid", 0),
            "port": row.get("port", 0),
            "restarts": row.get("restarts", 0),
            "outcome": row.get("outcome", ""),
            "replayed": row.get("records_applied", 0),
        }
        out.append(
            "  ".join(
                f"{str(vals[title]):>{w}}" for title, w in CLUSTER_COLUMNS
            )
        )
    for ev in (report.get("events") or [])[-3:]:
        out.append(
            f"  event: shard {ev.get('shard')} {ev.get('outcome')} "
            f"epoch={ev.get('epoch')} "
            f"unavailable={ev.get('unavailable_s')}s "
            f"resolution={ev.get('resolution')}"
        )
    return "\n".join(out) + "\n"


class ClusterDirSource:
    """Supervisor snapshot-dir mode (``--cluster``): ``shard-*.json``
    federate like :class:`DirSource`, ``cluster.json`` feeds the
    supervision panel via :meth:`header`."""

    def __init__(self, path: str):
        self.path = str(path)
        self._cache: dict = {}

    def _report(self) -> dict:
        try:
            with open(Path(self.path) / "cluster.json") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}  # mid-write or not dumped yet: empty panel

    def header(self) -> str:
        return render_cluster(self._report())

    def poll(self) -> list[tuple[str, dict]]:
        from yjs_tpu_torch.obs.federate import (
            federate_snapshots,
            read_snapshot_dir,
        )

        sources = [
            s for s in read_snapshot_dir(self.path, cache=self._cache)
            if str(s.get("label", "")) != "cluster"
        ]
        out = [("CLUSTER", federate_snapshots(sources))]
        for src in sources:
            out.append(
                (str(src.get("label", "?")), src.get("snapshot") or {})
            )
        return out


class UrlSource:
    """Admin-plane scrape mode (``--url``): every poll GETs
    each endpoint's ``/metrics.json`` via
    :func:`~yjs_tpu_torch.obs.federate.scrape_endpoints`.  One URL renders a
    single provider row; several federate under a leading ``FLEET``
    row, with dead endpoints as stale blank rows (never a crash)."""

    def __init__(self, urls: list[str], timeout_s: float = 2.0):
        self.urls = list(urls)
        self.timeout_s = timeout_s

    def poll(self) -> list[tuple[str, dict]]:
        from yjs_tpu_torch.obs.federate import (
            federate_snapshots,
            scrape_endpoints,
        )

        sources = scrape_endpoints(self.urls, timeout_s=self.timeout_s)
        out = []
        if len(sources) > 1:
            out.append(("FLEET", federate_snapshots(sources)))
        for src in sources:
            out.append(
                (str(src.get("label", "?")), src.get("snapshot") or {})
            )
        return out


class DemoSource:
    """Two in-process providers joined by per-room peer sessions over
    an in-memory pipe; every poll applies one fresh edit and pumps the
    wire, so the session table renders live states and ack ages."""

    def __init__(self, device: str | None = None):
        from yjs_tpu_torch.provider import TpuProvider
        from yjs_tpu_torch.sync import PipeNetwork

        self.a = TpuProvider(8, device=device)
        self.b = TpuProvider(8, device=device)
        self._n = 0
        self.net = PipeNetwork()
        for k in range(4):
            t1, t2 = self.net.pair()
            self.a.session(f"room{k}", "provider-b").connect(t1)
            self.b.session(f"room{k}", "provider-a").connect(t2)

    def _drive(self) -> None:
        self.a.flush()
        self.b.flush()
        self.a.tick_sessions()
        self.b.tick_sessions()

    def poll(self) -> list[tuple[str, dict]]:
        from yjs_tpu_torch.core import Doc
        from yjs_tpu_torch.updates import encode_state_as_update

        self._n += 1
        d = Doc(gc=False)
        d.get_text("text").insert(0, f"edit {self._n} ")
        u = encode_state_as_update(d)
        self.a.receive_update(f"room{self._n % 4}", u)
        self.net.settle((self._drive,))
        return [
            ("provider-a", self.a.metrics_snapshot()),
            ("provider-b", self.b.metrics_snapshot()),
        ]


# -- history range mode ---------------------------------------------------------


def run_range(
    urls: list[str], name: str, labels: str, last_s: float, agg: str,
    timeout_s: float = 2.0, out=None,
) -> int:
    """``--range``: one shot against each admin endpoint's embedded-TSDB
    ``/query`` (a supervisor URL answers with the federated cross-shard
    series), rendered as min/max/last plus a sparkline per endpoint."""
    from yjs_tpu_torch.obs.tsdb import query_endpoints

    out = out or sys.stdout
    end = time.time()
    results = query_endpoints(
        {u: u for u in urls},
        {
            "name": name,
            "labels": labels,
            "start": end - last_s,
            "end": end,
            "agg": agg,
        },
        timeout_s=timeout_s,
    )
    out.write(
        f"ytpu_top --range  {name}"
        + (f"{{{labels}}}" if labels else "")
        + f"  last {last_s:g}s  agg={agg}\n"
    )
    rc = 1
    for url in sorted(results):
        res = results[url]
        pts = res.get("points") or []
        if res.get("stale") or not pts:
            out.write(f"{url:>40}  (no data)\n")
            continue
        rc = 0
        vals = [v for _, v in pts]
        out.write(
            f"{url:>40}  n={len(vals):<4d} "
            f"min={min(vals):<10.4g} max={max(vals):<10.4g} "
            f"last={vals[-1]:<10.4g} {sparkline(vals, 40)}\n"
        )
    out.flush()
    return rc


# -- run loops ---------------------------------------------------------------


def run_plain(source, interval: float, iterations: int | None = None,
              out=None) -> None:
    out = out or sys.stdout
    prev: dict[str, dict] = {}
    n = 0
    while iterations is None or n < iterations:
        if n:
            time.sleep(interval)
        rows = [
            collect_row(name, snap, prev.get(name), interval)
            for name, snap in source.poll()
        ]
        prev = {r["provider"]: r for r in rows}
        header = getattr(source, "header", None)
        if header is not None:
            out.write(header())
        out.write(render(rows, interval))
        out.flush()
        n += 1


def run_curses(source, interval: float) -> None:  # pragma: no cover - tty
    import curses

    def loop(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        prev: dict[str, dict] = {}
        while True:
            rows = [
                collect_row(name, snap, prev.get(name), interval)
                for name, snap in source.poll()
            ]
            prev = {r["provider"]: r for r in rows}
            scr.erase()
            header = getattr(source, "header", None)
            frame = (header() if header is not None else "") + render(
                rows, interval
            )
            for y, line in enumerate(frame.splitlines()):
                try:
                    scr.addnstr(y, 0, line, curses.COLS - 1)
                except curses.error:
                    break  # terminal shrank below the frame
            scr.refresh()
            t_end = time.time() + interval
            while time.time() < t_end:
                if scr.getch() in (ord("q"), 27):
                    return
                time.sleep(0.05)

    curses.wrapper(loop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ytpu_top", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("snapshots", nargs="*",
                    help="provider metrics-snapshot JSON files to poll, "
                         "or ONE directory of per-shard snapshots to "
                         "federate")
    ap.add_argument("--demo", action="store_true",
                    help="dashboard over two in-process demo providers")
    ap.add_argument("--device", default=None,
                    help="with --demo: 'cpu' runs the kernels' plain "
                         "versions; by default the CUDA device, and no "
                         "card is an error")
    ap.add_argument("--url", action="append", default=[],
                    metavar="URL",
                    help="scrape a live admin endpoint's /metrics.json "
                         "(repeatable; several URLs federate under a "
                         "FLEET row)")
    ap.add_argument("--scrape-timeout", type=float, default=2.0,
                    help="per-endpoint HTTP deadline for --url "
                         "(default 2s)")
    ap.add_argument("--range", metavar="SERIES",
                    help="history mode: query each --url "
                         "endpoint's embedded-TSDB /query for this "
                         "series and print min/max/last + a sparkline, "
                         "then exit")
    ap.add_argument("--labels", default="",
                    help="label filter for --range (k=v,k2=v2 form, "
                         "default: the unlabeled series)")
    ap.add_argument("--last", type=float, default=3600.0,
                    help="seconds of history for --range (default 3600)")
    ap.add_argument("--agg", default="avg",
                    choices=("avg", "min", "max", "last", "sum", "count"),
                    help="downsample/federation aggregator for --range "
                         "(default avg)")
    ap.add_argument("--cluster", action="store_true",
                    help="treat the directory argument as a supervisor "
                         "snapshot drop and render the cluster.json "
                         "supervision panel above the shard rows")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll interval in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    ap.add_argument("--plain", action="store_true",
                    help="plain text frames even on a tty")
    args = ap.parse_args(argv)

    if args.range:
        if not args.url:
            ap.error("--range needs at least one --url endpoint")
        return run_range(
            args.url, args.range, args.labels, args.last, args.agg,
            timeout_s=args.scrape_timeout,
        )
    if args.demo:
        source = DemoSource(args.device)
    elif args.url:
        if args.snapshots:
            ap.error("--url and file/dir sources are mutually exclusive")
        source = UrlSource(args.url, timeout_s=args.scrape_timeout)
    elif args.cluster:
        if len(args.snapshots) != 1 or not Path(args.snapshots[0]).is_dir():
            ap.error("--cluster requires ONE snapshot directory")
        source = ClusterDirSource(args.snapshots[0])
    elif len(args.snapshots) == 1 and Path(args.snapshots[0]).is_dir():
        source = DirSource(args.snapshots[0])
    elif args.snapshots:
        source = FileSource(args.snapshots)
    else:
        ap.error("either snapshot files or --demo is required")

    if args.once:
        run_plain(source, args.interval, iterations=1)
        return 0
    if args.plain or not sys.stdout.isatty():
        run_plain(source, args.interval)
        return 0
    run_curses(source, args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
