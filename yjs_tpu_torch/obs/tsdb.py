"""Embedded per-process time-series store.

Every observability surface before this PR — registry scrapes,
``/metrics.json``, file-drop/HTTP federation, ``ytpu_top`` — is a
*point-in-time* snapshot: the moment a scrape ends, the fleet's past is
gone.  This module gives each process a memory.  A background sampler
(injectable clock; ``YTPU_TSDB_INTERVAL_S``, default 5s) walks the
metrics registries into per-series rings:

- **raw tier** — every sample, sealed into Gorilla-style compressed
  chunks (delta-of-delta timestamps + XOR float values, the Facebook
  in-memory TSDB encoding), retained ``YTPU_TSDB_RETENTION_RAW_S``;
- **1m / 10m downsample tiers** — per-bucket ``(count, sum, min, max,
  last)`` aggregates retained ``YTPU_TSDB_RETENTION_1M_S`` /
  ``YTPU_TSDB_RETENTION_10M_S``, so a day of history costs hundreds of
  points per series, not tens of thousands.

Sampled series: one per counter/gauge label-set, plus ``name:p50`` /
``name:p99`` / ``name:count`` derived series per histogram.  Total
series are capped (``YTPU_TSDB_MAX_SERIES``); overflow is counted, not
silently absorbed.

Lock discipline is torn-scrape-safe: the registry walk happens OUTSIDE
the store lock (registry reads are lock-free snapshots by design), and
every ring mutation and every range query runs under one store lock —
a ``/query`` racing the sampler sees either the pre- or post-sample
ring, never a half-appended chunk.

Persistence (``YTPU_TSDB_DIR``): length+CRC framed binary records,
written to a temp file and atomically renamed every
``YTPU_TSDB_PERSIST_S``.  Reload tolerates a crash-truncated file by
keeping exactly the frames whose checksum verifies — no sample is ever
invented, the torn tail is dropped and counted
(``ytpu_tsdb_reload_truncated_total``).

The range-query API (:meth:`Tsdb.query`) is served over the
admin plane as ``/query`` (``?name=…&labels=…&start=…&end=…&agg=…``)
and ``/debug/tsdb``; the cluster supervisor federates it across shard
children via the same admin scrape path (:func:`query_endpoints` +
:func:`merge_points`).

``YTPU_TSDB_DISABLED=1`` turns the whole subsystem off; it is
observational only, so engine output is byte-identical either way
(pinned by tests/test_cost.py).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import urllib.parse
import urllib.request
import weakref
import zlib
from collections import deque

__all__ = [
    "Tsdb",
    "TsdbConfig",
    "tsdb",
    "tsdb_enabled",
    "tsdb_metrics",
    "maybe_attach_tsdb",
    "tsdb_window",
    "encode_chunk",
    "decode_chunk",
    "query_endpoints",
    "merge_points",
]

_MAGIC = b"YTPUTSDB1\0"
_CHUNK_POINTS = 128  # raw points per sealed Gorilla chunk
_TIER_BUCKETS_MS = {"1m": 60_000, "10m": 600_000}
_AGGS = ("avg", "min", "max", "last", "sum", "count")
# key-series prefixes the flight recorder embeds in post-mortem dumps
KEY_SERIES_PREFIXES = (
    "ytpu_convergence_latency_seconds",
    "ytpu_engine_flushes_total",
    "ytpu_engine_flush_seconds",
    "ytpu_engine_pending_docs",
    "ytpu_admission_",
    "ytpu_cost_",
)


def _env_float(name: str, default: float, lo: float = 0.0) -> float:
    try:
        v = float(os.environ.get(name, default))
    except ValueError:
        return default
    return max(lo, v)


def _env_int(name: str, default: int, lo: int = 0) -> int:
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        return default
    return max(lo, v)


def tsdb_enabled() -> bool:
    return os.environ.get("YTPU_TSDB_DISABLED", "") != "1"


class TsdbConfig:
    """TSDB knobs (env-derived defaults, constructor wins)."""

    __slots__ = (
        "interval_s", "retention_raw_s", "retention_1m_s",
        "retention_10m_s", "max_series", "directory", "persist_s",
    )

    def __init__(
        self,
        interval_s: float | None = None,
        retention_raw_s: float | None = None,
        retention_1m_s: float | None = None,
        retention_10m_s: float | None = None,
        max_series: int | None = None,
        directory: str | None = None,
        persist_s: float | None = None,
    ):
        def pick(v, n, d, lo):
            return v if v is not None else _env_float(n, d, lo)

        self.interval_s = pick(interval_s, "YTPU_TSDB_INTERVAL_S", 5.0, 0.05)
        self.retention_raw_s = pick(
            retention_raw_s, "YTPU_TSDB_RETENTION_RAW_S", 3600.0, 60.0
        )
        self.retention_1m_s = pick(
            retention_1m_s, "YTPU_TSDB_RETENTION_1M_S", 6 * 3600.0, 60.0
        )
        self.retention_10m_s = pick(
            retention_10m_s, "YTPU_TSDB_RETENTION_10M_S", 24 * 3600.0, 600.0
        )
        self.max_series = (
            max_series
            if max_series is not None
            else _env_int("YTPU_TSDB_MAX_SERIES", 4096, lo=16)
        )
        self.directory = (
            directory
            if directory is not None
            else (os.environ.get("YTPU_TSDB_DIR") or None)
        )
        self.persist_s = pick(persist_s, "YTPU_TSDB_PERSIST_S", 60.0, 1.0)

    def retention_ms(self, tier: str) -> int:
        if tier == "raw":
            return int(self.retention_raw_s * 1000)
        if tier == "1m":
            return int(self.retention_1m_s * 1000)
        return int(self.retention_10m_s * 1000)


class _TsdbMetrics:
    """``ytpu_tsdb_*`` families on the process-global registry."""

    def __init__(self):
        from . import global_registry

        reg = global_registry()
        self.samples = reg.counter(
            "ytpu_tsdb_samples_total",
            "Sampler passes completed (one walk of every attached "
            "registry)",
        )
        self.points = reg.counter(
            "ytpu_tsdb_points_total",
            "Raw points appended across all series",
        )
        self.series = reg.gauge(
            "ytpu_tsdb_series",
            "Distinct (name, labels) series currently retained",
        )
        self.dropped = reg.counter(
            "ytpu_tsdb_dropped_series_total",
            "Series rejected by the YTPU_TSDB_MAX_SERIES cap",
        )
        self.queries = reg.counter(
            "ytpu_tsdb_queries_total",
            "Range queries served (local + admin /query)",
        )
        self.persists = reg.counter(
            "ytpu_tsdb_persists_total",
            "Atomic-rename persistence attempts, by outcome",
            labelnames=("status",),
        )
        self.reload_truncated = reg.counter(
            "ytpu_tsdb_reload_truncated_total",
            "Reloads that hit a torn frame and kept only the intact "
            "prefix (crash-mid-persist tolerance)",
        )


_TSDB_METRICS: _TsdbMetrics | None = None
_TSDB_METRICS_LOCK = threading.Lock()


def tsdb_metrics() -> _TsdbMetrics:
    global _TSDB_METRICS
    with _TSDB_METRICS_LOCK:
        if _TSDB_METRICS is None:
            _TSDB_METRICS = _TsdbMetrics()
        return _TSDB_METRICS


# -- Gorilla bit codec --------------------------------------------------------


class _BitWriter:
    __slots__ = ("buf", "_acc", "_nbits")

    def __init__(self):
        self.buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self.buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def to_bytes(self) -> bytes:
        out = bytes(self.buf)
        if self._nbits:
            out += bytes([(self._acc << (8 - self._nbits)) & 0xFF])
        return out


class _BitReader:
    __slots__ = ("data", "_pos")

    def __init__(self, data: bytes):
        self.data = data
        self._pos = 0

    def read(self, nbits: int) -> int:
        out = 0
        pos = self._pos
        data = self.data
        for _ in range(nbits):
            out = (out << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self._pos = pos
        return out


def _f2b(v: float) -> int:
    return struct.unpack(">Q", struct.pack(">d", float(v)))[0]


def _b2f(b: int) -> float:
    return struct.unpack(">d", struct.pack(">Q", b))[0]


def _signed(v: int, nbits: int) -> int:
    return v - (1 << nbits) if v >= 1 << (nbits - 1) else v


# delta-of-delta payload widths for the '10' / '110' / '1110' prefixes
_DOD_WIDTHS = (7, 13, 20)


def encode_chunk(points) -> bytes:
    """Gorilla-encode ``[(ts_ms, value), …]``: first point raw 64+64,
    then delta-of-delta timestamps ('0' = repeat cadence) and XOR
    values with leading/trailing zero-window reuse."""
    w = _BitWriter()
    prev_ts = prev_delta = 0
    prev_bits = 0
    lead = trail = -1
    for i, (ts, v) in enumerate(points):
        ts = int(ts)
        bits = _f2b(v)
        if i == 0:
            w.write(ts, 64)
            w.write(bits, 64)
        else:
            delta = ts - prev_ts
            dod = delta - prev_delta
            prev_delta = delta
            if dod == 0:
                w.write(0, 1)
            else:
                for k, width in enumerate(_DOD_WIDTHS):
                    half = 1 << (width - 1)
                    if -half + 1 <= dod <= half:
                        # prefix: k+1 ones then a zero (10 / 110 / 1110)
                        w.write(((1 << (k + 1)) - 1) << 1, k + 2)
                        w.write(dod + half - 1, width)
                        break
                else:
                    w.write(0b1111, 4)
                    w.write(dod, 64)
            x = bits ^ prev_bits
            if x == 0:
                w.write(0, 1)
            else:
                xl = 64 - x.bit_length()
                xt = (x & -x).bit_length() - 1
                if lead >= 0 and xl >= lead and xt >= trail:
                    w.write(0b10, 2)
                    w.write(x >> trail, 64 - lead - trail)
                else:
                    lead = min(xl, 31)
                    trail = xt
                    mbits = 64 - lead - trail
                    w.write(0b11, 2)
                    w.write(lead, 5)
                    w.write(mbits - 1, 6)
                    w.write(x >> trail, mbits)
        prev_ts = ts
        prev_bits = bits
    return w.to_bytes()


def decode_chunk(data: bytes, count: int) -> list:
    """Inverse of :func:`encode_chunk` (``count`` points)."""
    if count <= 0:
        return []
    r = _BitReader(data)
    ts = _signed(r.read(64), 64)
    bits = r.read(64)
    out = [(ts, _b2f(bits))]
    delta = 0
    lead = trail = 0
    for _ in range(count - 1):
        if r.read(1) == 0:
            dod = 0
        else:
            ones = 1
            while ones < 4 and r.read(1) == 1:
                ones += 1
            if ones < 4:
                width = _DOD_WIDTHS[ones - 1]
                dod = r.read(width) - (1 << (width - 1)) + 1
            else:
                dod = _signed(r.read(64), 64)
        delta += dod
        ts += delta
        if r.read(1) == 1:
            if r.read(1) == 0:
                x = r.read(64 - lead - trail) << trail
            else:
                lead = r.read(5)
                mbits = r.read(6) + 1
                trail = 64 - lead - mbits
                x = r.read(mbits) << trail
            bits ^= x
        out.append((ts, _b2f(bits)))
    return out


# -- per-series storage -------------------------------------------------------


class _SealedChunk:
    __slots__ = ("start_ts", "end_ts", "count", "data")

    def __init__(self, start_ts: int, end_ts: int, count: int, data: bytes):
        self.start_ts = start_ts
        self.end_ts = end_ts
        self.count = count
        self.data = data


class _Series:
    """One (name, labels) ring: sealed Gorilla chunks + an open plain
    tail at raw resolution, plus the 1m/10m downsample tiers.  All
    mutation happens under the owning store's lock."""

    __slots__ = (
        "name", "labels", "chunks", "open", "tiers", "last_ts",
        "_next_ret_ms", "_tier_rings",
    )

    def __init__(self, name: str, labels: str):
        self.name = name
        self.labels = labels
        self.chunks: deque = deque()
        self.open: list = []
        # tier -> deque of [bucket_ts, count, sum, mn, mx, last]
        self.tiers = {t: deque() for t in _TIER_BUCKETS_MS}
        # (ring, bucket_ms) pairs hoisted for the per-append loop; the
        # deques are only ever mutated in place, so the refs stay live
        self._tier_rings = tuple(
            (self.tiers[t], ms) for t, ms in _TIER_BUCKETS_MS.items()
        )
        self.last_ts = 0
        # retention is enforced at most once per minute of series time:
        # the tightest retention window is measured in hours, so a
        # per-append sweep is pure sampler-tick overhead
        self._next_ret_ms = 0

    def append(self, ts_ms: int, value: float, config: TsdbConfig) -> None:
        if ts_ms <= self.last_ts:
            ts_ms = self.last_ts + 1  # clock went backwards: keep order
        self.last_ts = ts_ms
        self.open.append((ts_ms, float(value)))
        if len(self.open) >= _CHUNK_POINTS:
            pts = self.open
            self.chunks.append(_SealedChunk(
                pts[0][0], pts[-1][0], len(pts), encode_chunk(pts)
            ))
            self.open = []
        for ring, bucket_ms in self._tier_rings:
            bucket = ts_ms - ts_ms % bucket_ms
            if ring:
                row = ring[-1]
                if row[0] == bucket:
                    row[1] += 1
                    row[2] += value
                    if value < row[3]:
                        row[3] = value
                    if value > row[4]:
                        row[4] = value
                    row[5] = value
                    continue
                if bucket <= row[0]:
                    continue
            ring.append([bucket, 1, value, value, value, value])
        if ts_ms >= self._next_ret_ms:
            self.enforce_retention(ts_ms, config)
            self._next_ret_ms = ts_ms + 60_000

    def enforce_retention(self, now_ms: int, config: TsdbConfig) -> None:
        floor = now_ms - config.retention_ms("raw")
        while self.chunks and self.chunks[0].end_ts < floor:
            self.chunks.popleft()
        for tier, bucket_ms in _TIER_BUCKETS_MS.items():
            ring = self.tiers[tier]
            tfloor = now_ms - config.retention_ms(tier) - bucket_ms
            while ring and ring[0][0] < tfloor:
                ring.popleft()

    def raw_points(self, start_ms: int, end_ms: int) -> list:
        out = []
        for c in self.chunks:
            if c.end_ts < start_ms or c.start_ts > end_ms:
                continue
            out.extend(
                p for p in decode_chunk(c.data, c.count)
                if start_ms <= p[0] <= end_ms
            )
        out.extend(
            p for p in self.open if start_ms <= p[0] <= end_ms
        )
        return out

    def tier_points(
        self, tier: str, start_ms: int, end_ms: int, agg: str
    ) -> list:
        out = []
        for bucket, count, total, mn, mx, last in self.tiers[tier]:
            if bucket < start_ms or bucket > end_ms:
                continue
            if agg == "min":
                v = mn
            elif agg == "max":
                v = mx
            elif agg == "last":
                v = last
            elif agg == "sum":
                v = total
            elif agg == "count":
                v = float(count)
            else:
                v = total / count if count else 0.0
            out.append((bucket, v))
        return out

    def point_count(self) -> int:
        return sum(c.count for c in self.chunks) + len(self.open)

    def byte_size(self) -> int:
        return sum(len(c.data) for c in self.chunks) + 16 * len(self.open)


# -- the store ---------------------------------------------------------------


class Tsdb:
    """Per-process embedded TSDB (module docstring).  ``clock`` is
    injectable for deterministic tests; the background thread (when
    :meth:`start`-ed) paces itself on wall time but stamps samples with
    ``clock()``."""

    def __init__(self, config: TsdbConfig | None = None, clock=None):
        import time as _time

        self.config = config if config is not None else TsdbConfig()
        self.clock = clock if clock is not None else _time.time
        self._lock = threading.Lock()
        self._series: dict = {}
        self._sources: list = []  # weakrefs to attached registries
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self._n_samples = 0
        self._n_dropped = 0
        self._n_truncated = 0
        self._last_persist = 0.0
        if self.config.directory:
            self._load()

    # -- sources -------------------------------------------------------------

    def add_registry(self, registry) -> None:
        """Attach one metrics registry (weakly referenced; a dead
        registry is pruned on the next sample)."""
        ref = weakref.ref(registry)
        with self._lock:
            live = [r for r in self._sources if r() is not None]
            if not any(r() is registry for r in live):
                live.append(ref)
            self._sources = live

    # -- sampling ------------------------------------------------------------

    def _collect(self) -> dict:
        """Merged flat sample map ``(name, labels) -> value`` over the
        global registry + every attached registry.  Runs OUTSIDE the
        store lock: registry reads are lock-free snapshots, and holding
        the store lock across them would serialize /query behind a
        potentially large walk."""
        from . import global_registry
        from .expo import _labels_key

        with self._lock:
            sources = list(self._sources)
        regs = [global_registry()]
        for ref in sources:
            reg = ref()
            if reg is not None and reg is not regs[0]:
                regs.append(reg)
        # walked flat — no intermediate nested snapshot; the first
        # registry to export a (kind, name) family wins, matching the
        # registry_snapshot merge the admin plane uses
        flat: dict = {}
        seen: set = set()
        for reg in regs:
            for m in reg.collect():
                name = m.name
                fam = (m.kind, name)
                if fam in seen:
                    continue
                seen.add(fam)
                if m.kind == "histogram":
                    for labels, series in m.samples():
                        lk = _labels_key(labels)
                        s = series.summary()
                        flat.setdefault(
                            (f"{name}:p50", lk), float(s["p50"])
                        )
                        flat.setdefault(
                            (f"{name}:p99", lk), float(s["p99"])
                        )
                        flat.setdefault(
                            (f"{name}:count", lk), float(s["count"])
                        )
                else:
                    for labels, series in m.samples():
                        flat.setdefault(
                            (name, _labels_key(labels)),
                            float(series.value),
                        )
        return flat

    def sample_once(self, now: float | None = None) -> int:
        """One sampler pass; returns the number of points appended."""
        if now is None:
            now = self.clock()
        ts_ms = int(now * 1000)
        flat = self._collect()
        m = tsdb_metrics()
        appended = dropped = 0
        with self._lock:
            for (name, labels), value in flat.items():
                key = (name, labels)
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= self.config.max_series:
                        dropped += 1
                        continue
                    s = self._series[key] = _Series(name, labels)
                s.append(ts_ms, value, self.config)
                appended += 1
            self._n_samples += 1
            self._n_dropped += dropped
            n_series = len(self._series)
        m.samples.inc()
        m.points.inc(appended)
        m.series.set(n_series)
        if dropped:
            m.dropped.inc(dropped)
        if self.config.directory and (
            now - self._last_persist >= self.config.persist_s
        ):
            self.persist(now=now)
        return appended

    def record(
        self, name: str, value: float, labels: str = "",
        now: float | None = None,
    ) -> None:
        """Append one point directly (the cost ledger and the capacity
        ramp feed derived series through here without registering a
        metric family)."""
        if now is None:
            now = self.clock()
        with self._lock:
            key = (name, labels)
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.config.max_series:
                    self._n_dropped += 1
                    return
                s = self._series[key] = _Series(name, labels)
            s.append(int(now * 1000), float(value), self.config)

    # -- background thread ---------------------------------------------------

    def start(self) -> "Tsdb":
        if self._thread is not None or not tsdb_enabled():
            return self
        t = threading.Thread(
            target=self._run, name="ytpu-tsdb-sampler", daemon=True
        )
        self._thread = t
        t.start()
        return self

    def _run(self) -> None:
        while not self._wake.wait(self.config.interval_s):
            try:
                self.sample_once()
            except Exception:
                # the sampler must never take the process down; the
                # next tick retries
                pass

    def close(self) -> None:
        self._wake.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        self._wake.clear()

    # -- queries -------------------------------------------------------------

    def series_names(self) -> list:
        with self._lock:
            return sorted(self._series)

    def _pick_tier(self, s: _Series, start_ms: int) -> str:
        span = s.last_ts - start_ms
        if span <= self.config.retention_ms("raw"):
            return "raw"
        if span <= self.config.retention_ms("1m"):
            return "1m"
        return "10m"

    def query(
        self,
        name: str,
        labels: str = "",
        start: float | None = None,
        end: float | None = None,
        agg: str = "avg",
        tier: str | None = None,
    ) -> list:
        """Points ``[(ts_seconds, value), …]`` for one series in
        ``[start, end]`` (epoch seconds; default: the last hour up to
        now).  ``agg`` applies to downsample-tier buckets (raw points
        are returned as-is); ``tier`` forces raw/1m/10m, else the
        finest tier whose retention covers ``start`` is chosen."""
        if agg not in _AGGS:
            raise ValueError(f"agg must be one of {_AGGS}, not {agg!r}")
        if tier is not None and tier not in ("raw", "1m", "10m"):
            raise ValueError(f"tier must be raw/1m/10m, not {tier!r}")
        if end is None:
            end = self.clock()
        if start is None:
            start = end - 3600.0
        start_ms, end_ms = int(start * 1000), int(end * 1000)
        tsdb_metrics().queries.inc()
        with self._lock:
            s = self._series.get((name, labels))
            if s is None:
                return []
            # appends throttle retention sweeps to once a minute of
            # series time; reads settle it so results are always exact
            s.enforce_retention(s.last_ts, self.config)
            t = tier if tier is not None else self._pick_tier(s, start_ms)
            if t == "raw":
                pts = s.raw_points(start_ms, end_ms)
            else:
                pts = s.tier_points(t, start_ms, end_ms, agg)
        return [(ts / 1000.0, v) for ts, v in pts]

    def query_params(self, params: dict) -> dict:
        """The admin-plane ``/query`` surface: string params in, a
        JSON-able result out.  Raises ValueError on a missing name or
        malformed number (the handler renders it as a 400)."""
        name = params.get("name")
        if not name:
            raise ValueError("query needs ?name=<series>")

        def num(key):
            v = params.get(key)
            return None if v in (None, "") else float(v)

        tier = params.get("tier") or None
        agg = params.get("agg") or "avg"
        points = self.query(
            name,
            labels=params.get("labels", "") or "",
            start=num("start"),
            end=num("end"),
            agg=agg,
            tier=tier,
        )
        return {
            "name": name,
            "labels": params.get("labels", "") or "",
            "agg": agg,
            "tier": tier or "auto",
            "points": [[round(ts, 3), v] for ts, v in points],
        }

    def window(
        self, window_s: float, prefixes=KEY_SERIES_PREFIXES,
        max_series: int = 32, now: float | None = None,
    ) -> dict:
        """The last ``window_s`` seconds of every key series (matched
        by name prefix), as ``{"name{labels}": [[ts, v], …]}`` — the
        flight-recorder embedding."""
        if now is None:
            now = self.clock()
        start_ms = int((now - window_s) * 1000)
        end_ms = int(now * 1000)
        out: dict = {}
        with self._lock:
            for (name, labels) in sorted(self._series):
                if len(out) >= max_series:
                    break
                if not any(name.startswith(p) for p in prefixes):
                    continue
                s = self._series[(name, labels)]
                pts = s.raw_points(start_ms, end_ms)
                if pts:
                    key = f"{name}{{{labels}}}" if labels else name
                    out[key] = [
                        [round(ts / 1000.0, 3), v] for ts, v in pts
                    ]
        return out

    def stats(self) -> dict:
        with self._lock:
            series = list(self._series.values())
            for s in series:
                # settle append-throttled retention so the counts the
                # admin plane reports never include aged-out chunks
                s.enforce_retention(s.last_ts, self.config)
            n_samples = self._n_samples
            n_dropped = self._n_dropped
            n_truncated = self._n_truncated
        return {
            "series": len(series),
            "points_raw": sum(s.point_count() for s in series),
            "points_1m": sum(len(s.tiers["1m"]) for s in series),
            "points_10m": sum(len(s.tiers["10m"]) for s in series),
            "sealed_chunks": sum(len(s.chunks) for s in series),
            "encoded_bytes": sum(s.byte_size() for s in series),
            "samples": n_samples,
            "dropped_series": n_dropped,
            "reload_truncated": n_truncated,
            "interval_s": self.config.interval_s,
            "retention_s": {
                "raw": self.config.retention_raw_s,
                "1m": self.config.retention_1m_s,
                "10m": self.config.retention_10m_s,
            },
            "dir": self.config.directory,
        }

    # -- persistence ---------------------------------------------------------

    def _encode_series(self, s: _Series) -> bytes:
        out = bytearray()
        name = s.name.encode("utf-8")
        labels = s.labels.encode("utf-8")
        out += struct.pack(">H", len(name)) + name
        out += struct.pack(">H", len(labels)) + labels
        out += struct.pack(">I", len(s.chunks))
        for c in s.chunks:
            out += struct.pack(
                ">qqII", c.start_ts, c.end_ts, c.count, len(c.data)
            )
            out += c.data
        out += struct.pack(">I", len(s.open))
        for ts, v in s.open:
            out += struct.pack(">qd", ts, v)
        for tier in _TIER_BUCKETS_MS:
            ring = s.tiers[tier]
            out += struct.pack(">I", len(ring))
            for bucket, count, total, mn, mx, last in ring:
                out += struct.pack(
                    ">qIdddd", bucket, count, total, mn, mx, last
                )
        return bytes(out)

    @staticmethod
    def _decode_series(payload: bytes) -> _Series:
        off = 0

        def take(fmt):
            nonlocal off
            size = struct.calcsize(fmt)
            vals = struct.unpack_from(fmt, payload, off)
            off += size
            return vals

        (nlen,) = take(">H")
        name = payload[off:off + nlen].decode("utf-8")
        off += nlen
        (llen,) = take(">H")
        labels = payload[off:off + llen].decode("utf-8")
        off += llen
        s = _Series(name, labels)
        (n_chunks,) = take(">I")
        for _ in range(n_chunks):
            start, end, count, nbytes = take(">qqII")
            data = payload[off:off + nbytes]
            off += nbytes
            s.chunks.append(_SealedChunk(start, end, count, data))
            s.last_ts = max(s.last_ts, end)
        (n_open,) = take(">I")
        for _ in range(n_open):
            ts, v = take(">qd")
            s.open.append((ts, v))
            s.last_ts = max(s.last_ts, ts)
        for tier in _TIER_BUCKETS_MS:
            (n,) = take(">I")
            for _ in range(n):
                s.tiers[tier].append(list(take(">qIdddd")))
        return s

    def persist(self, now: float | None = None) -> bool:
        """Write every series to ``<dir>/tsdb.bin`` via temp file +
        atomic rename.  Returns True on success; failure is counted
        and swallowed (history must never take the serving path down).
        """
        directory = self.config.directory
        if not directory:
            return False
        if now is None:
            now = self.clock()
        self._last_persist = now
        with self._lock:
            payloads = [
                self._encode_series(s) for _, s in sorted(self._series.items())
            ]
        m = tsdb_metrics()
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, "tsdb.bin")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                for p in payloads:
                    f.write(struct.pack(">II", len(p), zlib.crc32(p)))
                    f.write(p)
            os.replace(tmp, path)
        except OSError:
            m.persists.labels(status="error").inc()
            return False
        m.persists.labels(status="ok").inc()
        return True

    def _load(self) -> None:
        """Crash-truncation-tolerant reload: keep exactly the prefix of
        frames whose length + CRC verify; drop (and count) the torn
        tail.  Called from __init__ only — no lock needed."""
        path = os.path.join(self.config.directory, "tsdb.bin")
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return
        if not blob.startswith(_MAGIC):
            return
        off = len(_MAGIC)
        truncated = False
        while off < len(blob):
            if off + 8 > len(blob):
                truncated = True
                break
            length, crc = struct.unpack_from(">II", blob, off)
            off += 8
            payload = blob[off:off + length]
            if len(payload) < length or zlib.crc32(payload) != crc:
                truncated = True
                break
            off += length
            try:
                s = self._decode_series(payload)
            except (struct.error, UnicodeDecodeError, IndexError):
                truncated = True
                break
            self._series[(s.name, s.labels)] = s  # ytpu-lint: disable=lock-discipline -- constructor-only path: _load runs before the store is published to any other thread
        if truncated:
            self._n_truncated += 1
            tsdb_metrics().reload_truncated.inc()


# -- process-global singleton -------------------------------------------------

_TSDB: Tsdb | None = None
_TSDB_GUARD = threading.Lock()


def tsdb() -> Tsdb:
    """The process-global store (created on first use; the sampler
    thread starts on the first registry attach, not here)."""
    global _TSDB
    with _TSDB_GUARD:
        if _TSDB is None:
            _TSDB = Tsdb()
        return _TSDB


def maybe_attach_tsdb(registry) -> Tsdb | None:
    """Attach one registry to the process-global store and ensure the
    sampler runs — unless ``YTPU_TSDB_DISABLED=1``.  The provider calls
    this at construction; tests building hundreds of providers share
    one sampler thread."""
    if not tsdb_enabled():
        return None
    t = tsdb()
    t.add_registry(registry)
    t.start()
    return t


def tsdb_window(window_s: float | None = None) -> dict:
    """The flight-recorder embedding: the last
    ``YTPU_BLACKBOX_TSDB_WINDOW_S`` (default 60s) of key series from
    the process-global store; ``{}`` when the TSDB is disabled or has
    no matching history yet."""
    if not tsdb_enabled() or _TSDB is None:  # ytpu-lint: disable=lock-discipline -- double-checked fast path: publication of a fully-constructed store is atomic under the GIL
        return {}
    if window_s is None:
        window_s = _env_float("YTPU_BLACKBOX_TSDB_WINDOW_S", 60.0, 1.0)
    return _TSDB.window(window_s)


# -- cross-shard federation (supervisor scrape path) --------------------------


def query_endpoints(
    urls: dict, params: dict, timeout_s: float = 2.0
) -> dict:
    """Fan one ``/query`` out to every admin endpoint in ``urls``
    (label -> base URL); a dead or erroring endpoint contributes an
    empty result rather than failing the federation."""
    qs = urllib.parse.urlencode(
        {k: v for k, v in params.items() if v not in (None, "")}
    )
    out: dict = {}
    for label in sorted(urls):
        try:
            with urllib.request.urlopen(
                f"{urls[label]}/query?{qs}", timeout=timeout_s
            ) as r:
                res = json.load(r)
            out[label] = res if isinstance(res, dict) else {"points": []}
        except (OSError, ValueError):
            out[label] = {"points": [], "stale": True}
    return out


def merge_points(
    per_shard: dict, agg: str = "avg", bucket_s: float = 5.0
) -> list:
    """Merge per-shard point lists into one fleet series: points are
    bucketed to the sampler cadence and combined with ``agg`` across
    shards (sum for counters queried with agg=sum, avg/min/max/last
    otherwise)."""
    buckets: dict = {}
    for res in per_shard.values():
        for ts, v in res.get("points") or ():
            b = ts - ts % bucket_s
            buckets.setdefault(b, []).append(v)
    out = []
    for b in sorted(buckets):
        vals = buckets[b]
        if agg == "sum":
            v = sum(vals)
        elif agg == "min":
            v = min(vals)
        elif agg == "max":
            v = max(vals)
        elif agg == "count":
            v = float(len(vals))
        elif agg == "last":
            v = vals[-1]
        else:
            v = sum(vals) / len(vals)
        out.append([round(b, 3), v])
    return out
