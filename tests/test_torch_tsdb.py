"""The cases of the JAX package's ``tests/test_tsdb.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Embedded telemetry-history store tests.

Covers the Gorilla codec (delta-of-delta timestamps + XOR floats) on
pathological point sets, downsample-tier correctness against a
brute-force oracle, the torn-read hammer (concurrent writers vs range
queries), crash-mid-persist reload (truncated files keep exactly the
intact frame prefix, never invent samples), series-cap enforcement,
the admin-plane ``/query`` + ``/debug/tsdb`` endpoints, cross-shard
federation (``query_endpoints`` / ``merge_points``), the
flight-recorder window embedding, and the ytpu_top snapshot-dir mtime
cache.
"""

from __future__ import annotations

import json
import math
import os
import struct
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from yjs_tpu_torch.obs import MetricsRegistry
from yjs_tpu_torch.obs.admin import AdminServer
from yjs_tpu_torch.obs.federate import read_snapshot_dir
from yjs_tpu_torch.obs.tsdb import (
    KEY_SERIES_PREFIXES,
    Tsdb,
    TsdbConfig,
    decode_chunk,
    encode_chunk,
    merge_points,
    query_endpoints,
    tsdb,
    tsdb_enabled,
    tsdb_window,
)

pytestmark = pytest.mark.tsdb


def _store(**kw) -> Tsdb:
    """A private store with huge retentions so injected-clock tests
    never race the retention sweeps (constructor args beat env)."""
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("retention_raw_s", 10 * 24 * 3600.0)
    kw.setdefault("retention_1m_s", 20 * 24 * 3600.0)
    kw.setdefault("retention_10m_s", 30 * 24 * 3600.0)
    kw.setdefault("directory", None)
    return Tsdb(TsdbConfig(**kw))


# -- codec -------------------------------------------------------------------


def _bits(v: float) -> bytes:
    return struct.pack(">d", v)


PATHOLOGICAL_POINTS = [
    # (ts_ms, value): irregular cadence, sign flips, denormals, huge
    # jumps, repeats, infinities — everything the XOR window must survive
    (1_000, 0.0),
    (1_001, 0.0),
    (6_000, -0.0),
    (6_001, 1e300),
    (6_002, -1e300),
    (66_002, 5e-324),          # smallest denormal
    (66_003, 5e-324),
    (1_066_003, math.pi),
    (1_066_004, math.pi),
    (1_066_005, -math.pi),
    (1_066_006, float("inf")),
    (1_066_007, float("-inf")),
    (9_999_999_999, 42.5),     # ~year 2286, 64-bit dod escape
    (10_000_000_000, 42.5),
    (10_000_000_001, 1.0 / 3.0),
]


def test_codec_roundtrip_pathological_points():
    data = encode_chunk(PATHOLOGICAL_POINTS)
    out = decode_chunk(data, len(PATHOLOGICAL_POINTS))
    assert len(out) == len(PATHOLOGICAL_POINTS)
    for (ts, v), (ts2, v2) in zip(PATHOLOGICAL_POINTS, out):
        assert ts2 == ts
        # bit-exact, so -0.0 vs 0.0 and denormals count
        assert _bits(v2) == _bits(v)


def test_codec_roundtrip_nan_payload_preserved():
    pts = [(100, 1.0), (200, float("nan")), (300, 1.0)]
    out = decode_chunk(encode_chunk(pts), 3)
    assert [ts for ts, _ in out] == [100, 200, 300]
    assert math.isnan(out[1][1])
    assert out[0][1] == out[2][1] == 1.0


def test_codec_compresses_steady_cadence(rng):
    # the sampler's common case: fixed cadence, slowly-drifting floats.
    # dod==0 costs 1 bit; identical values cost 1 bit — the whole point
    # of carrying Gorilla instead of 16-byte raw pairs.
    pts = []
    v = 100.0
    for i in range(1024):
        v += rng.choice((0.0, 0.0, 1.0))
        pts.append((1_000_000 + 5000 * i, v))
    data = encode_chunk(pts)
    assert decode_chunk(data, len(pts)) == pts
    assert len(data) < 16 * len(pts) / 2  # at least 2x vs raw pairs


def test_codec_empty_and_single_point():
    assert decode_chunk(encode_chunk([]), 0) == []
    one = [(123_456, -7.25)]
    assert decode_chunk(encode_chunk(one), 1) == one


# -- record / query ----------------------------------------------------------


def test_record_and_query_range_filtering():
    st = _store()
    for i in range(10):
        st.record("s", float(i), now=1000.0 + i)
    pts = st.query("s", start=1003.0, end=1006.0, tier="raw")
    assert pts == [(1003.0, 3.0), (1004.0, 4.0), (1005.0, 5.0),
                   (1006.0, 6.0)]
    # default window is the last hour up to clock(); unknown series []
    assert st.query("nope") == []


def test_record_clock_going_backwards_keeps_order():
    st = _store()
    st.record("s", 1.0, now=2000.0)
    st.record("s", 2.0, now=1000.0)  # clock jumped back an hour
    pts = st.query("s", start=0.0, end=3000.0, tier="raw")
    assert [v for _, v in pts] == [1.0, 2.0]
    ts = [t for t, _ in pts]
    assert ts == sorted(ts) and len(set(ts)) == 2


def test_query_rejects_bad_agg_and_tier():
    st = _store()
    with pytest.raises(ValueError):
        st.query("s", agg="median")
    with pytest.raises(ValueError):
        st.query("s", tier="5m")
    with pytest.raises(ValueError):
        st.query_params({})  # missing name
    with pytest.raises(ValueError):
        st.query_params({"name": "s", "start": "yesterday"})


def test_chunk_sealing_spans_queries():
    # cross the 128-point seal boundary several times: the range read
    # must stitch sealed chunks + the open tail seamlessly
    st = _store()
    n = 300
    for i in range(n):
        st.record("s", float(i), now=1000.0 + i)
    assert st.stats()["sealed_chunks"] == n // 128
    pts = st.query("s", start=1000.0, end=1000.0 + n, tier="raw")
    assert [v for _, v in pts] == [float(i) for i in range(n)]


# -- downsample tiers vs brute-force oracle ----------------------------------


def _oracle(points, bucket_ms, agg):
    buckets: dict = {}
    for ts_ms, v in points:
        buckets.setdefault(ts_ms - ts_ms % bucket_ms, []).append(v)
    out = []
    for b in sorted(buckets):
        vals = buckets[b]
        if agg == "min":
            o = min(vals)
        elif agg == "max":
            o = max(vals)
        elif agg == "last":
            o = vals[-1]
        elif agg == "sum":
            o = sum(vals)
        elif agg == "count":
            o = float(len(vals))
        else:
            o = sum(vals) / len(vals)
        out.append((b / 1000.0, o))
    return out


@pytest.mark.parametrize("tier,bucket_ms", [("1m", 60_000),
                                            ("10m", 600_000)])
@pytest.mark.parametrize("agg", ["avg", "min", "max", "last", "sum",
                                 "count"])
def test_downsample_tier_matches_bruteforce_oracle(tier, bucket_ms, agg,
                                                   rng):
    st = _store()
    fed = []
    t = 50_000.0  # seconds
    for _ in range(500):
        t += rng.uniform(0.5, 90.0)  # irregular cadence crossing buckets
        v = rng.uniform(-100.0, 100.0)
        st.record("s", v, now=t)
        fed.append((int(t * 1000), v))
    got = st.query("s", start=0.0, end=2 * t, agg=agg, tier=tier)
    want = _oracle(fed, bucket_ms, agg)
    assert len(got) == len(want)
    for (gt, gv), (wt, wv) in zip(got, want):
        assert gt == wt
        assert gv == pytest.approx(wv, rel=1e-12, abs=1e-12)


def test_tier_autopick_prefers_finest_covering_retention():
    st = _store(retention_raw_s=60.0, retention_1m_s=3600.0,
                retention_10m_s=24 * 3600.0)
    now = 100_000.0
    for i in range(100):
        st.record("s", float(i), now=now + i)
    last = now + 99
    # span within raw retention -> raw (exact timestamps)
    raw = st.query("s", start=last - 50, end=last + 1)
    assert raw == st.query("s", start=last - 50, end=last + 1, tier="raw")
    assert len(raw) == 51  # exact per-second points, not buckets
    # span beyond raw but within 1m retention -> 1m buckets
    mid = st.query("s", start=last - 1800, end=last + 1)
    assert mid == st.query("s", start=last - 1800, end=last + 1,
                           tier="1m")
    assert all(int(ts * 1000) % 60_000 == 0 for ts, _ in mid)
    # span beyond 1m retention -> 10m buckets
    old = st.query("s", start=last - 7200, end=last + 1)
    assert old == st.query("s", start=last - 7200, end=last + 1,
                           tier="10m")
    assert all(int(ts * 1000) % 600_000 == 0 for ts, _ in old)


def test_retention_trims_sealed_raw_chunks_before_tiers():
    st = _store(retention_raw_s=60.0, retention_1m_s=3600.0,
                retention_10m_s=24 * 3600.0)
    t0 = 10_000.0
    n = 600  # 10 minutes of 1s cadence: 4 sealed chunks + open tail
    for i in range(n):
        st.record("s", float(i), now=t0 + i)
    end = t0 + n - 1
    assert st.stats()["sealed_chunks"] == 0  # all aged out
    raw = st.query("s", start=0.0, end=end, tier="raw")
    assert raw  # the open tail survives
    assert len(raw) < n
    assert min(ts for ts, _ in raw) == t0 + 512  # 4 * 128 sealed, gone
    m1 = st.query("s", start=0.0, end=end, tier="1m", agg="count")
    assert sum(v for _, v in m1) == n  # the tier kept everything


# -- series cap + sampler ----------------------------------------------------


def test_max_series_cap_drops_and_counts():
    st = _store(max_series=16)
    for i in range(25):
        st.record(f"s{i:02d}", 1.0, now=1000.0)
    stats = st.stats()
    assert stats["series"] == 16
    assert stats["dropped_series"] == 9
    assert st.query("s00", start=0, end=2000, tier="raw")
    assert st.query("s20", start=0, end=2000, tier="raw") == []


def test_sample_once_walks_registry_counters_gauges_histograms():
    st = _store()
    reg = MetricsRegistry()
    c = reg.counter("t_ctr", "d", labelnames=("k",))
    g = reg.gauge("t_gauge", "d")
    h = reg.histogram("t_hist", "d")
    c.labels(k="a").inc(3)
    g.set(7.5)
    for v in (0.01, 0.02, 0.04):
        h.observe(v)
    st.add_registry(reg)
    st.sample_once(now=500.0)
    c.labels(k="a").inc(2)
    st.sample_once(now=505.0)
    names = dict(st.series_names())
    assert "t_ctr" in names and "t_gauge" in names
    pts = st.query("t_ctr", labels="k=a", start=0, end=1000,
                   tier="raw")
    assert [v for _, v in pts] == [3.0, 5.0]
    assert st.query("t_gauge", start=0, end=1000, tier="raw") == [
        (500.0, 7.5), (505.0, 7.5)
    ]
    # histograms land as derived :p50/:p99/:count series
    assert "t_hist:p50" in names and "t_hist:p99" in names
    counts = st.query("t_hist:count", start=0, end=1000, tier="raw")
    assert [v for _, v in counts] == [3.0, 3.0]


def test_dead_registry_pruned_from_sampler():
    st = _store()
    reg = MetricsRegistry()
    reg.counter("gone_ctr", "d").inc()
    st.add_registry(reg)
    st.sample_once(now=100.0)
    assert any(n == "gone_ctr" for n, _ in st.series_names())
    del reg
    import gc

    gc.collect()
    st.sample_once(now=105.0)  # must not raise; source is pruned
    pts = st.query("gone_ctr", start=0, end=1000, tier="raw")
    assert len(pts) == 1  # no new point after the registry died


# -- torn-read hammer --------------------------------------------------------


def test_torn_read_hammer_concurrent_writers_vs_queries():
    """Writers (direct records + sampler passes) race range queries;
    every answer must be well-formed: in-range, time-ordered, and
    values from the written alphabet — a torn chunk/tier read would
    surface as an exception or a garbage float."""
    st = _store()
    reg = MetricsRegistry()
    ctr = reg.counter("hammer_ctr", "d")
    st.add_registry(reg)
    stop = threading.Event()
    errors: list = []
    written_values = {float(i) for i in range(100_000)}

    def writer(tid: int):
        t = 1_000.0 + tid * 1_000_000.0
        i = 0
        try:
            while not stop.is_set():
                st.record(f"w{tid}", float(i % 100_000), now=t)
                ctr.inc()
                st.sample_once(now=t)
                t += 1.0
                i += 1
        except Exception as e:  # pragma: no cover - the assertion
            errors.append(e)

    def reader(tid: int):
        try:
            while not stop.is_set():
                for name in ("w0", "w1", "hammer_ctr"):
                    lo, hi = 0.0, 3_000_000.0
                    for tier in (None, "raw", "1m", "10m"):
                        pts = st.query(name, start=lo, end=hi,
                                       tier=tier)
                        ts = [p[0] for p in pts]
                        assert ts == sorted(ts)
                        assert all(lo <= t <= hi for t in ts)
                    raw = st.query(name, start=lo, end=hi, tier="raw")
                    if name.startswith("w"):
                        assert all(
                            v in written_values for _, v in raw
                        )
                st.stats()
                st.window(1e9, prefixes=("w", "hammer"))
        except Exception as e:  # pragma: no cover - the assertion
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(2)]
    threads += [threading.Thread(target=reader, args=(i,))
                for i in range(3)]
    for t in threads:
        t.start()
    import time

    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=10.0)
    assert not errors, errors[:3]
    assert st.stats()["points_raw"] > 0


# -- persistence + crash truncation ------------------------------------------


def _fill(st: Tsdb, n: int = 300) -> None:
    for i in range(n):
        st.record("a", float(i), now=1000.0 + i)
        st.record("b", float(-i), now=1000.0 + i, labels='x="1"')


def test_persist_reload_roundtrip(tmp_path):
    st = _store(directory=str(tmp_path))
    _fill(st)
    assert st.persist(now=2000.0)
    st2 = _store(directory=str(tmp_path))
    assert st2.series_names() == st.series_names()
    for name, labels in st.series_names():
        assert st2.query(name, labels=labels, start=0, end=1e9,
                         tier="raw") == st.query(
            name, labels=labels, start=0, end=1e9, tier="raw")
        for tier in ("1m", "10m"):
            for agg in ("avg", "min", "max", "sum", "count", "last"):
                assert st2.query(
                    name, labels=labels, start=0, end=1e9, tier=tier,
                    agg=agg,
                ) == st.query(name, labels=labels, start=0, end=1e9,
                              tier=tier, agg=agg)
    assert st2.stats()["reload_truncated"] == 0


def test_crash_mid_persist_keeps_intact_prefix_only(tmp_path):
    st = _store(directory=str(tmp_path))
    _fill(st)
    st.persist(now=2000.0)
    path = tmp_path / "tsdb.bin"
    blob = path.read_bytes()
    full = {
        key: st.query(key[0], labels=key[1], start=0, end=1e9,
                      tier="raw")
        for key in st.series_names()
    }
    all_points = {
        (name, labels, ts, v)
        for (name, labels), pts in full.items()
        for ts, v in pts
    }
    # cut at every byte class: inside the magic, inside a frame header,
    # mid-payload, and just shy of the end
    for cut in (4, len(blob) // 3, len(blob) // 2, len(blob) - 1):
        path.write_bytes(blob[:cut])
        st2 = _store(directory=str(tmp_path))
        loaded = {
            (name, labels, ts, v)
            for (name, labels) in st2.series_names()
            for ts, v in st2.query(name, labels=labels, start=0,
                                   end=1e9, tier="raw")
        }
        # never invents a sample: loaded is a strict subset
        assert loaded <= all_points
        assert len(st2.series_names()) < len(full)
        if cut > len(_magic()):
            assert st2.stats()["reload_truncated"] == 1


def _magic() -> bytes:
    return _tsdb_module()._MAGIC


def _tsdb_module():
    # ``yjs_tpu_torch.obs.tsdb`` the MODULE — the package re-exports the
    # ``tsdb()`` accessor under the same name, shadowing attribute-style
    # imports
    import importlib

    return importlib.import_module("yjs_tpu_torch.obs.tsdb")


def test_corrupted_crc_drops_frame_and_tail(tmp_path):
    st = _store(directory=str(tmp_path))
    _fill(st, n=50)
    st.persist(now=2000.0)
    path = tmp_path / "tsdb.bin"
    blob = bytearray(path.read_bytes())
    # flip one payload byte in the FIRST frame: everything after the
    # torn frame is dropped too (the stream offset can't be trusted)
    blob[len(_magic()) + 8 + 4] ^= 0xFF
    path.write_bytes(bytes(blob))
    st2 = _store(directory=str(tmp_path))
    assert st2.series_names() == []
    assert st2.stats()["reload_truncated"] == 1


def test_missing_or_foreign_file_loads_empty(tmp_path):
    assert _store(directory=str(tmp_path)).series_names() == []
    (tmp_path / "tsdb.bin").write_bytes(b"not a tsdb file at all")
    st = _store(directory=str(tmp_path))
    assert st.series_names() == []
    assert st.stats()["reload_truncated"] == 0  # wrong magic != torn


def test_sampler_persists_on_cadence(tmp_path):
    st = _store(directory=str(tmp_path), persist_s=10.0)
    reg = MetricsRegistry()
    reg.counter("p_ctr", "d").inc()
    st.add_registry(reg)
    st.sample_once(now=100.0)   # first pass persists (last_persist=0)
    assert (tmp_path / "tsdb.bin").exists()
    mtime = (tmp_path / "tsdb.bin").stat().st_mtime_ns
    st.sample_once(now=105.0)   # within cadence: no rewrite
    assert (tmp_path / "tsdb.bin").stat().st_mtime_ns == mtime
    st.sample_once(now=111.0)   # past cadence: rewritten
    st2 = _store(directory=str(tmp_path))
    assert st2.query("p_ctr", start=0, end=1e9, tier="raw")


# -- window / flight-recorder embedding --------------------------------------


def test_window_filters_by_key_prefix_and_span():
    st = _store()
    st.record("ytpu_cost_wal_bytes_total", 5.0, labels='tenant="t"',
              now=1000.0)
    st.record("ytpu_cost_wal_bytes_total", 9.0, labels='tenant="t"',
              now=1050.0)
    st.record("unrelated_series", 1.0, now=1050.0)
    win = st.window(60.0, now=1105.0)
    assert list(win) == ['ytpu_cost_wal_bytes_total{tenant="t"}']
    # only the last 60s: the t=1000 point is outside
    assert win['ytpu_cost_wal_bytes_total{tenant="t"}'] == [[1050.0, 9.0]]
    assert all(
        any(k.startswith(p) for p in KEY_SERIES_PREFIXES) for k in win
    )


def test_blackbox_dump_embeds_tsdb_window(monkeypatch):
    import time

    from yjs_tpu_torch.obs.blackbox import reset_flight_recorder

    mod = _tsdb_module()

    monkeypatch.delenv("YTPU_TSDB_DISABLED", raising=False)
    # the dump reads the process-global store; swap in a private one so
    # series accumulated by other tests can't crowd the window cap
    st = _store()
    st.record("ytpu_cost_host_seconds_total", 1.25,
              labels='tenant="bb"', now=time.time())
    monkeypatch.setattr(mod, "_TSDB", st)
    rec = reset_flight_recorder()
    rec.record("tsdb-test", "boom", severity="error")
    dump = rec.dump("tsdb-embed-test")
    assert dump is not None
    assert 'ytpu_cost_host_seconds_total{tenant="bb"}' in dump["tsdb"]


def test_tsdb_window_empty_when_disabled(monkeypatch):
    monkeypatch.setenv("YTPU_TSDB_DISABLED", "1")
    assert not tsdb_enabled()
    assert tsdb_window() == {}
    from yjs_tpu_torch.obs.tsdb import maybe_attach_tsdb

    assert maybe_attach_tsdb(MetricsRegistry()) is None


# -- admin endpoints ---------------------------------------------------------


def _get(url: str, timeout: float = 10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _TsdbTarget:
    """Admin target exposing a PRIVATE store via the facade override
    hooks, so endpoint tests never touch the process-global one."""

    def __init__(self, store: Tsdb):
        self.store = store

    def tsdb_query(self, params: dict) -> dict:
        return self.store.query_params(params)

    def tsdb_stats(self) -> dict:
        out = self.store.stats()
        out["enabled"] = True
        return out


@pytest.fixture
def tsdb_admin():
    st = _store()
    for i in range(5):
        st.record("adm_series", float(i * i), now=1000.0 + i)
    admin = AdminServer(_TsdbTarget(st), role="tsdb-test").start()
    try:
        yield st, admin
    finally:
        admin.close()


@pytest.mark.admin
def test_admin_query_endpoint_returns_points(tsdb_admin):
    st, admin = tsdb_admin
    code, body = _get(
        admin.url + "/query?name=adm_series&start=1001&end=1003"
        "&tier=raw"
    )
    assert code == 200
    out = json.loads(body)
    assert out["name"] == "adm_series"
    assert out["tier"] == "raw"
    assert out["points"] == [[1001.0, 1.0], [1002.0, 4.0],
                             [1003.0, 9.0]]


@pytest.mark.admin
def test_admin_query_endpoint_malformed_is_400(tsdb_admin):
    _, admin = tsdb_admin
    for qs in ("", "name=adm_series&agg=median",
               "name=adm_series&start=noon", "name=adm_series&tier=2m"):
        code, body = _get(admin.url + "/query?" + qs)
        assert code == 400, qs
        assert "error" in json.loads(body)


@pytest.mark.admin
def test_admin_debug_tsdb_stats(tsdb_admin):
    st, admin = tsdb_admin
    code, body = _get(admin.url + "/debug/tsdb")
    assert code == 200
    out = json.loads(body)
    assert out["enabled"] is True
    assert out["series"] == 1
    assert out["points_raw"] == 5


# -- federation --------------------------------------------------------------


def test_merge_points_buckets_and_aggs():
    per_shard = {
        "s0": {"points": [[100.0, 1.0], [105.0, 3.0]]},
        "s1": {"points": [[101.0, 5.0]]},
        "dead": {"points": [], "stale": True},
    }
    assert merge_points(per_shard, agg="sum", bucket_s=5.0) == [
        [100.0, 6.0], [105.0, 3.0]
    ]
    assert merge_points(per_shard, agg="avg", bucket_s=5.0) == [
        [100.0, 3.0], [105.0, 3.0]
    ]
    assert merge_points(per_shard, agg="max", bucket_s=5.0) == [
        [100.0, 5.0], [105.0, 3.0]
    ]
    assert merge_points(per_shard, agg="min", bucket_s=5.0) == [
        [100.0, 1.0], [105.0, 3.0]
    ]
    assert merge_points(per_shard, agg="count", bucket_s=5.0) == [
        [100.0, 2.0], [105.0, 1.0]
    ]
    assert merge_points({}, agg="sum") == []


@pytest.mark.admin
def test_query_endpoints_federates_and_tolerates_dead_shard():
    stores = []
    admins = []
    try:
        for k in range(2):
            st = _store()
            for i in range(4):
                st.record("fed_series", float(10 * k + i),
                          now=1000.0 + i)
            stores.append(st)
            admins.append(
                AdminServer(_TsdbTarget(st), role=f"shard{k}").start()
            )
        urls = {f"shard{k}": a.url for k, a in enumerate(admins)}
        urls["dead"] = "http://127.0.0.1:9"  # discard port: refused
        per_shard = query_endpoints(
            urls,
            {"name": "fed_series", "start": "1000", "end": "2000",
             "tier": "raw", "agg": "avg", "empty": ""},
            timeout_s=5.0,
        )
        assert per_shard["dead"] == {"points": [], "stale": True}
        assert [v for _, v in per_shard["shard0"]["points"]] == [
            0.0, 1.0, 2.0, 3.0
        ]
        merged = merge_points(
            {k: v for k, v in per_shard.items()}, agg="sum",
            bucket_s=1.0,
        )
        assert [v for _, v in merged] == [10.0, 12.0, 14.0, 16.0]
    finally:
        for a in admins:
            a.close()


# -- ytpu_top snapshot-dir mtime cache (satellite) ---------------------------


def _write_snap(path: Path, docs: int) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({
        "role": "shard",
        "counters": {"ytpu_docs_resident": {"": docs}},
        "gauges": {}, "histograms": {},
    }))
    os.replace(tmp, path)


def test_read_snapshot_dir_mtime_cache_skips_unchanged(tmp_path,
                                                       monkeypatch):
    import types

    import yjs_tpu_torch.obs.federate as fed

    _write_snap(tmp_path / "a.json", 3)
    _write_snap(tmp_path / "b.json", 5)
    cache: dict = {}
    first = fed.read_snapshot_dir(str(tmp_path), cache=cache)
    assert [s["label"] for s in first] == ["a", "b"]
    assert len(cache) == 2

    parses = []
    real_json = fed.json

    def counting_load(f):
        parses.append(1)
        return real_json.loads(f.read())

    monkeypatch.setattr(
        fed, "json",
        types.SimpleNamespace(load=counting_load,
                              loads=real_json.loads),
    )
    second = fed.read_snapshot_dir(str(tmp_path), cache=cache)
    assert [s["label"] for s in second] == ["a", "b"]
    assert not parses  # both files served from the (mtime, size) cache

    # rewrite one file with new content: exactly that one re-parses
    _write_snap(tmp_path / "a.json", 9)
    third = fed.read_snapshot_dir(str(tmp_path), cache=cache)
    assert len(parses) == 1
    got = {s["label"]: s["snapshot"] for s in third}
    assert got["a"]["counters"]["ytpu_docs_resident"][""] == 9


def test_read_snapshot_dir_never_caches_stale_reads(tmp_path):
    import yjs_tpu_torch.obs.federate as fed

    _write_snap(tmp_path / "a.json", 1)
    # a writer caught mid-replace: rendered as a stale row, NOT cached,
    # so the next frame retries the parse
    (tmp_path / "torn.json").write_text('{"role": "shard", "cou')
    cache: dict = {}
    snaps = fed.read_snapshot_dir(str(tmp_path), cache=cache)
    assert [(s["label"], s["stale"]) for s in snaps] == [
        ("a", False), ("torn", True)
    ]
    assert len(cache) == 1
    _write_snap(tmp_path / "torn.json", 7)  # the writer finished
    snaps = fed.read_snapshot_dir(str(tmp_path), cache=cache)
    assert [(s["label"], s["stale"]) for s in snaps] == [
        ("a", False), ("torn", False)
    ]
    assert len(cache) == 2
    (tmp_path / "a.json").unlink()
    (tmp_path / "torn.json").unlink()
    assert fed.read_snapshot_dir(str(tmp_path), cache=cache) == []
    assert cache == {}  # vanished entries pruned


def _load_top():
    import importlib.util

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "ytpu_top", root / "scripts" / "torch_ytpu_top.py"
    )
    top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(top)
    return top


def test_ytpu_top_sparkline_shapes():
    top = _load_top()
    assert top.sparkline([]) == "-"
    assert top.sparkline([1.0, 1.0], 4) == "▁▁"
    line = top.sparkline([0.0, 5.0, 10.0])
    assert line[0] == "▁" and line[-1] == "█"
    assert len(top.sparkline(list(range(100)), 10)) == 10  # width trims


@pytest.mark.admin
def test_ytpu_top_range_mode_renders_query():
    import io
    import time

    top = _load_top()
    st = _store()
    t0 = time.time() - 30.0
    for i in range(6):
        st.record("rng_series", float(i), now=t0 + i)
    admin = AdminServer(_TsdbTarget(st), role="range").start()
    try:
        out = io.StringIO()
        rc = top.run_range(
            [admin.url], "rng_series", labels="", last_s=3600.0,
            agg="avg", out=out,
        )
        text = out.getvalue()
        assert rc == 0
        assert "rng_series" in text and "n=6" in text
        out = io.StringIO()
        rc = top.run_range(
            [admin.url], "no_such_series", labels="", last_s=3600.0,
            agg="avg", out=out,
        )
        assert rc == 1
        assert "(no data)" in out.getvalue()
    finally:
        admin.close()
