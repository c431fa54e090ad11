"""The cases of the JAX package's ``tests/test_flush_pipeline.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Pipelined-flush suite.

The correctness bar for the single pipelined flush path is byte-identity:
``YTPU_FLUSH_PIPELINE=1`` (double-buffered staging, donated device
tables, async dispatch) must produce the same encoded states, texts, and
emitted deltas as ``=0`` (the synchronous A/B path) under every seeded
trace shape — including a primary killed mid-pipelined-flush and a
crash-mid-flush WAL recovery.  On top of that: a cached plan adopted
AFTER the leader's tables were donated must never alias freed device
buffers, and the adaptive flush tick must tighten under SLO burn, widen
when idle, and coalesce under brownout.

Deterministic seeded traces; in tier-1; the ``flushpipe`` marker
deselects it with ``-m 'not flushpipe'`` and ci_check.sh runs it
standalone first.  Its kill-primary case is carried in
``tests/test_torch_fleet.py``.
"""

import random

import pytest

import yjs_tpu_torch as Y
from torch_service import FleetRouter
from yjs_tpu_torch.obs import FLUSH_METRICS_SCHEMA
from yjs_tpu_torch.ops import plan_cache
from torch_service import BatchEngine
from yjs_tpu_torch.ops.native_mirror import native_plan_available
from yjs_tpu_torch.persistence import WalConfig
from yjs_tpu_torch.provider import FlushTickController
from torch_service import TpuProvider
from yjs_tpu_torch.updates import (
    apply_update,
    encode_state_as_update,
    encode_state_vector,
)

pytestmark = pytest.mark.flushpipe

SMALL = WalConfig(segment_bytes=256, fsync="never")

# the 20-seed corpus from the acceptance matrix, cycling trace shapes
CORPUS_SEEDS = tuple(range(20))
SHAPES = ("prepend", "interleaved", "storm")


@pytest.fixture(autouse=True)
def _fresh_cache():
    plan_cache.reset_cache()
    yield
    plan_cache.reset_cache()


# -- seeded traces ------------------------------------------------------------


def make_trace(shape: str, seed: int, n_ops: int = 60) -> list[bytes]:
    """Incremental updates from concurrent seeded editors (the
    test_plan_cache texture: prepend / interleaved / conflict-storm).
    Generated ONCE per seed — both pipeline modes replay the SAME
    bytes, so any divergence is the flush path's fault."""
    n_clients = 4 if shape == "storm" else 3
    sync_p = 0.05 if shape == "storm" else 0.4
    gen = random.Random(seed)
    docs = []
    for k in range(n_clients):
        d = Y.Doc(gc=False)
        d.client_id = 100 + k
        docs.append(d)
    out = []
    for _ in range(n_ops):
        j = gen.randrange(n_clients)
        d = docs[j]
        t = d.get_text("text")
        sv = encode_state_vector(d)
        if shape == "prepend":
            t.insert(0, gen.choice("abcdef") * gen.randint(1, 3))
        elif shape == "storm":
            t.insert(min(len(t), gen.randrange(3)), gen.choice("xyz "))
        elif len(t) and gen.random() < 0.25:
            t.delete(gen.randrange(len(t)), 1)
        else:
            t.insert(gen.randrange(len(t) + 1), gen.choice("abcdef "))
        out.append(encode_state_as_update(d, sv))
        if gen.random() < sync_p:
            k = gen.randrange(n_clients)
            if k != j:
                apply_update(docs[k], encode_state_as_update(d))
    return out


def run_engine(updates, n_docs, pipeline, monkeypatch, flush_every=5):
    """Drive one engine over ``updates`` (broadcast to every doc);
    returns encoded states, texts, emitted deltas, and the flush-metrics
    keysets + last metrics dict."""
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "1" if pipeline else "0")
    eng = BatchEngine(n_docs)
    deltas = {i: [] for i in range(n_docs)}
    eng.on_update(lambda i, u: deltas[i].append(u))
    keysets = set()
    for j, u in enumerate(updates):
        for i in range(n_docs):
            eng.queue_update(i, u)
        if (j + 1) % flush_every == 0 or j == len(updates) - 1:
            eng.flush()
            keysets.add(frozenset(eng.last_flush_metrics))
    states = [
        Y.merge_updates([eng.encode_state_as_update(i)])
        for i in range(n_docs)
    ]
    texts = [eng.text(i) for i in range(n_docs)]
    return states, texts, deltas, keysets, eng


def oracle_state(updates) -> bytes:
    d = Y.Doc(gc=False)
    for u in updates:
        apply_update(d, u)
    return Y.merge_updates([encode_state_as_update(d)])


# -- one dispatch path --------------------------------------------------------


def test_exactly_one_flush_dispatch_path():
    """The three earlier flush bodies are gone: every kernel
    launch funnels through the single ``_dispatch`` seam."""
    assert hasattr(BatchEngine, "_dispatch")
    assert hasattr(BatchEngine, "_flush_bulk")
    for legacy in ("_flush_apply", "_flush_apply_batched"):
        assert not hasattr(BatchEngine, legacy), legacy


# -- metrics schema: every path, both modes -----------------------------------


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("kernel", ["apply", "levels", "seq"])
def test_schema_complete_on_every_path(kernel, pipeline, monkeypatch):
    """Every flush entry point (native batched apply, python apply,
    device-YATA levels/seq) emits the ONE shared metrics schema —
    including the pipeline fields — in both pipeline modes."""
    monkeypatch.setenv("YTPU_KERNEL", kernel)
    updates = make_trace("interleaved", seed=3, n_ops=20)
    _s, _t, _d, keysets, eng = run_engine(updates, 2, pipeline, monkeypatch)
    assert keysets == {frozenset(FLUSH_METRICS_SCHEMA)}
    m = eng.last_flush_metrics
    assert m["t_pack_overlap_s"] >= 0.0
    assert m["t_device_wait_s"] >= 0.0
    assert m["flush_donated"] in (0, 1)
    if not pipeline:
        # sync A/B path: each dispatch is drained before the next, so
        # the pipeline never reports depth
        assert m["pipeline_depth"] == 0


def test_python_mirror_path_emits_schema(monkeypatch):
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    updates = make_trace("interleaved", seed=4, n_ops=20)
    _s, _t, _d, keysets, _e = run_engine(updates, 2, True, monkeypatch)
    assert keysets == {frozenset(FLUSH_METRICS_SCHEMA)}


def _distinct_doc_engine(n_docs, monkeypatch, mode="device"):
    """One engine whose docs each carry a DISTINCT trace (no cache
    dedup), flushed once cold — the fan-out shape plan_threads must
    report (it used to report 1 on batched paths)."""
    monkeypatch.setenv("YTPU_PLAN_SEGMENT", mode)
    monkeypatch.setenv("YTPU_PLAN_CACHE", "0")
    eng = BatchEngine(n_docs)
    for i in range(n_docs):
        for u in make_trace("interleaved", seed=100 + i, n_ops=12):
            eng.queue_update(i, u)
    eng.flush()
    return eng.last_flush_metrics


def test_plan_threads_reports_py_chunk_fanout(monkeypatch):
    """Python path, device mode: the whole-chunk segment planner
    co-plans every cold doc in one call — plan_threads reports that
    fan-out, not 1."""
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    m = _distinct_doc_engine(4, monkeypatch)
    assert m["plan_threads"] == 4
    # the off lane plans per doc, serially
    m_off = _distinct_doc_engine(4, monkeypatch, mode="off")
    assert m_off["plan_threads"] == 1


def test_plan_threads_reports_native_pool_width(monkeypatch):
    if not native_plan_available():
        pytest.skip("native plancore unavailable")
    monkeypatch.setenv("YTPU_PLAN_THREADS", "3")
    m = _distinct_doc_engine(4, monkeypatch)
    # min(configured pool width, cold docs in the batch)
    assert m["plan_threads"] == 3


def test_steady_state_flush_donates(monkeypatch):
    """After the warm-up flush sized the tables, steady-state pipelined
    flushes reallocate nothing: donation hit rate 1.0."""
    updates = make_trace("interleaved", seed=5, n_ops=40)
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "1")
    eng = BatchEngine(2)
    for u in updates[:20]:
        for i in range(2):
            eng.queue_update(i, u)
    eng.flush()  # warm-up: allocates, may grow
    for u in updates[20:]:
        for i in range(2):
            eng.queue_update(i, u)
    eng.flush()
    m = eng.last_flush_metrics
    if m["realloc_bytes"] == 0:  # no growth this flush: must donate
        assert m["flush_donated"] == 1
    assert m["pipeline_depth"] >= 1


# -- donation aliasing (satellite 2) ------------------------------------------


@pytest.mark.parametrize("native", [True, False])
def test_cached_plan_adopted_after_donation_no_alias(native, monkeypatch):
    """A follower adopting a cached plan AFTER the leader's device
    tables were donated (and the leader kept flushing, recycling that
    memory) must replay byte-identically — the entry may hold host
    state only, never a donated ``jax.Array``."""
    if native and not native_plan_available():
        pytest.skip("native plancore unavailable")
    if not native:
        monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    monkeypatch.setenv("YTPU_PLAN_CACHE", "1")
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "1")
    updates = make_trace("prepend", seed=6, n_ops=40)
    extra = make_trace("interleaved", seed=7, n_ops=40)
    # leader populates the cache; every one of its dispatches donated
    # the tables the cached plans were built against
    s1, t1, _d, _k, leader = run_engine(updates, 2, True, monkeypatch)
    # leader keeps flushing OTHER traffic: the donated buffers are
    # freed and their memory recycled before the follower replays
    for j, u in enumerate(extra):
        leader.queue_update(0, u)
        if (j + 1) % 5 == 0:
            leader.flush()
    leader.flush()
    # follower replays the original trace purely from cache hits
    s2, t2, _d2, _k2, follower = run_engine(updates, 2, True, monkeypatch)
    assert s2 == s1
    assert t2 == t1
    assert s2[0] == oracle_state(updates)
    m = follower.last_flush_metrics
    if native:
        assert m["plan_cache_hits"] > 0


# -- the 20-seed pipeline on/off corpus (satellite 3) -------------------------


@pytest.mark.parametrize("seed", CORPUS_SEEDS)
def test_pipeline_on_off_byte_identical(seed, monkeypatch):
    """Acceptance bar: the SAME update bytes through pipeline-on and
    pipeline-off engines converge to byte-identical states, texts, and
    emitted deltas — across all 20 corpus seeds / 3 trace shapes."""
    updates = make_trace(SHAPES[seed % 3], seed=100 + seed)
    plan_cache.reset_cache()
    s_on, t_on, d_on, keys_on, _e = run_engine(
        updates, 2, True, monkeypatch
    )
    plan_cache.reset_cache()
    s_off, t_off, d_off, keys_off, _e = run_engine(
        updates, 2, False, monkeypatch
    )
    assert t_on == t_off
    assert s_on == s_off
    assert d_on == d_off
    assert keys_on == keys_off == {frozenset(FLUSH_METRICS_SCHEMA)}
    assert s_on[0] == oracle_state(updates)


# -- kill-primary-mid-pipelined-flush -----------------------------------------


def _seeded_rooms(seed, n_rooms=4, n_ops=8):
    out = {}
    for j in range(n_rooms):
        gen = random.Random(seed * 1000 + j)
        d = Y.Doc(gc=False)
        d.client_id = 100 + j
        t = d.get_text("text")
        updates = []
        d.on("update", lambda u, origin, doc: updates.append(bytes(u)))
        for _ in range(n_ops):
            t.insert(gen.randrange(len(t) + 1), gen.choice("abcdef "))
        out[f"room-{j}"] = (d, updates)
    return out


def _edit(doc, text):
    sv = encode_state_vector(doc)
    doc.get_text("text").insert(0, text)
    return encode_state_as_update(doc, sv)


# -- crash-mid-flush WAL recovery ---------------------------------------------


@pytest.mark.durability
@pytest.mark.chaos
@pytest.mark.parametrize("pipeline", [True, False])
def test_crash_mid_flush_wal_recovery(pipeline, tmp_path, monkeypatch):
    """kill -9 between flushes (pipeline possibly mid-dispatch, dirty
    updates journaled but unflushed): recovery replays the WAL to the
    exact same bytes in both pipeline modes."""
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "1" if pipeline else "0")
    updates = make_trace("interleaved", seed=8, n_ops=40)
    ref = TpuProvider(2)
    for u in updates:
        ref.receive_update("room", u)
    ref.flush()
    victim = TpuProvider(2, wal_dir=tmp_path, wal_config=SMALL)
    c = len(updates) // 2
    for j, u in enumerate(updates[:c]):
        victim.receive_update("room", u)
        if (j + 1) % 5 == 0:
            victim.flush()
    # a flush just dispatched + more acked updates queued behind it —
    # then the process dies with no seal-time fsync
    victim.receive_update("room", updates[c - 1])
    victim.wal.abandon()
    rec = TpuProvider.recover(
        tmp_path, n_docs=2, wal_config=SMALL
    )
    for u in updates[c:]:
        rec.receive_update("room", u)
    rec.flush()
    got = Y.merge_updates([rec.encode_state_as_update("room")])
    want = Y.merge_updates([ref.encode_state_as_update("room")])
    assert got == want


# -- adaptive flush tick ------------------------------------------------------


def test_tick_controller_widens_idle_tightens_on_burn(monkeypatch):
    monkeypatch.setenv("YTPU_FLUSH_TICK_MIN_MS", "2")
    monkeypatch.setenv("YTPU_FLUSH_TICK_MAX_MS", "64")
    monkeypatch.setenv("YTPU_FLUSH_TICK_GROW", "2")
    c = FlushTickController()
    assert c.window("ok") == 2.0
    # idle ticks widen geometrically, clamped at the max
    for want in (4.0, 8.0, 16.0, 32.0, 64.0, 64.0):
        c.applied(0.0, c.window("ok"), busy=False)
        assert c.window("ok") == want
    # busy ticks hold the window
    c.applied(0.0, c.window("ok"), busy=True)
    assert c.window("ok") == 64.0
    # an SLO burn verdict snaps straight back to the minimum
    assert c.window("page") == 2.0
    assert c.window("ok") == 2.0  # and stays there until idle again


def test_tick_controller_brownout_inputs():
    c = FlushTickController()
    # force_coalesce pins the window to the maximum regardless of state
    assert c.window("ok", coalesce=True) == c.max_ms
    # the brownout scale multiplies (never divides) the window
    assert c.window("ok", scale=4.0) == c.min_ms * 4.0
    assert c.window("ok", scale=0.25) == c.min_ms


def test_tick_controller_due_and_history():
    c = FlushTickController()
    assert c.due(0.0, 10.0)  # first tick is always due
    c.applied(0.0, 10.0, busy=True)
    assert not c.due(0.005, 10.0)
    assert c.due(0.010, 10.0)
    c.applied(0.010, 12.0, busy=True)
    p = c.percentiles()
    assert p["p50_ms"] in (10.0, 12.0) and p["p99_ms"] == 12.0


def test_provider_flush_tick(monkeypatch):
    monkeypatch.setenv("YTPU_FLUSH_TICK_MIN_MS", "2")
    prov = TpuProvider(2)
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "hello")
    prov.receive_update("room", encode_state_as_update(d))
    assert prov.flush_tick(now=0.0) is True  # dirty + due: flushed
    assert prov.text("room") == "hello"
    # idle tick: runs (due), flushes nothing, widens the window
    w0 = prov.flush_ticks.window_ms
    assert prov.flush_tick(now=1.0) is False
    assert prov.flush_ticks.window_ms > w0
    # inside the widened window: not due, dirty work waits
    prov.receive_update("room", _edit(d, "x"))
    assert prov.flush_tick(now=1.0005) is False
    assert prov._dirty
    # past the window: the queued edit flushes
    assert prov.flush_tick(now=2.0) is True
    assert prov.text("room") == "xhello"


@pytest.mark.fleet
def test_fleet_flush_tick_fans_out(tmp_path):
    fleet = FleetRouter(2, 4, wal_dir=tmp_path, wal_config=SMALL)
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "fan-out")
    fleet.receive_update("room-a", encode_state_as_update(d))
    assert fleet.flush_tick(now=0.0) is True
    assert fleet.text("room-a") == "fan-out"
    assert fleet.flush_tick(now=100.0) is False  # everyone idle
