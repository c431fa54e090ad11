"""The cases of the JAX package's ``tests/test_plan_cache.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Plan-cache + segment-planning suite.

The correctness bar for the frontier-keyed plan cache is byte-identical
convergence: under every seeded trace shape (prepend-heavy, interleaved,
conflict-storm), an engine with the cache on must produce the same
encoded state AND the same emitted deltas as one with the cache off —
including across demotion→promotion round trips and failover promotion,
where a stale mirror must never alias a cached entry.

Deterministic seeded traces; in tier-1; the ``planner`` marker
deselects it with ``-m 'not planner'`` and ci_check.sh runs it
standalone first.
"""

import random

import numpy as np
import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.obs import FLUSH_METRICS_SCHEMA
from torch_service import BatchEngine
from yjs_tpu_torch.ops import plan_cache
from yjs_tpu_torch.ops.columns import DocMirror
from yjs_tpu_torch.ops.native_mirror import native_plan_available
from yjs_tpu_torch.updates import (
    apply_update,
    encode_state_as_update,
    encode_state_vector,
)

pytestmark = pytest.mark.planner


@pytest.fixture(autouse=True)
def _fresh_cache():
    """Each test starts and ends with an empty process-global cache."""
    plan_cache.reset_cache()
    yield
    plan_cache.reset_cache()


# -- seeded trace shapes ------------------------------------------------------


def make_trace(shape: str, seed: int, n_ops: int = 150) -> list[bytes]:
    """Incremental updates from ``n_clients`` concurrent editors.

    ``prepend``: every insert at position 0 (maximal fragmentation);
    ``interleaved``: random positions, frequent cross-sync;
    ``storm``: 4 clients colliding at near-identical positions with rare
    syncs, so updates arrive causally out of order (pending queues).
    """
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


def run_engine(updates, n_docs, cache_on, monkeypatch, flush_every=5):
    """Drive one engine over ``updates`` (broadcast to every doc),
    returning encoded states, texts, per-doc emitted deltas, and summed
    flush metrics."""
    monkeypatch.setenv("YTPU_PLAN_CACHE", "1" if cache_on else "0")
    eng = BatchEngine(n_docs)
    deltas = {i: [] for i in range(n_docs)}
    eng.on_update(lambda i, u: deltas[i].append(u))
    sums = {"plan_cache_hits": 0, "plan_cache_misses": 0,
            "plan_fastpath_structs": 0}
    keysets = set()
    for j, u in enumerate(updates):
        for i in range(n_docs):
            eng.queue_update(i, u)
        if (j + 1) % flush_every == 0 or j == len(updates) - 1:
            eng.flush()
            m = eng.last_flush_metrics
            keysets.add(frozenset(m))
            for k in sums:
                sums[k] += m[k]
    states = [eng.encode_state_as_update(i) for i in range(n_docs)]
    texts = [eng.text(i) for i in range(n_docs)]
    return states, texts, deltas, sums, keysets


# -- cache-on vs cache-off byte-identity --------------------------------------


@pytest.mark.parametrize("shape", ["prepend", "interleaved", "storm"])
def test_cache_on_off_byte_identical(shape, monkeypatch):
    updates = make_trace(shape, seed=42)
    plan_cache.reset_cache()
    s_on, t_on, d_on, sums_on, keys_on = run_engine(
        updates, 3, True, monkeypatch
    )
    plan_cache.reset_cache()
    s_off, t_off, d_off, sums_off, keys_off = run_engine(
        updates, 3, False, monkeypatch
    )
    assert t_on == t_off
    assert s_on == s_off
    assert d_on == d_off
    # identical docs in one batch: the cache (or leader grouping) must
    # have served the duplicates; cache-off plans every doc cold
    assert sums_on["plan_cache_hits"] > 0
    assert sums_off["plan_cache_hits"] == 0
    # ONE metrics schema for both modes — no key drift
    assert keys_on == keys_off == {frozenset(FLUSH_METRICS_SCHEMA)}


def test_cross_engine_replay_is_all_hits(monkeypatch):
    """A second engine replaying the same trace is served entirely from
    the cache and still converges byte-identically."""
    monkeypatch.setenv("YTPU_PLAN_CACHE", "1")
    updates = make_trace("interleaved", seed=7)
    s1, t1, _d, _s, _k = run_engine(updates, 2, True, monkeypatch)
    s2, t2, _d, sums2, _k = run_engine(updates, 2, True, monkeypatch)
    assert (s1, t1) == (s2, t2)
    assert sums2["plan_cache_misses"] == 0
    assert sums2["plan_cache_hits"] > 0


def test_python_mirror_path_byte_identical(monkeypatch):
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    updates = make_trace("interleaved", seed=13)
    plan_cache.reset_cache()
    s_on, t_on, d_on, sums_on, _ = run_engine(updates, 2, True, monkeypatch)
    plan_cache.reset_cache()
    s_off, t_off, d_off, _s, _ = run_engine(updates, 2, False, monkeypatch)
    assert (t_on, s_on, d_on) == (t_off, s_off, d_off)
    assert sums_on["plan_cache_hits"] > 0


# -- frontier keying: a stale mirror can never alias --------------------------


def test_same_staged_bytes_different_history_do_not_alias(monkeypatch):
    """Two docs staging the SAME update bytes on DIFFERENT integrated
    states must plan independently — the frontier, not the staged
    digest, carries the history."""
    monkeypatch.setenv("YTPU_PLAN_CACHE", "1")
    d = Y.Doc(gc=False)
    d.client_id = 7
    t = d.get_text("text")
    t.insert(0, "base ")
    u1 = encode_state_as_update(d)
    sv = encode_state_vector(d)
    t.insert(5, "tail")
    u2 = encode_state_as_update(d, sv)

    eng = BatchEngine(2)
    eng.queue_update(0, u1)
    eng.flush()
    # doc 0 stages u2 on top of u1; doc 1 stages u2 on an EMPTY doc
    # (u2 alone is causally unready there — it must park as pending,
    # not adopt doc 0's post-plan state)
    eng.queue_update(0, u2)
    eng.queue_update(1, u2)
    eng.flush()
    assert eng.text(0) == "base tail"
    assert eng.text(1) == ""  # pending, not aliased
    eng.queue_update(1, u1)
    eng.flush()
    assert eng.text(1) == "base tail"


def test_reset_doc_reseeds_frontier(monkeypatch):
    """A reset slot re-planning the same bytes aliases the ORIGINAL
    fresh-doc entry — correct reuse — and converges identically."""
    monkeypatch.setenv("YTPU_PLAN_CACHE", "1")
    updates = make_trace("prepend", seed=3, n_ops=40)
    eng = BatchEngine(1)
    for u in updates:
        eng.queue_update(0, u)
    eng.flush()
    expect = eng.text(0)
    eng.reset_doc(0)
    assert eng.text(0) == ""
    for u in updates:
        eng.queue_update(0, u)
    eng.flush()
    assert eng.text(0) == expect


def test_plan_error_poisons_frontier():
    m = DocMirror("text", device="cpu")
    m.ingest(b"\xff\xffgarbage", False)
    key_before = m.plan_key()
    with pytest.raises(Exception):
        m.prepare_step()
    assert m.plan_frontier != key_before[1]
    # and no two poisons collide
    assert plan_cache.poison_frontier() != plan_cache.poison_frontier()


def test_demotion_promotion_roundtrip_byte_identical(monkeypatch):
    """Warm demote → demand promote → more traffic, cache on vs off:
    the promoted mirror's folded frontier keeps it from aliasing any
    pre-compaction entry."""
    from torch_service import TpuProvider
    from yjs_tpu_torch.tiering import TierConfig

    def upd(text, cid=1, at=0):
        d = Y.Doc(gc=False)
        d.client_id = cid
        d.get_text("text").insert(at, text)
        return encode_state_as_update(d)

    def drive(cache_on):
        monkeypatch.setenv("YTPU_PLAN_CACHE", "1" if cache_on else "0")
        plan_cache.reset_cache()
        p = TpuProvider(2, tier_config=TierConfig(enabled=True))
        p.receive_update("r", upd("round trip "))
        p.flush()
        assert p.demote_doc("r", "warm")
        # demand promotion (hydrate_doc_columns under the hood), then
        # more traffic through the promoted mirror
        assert p.text("r") == "round trip "
        p.receive_update("r", upd("second", cid=2))
        p.flush()
        return Y.merge_updates([p.encode_state_as_update("r")]), p.text("r")

    assert drive(True) == drive(False)


def test_failover_promotion_byte_identical(tmp_path, monkeypatch):
    """Shard death + replica promotion with the cache on (the default):
    promoted slots rebuild from journals and must converge to the
    uninterrupted reference byte-for-byte."""
    from yjs_tpu_torch.fleet import FailoverConfig
    from torch_service import FleetRouter
    from yjs_tpu_torch.persistence import WalConfig

    monkeypatch.setenv("YTPU_PLAN_CACHE", "1")
    assert plan_cache.get_cache() is not None
    fleet = FleetRouter(
        3, 4, backend="cpu", wal_dir=tmp_path,
        wal_config=WalConfig(segment_bytes=256, fsync="never"),
        failover_config=FailoverConfig(
            suspect_ticks=2, confirm_ticks=1, jitter_ticks=0
        ),
    )
    rooms = {}
    for j in range(4):
        d = Y.Doc(gc=False)
        d.client_id = 100 + j
        g = f"room-{j}"
        rooms[g] = d
        for step in range(6):
            sv = encode_state_vector(d)
            d.get_text("text").insert(0, f"{j}:{step} ")
            fleet.receive_update(g, encode_state_as_update(d, sv))
    fleet.flush()
    fleet.tick()  # drain the replication outbox
    victim = fleet.owner_of("room-0")
    fleet.kill_shard(victim)
    for _ in range(16):
        fleet.tick()
        if victim in fleet._down:
            break
    else:
        raise AssertionError("victim never convicted")
    for g, d in rooms.items():
        ref = Y.merge_updates([encode_state_as_update(d)])
        assert Y.merge_updates([fleet.encode_state_as_update(g)]) == ref
    # the recovered fleet keeps converging on post-failover traffic
    d = rooms["room-0"]
    sv = encode_state_vector(d)
    d.get_text("text").insert(0, "after! ")
    fleet.receive_update("room-0", encode_state_as_update(d, sv))
    assert fleet.text("room-0") == d.get_text("text").to_string()


# -- segment-sorted planning kernels ------------------------------------------


def test_anchor_lookup_np_matches_jax_and_bruteforce(rng):
    from yjs_tpu_torch.ops import kernels

    n_slots, per_slot, n_q = 5, 40, 64
    flat_slot = np.repeat(np.arange(n_slots), per_slot)
    starts = np.sort(
        np.asarray(
            [[rng.randrange(1000) for _ in range(per_slot)]
             for _ in range(n_slots)]
        ),
        axis=1,
    ).ravel()
    q_slot = np.asarray(
        [rng.randrange(-1, n_slots) for _ in range(n_q)], np.int64
    )
    q_clock = np.asarray(
        [rng.randrange(1100) for _ in range(n_q)], np.int64
    )
    got_np = kernels.plan_anchor_lookup(
        flat_slot, starts, q_slot, q_clock, backend="np"
    )
    got_jax = kernels.plan_anchor_lookup(
        flat_slot, starts, q_slot, q_clock, backend="jax", device="cpu"
    )
    assert (np.asarray(got_np) == np.asarray(got_jax)).all()
    key = flat_slot * 2000 + starts  # clocks < 1100 < 2000: no overlap
    for i in range(n_q):
        if q_slot[i] < 0:
            assert got_np[i] == -1
            continue
        qk = q_slot[i] * 2000 + q_clock[i]
        expect = int(np.searchsorted(key, qk, side="right")) - 1
        assert got_np[i] == expect


def test_conflict_scan_np_matches_jax(rng):
    from yjs_tpu_torch.ops import kernels

    n = 96
    client = np.asarray([rng.randrange(3) for _ in range(n)], np.int64)
    clock = np.cumsum([rng.randrange(1, 4) for _ in range(n)])
    length = np.asarray([rng.randrange(1, 4) for _ in range(n)], np.int64)
    o_cl = np.roll(client, 1)
    o_ck = np.roll(clock, 1)
    # degrade a third of the chain links to foreign origins
    for i in range(0, n, 3):
        o_cl[i] = -1
    r_cl = np.full(n, -1, np.int64)
    r_ck = np.zeros(n, np.int64)
    a = kernels.plan_conflict_scan(
        client, clock, length, o_cl, o_ck, r_cl, r_ck, backend="np"
    )
    b = kernels.plan_conflict_scan(
        client, clock, length, o_cl, o_ck, r_cl, r_ck, backend="jax",
        device="cpu",
    )
    for x, y in zip(a, b):
        assert (np.asarray(x) == np.asarray(y)).all()


@pytest.mark.parametrize("shape", ["prepend", "interleaved", "storm"])
def test_segment_hints_do_not_change_plans(shape, monkeypatch):
    """The segment fast path is a pure accelerator: hints on vs off must
    yield identical plans and identical mirror state."""
    updates = make_trace(shape, seed=5, n_ops=80)

    def drive(segment):
        monkeypatch.setenv("YTPU_PLAN_SEGMENT", segment)
        m = DocMirror("text", device="cpu")
        plans = []
        for j, u in enumerate(updates):
            m.ingest(u, False)
            if (j + 1) % 4 == 0 or j == len(updates) - 1:
                p = m.prepare_step()
                plans.append(
                    (p.sched, p.splits, p.link_rows, p.link_vals,
                     p.head_segs, p.head_vals, sorted(p.delete_rows))
                )
        return plans, m.encode_state_as_update(), m.plan_frontier

    p_on, s_on, f_on = drive("np")
    p_off, s_off, f_off = drive("off")
    assert p_on == p_off
    assert s_on == s_off
    assert f_on == f_off


def test_fastpath_structs_counted(monkeypatch):
    monkeypatch.setenv("YTPU_PLAN_SEGMENT", "np")
    updates = make_trace("prepend", seed=9, n_ops=60)
    m = DocMirror("text", device="cpu")
    for u in updates:
        m.ingest(u, False)
    p = m.prepare_step()
    assert p.fastpath_structs > 0
    assert p.fastpath_structs <= len(p.sched)


# -- cache mechanics ----------------------------------------------------------


def test_cache_eviction_respects_caps(monkeypatch):
    monkeypatch.setenv("YTPU_PLAN_CACHE", "1")
    monkeypatch.setenv("YTPU_PLAN_CACHE_CAP", "4")
    plan_cache.reset_cache()
    updates = make_trace("interleaved", seed=21, n_ops=60)
    eng = BatchEngine(1)
    for j, u in enumerate(updates):
        eng.queue_update(0, u)
        if (j + 1) % 3 == 0:
            eng.flush()
    eng.flush()
    cache = plan_cache.get_cache()
    assert len(cache) <= 4
    assert cache.stats()["bytes"] >= 0


def test_cache_disabled_plans_cold(monkeypatch):
    monkeypatch.setenv("YTPU_PLAN_CACHE", "0")
    assert plan_cache.get_cache() is None
    eng = BatchEngine(2)
    d = Y.Doc(gc=False)
    d.client_id = 1
    d.get_text("text").insert(0, "no cache")
    u = encode_state_as_update(d)
    eng.queue_update(0, u)
    eng.queue_update(1, u)
    eng.flush()
    m = eng.last_flush_metrics
    assert m["plan_cache_hits"] == 0
    assert eng.text(0) == eng.text(1) == "no cache"


@pytest.mark.skipif(
    not native_plan_available(), reason="native plan core unavailable"
)
def test_plan_threads_reports_actual_width(monkeypatch):
    """plan_threads is the width the flush actually used: bounded by the
    batch, and 1 on an all-hit flush."""
    monkeypatch.setenv("YTPU_PLAN_CACHE", "1")
    d = Y.Doc(gc=False)
    d.client_id = 1
    d.get_text("text").insert(0, "threads")
    u = encode_state_as_update(d)
    eng = BatchEngine(4)
    for i in range(4):
        eng.queue_update(i, u)
    eng.flush()
    first = eng.last_flush_metrics["plan_threads"]
    assert 1 <= first <= 4  # one cold leader in a 4-doc chunk
    eng2 = BatchEngine(4)
    for i in range(4):
        eng2.queue_update(i, u)
    eng2.flush()
    assert eng2.last_flush_metrics["plan_threads"] == 1  # all hits
    assert eng2.last_flush_metrics["plan_cache_misses"] == 0


def test_timer_split_is_consistent():
    updates = make_trace("interleaved", seed=31, n_ops=30)
    eng = BatchEngine(2)
    for u in updates:
        eng.queue_update(0, u)
        eng.queue_update(1, u)
    eng.flush()
    m = eng.last_flush_metrics
    assert m["t_plan_cached_s"] + m["t_plan_cold_s"] <= m["t_plan_s"] + 1e-6
    assert m["plan_cache_hits"] + m["plan_cache_misses"] >= 1


def test_invalidation_counter_has_reasons():
    from yjs_tpu_torch.obs import global_registry, registry_snapshot

    def series():
        snap = registry_snapshot(global_registry())
        return dict(
            snap["counters"].get("ytpu_plan_cache_invalidations_total", {})
        )

    before = series()
    eng = BatchEngine(1)
    d = Y.Doc(gc=False)
    d.client_id = 1
    d.get_text("text").insert(0, "x")
    eng.queue_update(0, encode_state_as_update(d))
    eng.flush()
    eng.reset_doc(0)
    after = series()
    assert after.get("reason=reset", 0) == before.get("reason=reset", 0) + 1
