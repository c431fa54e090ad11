"""The cases of the JAX package's ``tests/test_segment_planner.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Device-authoritative cold planning suite.

The correctness bar: under every seeded corpus shape (prepend-storm,
interleaved, 4-client conflict storm, B4-texture trace head) the
device-planned integration must equal the sequential YATA walk
**struct-for-struct** — identical sched/link/head/delete plans — and
the engine must converge byte-identically `YTPU_PLAN_SEGMENT=device`
vs `off` on both native and pure-Python mirrors, including across
demotion→promotion and kill-primary failover.  Plus the
pins: snapshot reuse on monotone prepend runs (the
`plan_snapshot` host op must stay cold) and the fast-set/residue
metrics accounting.
"""

import random

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.obs import FLUSH_METRICS_SCHEMA
from yjs_tpu_torch.obs.prof import kernel_profiler
from torch_service import BatchEngine
from yjs_tpu_torch.ops import plan_cache
from yjs_tpu_torch.ops import segment_planner
from yjs_tpu_torch.ops.columns import DocMirror
from yjs_tpu_torch.updates import (
    apply_update,
    encode_state_as_update,
    encode_state_vector,
)

pytestmark = pytest.mark.planner

SHAPES = ("prepend_storm", "interleaved", "storm", "b4_head")


@pytest.fixture(autouse=True)
def _fresh_cache():
    plan_cache.reset_cache()
    yield
    plan_cache.reset_cache()


def corpus(shape: str, seed: int, n_ops: int = 90) -> list[bytes]:
    """Seeded incremental updates from concurrent editors, one list per
    (shape, seed).  ``b4_head`` reproduces the head of the B4 fixture's
    editing texture (scripts/gen_b4_fixture.py): single-char typing and
    backspace runs at a mostly-sequential cursor, periodic syncs."""
    gen = random.Random(seed)
    n_clients = 4 if shape == "storm" else 2 if shape == "b4_head" else 3
    docs = []
    for k in range(n_clients):
        d = Y.Doc(gc=False)
        d.client_id = 300 + k
        docs.append(d)
    out: list[bytes] = []
    cursors = {id(d): 0 for d in docs}
    j = 0
    while len(out) < n_ops:
        if shape == "b4_head" and gen.random() < 0.1:
            j = gen.randrange(n_clients)
        elif shape != "b4_head":
            j = gen.randrange(n_clients)
        d = docs[j]
        t = d.get_text("text")
        sv = encode_state_vector(d)
        if shape == "prepend_storm":
            t.insert(0, gen.choice("abcdef") * gen.randint(1, 2))
        elif shape == "storm":
            t.insert(min(len(t), gen.randrange(3)), gen.choice("xyz "))
        elif shape == "b4_head":
            cur = min(cursors[id(d)], len(t))
            if gen.random() < 0.05:
                cur = gen.randint(0, len(t))
            if len(t) and cur and gen.random() < 0.3:
                t.delete(cur - 1, 1)  # backspace
                cur -= 1
            else:
                t.insert(cur, gen.choice("etaoin shr"))
                cur += 1
            cursors[id(d)] = cur
        elif len(t) and gen.random() < 0.25:
            t.delete(gen.randrange(len(t)), 1)
        else:
            t.insert(gen.randrange(len(t) + 1), gen.choice("abcdef "))
        out.append(encode_state_as_update(d, sv))
        sync_p = 0.05 if shape == "storm" else 0.3
        if gen.random() < sync_p:
            k = gen.randrange(n_clients)
            if k != j:
                apply_update(docs[k], encode_state_as_update(d))
    return out


# -- oracle: device-planned ranks == sequential YATA walk ---------------------


def plan_tuple(p):
    return (
        p.sched, p.splits, p.link_rows, p.link_vals,
        p.head_segs, p.head_vals, sorted(p.delete_rows),
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_device_ranks_match_sequential_walk(shape, monkeypatch):
    """Struct-for-struct: every flush's sched entries, link writes, head
    writes and delete rows must be identical between the authoritative
    device plan and the pure sequential walk."""
    updates = corpus(shape, seed=15)

    def drive(mode):
        monkeypatch.setenv("YTPU_PLAN_SEGMENT", mode)
        m = DocMirror("text", device="cpu")
        plans = []
        for j, u in enumerate(updates):
            m.ingest(u, False)
            if (j + 1) % 6 == 0 or j == len(updates) - 1:
                plans.append(plan_tuple(m.prepare_step()))
        return plans, m.encode_state_as_update(), m.plan_frontier

    ref = drive("off")
    for mode in ("device", "np", "jax"):
        assert drive(mode) == ref, f"mode={mode} diverged from walk"


@pytest.mark.parametrize("shape", SHAPES)
def test_native_plans_match_walk(shape, monkeypatch):
    """The native core's chain-run anchor adoption must not change one
    plan array either."""
    from yjs_tpu_torch.ops.native_mirror import NativeMirror, native_plan_available

    if not native_plan_available():
        pytest.skip("native plancore unavailable")
    updates = corpus(shape, seed=23)

    def drive(mode):
        monkeypatch.setenv("YTPU_PLAN_SEGMENT", mode)
        m = NativeMirror("text")
        plans = []
        for j, u in enumerate(updates):
            m.ingest(u, False)
            if (j + 1) % 6 == 0 or j == len(updates) - 1:
                p = m.prepare_step()
                plans.append((
                    p.sched.tolist(), p.splits.tolist(),
                    p.link_rows.tolist(), p.link_vals.tolist(),
                    p.head_segs.tolist(), p.head_vals.tolist(),
                    sorted(int(r) for r in p.delete_rows),
                ))
        return plans, m.encode_state_as_update(), m.plan_frontier

    assert drive("device") == drive("off")


# -- engine-level byte identity: device vs off --------------------------------


def run_engine(updates, n_docs, mode, monkeypatch, py=False, flush_every=6):
    monkeypatch.setenv("YTPU_PLAN_SEGMENT", mode)
    if py:
        monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    eng = BatchEngine(n_docs)
    deltas = {i: [] for i in range(n_docs)}
    eng.on_update(lambda i, u: deltas[i].append(u))
    sums = {"plan_segment_fast": 0, "plan_segment_residue": 0,
            "plan_threads": 0}
    keysets = set()
    for j, u in enumerate(updates):
        for i in range(n_docs):
            eng.queue_update(i, u)
        if (j + 1) % flush_every == 0 or j == len(updates) - 1:
            eng.flush()
            m = eng.last_flush_metrics
            keysets.add(frozenset(m))
            sums["plan_segment_fast"] += m["plan_segment_fast"]
            sums["plan_segment_residue"] += m["plan_segment_residue"]
            sums["plan_threads"] = max(
                sums["plan_threads"], m["plan_threads"]
            )
    states = [eng.encode_state_as_update(i) for i in range(n_docs)]
    texts = [eng.text(i) for i in range(n_docs)]
    return states, texts, deltas, sums, keysets


@pytest.mark.parametrize("py", [False, True], ids=["native", "python"])
@pytest.mark.parametrize("shape", ["prepend_storm", "storm", "b4_head"])
def test_engine_device_vs_off_byte_identical(shape, py, monkeypatch):
    updates = corpus(shape, seed=31)
    monkeypatch.setenv("YTPU_PLAN_CACHE", "0")
    s_dev, t_dev, d_dev, sums_dev, keys_dev = run_engine(
        updates, 3, "device", monkeypatch, py=py
    )
    s_off, t_off, d_off, sums_off, keys_off = run_engine(
        updates, 3, "off", monkeypatch, py=py
    )
    assert (t_dev, s_dev, d_dev) == (t_off, s_off, d_off)
    # the off lane really is the pure walk: zero fast-set structs
    assert sums_off["plan_segment_fast"] == 0
    assert sums_off["plan_segment_residue"] == 0
    # ONE metrics schema either way
    assert keys_dev == keys_off == {frozenset(FLUSH_METRICS_SCHEMA)}


def test_device_mode_counts_fast_set(monkeypatch):
    """Typing/prepend-heavy traffic must actually exercise the fast set
    (bulk integration from device ranks), not silently fall back."""
    updates = corpus("prepend_storm", seed=47)
    monkeypatch.setenv("YTPU_PLAN_CACHE", "0")
    _s, _t, _d, sums, _k = run_engine(
        updates, 2, "device", monkeypatch, py=True
    )
    assert sums["plan_segment_fast"] > 0


# -- plan-cache interop: warm hits byte-identical, cache on vs off ------------


def test_device_plans_fold_same_frontier_as_walk(monkeypatch):
    """Cache interop is exact: a device-planned prepare folds the same
    frontier digest as the walk, so warm cache hits replay states that
    are byte-identical across planner modes."""
    updates = corpus("interleaved", seed=7)
    monkeypatch.setenv("YTPU_PLAN_CACHE", "1")
    plan_cache.reset_cache()
    s_on, t_on, d_on, _s1, _k1 = run_engine(
        updates, 2, "device", monkeypatch, py=True
    )
    plan_cache.reset_cache()
    monkeypatch.setenv("YTPU_PLAN_CACHE", "0")
    s_off, t_off, d_off, _s2, _k2 = run_engine(
        updates, 2, "device", monkeypatch, py=True
    )
    assert (t_on, s_on, d_on) == (t_off, s_off, d_off)


# -- lifecycle: demotion→promotion and failover with the planner on -----------


def test_demotion_promotion_device_vs_off(monkeypatch):
    from torch_service import TpuProvider
    from yjs_tpu_torch.tiering import TierConfig

    def upd(text, cid=1, at=0):
        d = Y.Doc(gc=False)
        d.client_id = cid
        d.get_text("text").insert(at, text)
        return encode_state_as_update(d)

    def drive(mode):
        monkeypatch.setenv("YTPU_PLAN_SEGMENT", mode)
        plan_cache.reset_cache()
        p = TpuProvider(2, tier_config=TierConfig(enabled=True))
        p.receive_update("r", upd("round trip "))
        p.flush()
        assert p.demote_doc("r", "warm")
        assert p.text("r") == "round trip "  # demand promotion
        p.receive_update("r", upd("second", cid=2))
        p.flush()
        return Y.merge_updates([p.encode_state_as_update("r")]), p.text("r")

    assert drive("device") == drive("off")


def test_failover_promotion_with_planner_on(tmp_path, monkeypatch):
    """Kill-primary failover with the segment planner on (the default):
    promoted slots rebuild from journals and must converge to the
    uninterrupted reference byte-for-byte."""
    from yjs_tpu_torch.fleet import FailoverConfig
    from torch_service import FleetRouter
    from yjs_tpu_torch.persistence import WalConfig

    monkeypatch.setenv("YTPU_PLAN_SEGMENT", "device")
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
    fleet.tick()
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
    d = rooms["room-0"]
    sv = encode_state_vector(d)
    d.get_text("text").insert(0, "after! ")
    fleet.receive_update("room-0", encode_state_as_update(d, sv))
    assert fleet.text("room-0") == d.get_text("text").to_string()


# -- satellite 6: monotone runs reuse the sorted segment ----------------------


def _snapshot_ops() -> int:
    return kernel_profiler().host_op_stats().get(
        "plan_snapshot", {"count": 0}
    )["count"]


def test_monotone_prepend_skips_snapshot_rebuild(monkeypatch):
    """A pure head-prepend run is one monotone chain: the planner must
    reuse the prior sorted segment instead of re-sorting (rebuilding)
    the whole fragment snapshot every flush."""
    monkeypatch.setenv("YTPU_PLAN_SEGMENT", "device")
    d = Y.Doc(gc=False)
    d.client_id = 9
    t = d.get_text("text")
    m = DocMirror("text", device="cpu")
    before = _snapshot_ops()
    for j in range(120):
        sv = encode_state_vector(d)
        t.insert(0, "p")
        m.ingest(encode_state_as_update(d, sv), False)
        if (j + 1) % 12 == 0:
            m.prepare_step()
    assert _snapshot_ops() == before, (
        "head-prepend flushes must not rebuild the fragment snapshot"
    )
    ref = Y.Doc(gc=False)
    apply_update(ref, m.encode_state_as_update())
    assert ref.get_text("text").to_string() == t.to_string()


def test_conflicted_runs_still_build_snapshot(monkeypatch):
    """The reuse shortcut must not swallow real anchor lookups: a
    conflicted corpus with many non-chained anchors rebuilds."""
    monkeypatch.setenv("YTPU_PLAN_SEGMENT", "device")
    updates = corpus("interleaved", seed=3, n_ops=120)
    m = DocMirror("text", device="cpu")
    before = _snapshot_ops()
    for j, u in enumerate(updates):
        m.ingest(u, False)
        if (j + 1) % 30 == 0 or j == len(updates) - 1:
            m.prepare_step()
    assert _snapshot_ops() > before


# -- whole-chunk planner internals --------------------------------------------


def test_plan_chunk_matches_per_doc_plans(monkeypatch):
    """plan_chunk's doc-composed global keys must resolve the same
    hints/chains as independent per-doc plan_doc calls."""
    monkeypatch.setenv("YTPU_PLAN_SEGMENT", "device")
    shapes = ["prepend_storm", "storm", "interleaved", "b4_head"]
    tokens = []
    for k, shape in enumerate(shapes):
        m = DocMirror("text", device="cpu")
        for u in corpus(shape, seed=60 + k, n_ops=40):
            m.ingest(u, False)
        tokens.append((m, m.prepare_step_begin()))
    items = [(tok.queries, m._segment_snapshot) for m, tok in tokens]
    chunked = segment_planner.plan_chunk(items, mode="device", device="cpu")
    solo = [
        segment_planner.plan_doc(q, mode="jax", snapshot=snap,
                                 device="cpu")
        for q, snap in items
    ]
    assert len(chunked) == len(solo)
    for c, s in zip(chunked, solo):
        if c is None or s is None:
            assert c is None and s is None
            continue
        assert c.spans == s.spans
        assert (c.chain_l == s.chain_l).all()
        assert (c.chain_r == s.chain_r).all()
        if c.hint_l is None or s.hint_l is None:
            assert c.snapshot_reused == s.snapshot_reused
        else:
            assert (c.hint_l == s.hint_l).all()
            assert (c.hint_r == s.hint_r).all()
    # the mirrors are mid-prepare; finish them so nothing leaks poisoned
    for (m, tok), sp in zip(tokens, chunked):
        m.prepare_step_finish(tok, sp)


def test_modes_table_is_closed():
    assert set(segment_planner.MODES) == {"device", "np", "jax", "off"}
    assert segment_planner.plan_segment_mode() in segment_planner.MODES
