"""The port's on-device YATA lanes (``YTPU_KERNEL=levels|seq``) against the
JAX package's, on the CPU.

Two layers, both compared exactly (integer tables: tolerance 0):

- the kernels: the plain PyTorch versions of ``scatter_statics``,
  ``batch_step`` and ``batch_step_levels`` (what the port's wrappers take
  for CPU tensors) against the jitted JAX ``_scatter_statics``,
  ``batch_step`` and ``batch_step_levels`` on the same numpy inputs, built
  from ``DocMirror`` plans by ``test_torch_cuda.yata_case`` flush by
  flush, with client ids at and above 2**31, deferred (true-conflict)
  level lanes, split pre-passes and deletes;
- the engine: ``yjs_tpu_torch.ops.BatchEngine(device="cpu")`` on the
  levels and seq lanes against ``yjs_tpu.ops.BatchEngine`` on the same
  lanes and against the port's own apply lane: device tables trimmed to
  live rows, resident statics, ``text``/``to_json``/``map_json`` exports
  (``tests/conftest.py`` sets ``YTPU_EXPORT_DEVICE=1``, so exports rank
  the device tables) and flush-metric key sets.

Each JAX engine run is made once per corpus, in a module-scoped fixture,
with ``YTPU_FLUSH_PIPELINE=0`` (ROADMAP caveat R1).  Nothing here depends
on whether the JAX package's native planner loaded (caveat R3): its
Python mirror plans the same steps.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yjs_tpu as Y
from test_flush_pipeline import SHAPES, make_trace
from test_native_plan import two_client_session
from test_torch_cuda import YATA_CLIENTS, statics_case, yata_case, yata_tables
from yjs_tpu.ops import BatchEngine as JaxEngine
from yjs_tpu.ops import kernels as jk
from yjs_tpu.ops import plan_cache as jax_plan_cache
from yjs_tpu.ops.engine import _scatter_statics as jax_scatter_statics
from yjs_tpu_torch.obs import FLUSH_METRICS_SCHEMA
from yjs_tpu_torch.ops import BatchEngine as TorchEngine
from yjs_tpu_torch.ops import kernels as tk
from yjs_tpu_torch.ops import plan_cache as torch_plan_cache
from yjs_tpu_torch.ops.carry import tables_from_numpy, trim_tables
from yjs_tpu_torch.ops.engine import _STATIC_COLS

# -- the kernels ------------------------------------------------------------------


def _jax_statics(stage):
    return {
        k: jnp.asarray(stage[k].view(np.uint32) if k == "client_key"
                       else stage[k])
        for k in tk.STATIC_KEYS
    }


def _torch_statics(stage):
    return {k: torch.from_numpy(stage[k].copy()) for k in tk.STATIC_KEYS}


def _to(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_static_keys_follow_the_packed_rows():
    assert tk.STATIC_KEYS == tuple(k for k, _f, _d in _STATIC_COLS)


@pytest.mark.parametrize("shape", [(1, 65, 8), (3, 129, 200), (16, 257, 900)])
def test_scatter_statics_plain_matches_jax(shape):
    b, n1, k = shape
    cols, packed = statics_case(23 + b, b, n1, k)
    want = jax_scatter_statics(
        {key: jnp.asarray(c.view(np.uint32) if key == "client_key" else c)
         for key, c in zip(tk.STATIC_KEYS, cols)},
        jnp.asarray(packed),
    )
    got = tk.scatter_statics(
        dict(zip(tk.STATIC_KEYS, (torch.from_numpy(c.copy()) for c in cols))),
        torch.from_numpy(packed),
    )
    for key in tk.STATIC_KEYS:
        np.testing.assert_array_equal(
            np.asarray(want[key]).view(np.int32), got[key].numpy()
        )


# sixteen concurrent editors, half of their ids at or above 2**31
MANY_CLIENTS = tuple(range(1, 9)) + tuple(2**32 - k for k in range(1, 9))

# (seed, b, w_pad, clients, n_ops, cap_min): client ids at and above 2**31
# beside small ones, a padded lane width, small ids only, sixteen editors
# whose level lanes defer about a quarter of the time (117 of 471 lanes,
# four times the others' count), and N+1 = 65537, past what one block's
# shared memory holds (the global variant on the card)
KERNEL_CASES = [
    (31, 4, 1, YATA_CLIENTS, 60, 64),
    (34, 3, 33, YATA_CLIENTS, 60, 64),
    (36, 5, 1, (11, 12, 13), 60, 64),
    (40, 4, 1, MANY_CLIENTS, 120, 64),
    (42, 2, 1, YATA_CLIENTS, 60, 65536),
]


@pytest.fixture(scope="module", params=KERNEL_CASES, ids=lambda c: f"seed{c[0]}")
def kernel_case(request):
    seed, b, w_pad, clients, n_ops, cap_min = request.param
    cap, s1, stages = yata_case(seed, b, n_ops=n_ops, w_pad=w_pad,
                                cap_min=cap_min, clients=clients,
                                uniform=True)
    want = {}
    for name in ("seq", "levels"):
        dyn = tuple(jnp.asarray(a) for a in yata_tables(b, cap, s1))
        out = []
        for st in stages:
            if name == "seq":
                dyn = jk.batch_step(
                    _jax_statics(st), dyn, jnp.asarray(st["splits"]),
                    jnp.asarray(st["sched"]), jnp.asarray(st["dels"]),
                )
            else:
                dyn = jk.batch_step_levels(
                    _jax_statics(st), dyn, jnp.asarray(st["splits"]),
                    jnp.asarray(st["lv"]), jnp.asarray(st["dels"]),
                    jnp.asarray(st["scratch"]),
                )
            out.append(tuple(np.asarray(a) for a in dyn))
        want[name] = out
    return b, cap, s1, stages, want


@pytest.mark.parametrize("epoch_max", [None, 40])
@pytest.mark.parametrize("name", ["seq", "levels"])
def test_yata_plain_matches_jax(kernel_case, name, epoch_max, monkeypatch):
    """Flush by flush, the plain K5/K6 give the JAX kernels' tables; an
    ``EPOCH_MAX`` of 40 restarts the visit epoch many times a launch and
    changes nothing."""
    if epoch_max is not None:
        monkeypatch.setattr(tk, "EPOCH_MAX", epoch_max)
    b, cap, s1, stages, want = kernel_case
    plain = tk.batch_step_plain if name == "seq" else tk.batch_step_levels_plain
    dyn = tuple(torch.from_numpy(a) for a in yata_tables(b, cap, s1))
    stats = tk.new_yata_stats(b)
    for st, w in zip(stages, want[name]):
        if name == "seq":
            plain(_torch_statics(st), dyn, _to(st["splits"]), _to(st["sched"]),
                  _to(st["dels"]), stats)
        else:
            plain(_torch_statics(st), dyn, _to(st["splits"]), _to(st["lv"]),
                  _to(st["dels"]), _to(st["scratch"]), stats)
        for a, g in zip(w, dyn):
            np.testing.assert_array_equal(a, g.numpy())
    scanned = int(stats["scanned"].sum())
    assert 0 < scanned <= int(stats["scan_steps"].sum())
    if name == "levels":
        assert scanned <= int(stats["deferred"].sum())
        assert int(stats["deferred"].sum()) > 0


# cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100 (227 KB)
H100_SMEM_OPTIN = 232448


@pytest.mark.parametrize("n1, s1, w, want", [
    (129, 9, 10, "shared"),
    (1025, 9, 0, "shared"),
    (1437, 9, 239, "rows"),  # chip_smoke's broadcast step (K7b)
    (2049, 9, 0, "rows"),
    (2049, 9, 512, "rows"),
    (4097, 9, 512, "global"),  # chip_smoke's level steps (K6, K15)
    (4097, 9, 0, "global"),  # its per-item step (K5)
    (65537, 9, 512, "global"),
])
def test_yata_variant_by_size(n1, s1, w, want):
    """The YATA steps' variant depends on N+1, S+1 and W alone: the first
    whose staged doc lets an SM of the card (its opt-in limit plus a
    block's reserve) hold YATA_MIN_DOCS_SM docs beside the static shared
    memory; the one before it does not."""
    variant, nbytes = tk.yata_variant(n1, s1, w, H100_SMEM_OPTIN)
    assert variant == want
    assert nbytes == tk.yata_smem_bytes(n1, s1, w, want)
    sm = H100_SMEM_OPTIN + tk.YATA_RESERVED_SMEM

    def docs(v):
        block = (tk.yata_smem_bytes(n1, s1, w, v) + tk.YATA_STATIC_SMEM
                 + tk.YATA_RESERVED_SMEM)
        return sm // block

    i = tk.YATA_VARIANTS.index(want)
    if want != "global":
        assert docs(want) >= tk.YATA_MIN_DOCS_SM
        assert nbytes + tk.YATA_STATIC_SMEM <= H100_SMEM_OPTIN
    for before in tk.YATA_VARIANTS[:i]:
        assert docs(before) < tk.YATA_MIN_DOCS_SM
    # the rows in whole 16-byte words, each with room for its alignment
    words = lambda n: -(-n // 4) * 4  # noqa: E731
    rows = 4 * (words(n1 + 3) + words(s1 + 3)) + w
    assert tk.yata_smem_bytes(n1, s1, w, "rows") == rows
    assert tk.yata_smem_bytes(n1, s1, w, "shared") == rows + 4 * words(n1)
    st_at, visit_at, fast_at, total = tk.yata_layout(n1, s1, w, "shared")
    assert (st_at, visit_at) == (words(n1 + 3), words(n1 + 3) + words(s1 + 3))
    assert (4 * fast_at + w, total) == (rows + 4 * words(n1), total)
    assert tk.yata_layout(n1, s1, w, "global") == (0, 0, 0, 0)
    assert tk.yata_variant(n1, s1, w, 0) == ("global", 0)


def test_kernel_cases_cover_splits_deletes_and_big_clients():
    cap, s1, stages = yata_case(31, 4, uniform=True)
    assert any((st["splits"][..., 0] >= 0).any() for st in stages)
    assert any((st["dels"] >= 0).any() for st in stages)
    assert any((st["lv"][..., 0] >= 0).sum(-1).max() > 1 for st in stages)
    keys = stages[-1]["client_key"].view(np.uint32)
    assert (keys >= 2**31).any() and ((keys > 0) & (keys < 2**31)).any()


def test_unsigned_client_order_decides_case_one():
    """Two clients insert at one position: the lower id goes left, with
    ids compared unsigned (2**31 + 5 sorts after 7)."""
    texts = {}
    for first, second in ((7, 2**31 + 5), (2**31 + 5, 7)):
        ups = []
        for cid, s in ((first, "A"), (second, "B")):
            d = Y.Doc(gc=False)
            d.client_id = cid
            d.get_text("text").insert(0, s)
            ups.append(Y.encode_state_as_update(d))
        oracle = Y.Doc(gc=False)
        for u in ups:
            Y.apply_update(oracle, u)
        for mode in ("seq", "levels"):
            eng = TorchEngine(1, device="cpu")
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("YTPU_KERNEL", mode)
                for u in ups:
                    eng.queue_update(0, u)
                eng.flush()
            texts[(first, mode)] = eng.text(0)
        assert texts[(first, "seq")] == texts[(first, "levels")] == (
            oracle.get_text("text").to_string()
        )
    assert texts[(7, "seq")] == "AB" and texts[(2**31 + 5, "seq")] == "BA"


# -- the engine -------------------------------------------------------------------


def _reset_caches():
    jax_plan_cache.reset_cache()
    torch_plan_cache.reset_cache()


def drive(engine, per_doc, flush_every, mode, exports=("list", "meta"),
          check=None):
    """Queue step j's update of every doc, flushing every ``flush_every``
    steps under ``YTPU_KERNEL=mode`` (a tuple cycles through lanes flush
    by flush; None unsets it), calling ``check(engine, lane)`` after each
    flush; returns what the comparisons read."""
    n = engine.n_docs
    keysets, tables = set(), []
    steps = max(len(u) for u in per_doc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YTPU_FLUSH_PIPELINE", "0")
        for j in range(steps):
            for i, ups in enumerate(per_doc):
                if j < len(ups):
                    engine.queue_update(i, ups[j])
            if (j + 1) % flush_every == 0 or j == steps - 1:
                lane = mode[len(tables) % len(mode)] if isinstance(
                    mode, tuple) else mode
                if lane is None:
                    mp.delenv("YTPU_KERNEL", raising=False)
                else:
                    mp.setenv("YTPU_KERNEL", lane)
                engine.flush()
                if check is not None:
                    check(engine, lane)
                keysets.add(frozenset(engine.last_flush_metrics))
                tables.append(trim_tables(engine, statics=True))
    return {
        "texts": [engine.text(i) for i in range(n)],
        "lists": [engine.to_json(i, exports[0]) for i in range(n)],
        "maps": [engine.map_json(i, exports[1]) for i in range(n)],
        "keysets": keysets,
        "tables": tables,
    }


def assert_tables_equal(want, got, statics=True):
    assert len(want) == len(got)
    for tw, tg in zip(want, got):
        for dw, dg in zip(tw, tg):
            assert (dw is None) == (dg is None)
            if dw is None:
                continue
            for a, b in zip(dw[:3], dg[:3]):
                np.testing.assert_array_equal(a, b)
            if statics:
                assert (dw[3] is None) == (dg[3] is None)
                if dw[3] is not None:
                    for key in tk.STATIC_KEYS:
                        np.testing.assert_array_equal(dw[3][key], dg[3][key])


def rich_corpus():
    updates, _a, _b = two_client_session(random.Random(5), 40, rich=True)
    return [updates, updates], 7


def trace_corpus():
    return [make_trace(s, seed=70 + i, n_ops=40) for i, s in
            enumerate(SHAPES)], 5


def deleted_split_corpus():
    """The deleted-run split of tests/test_native_plan.py: a later flush
    splits an already-deleted run, whose new fragment must stay deleted."""
    a = Y.Doc(gc=False)
    a.client_id = 1
    a.get_text("text").insert(0, "hello")
    u1 = Y.encode_state_as_update(a)
    sv1 = Y.encode_state_vector(a)
    b = Y.Doc(gc=False)
    b.client_id = 2
    Y.apply_update(b, u1)
    a.get_text("text").delete(0, 5)
    u2 = Y.encode_state_as_update(a, sv1)
    b.get_text("text").insert(1, "X")
    u3 = Y.encode_state_as_update(b, sv1)
    return [[u1, u2, u3]], 1


def origin_moves_corpus():
    """Flush 2 splits "hello" at "he|llo", so the row holding "Z"'s origin
    (after "hell") becomes the new fragment: an existing row's origin_row
    changes, and the next device-lane flush (flush 3, which splits
    nothing) must re-upload it.  Flush 1 is "hello" and "Z" together."""

    def doc(cid, *ups):
        d = Y.Doc(gc=False)
        d.client_id = cid
        for u in ups:
            Y.apply_update(d, u)
        return d

    a = doc(1)
    a.get_text("text").insert(0, "hello")
    u1 = Y.encode_state_as_update(a)
    sv1 = Y.encode_state_vector(a)
    c = doc(3, u1)
    c.get_text("text").insert(4, "Z")
    b = doc(2, u1)
    b.get_text("text").insert(2, "X")
    u2 = Y.encode_state_as_update(b, sv1)
    u13 = Y.encode_state_as_update(c)
    d = doc(4, u13, u2)
    sv = Y.encode_state_vector(d)
    d.get_text("text").insert(len(d.get_text("text")), "!")
    return [[u13, u2, Y.encode_state_as_update(d, sv)]], 1


CORPORA = {
    "rich": rich_corpus,
    "traces": trace_corpus,
    "deleted_split": deleted_split_corpus,
    "origin_moves": origin_moves_corpus,
}


@pytest.fixture(scope="module", params=sorted(CORPORA))
def corpus(request):
    """One corpus through the JAX engine on both device lanes (once per
    module) and through the port on all three lanes."""
    per_doc, every = CORPORA[request.param]()
    out = {"per_doc": per_doc, "every": every, "name": request.param}
    for mode in ("levels", "seq"):
        _reset_caches()
        out[("jax", mode)] = drive(JaxEngine(len(per_doc)), per_doc, every, mode)
    for mode in ("apply", "levels", "seq"):
        _reset_caches()
        out[("torch", mode)] = drive(
            TorchEngine(len(per_doc), device="cpu"), per_doc, every, mode
        )
    return out


def _exports(run):
    return run["texts"], run["lists"], run["maps"]


@pytest.mark.parametrize("mode", ["levels", "seq"])
def test_engine_lane_matches_jax(corpus, mode):
    want, got = corpus[("jax", mode)], corpus[("torch", mode)]
    assert _exports(got) == _exports(want)
    assert got["keysets"] == want["keysets"] == {frozenset(FLUSH_METRICS_SCHEMA)}
    assert_tables_equal(want["tables"], got["tables"])


@pytest.mark.parametrize("mode", ["levels", "seq"])
def test_engine_lane_matches_apply_lane(corpus, mode):
    want, got = corpus[("torch", "apply")], corpus[("torch", mode)]
    assert _exports(got) == _exports(want)
    assert got["keysets"] == want["keysets"]
    assert_tables_equal(want["tables"], got["tables"], statics=False)


def test_engine_lanes_match_the_oracle(corpus):
    for i, ups in enumerate(corpus["per_doc"]):
        doc = Y.Doc(gc=False)
        for u in ups:
            Y.apply_update(doc, u)
        want = doc.get_text("text").to_string()
        for mode in ("levels", "seq"):
            assert corpus[("torch", mode)]["texts"][i] == want


def assert_statics_current(eng, lane):
    """After a device-lane flush every doc's resident statics are its
    mirror's static columns (every corpus doc flushes every time)."""
    if lane in (None, "apply"):
        return
    for i, m in enumerate(eng.mirrors):
        assert eng._uploaded_rows[i] == m.n_rows
        cols = m.static_columns()
        for key in tk.STATIC_KEYS:
            dev = eng._statics[key][i, : m.n_rows].numpy()
            want = cols[key].astype(np.uint32).view(np.int32) if (
                key == "client_key") else cols[key]
            np.testing.assert_array_equal(dev, want, err_msg=key)


@pytest.mark.parametrize("mode", ["levels", "seq"])
def test_engine_statics_equal_the_mirrors(corpus, mode):
    per_doc, every = corpus["per_doc"], corpus["every"]
    drive(TorchEngine(len(per_doc), device="cpu"), per_doc, every, mode,
          check=assert_statics_current)


def test_bogus_kernel_runs_the_levels_lane(corpus):
    """Any YTPU_KERNEL other than apply and seq takes the levels lane, as
    in the JAX engine."""
    per_doc, every = corpus["per_doc"], corpus["every"]
    _reset_caches()
    got = drive(TorchEngine(len(per_doc), device="cpu"), per_doc, every,
                "bogus")
    want = corpus[("jax", "levels")]
    assert _exports(got) == _exports(want)
    assert_tables_equal(want["tables"], got["tables"])


def test_carry_moves_statics_between_packages(corpus):
    """The JAX levels engine's tables and statics, carried into the port,
    equal the port's levels engine's after the same flushes."""
    per_doc, every = corpus["per_doc"], corpus["every"]
    jeng = JaxEngine(len(per_doc))
    teng = TorchEngine(len(per_doc), device="cpu")
    for eng in (jeng, teng):
        _reset_caches()
        drive(eng, per_doc, every, "levels")
    carried = tables_from_numpy(
        np.asarray(jeng._right), np.asarray(jeng._deleted),
        np.asarray(jeng._starts), device="cpu",
        statics={k: np.asarray(v) for k, v in jeng._statics.items()},
    )
    own = (teng._right, teng._deleted, teng._starts, teng._statics)
    for a, b in zip(carried[:3], own[:3]):
        assert torch.equal(a, b)
    for key in tk.STATIC_KEYS:
        assert torch.equal(carried[3][key], own[3][key])


def test_multi_block_levels_match_one_block(corpus, monkeypatch):
    """YTPU_BLOCK_LEVELS=1 cuts every levels flush into one dispatch per
    level (splits in the first, deletes in the last): the untrimmed
    tables and statics equal those of one dispatch per flush."""
    per_doc, every = corpus["per_doc"], corpus["every"]
    calls = {"0": [], "1": []}
    step = tk.batch_step_levels
    engines = {}
    for block in ("0", "1"):

        def counted(*args, _calls=calls[block]):
            _calls.append(args[3].shape[1])
            return step(*args)

        monkeypatch.setattr(tk, "batch_step_levels", counted)
        monkeypatch.setenv("YTPU_BLOCK_LEVELS", block)
        _reset_caches()
        eng = TorchEngine(len(per_doc), device="cpu")
        drive(eng, per_doc, every, "levels")
        engines[block] = eng
    one, many = engines["0"], engines["1"]
    assert set(calls["1"]) == {1} and len(calls["1"]) == sum(calls["0"])
    if corpus["name"] in ("rich", "traces"):  # the others: a level a flush
        assert len(calls["1"]) > len(calls["0"])
    for name in ("_right", "_deleted", "_starts"):
        assert torch.equal(getattr(one, name), getattr(many, name))
    for key in tk.STATIC_KEYS:
        assert torch.equal(one._statics[key], many._statics[key])


@pytest.mark.parametrize("lanes", [("apply", "levels", "seq"),
                                   ("levels", None, "levels")])
def test_switching_lanes_between_flushes(corpus, lanes):
    """A doc that flushes on the apply lane (unset YTPU_KERNEL is apply)
    and then on a device lane re-uploads its statics from row 0 (an apply
    flush that split a run moved origin rows the device lane reads): the
    statics are current after every device-lane flush, and the mixed run
    equals one lane throughout, flush by flush."""
    per_doc, every = corpus["per_doc"], corpus["every"]
    _reset_caches()
    got = drive(TorchEngine(len(per_doc), device="cpu"), per_doc, every, lanes,
                check=assert_statics_current)
    for want in (corpus[("torch", "apply")], corpus[("jax", "levels")]):
        assert _exports(got) == _exports(want)
        assert_tables_equal(want["tables"], got["tables"], statics=False)


def test_compaction_reset_and_hydration_then_levels(monkeypatch):
    """Compaction (amortized and forced), reset_doc and a warm-tier
    round trip, each followed by levels flushes, hold to the JAX engine:
    tables, statics and compaction stats after every flush, exports at
    the end."""
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")
    monkeypatch.setenv("YTPU_KERNEL", "levels")
    per_doc = [make_trace(s, seed=90 + i, n_ops=48) for i, s in
               enumerate(SHAPES)]
    half = 24
    runs = {}
    for name, make in (("jax", lambda: JaxEngine(3, compact_min_rows=8)),
                       ("torch", lambda: TorchEngine(3, device="cpu",
                                                     compact_min_rows=8))):
        _reset_caches()
        eng = make()
        seen = []

        def flush(eng=eng, seen=seen):
            eng.flush()
            seen.append((trim_tables(eng, statics=True),
                         eng.last_compaction))

        for j in range(half):
            for i, ups in enumerate(per_doc):
                eng.queue_update(i, ups[j])
            if j % 6 == 5:
                flush()
        seen.append(eng.compact_docs([0]))
        mirror = eng.export_doc_columns(2)
        eng.reset_doc(2)
        eng.hydrate_doc_columns(2, mirror)
        eng.reset_doc(1)
        for u in per_doc[1][:half]:
            eng.queue_update(1, u)
        flush()
        for j in range(half, len(per_doc[0])):
            for i, ups in enumerate(per_doc):
                eng.queue_update(i, ups[j])
            if j % 6 == 5:
                flush()
        flush()
        runs[name] = (eng, seen)
    (jeng, jseen), (teng, tseen) = runs["jax"], runs["torch"]
    assert any(c for _t, c in jseen[:4]), "no amortized compaction ran"
    assert jseen[4], "compact_docs compacted nothing"
    assert len(jseen) == len(tseen)
    for w, g in zip(jseen, tseen):
        if isinstance(w, list):  # compact_docs stats
            assert w == g
            continue
        assert_tables_equal([w[0]], [g[0]])
        assert w[1] == g[1]
    for i, ups in enumerate(per_doc):
        doc = Y.Doc(gc=False)
        for u in ups:
            Y.apply_update(doc, u)
        assert teng.text(i) == jeng.text(i) == doc.get_text("text").to_string()
