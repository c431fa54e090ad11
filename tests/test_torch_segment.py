"""The port's segment planner and broadcast kernels against the JAX package.

Kernels K11 (``anchor_lookup``), K12 (``conflict_scan``, per doc and per
chunk), K7a (``apply_plan_shared``) and K7b
(``batch_step_levels_shared``): the plain PyTorch versions the port's
wrappers take for CPU tensors are held against the jitted JAX kernels on
the same seeded numpy inputs.  The segment planner's ``device`` and
``jax`` modes (the kernels on ``device="cpu"``) are held against the
port's ``np`` mode, and the Python-mirror engine
(``YTPU_NO_NATIVE_PLAN=1``) in the default ``device`` mode against the
JAX engine in the same mode (run with ``YTPU_FLUSH_PIPELINE=0``, ROADMAP
R1) and against the port's own ``off`` mode.

All data is integer, so the tolerance is 0 everywhere: results are equal
element for element, byte for byte.  One rule from ROADMAP R2: the JAX
package runs without x64, so its lookup truncates int64 keys to int32 and
its ``int64.max`` padding becomes -1.  K11 is held to
``np.searchsorted`` on keys past 2**31 with that padding, and to the JAX
kernel only where keys fit int32 and no padding is present; the port's
hints and ``plan_segment_*`` counters are held to the ``np`` mode, its
final state to every mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yjs_tpu as Y
from test_torch_cuda import (
    INT64_MAX,
    PLANNER_SHAPES,
    lookup_case,
    planner_corpus,
    scan_case,
    shared_case,
    trimmed,
)
from yjs_tpu.obs import FLUSH_METRICS_SCHEMA as JAX_SCHEMA
from yjs_tpu.ops import BatchEngine as JaxEngine
from yjs_tpu.ops import kernels as jk
from yjs_tpu.ops import plan_cache as jax_plan_cache
from yjs_tpu_torch.obs import FLUSH_METRICS_SCHEMA
from yjs_tpu_torch.ops import BatchEngine as TorchEngine
from yjs_tpu_torch.ops import kernels as tk
from yjs_tpu_torch.ops import plan_cache as torch_plan_cache
from yjs_tpu_torch.ops import segment_planner as tsp
from yjs_tpu_torch.ops.carry import trim_tables
from yjs_tpu_torch.ops.columns import DocMirror


@pytest.fixture(autouse=True)
def _fresh_caches():
    jax_plan_cache.reset_cache()
    torch_plan_cache.reset_cache()
    yield
    jax_plan_cache.reset_cache()
    torch_plan_cache.reset_cache()


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


# -- K12: conflict_scan -----------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 0), (2, 0), (59, 5), (300, 212),
                                   (1000, 24)])
@pytest.mark.parametrize("seed", [0, 1])
def test_conflict_scan_plain_matches_jax(seed, shape):
    """Both variants, with the planner's padding lanes; values fit int32,
    where the JAX kernels compute what int64 does."""
    n, pad = shape
    cols, doc_id = scan_case(seed * 10 + n, n, n_docs=6, pad=pad)
    want = jk._conflict_scan_jax(*cols)
    got = tk.conflict_scan(*_t(cols))
    assert got[2].dtype == torch.int64
    for w, g in zip(want, got):
        _eq(w, g)
    want = jk._chunk_conflict_scan_jax(doc_id, *cols)
    got = tk.conflict_scan(*_t(cols), torch.from_numpy(doc_id))
    for w, g in zip(want, got):
        _eq(w, g)
    assert not got[0][0] and not got[1][0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conflict_scan_is_true_int64(seed):
    """Clocks and client ids past 2**31: the plain version equals the
    NumPy planner (the JAX kernels would truncate, ROADMAP R2)."""
    cols, doc_id = scan_case(seed, 400, n_docs=9, pad=112, wide=True)
    got = tk.conflict_scan(*_t(cols), torch.from_numpy(doc_id))
    for w, g in zip(tk.plan_chunk_conflict_scan(doc_id, *cols), got):
        _eq(w, g)
    for w, g in zip(tk.plan_conflict_scan(*cols), tk.conflict_scan(*_t(cols))):
        _eq(w, g)


def test_conflict_scan_chains_a_known_batch():
    # ref 1 continues ref 0 (origin inside 0's range), ref 2 prepends
    # before ref 1 (right origin inside 1's range), ref 3 is another
    # doc's first ref, ref 4 breaks (origin past ref 3's end)
    client = [5, 5, 5, 5, 5]
    clock = [0, 3, 4, 0, 2]
    length = [3, 1, 1, 2, 1]
    o_cl, o_ck = [-1, 5, -1, 5, 5], [0, 2, 0, 3, 2]
    r_cl, r_ck = [-1, -1, 5, -1, -1], [0, 0, 3, 0, 0]
    doc = [0, 0, 0, 1, 1]
    cols = _t(np.asarray(c, np.int64) for c in
              (client, clock, length, o_cl, o_ck, r_cl, r_ck))
    left, right, run_id = tk.conflict_scan(*cols, torch.tensor(doc))
    assert left.tolist() == [False, True, False, False, False]
    assert right.tolist() == [False, False, True, False, False]
    assert run_id.tolist() == [1, 1, 1, 2, 3]


# -- K11: anchor_lookup -----------------------------------------------------------


@pytest.mark.parametrize("sizes", [(0, 5), (1, 64), (37, 300), (900, 4000)])
@pytest.mark.parametrize("wide", [False, True])
def test_anchor_lookup_plain_matches_numpy(sizes, wide):
    """int64 keys past 2**31, int64.max padding: equal to
    ``np.searchsorted(side="right") - 1``."""
    flat, q = lookup_case(sizes[0] + 3, *sizes, wide=wide)
    assert flat[-1] == INT64_MAX or sizes[0] == 64
    got = tk.anchor_lookup(torch.from_numpy(flat), torch.from_numpy(q))
    assert got.dtype == torch.int64
    _eq(np.searchsorted(flat, q, side="right") - 1, got)


@pytest.mark.parametrize("sizes", [(1, 64), (37, 300), (900, 4000)])
def test_anchor_lookup_plain_matches_jax_where_keys_fit_int32(sizes):
    flat, q = lookup_case(sizes[0] + 5, *sizes, pad=False)
    q = np.where(q > 2**31 - 1, 2**31 - 1, q)  # no key past int32
    want = jk._anchor_lookup_jax(flat, q)
    got = tk.anchor_lookup(torch.from_numpy(flat), torch.from_numpy(q))
    _eq(want, got)


def test_anchor_lookup_sorts_int64_max_padding_last():
    """ROADMAP R2's repro: the padded JAX lookup gives [1, 7, 7]; true
    int64, as NumPy does, gives [1, 4, 4]."""
    flat_slot = np.array([0, 0, 0, 1, 1], np.int64)
    flat_clock = np.array([0, 10, 20, 0, 5], np.int64)
    q_slot = np.array([0, 1, 1], np.int64)
    q_clock = np.array([15, 7, 100], np.int64)
    fk, qk = tk._compose_keys(flat_slot, flat_clock, q_slot, q_clock)
    fk = np.concatenate([fk, np.full(3, INT64_MAX)])
    got = tk.anchor_lookup(torch.from_numpy(fk), torch.from_numpy(qk))
    assert got.tolist() == [1, 4, 4]
    want_np = tk.plan_anchor_lookup(flat_slot, flat_clock, q_slot, q_clock)
    got_dev = tk.plan_anchor_lookup(flat_slot, flat_clock, q_slot, q_clock,
                                    backend="jax", device="cpu")
    assert want_np.tolist() == got_dev.tolist() == [1, 4, 4]


# -- K7a / K7b: the broadcast kernels ----------------------------------------------


def _jax_statics(statics):
    out = {k: jnp.asarray(v) for k, v in statics.items()}
    out["client_key"] = jnp.asarray(statics["client_key"].view(np.uint32))
    return out


@pytest.mark.parametrize("n_docs", [1, 4])
@pytest.mark.parametrize("seed", [3, 8])
def test_broadcast_kernels_plain_match_jax_and_each_other(seed, n_docs):
    """K7a and K7b's plain versions equal the JAX kernels on every table,
    untrimmed, and each other on the live rows (the B4 check of
    ``tests/test_native_plan.py::test_broadcast_kernels_agree``)."""
    case = shared_case(seed, n_docs)
    widths = (case["k_l"], case["k_h"], case["k_d"])
    want_a = jk.apply_plan_shared(
        tuple(jnp.asarray(t) for t in case["tables"]),
        jnp.asarray(case["lanes"]), *widths,
    )
    got_a = tk.apply_plan_shared(_t(case["tables"]),
                                 torch.from_numpy(case["lanes"]), *widths)
    for w, g in zip(want_a, got_a):
        _eq(w, g)
    shared = (case["splits"], case["lv"], case["dels"], case["scratch"])
    want_b = jk.batch_step_levels_shared(
        _jax_statics(case["statics"]),
        tuple(jnp.asarray(t) for t in case["tables"]),
        *(jnp.asarray(a) for a in shared),
    )
    got_b = tk.batch_step_levels_shared(
        {k: torch.from_numpy(v) for k, v in case["statics"].items()},
        _t(case["tables"]), *_t(shared),
    )
    for w, g in zip(want_b, got_b):
        _eq(w, g)
    for a, b in zip(trimmed(got_a, case["n"], case["n_segs"]),
                    trimmed(got_b, case["n"], case["n_segs"])):
        _eq(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_plan_shared_index_rules_match_jax(seed):
    """Random unique targets with negative indices (wrapped) and
    out-of-range ones (dropped) in every section."""
    g = np.random.default_rng(seed)
    b, n1, s1 = 3, 40, 9

    def section(width, k):
        idx = g.choice(np.arange(-3, width - 3), size=k, replace=False)
        idx[:2] = width + 4, -(width + 7)  # both out of range
        return idx

    rows, segs, dels = section(n1, 12), section(s1, 5), section(n1, 7)
    lanes = np.concatenate([rows, g.integers(-1, 40, 12), segs,
                            g.integers(-1, 40, 5), dels]).astype(np.int32)
    tables = (g.integers(-1, 40, (b, n1)).astype(np.int32),
              g.random((b, n1)) < 0.2,
              g.integers(-1, 40, (b, s1)).astype(np.int32))
    want = jk.apply_plan_shared(tuple(jnp.asarray(t) for t in tables),
                                jnp.asarray(lanes), 12, 5, 7)
    got = tk.apply_plan_shared(_t(tables), torch.from_numpy(lanes), 12, 5, 7)
    for w, gt in zip(want, got):
        _eq(w, gt)


# -- the segment planner: device and jax modes against np ---------------------------


def _tokens(shape: str, seed: int, n_ops: int = 40):
    """A mirror that planned the corpus' first half and has begun the
    second: anchors into rows of earlier flushes stay open."""
    m = DocMirror("text", device="cpu")
    ups = planner_corpus(shape, seed, n_ops)
    for j, u in enumerate(ups):
        if j == len(ups) // 2:
            m.prepare_step()
        m.ingest(u, False)
    return m, m.prepare_step_begin()


def _assert_plans_equal(want, got, chunk: bool = False):
    """``chunk``: ``got`` came out of a chunk, whose run ids number the
    runs of the whole chunk (as the reference's do): compare them from
    the doc's first run on."""
    if want is None or got is None:
        assert want is None and got is None
        return
    for name in ("chain_l", "chain_r", "run_id", "hint_l", "hint_r"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            assert w.dtype == g.dtype, name
            if chunk and name == "run_id":
                g = g - g[0] + w[0]
            _eq(w, g)
    assert want.spans == got.spans
    assert want.snapshot_reused == got.snapshot_reused


@pytest.mark.parametrize("mode", ["device", "jax"])
@pytest.mark.parametrize("shape", PLANNER_SHAPES)
def test_plan_doc_modes_match_np(shape, mode):
    """Per-doc plans of a real flush batch: chains, spans, hints and
    snapshot reuse equal the np mode's, with and without a snapshot."""
    m, tok = _tokens(shape, 60)
    for snap in (None, m._segment_snapshot):
        want = tsp.plan_doc(tok.queries, mode="np", snapshot=snap)
        got = tsp.plan_doc(tok.queries, mode=mode, snapshot=snap,
                           device="cpu")
        _assert_plans_equal(want, got)
    m.prepare_step_finish(tok, "auto")


def test_plan_chunk_device_matches_per_doc_np():
    """One chunk over the four shapes (each conflicted enough to need
    the lookup) equals per-doc np plans, and launches nothing on the
    CPU."""
    pairs = [_tokens(s, 61 + k, 50) for k, s in enumerate(PLANNER_SHAPES)]
    pairs += [_tokens("interleaved", 90, 120)]
    items = [(tok.queries, m._segment_snapshot) for m, tok in pairs]
    before = dict(tk.launches)
    chunked = tsp.plan_chunk(items, mode="device", device="cpu")
    assert tk.launches == before
    assert any(p is not None and p.hint_l is not None for p in chunked)
    for (q, snap), got in zip(items, chunked):
        _assert_plans_equal(tsp.plan_doc(q, mode="np", snapshot=snap), got,
                            chunk=True)
    for (m, tok), sp in zip(pairs, chunked):
        m.prepare_step_finish(tok, sp)


def test_plan_chunk_refuses_a_multi_device_mesh():
    m, tok = _tokens("storm", 5)
    items = [(tok.queries, m._segment_snapshot)] * 2

    class Mesh:
        class devices:
            size = 2

    with pytest.raises(NotImplementedError, match="item 10"):
        tsp.plan_chunk(items, mode="device", mesh=Mesh(), device="cpu")
    Mesh.devices.size = 1
    one = tsp.plan_chunk(items, mode="device", mesh=Mesh(), device="cpu")
    _assert_plans_equal(one[0], tsp.plan_doc(tok.queries, mode="np",
                                             snapshot=m._segment_snapshot))


def test_mirror_plans_on_its_device():
    """A mirror made outside an engine plans on CUDA and raises without
    it; one given the CPU plans there; a plan-cache clone keeps the
    device and an engine's replay gives the mirror the engine's."""
    ups = planner_corpus("interleaved", 7, 30)
    m = DocMirror("text")
    for u in ups:
        m.ingest(u, False)
    if torch.cuda.is_available():
        m.prepare_step()
    else:
        with pytest.raises(tk.KernelError, match="CUDA"):
            m.prepare_step()
    cpu = DocMirror("text", device="cpu")
    for u in ups:
        cpu.ingest(u, False)
    plan = cpu.prepare_step()
    ent = torch_plan_cache._PyEntry(cpu, plan)
    clone, _plan = ent.clone()
    assert clone.plan_device == "cpu"
    eng = TorchEngine(1, device="cpu")
    target = DocMirror("text")
    eng._replay_py(target, ent)
    assert target.plan_device == eng.device
    assert target.encode_state_as_update() == cpu.encode_state_as_update()


# -- the Python-mirror engine in the default mode ---------------------------------


def drive(engine, per_doc, flush_every=6):
    """Queue step j's update of every doc, flushing every ``flush_every``
    steps; returns what the comparison reads, with each flush's metrics."""
    n = engine.n_docs
    deltas = {i: [] for i in range(n)}
    engine.on_update(lambda i, u: deltas[i].append(u))
    keysets, tables, metrics = set(), [], []
    steps = max(len(u) for u in per_doc)
    for j in range(steps):
        for i, ups in enumerate(per_doc):
            if j < len(ups):
                engine.queue_update(i, ups[j])
        if (j + 1) % flush_every == 0 or j == steps - 1:
            engine.flush()
            keysets.add(frozenset(engine.last_flush_metrics))
            metrics.append(dict(engine.last_flush_metrics))
            tables.append(trim_tables(engine))
    return {
        "states": [Y.merge_updates([engine.encode_state_as_update(i)])
                   for i in range(n)],
        "texts": [engine.text(i) for i in range(n)],
        "deltas": deltas,
        "keysets": keysets,
        "tables": tables,
        "metrics": metrics,
    }


def _counters(out):
    return [(m["plan_segment_fast"], m["plan_segment_residue"])
            for m in out["metrics"]]


def _assert_tables(want, got):
    assert len(want) == len(got)
    for tw, tg in zip(want, got):
        for dw, dg in zip(tw, tg):
            assert (dw is None) == (dg is None)
            if dw is not None:
                for a, b in zip(dw, dg):
                    _eq(a, b)


def _per_doc(shape: str):
    """Four docs: three seeds of the shape and a copy of the first (an
    intra-flush duplicate key, replayed from its leader)."""
    per_doc = [planner_corpus(shape, seed=20 + i, n_ops=60) for i in range(3)]
    return per_doc + [per_doc[0]]


@pytest.mark.parametrize("shape", PLANNER_SHAPES)
def test_python_mirror_engine_matches_jax_in_device_mode(shape, monkeypatch):
    """Default mode on both packages: trimmed tables, texts, encoded
    states, emitted updates, metric key sets and ``plan_threads`` equal
    the JAX engine's; the segment counters equal the np mode's."""
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    monkeypatch.delenv("YTPU_PLAN_SEGMENT", raising=False)
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")
    per_doc = _per_doc(shape)
    want = drive(JaxEngine(4), per_doc)
    before = dict(tk.launches)
    eng = TorchEngine(4, device="cpu")
    got = drive(eng, per_doc)
    assert tk.launches == before  # the CPU engine launches no kernel
    assert type(eng.mirrors[0]) is DocMirror
    assert got["texts"] == want["texts"]
    assert got["states"] == want["states"]
    assert got["deltas"] == want["deltas"]
    assert want["keysets"] == {frozenset(JAX_SCHEMA)}
    assert got["keysets"] == {frozenset(FLUSH_METRICS_SCHEMA)}
    _assert_tables(want["tables"], got["tables"])
    threads = [m["plan_threads"] for m in got["metrics"]]
    assert threads == [m["plan_threads"] for m in want["metrics"]]
    assert max(threads) == 3  # the duplicate replays its leader's plan
    for m in got["metrics"]:
        assert m["n_demoted"] == m["n_rolled_back"] == 0
    torch_plan_cache.reset_cache()
    monkeypatch.setenv("YTPU_PLAN_SEGMENT", "np")
    np_mode = drive(TorchEngine(4, device="cpu"), per_doc)
    assert _counters(got) == _counters(np_mode)
    assert got["states"] == np_mode["states"]
    for i, ups in enumerate(per_doc):
        doc = Y.Doc(gc=False)
        for u in ups:
            Y.apply_update(doc, u)
        assert got["texts"][i] == doc.get_text("text").to_string()


@pytest.mark.parametrize("shape", ["prepend_storm", "storm", "b4_head"])
def test_python_mirror_engine_device_vs_off_byte_identical(shape,
                                                          monkeypatch):
    """The port's own A/B: device mode equals the pure host walk byte for
    byte (the off lane really is the walk: zero fast-set structs)."""
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    monkeypatch.setenv("YTPU_PLAN_CACHE", "0")
    ups = planner_corpus(shape, seed=31)
    out = {}
    for mode in ("device", "off"):
        monkeypatch.setenv("YTPU_PLAN_SEGMENT", mode)
        out[mode] = drive(TorchEngine(3, device="cpu"), [ups] * 3)
    dev, off = out["device"], out["off"]
    assert (dev["texts"], dev["states"], dev["deltas"]) == (
        off["texts"], off["states"], off["deltas"])
    assert all(c == (0, 0) for c in _counters(off))
    assert dev["keysets"] == off["keysets"] == {frozenset(FLUSH_METRICS_SCHEMA)}
    if shape == "prepend_storm":
        assert sum(f for f, _r in _counters(dev)) > 0


def test_planner_fault_replans_per_doc(monkeypatch):
    """A whole-chunk planner fault falls back to per-doc planning (the
    JAX engine's semantics): nothing is demoted or rolled back and the
    result equals the unfaulted run."""
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    monkeypatch.delenv("YTPU_PLAN_SEGMENT", raising=False)
    per_doc = _per_doc("interleaved")
    want = drive(TorchEngine(4, device="cpu"), per_doc)
    torch_plan_cache.reset_cache()
    calls = []

    def broken(*args, **kw):
        calls.append(1)
        raise RuntimeError("planner fault")

    monkeypatch.setattr(tsp, "plan_chunk", broken)
    got = drive(TorchEngine(4, device="cpu"), per_doc)
    assert calls
    assert (got["texts"], got["states"], got["deltas"]) == (
        want["texts"], want["states"], want["deltas"])
    _assert_tables(want["tables"], got["tables"])
    for m in got["metrics"]:
        assert m["n_demoted"] == m["n_rolled_back"] == 0


# -- a dead kernel stops the flush --------------------------------------------------


def _dead_kernel(*args, **kw):
    raise tk.KernelError("ytpu_conflict_scan: CUDA error 209 at launch")


@pytest.mark.parametrize("mode", ["device", "jax"])
@pytest.mark.parametrize("kernel", ["conflict_scan", "anchor_lookup"])
def test_dead_kernel_raises_and_demotes_nothing(kernel, mode, monkeypatch):
    """A planner kernel that does not build or launch is no fault of a
    doc: the flush raises :class:`KernelError` and no doc is replanned,
    demoted or sent to the CPU core (the wrapper stands in for its CUDA
    launch, which a CPU tensor never reaches)."""
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    monkeypatch.setenv("YTPU_PLAN_SEGMENT", mode)
    eng = TorchEngine(4, device="cpu")
    monkeypatch.setattr(tk, kernel, _dead_kernel)
    with pytest.raises(tk.KernelError, match="at launch"):
        drive(eng, _per_doc("interleaved"))
    assert not eng.fallback and not eng.demotions


def test_dead_kernel_in_the_per_doc_replan_raises(monkeypatch):
    """After a whole-chunk planner fault of the data, the per-doc replan
    reaches the same kernels: a dead one raises there too."""
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    monkeypatch.delenv("YTPU_PLAN_SEGMENT", raising=False)

    def faulty(*args, **kw):
        raise ValueError("planner fault")

    monkeypatch.setattr(tsp, "plan_chunk", faulty)
    monkeypatch.setattr(tk, "conflict_scan", _dead_kernel)
    eng = TorchEngine(4, device="cpu")
    with pytest.raises(tk.KernelError):
        drive(eng, _per_doc("interleaved"))
    assert not eng.fallback and not eng.demotions


def test_failed_build_is_a_kernel_error(monkeypatch):
    """A source nvcc rejects raises :class:`KernelError` with the
    compiler's message; nothing is bound."""
    import subprocess

    from yjs_tpu_torch.ops import _cuda

    def reject(stem, sources, cmd, timeout):
        raise subprocess.CalledProcessError(
            2, ["nvcc"], stderr=b"conflict_scan.cu(9): error: bad")

    monkeypatch.setattr(_cuda, "_fns", None)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_cuda, "build_shared", reject)
    with pytest.raises(tk.KernelError, match="error: bad"):
        _cuda.build_all()
    assert _cuda._fns is None


# -- the doc-free batch ops on the Python mirror ------------------------------------


def test_batch_ops_plan_on_the_device_they_are_given(monkeypatch):
    """Without the plan core, ``merge_updates_columnar``,
    ``diff_update_columnar`` and ``encode_state_vector_from_update_columnar``
    plan on the Python mirror: on ``device="cpu"`` through the planner's
    plain kernels, equal to the JAX package's versions byte for byte; with
    no device on a host without CUDA they raise :class:`KernelError`."""
    from yjs_tpu.ops import batch as jb
    from yjs_tpu_torch.ops import batch as tb

    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    monkeypatch.delenv("YTPU_PLAN_SEGMENT", raising=False)
    ups = planner_corpus("interleaved", 11, 40)
    head = Y.merge_updates(ups[:20])
    sv = Y.encode_state_vector_from_update(head)
    calls = []
    real = tk.conflict_scan
    monkeypatch.setattr(
        tk, "conflict_scan", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = tb.merge_updates_columnar(ups, device="cpu")
    assert calls  # the planner ran its (plain) kernel
    assert got == jb.merge_updates_columnar(ups)
    docs = [Y.Doc(gc=False), Y.Doc(gc=False)]
    Y.apply_update(docs[0], got)
    for u in ups:
        Y.apply_update(docs[1], u)
    assert len({(d.get_text("text").to_string(),
                 tuple(sorted(Y.decode_state_vector(
                     Y.encode_state_vector(d)).items())))
                for d in docs}) == 1
    assert tb.diff_update_columnar(got, sv, device="cpu") \
        == jb.diff_update_columnar(got, sv)
    assert tb.encode_state_vector_from_update_columnar(got, device="cpu") \
        == jb.encode_state_vector_from_update_columnar(got)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tk.KernelError, match="CUDA"):
        tb.merge_updates_columnar(ups)
