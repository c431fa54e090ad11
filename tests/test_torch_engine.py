"""The port's apply-lane flush against the JAX engine and the CPU oracle.

The same update bytes go through ``yjs_tpu.ops.BatchEngine`` (JAX on
the CPU) and ``yjs_tpu_torch.ops.BatchEngine(device="cpu")``, whose
kernel wrappers take their plain PyTorch versions on CPU tensors.  The
comparison is exact: device tables trimmed to live rows and segments,
texts, encoded states, emitted updates, typed events and flush-metric
key sets.  The JAX side runs with ``YTPU_FLUSH_PIPELINE=0``: its
pipelined flush sometimes leaves wrong device tables (ROADMAP R1), and
the port is held to the oracle there instead.  ``tests/conftest.py``
sets ``YTPU_EXPORT_DEVICE=1``, so every text read here ranks the device
tables (the ``list_ranks`` kernel).
"""

import random
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import yjs_tpu as Y
import yjs_tpu_torch as T
from test_engine_events import norm, session_updates
from test_flush_pipeline import SHAPES, make_trace, oracle_state
from yjs_tpu.obs import FLUSH_METRICS_SCHEMA as JAX_SCHEMA
from yjs_tpu.ops import BatchEngine as JaxEngine
from yjs_tpu.ops import plan_cache as jax_plan_cache
from yjs_tpu_torch.obs import FLUSH_METRICS_SCHEMA
from yjs_tpu_torch.ops import BatchEngine as TorchEngine
from yjs_tpu_torch.ops import kernels
from yjs_tpu_torch.ops import plan_cache as torch_plan_cache
from yjs_tpu_torch.ops.carry import tables_from_numpy, trim_tables

FIXTURE = Path(__file__).parent / "fixtures" / "distinct_traces_1500.bin.z"


@pytest.fixture(autouse=True)
def _fresh_caches():
    jax_plan_cache.reset_cache()
    torch_plan_cache.reset_cache()
    yield
    jax_plan_cache.reset_cache()
    torch_plan_cache.reset_cache()


def fixture_traces(n: int) -> list[bytes]:
    """The first ``n`` distinct 1500-op traces (one update each)."""
    raw = zlib.decompress(FIXTURE.read_bytes())
    count, _ops = struct.unpack_from("<II", raw, 0)
    out, o = [], 8
    for _ in range(min(n, count)):
        (ln,) = struct.unpack_from("<I", raw, o)
        out.append(raw[o + 4 : o + 4 + ln])
        o += 4 + ln
    return out


def editor_updates(trace: bytes, seed: int, n_edits: int = 6) -> list[bytes]:
    """Incremental edits of a seeded editor that holds ``trace``."""
    gen = random.Random(seed)
    d = Y.Doc(gc=False)
    d.client_id = 9000 + seed
    Y.apply_update(d, trace)
    t = d.get_text("text")
    out = []
    for _ in range(n_edits):
        sv = Y.encode_state_vector(d)
        if len(t) > 4 and gen.random() < 0.4:
            t.delete(gen.randrange(len(t) - 2), 2)
        else:
            t.insert(gen.randrange(len(t) + 1), gen.choice(["ab", "c ", "xyz"]))
        out.append(Y.encode_state_as_update(d, sv))
    return out


def drive(engine, per_doc, flush_every=5):
    """Queue step j's update of every doc, flushing every ``flush_every``
    steps; returns what the comparison reads."""
    n = engine.n_docs
    deltas = {i: [] for i in range(n)}
    engine.on_update(lambda i, u: deltas[i].append(u))
    keysets, tables = set(), []
    steps = max(len(u) for u in per_doc)
    for j in range(steps):
        for i, ups in enumerate(per_doc):
            if j < len(ups):
                engine.queue_update(i, ups[j])
        if (j + 1) % flush_every == 0 or j == steps - 1:
            engine.flush()
            keysets.add(frozenset(engine.last_flush_metrics))
            tables.append(trim_tables(engine))
    return {
        "states": [
            Y.merge_updates([engine.encode_state_as_update(i)])
            for i in range(n)
        ],
        "texts": [engine.text(i) for i in range(n)],
        "deltas": deltas,
        "keysets": keysets,
        "tables": tables,
    }


def assert_tables_equal(want, got):
    assert len(want) == len(got)
    for tw, tg in zip(want, got):
        for dw, dg in zip(tw, tg):
            assert (dw is None) == (dg is None)
            if dw is not None:
                for a, b in zip(dw, dg):
                    np.testing.assert_array_equal(a, b)


def assert_same(want, got):
    assert got["texts"] == want["texts"]
    assert got["states"] == want["states"]
    assert got["deltas"] == want["deltas"]
    assert got["keysets"] == want["keysets"] == {frozenset(FLUSH_METRICS_SCHEMA)}
    assert_tables_equal(want["tables"], got["tables"])


def run_pair(per_doc, monkeypatch, pipeline=True, flush_every=5):
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")
    want = drive(JaxEngine(len(per_doc)), per_doc, flush_every)
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "1" if pipeline else "0")
    eng = TorchEngine(len(per_doc), device="cpu")
    got = drive(eng, per_doc, flush_every)
    return want, got, eng


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_traces_match_jax_and_oracle(shape, pipeline, monkeypatch):
    per_doc = [make_trace(shape, seed=10 * i + len(shape)) for i in range(4)]
    want, got, _eng = run_pair(per_doc, monkeypatch, pipeline)
    assert_same(want, got)
    for i, ups in enumerate(per_doc):
        assert got["states"][i] == oracle_state(ups)


def test_broadcast_trace_at_eight_docs(monkeypatch):
    ups = make_trace("interleaved", seed=4)
    want, got, _eng = run_pair([ups] * 8, monkeypatch)
    assert_same(want, got)
    assert set(got["states"]) == {oracle_state(ups)}


def test_fixture_traces_with_compaction(monkeypatch):
    """Flush 1 loads four distinct 1500-op traces (dense lanes); flush 2
    applies editor deltas (sparse and delete lanes) and first compacts
    every doc of at least 512 rows (scatter_rows)."""
    traces = fixture_traces(4)
    per_doc = [[tr] + editor_updates(tr, seed=i) for i, tr in enumerate(traces)]
    want, got, eng = run_pair(per_doc, monkeypatch, flush_every=1)
    assert eng.last_compaction and all(
        c["rows_before"] >= 512 for c in eng.last_compaction
    )
    assert_same(want, got)
    for i, ups in enumerate(per_doc):
        assert got["states"][i] == oracle_state(ups)


def test_hydration_round_trip(monkeypatch):
    per_doc = [make_trace("storm", seed=40 + i) for i in range(3)]
    more = [make_trace("prepend", seed=50 + i, n_ops=10) for i in range(3)]
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")
    engines = [JaxEngine(3), TorchEngine(3, device="cpu")]
    for eng in engines:
        drive(eng, per_doc)
        mirror = eng.export_doc_columns(1)
        eng.reset_doc(1)
        assert eng.text(1) == ""
        stats = eng.hydrate_doc_columns(1, mirror)
        assert stats["rows"] > 0
        for i in (0, 2):
            for u in more[i]:
                eng.queue_update(i, u)
        eng.flush()
    jax_eng, torch_eng = engines
    assert_tables_equal([trim_tables(jax_eng)], [trim_tables(torch_eng)])
    for i in range(3):
        assert torch_eng.text(i) == jax_eng.text(i)
        extra = more[i] if i != 1 else []
        doc = Y.Doc(gc=False)
        for u in per_doc[i] + extra:
            Y.apply_update(doc, u)
        assert torch_eng.text(i) == doc.get_text("text").to_string()


@pytest.mark.parametrize("seed", [6, 7])
def test_pipelined_device_export_matches_oracle(seed, monkeypatch):
    """The case where the pipelined JAX engine's device tables went
    wrong (ROADMAP R1): the port, pipelined, with exports ranking the
    device tables, matches the oracle on every one of three runs."""
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "1")
    monkeypatch.setenv("YTPU_EXPORT_DEVICE", "1")
    ups = make_trace(SHAPES[seed % 3], seed=100 + seed)
    doc = Y.Doc(gc=False)
    for u in ups:
        Y.apply_update(doc, u)
    want_text = doc.get_text("text").to_string()
    for _run in range(3):
        torch_plan_cache.reset_cache()
        out = drive(TorchEngine(2, device="cpu"), [ups, ups])
        assert out["texts"] == [want_text, want_text]
        assert set(out["states"]) == {oracle_state(ups)}


def test_python_mirror_matches_jax(monkeypatch):
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    monkeypatch.setenv("YTPU_PLAN_SEGMENT", "np")
    per_doc = [make_trace(s, seed=60 + i) for i, s in enumerate(SHAPES)]
    want, got, eng = run_pair(per_doc, monkeypatch)
    assert type(eng.mirrors[0]).__name__ == "DocMirror"
    assert_same(want, got)


def test_python_mirror_device_segment_mode_raises(monkeypatch):
    """The Python mirror's device segment mode (the whole-chunk planner,
    here on the kernels' plain versions) no longer raises: it matches
    the JAX engine in the same mode."""
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    monkeypatch.setenv("YTPU_PLAN_SEGMENT", "device")
    per_doc = [make_trace(s, seed=60 + i) for i, s in enumerate(SHAPES)]
    want, got, eng = run_pair(per_doc, monkeypatch)
    assert type(eng.mirrors[0]).__name__ == "DocMirror"
    assert_same(want, got)


def test_unported_paths_raise(monkeypatch):
    """The mesh is not ported and raises; the on-device YATA lane is
    ported: a levels flush runs and gives the apply lane's text."""
    with pytest.raises(NotImplementedError, match="mesh"):
        TorchEngine(2, mesh=object(), device="cpu")
    ups = make_trace("storm", seed=2, n_ops=10)
    texts = {}
    for mode in ("levels", "apply"):
        monkeypatch.setenv("YTPU_KERNEL", mode)
        eng = TorchEngine(2, device="cpu")
        for u in ups:
            eng.queue_update(0, u)
        eng.flush()
        texts[mode] = eng.text(0)
    assert texts["levels"] == texts["apply"] != ""


def test_default_device_is_cuda():
    """An entry point runs on the card unless asked for the CPU: without
    CUDA the default engine raises instead of falling back."""
    if torch.cuda.is_available():
        assert TorchEngine(1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchEngine(1)
    assert TorchEngine(1, device="cpu")._right is None


def test_steady_state_flush_writes_in_place(monkeypatch):
    """The kernels write the resident tables in place: a flush that does
    not grow capacity allocates no table (realloc_bytes 0, the
    flush_donated flag of the shared metrics schema)."""
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "1")
    ups = make_trace("interleaved", seed=9, n_ops=40)
    eng = TorchEngine(2, device="cpu")
    for u in ups[:30]:
        eng.queue_update(0, u)
        eng.queue_update(1, u)
    eng.flush()
    ptrs = [t.data_ptr() for t in (eng._right, eng._deleted, eng._starts)]
    for u in ups[30:33]:
        eng.queue_update(0, u)
    eng.flush()
    m = eng.last_flush_metrics
    assert m["realloc_bytes"] == 0 and m["flush_donated"] == 1
    assert ptrs == [t.data_ptr() for t in (eng._right, eng._deleted, eng._starts)]
    assert kernels.launches == {k: 0 for k in kernels.launches}


def test_carry_tables_from_jax(monkeypatch):
    per_doc = [make_trace("prepend", seed=70 + i) for i in range(3)]
    want, got, eng = run_pair(per_doc, monkeypatch)
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")
    jax_eng = JaxEngine(3)
    drive(jax_eng, per_doc)
    carried = tables_from_numpy(
        np.asarray(jax_eng._right), np.asarray(jax_eng._deleted),
        np.asarray(jax_eng._starts), device="cpu",
    )
    for c, t in zip(carried, (eng._right, eng._deleted, eng._starts)):
        assert c.dtype == t.dtype
        assert torch.equal(c, t)
    with pytest.raises(TypeError):
        tables_from_numpy(
            np.zeros((1, 2), np.int64), np.zeros((1, 2), bool),
            np.zeros((1, 2), np.int32), device="cpu",
        )


def test_events_and_typed_exports_match_jax(monkeypatch):
    rng = random.Random(5)
    updates = session_updates(rng, n_rounds=30, nested=True)
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")
    outs = []
    for cls, kw in ((JaxEngine, {}), (TorchEngine, {"device": "cpu"})):
        eng = cls(1, **kw)
        events = []
        eng.observe(0, lambda doc, evs, sink=events: sink.append(norm(evs)))
        for j, u in enumerate(updates):
            eng.queue_update(0, u)
            if j % 3 == 2:
                eng.flush()
        eng.flush()
        outs.append((
            events, eng.text(0), eng.to_delta(0), eng.map_json(0, "meta"),
            eng.to_json(0, "list"), eng.encode_state_vector(0),
            eng.sync_step2_batch([(0, None), (0, {11: 3})]),
        ))
    assert outs[0] == outs[1]


def test_xml_string_matches_jax(monkeypatch):
    rng = random.Random(8)
    a = Y.Doc(gc=False)
    a.client_id = 41
    updates = []
    for _ in range(40):
        sv = Y.encode_state_vector(a)
        frag = a.get_xml_fragment("xml")
        if len(frag) == 0 or rng.random() < 0.5:
            el = Y.YXmlElement(rng.choice(["div", "p"]))
            frag.insert(rng.randint(0, len(frag)), [el])
            el.set_attribute("k", str(rng.randint(0, 9)))
            txt = Y.YXmlText()
            el.insert(0, [txt])
            txt.insert(0, rng.choice(["hi ", "yo "]))
        else:
            frag.delete(rng.randrange(len(frag)), 1)
        updates.append(Y.encode_state_as_update(a, sv))
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")
    got = []
    for cls, kw in ((JaxEngine, {}), (TorchEngine, {"device": "cpu"})):
        eng = cls(1, **kw)
        for u in updates:
            eng.queue_update(0, u)
        eng.flush()
        got.append(eng.xml_string(0, "xml"))
    assert got[0] == got[1] == a.get_xml_fragment("xml").to_string()


def test_metrics_schema_matches_jax():
    assert FLUSH_METRICS_SCHEMA == JAX_SCHEMA
    assert T.Doc is not Y.Doc  # the port keeps its own copy of the core
