"""The port's batched sync kernels and engine paths against the JAX package.

K9 (``state_vector_kernel``) and K10 (``diff_mask_kernel``): the plain
PyTorch versions that the port's wrappers take for CPU tensors are held
exactly against the JAX kernels on the same seeded numpy inputs,
including NULL rows, slots at or past ``n_slots`` and int32 wrap-around
(all data is integer, so the tolerance is 0).  Then the engine paths
that launch them: ``state_vectors_batched`` against the per-doc state
vectors, and ``sync_step2_batch`` under ``YTPU_SYNC_DEVICE=1`` (the
device diff branch) against the JAX engine's replies under the same
setting, byte for byte.  The CUDA kernels are held against the same
plain versions on the card by ``test_torch_cuda.py``, whose case
generator this file shares.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yjs_tpu as Y
import yjs_tpu_torch as T
from test_torch_cuda import DIFF_EDGE_SHAPES, diff_case, sync_case
from yjs_tpu.ops import BatchEngine as JaxEngine
from yjs_tpu.ops import kernels as jk
from yjs_tpu_torch.ops import BatchEngine as TorchEngine
from yjs_tpu_torch.ops import _cuda
from yjs_tpu_torch.ops import kernels as tk


@pytest.fixture(autouse=True)
def _sync_pipeline(monkeypatch):
    # the pipelined JAX engine sometimes leaves wrong device tables
    # (ROADMAP R1); both engines flush synchronously here
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


SHAPES = [(1, 1, 1), (2, 7, 1), (3, 70, 4), (9, 130, 17), (4, 33, 64)]


# -- K9 / K10: plain versions against the JAX kernels ------------------------


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_state_vector_plain_matches_jax(seed, shape, wide):
    b, n, n_slots = shape
    row_slot, _clock, row_end, _sv = sync_case(seed * 31 + n, b, n, n_slots, wide)
    want = jk.state_vector_kernel(
        jnp.asarray(row_slot), jnp.asarray(row_end), n_slots
    )
    before = dict(tk.launches)
    got = tk.state_vector_kernel(
        torch.from_numpy(row_slot), torch.from_numpy(row_end), n_slots
    )
    assert tk.launches == before  # the plain version never counts
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(want), _np(got))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_diff_mask_plain_matches_jax(seed, shape, wide):
    b, n, n_slots = shape
    case = sync_case(seed * 37 + n, b, n, n_slots, wide)
    want = jk.diff_mask_kernel(*(jnp.asarray(a) for a in case))
    before = dict(tk.launches)
    got = tk.diff_mask_kernel(*(torch.from_numpy(a) for a in case))
    assert tk.launches == before
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(w), _np(g))


@pytest.mark.parametrize("kind", ["seeded", "wide", "empty"])
@pytest.mark.parametrize("shape", DIFF_EDGE_SHAPES)
def test_diff_mask_plain_matches_jax_at_edges(shape, kind):
    """The card tests' edge cases: N = 1, 3, 5 and 1102 (not multiples of
    four), B past a grid's y limit, state vectors past the kernel's
    staging, wrapping clocks and the checkpoint's empty state vectors."""
    b, n, n_slots = shape
    case = diff_case(kind, 23 + n, b, n, n_slots)
    want = jk.diff_mask_kernel(*(jnp.asarray(a) for a in case))
    got = tk.diff_mask_kernel(*(torch.from_numpy(a) for a in case))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(w), _np(g))
    if kind == "empty":
        np.testing.assert_array_equal(_np(got[0]), case[0] >= 0)


DIFF_SOURCE = Path(tk.__file__).resolve().parent.parent / "csrc" / "diff_mask.cu"


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 1102, 9373, 65537,
                               (1 << 20) + 7, 2**31 - 1025])
def test_fast_div_is_exact_below_2_31(n):
    """K10's multiply-high and shift give ``x // n`` for every dividend
    the kernel hands it (below 2**31): the edges around each multiple of
    ``n`` and seeded values."""
    mul, shift = _cuda.fast_div(n)
    assert 0 <= mul < 2**32 and 0 <= shift < 32
    g = np.random.default_rng(n % 1000)
    xs = {0, 1, 2**31 - 1, 2**31 - 2}
    for q in (1, 2, 3, 1000, (2**31 - 1) // n):
        xs |= {q * n - 1, q * n, q * n + 1}
    xs |= set(g.integers(0, 2**31, 200).tolist())
    for x in sorted(v for v in xs if 0 <= v < 2**31):
        got = x if mul == 0 else (x * mul) >> (32 + shift)
        assert got == x // n, (n, x)


@pytest.mark.parametrize("total", [0, 1, 3, 4, 5, 15, 16, 17, 4096 * 1102])
def test_diff_layout(total):
    """offset's ``4 total`` bytes first, then needed on a 16-byte
    boundary; the buffer a whole number of 16-byte words."""
    at, nbytes = _cuda.diff_layout(total)
    a = _cuda.DIFF_ALIGN
    assert at % a == 0 and nbytes % a == 0
    assert 4 * total <= at < 4 * total + a
    assert total <= nbytes - at < total + a


def test_diff_mask_entry_matches_the_source():
    """``ytpu_diff_mask``'s ctypes argument types follow its C
    parameters, and the launch constants the wrapper relies on hold."""
    text = DIFF_SOURCE.read_text()
    m = re.search(r'extern "C" int ytpu_diff_mask\(([^)]*)\)', text)
    assert m
    kinds = {"const void*": _cuda._vp, "void*": _cuda._vp, "int": _cuda._int,
             "unsigned": _cuda._u32}
    want = [kinds[p.strip().rsplit(" ", 1)[0]] for p in m.group(1).split(",")]
    lib, argtypes = _cuda._ENTRIES["ytpu_diff_mask"]
    assert lib == "diff_mask" and argtypes == want
    rows = int(re.search(r"constexpr int kRows = (\d+);", text).group(1))
    assert _cuda.DIFF_ALIGN % (4 * rows) == 0  # a thread's 16-byte words


def test_diff_mask_wrapper_refuses_mixed_devices():
    case = [torch.from_numpy(a) for a in sync_case(1, 2, 3, 2)]
    for j in range(4):
        bad = list(case)
        bad[j] = bad[j].to("meta")
        with pytest.raises(ValueError):
            tk.diff_mask_kernel(*bad)


def test_sync_cases_reach_the_edge_rules():
    """The seeded cases must hold the rows the edge rules are about, or
    the comparisons above prove less than they claim."""
    row_slot, row_clock, row_end, sv = sync_case(5, 9, 130, 17, wide=True)
    n_slots = sv.shape[1]
    assert (row_slot < 0).any() and (row_slot >= n_slots).any()
    needed, offset = tk.diff_mask_kernel(
        *(torch.from_numpy(a) for a in (row_slot, row_clock, row_end, sv))
    )
    # an out-of-range slot reads INT32_MIN: needed unless row_end is too
    over = row_slot >= n_slots
    np.testing.assert_array_equal(_np(needed)[over], row_end[over] > -(2**31))
    # remote - clock wrapped in int32 for some needed row
    safe = np.where((row_slot >= 0) & (row_slot < n_slots), row_slot, 0)
    remote = np.take_along_axis(sv, safe, axis=1).astype(np.int64)
    exact = remote - row_clock.astype(np.int64)
    assert ((exact > 2**31 - 1) | (exact < -(2**31))).any()


# -- engine paths --------------------------------------------------------------


def _spy(monkeypatch, name):
    """Record the calls of a plain kernel version (the wrapper reaches
    it through the module, so the spy sees every CPU launch)."""
    calls = []
    orig = getattr(tk, name)

    def spy(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(tk, name, spy)
    return calls


def make_docs(n):
    """``_make_engine``'s fleet of tests/test_engine_sync.py: text with a
    delete and a map entry per doc, one client each."""
    docs = []
    for i in range(n):
        d = Y.Doc(gc=False)
        d.client_id = 100 + i
        t = d.get_text("text")
        t.insert(0, f"doc{i} " * (i + 1))
        t.delete(0, 2)
        d.get_map("m").set("k", i)
        docs.append(d)
    return docs


def loaded(engine_cls, docs, **kw):
    eng = engine_cls(len(docs), **kw)
    for i, d in enumerate(docs):
        eng.queue_update(i, Y.encode_state_as_update(d))
    eng.flush()
    return eng


def engines(docs):
    return loaded(JaxEngine, docs), loaded(TorchEngine, docs, device="cpu")


def encoded_sv(sv):
    if not sv:
        return None
    from yjs_tpu_torch.coding import DSEncoderV1
    from yjs_tpu_torch.updates import write_state_vector

    e = DSEncoderV1()
    write_state_vector(e, sv)
    return e.to_bytes()


def test_state_vectors_batched_matches_per_doc_and_jax(monkeypatch):
    docs = make_docs(6)
    # a second client in doc 4 widens the slot table past one column
    other = Y.Doc(gc=False)
    other.client_id = 77
    Y.apply_update(other, Y.encode_state_as_update(docs[4]))
    other.get_text("text").insert(0, "more ")
    jeng, teng = engines(docs)
    for e in (jeng, teng):
        e.queue_update(4, Y.encode_state_as_update(other))
        e.flush()
    order = [5, 0, 4, 2, 1, 3]
    calls = _spy(monkeypatch, "state_vector_kernel_plain")
    svs = teng.state_vectors_batched(order)
    assert len(calls) == 1  # one batched reduction for all six docs
    assert svs == [teng.state_vector(i) for i in order]
    assert svs == jeng.state_vectors_batched(order)
    assert svs[2] == Y.decode_state_vector(Y.encode_state_vector(other))


@pytest.mark.parametrize("v2", [False, True])
def test_sync_step2_batch_device_branch_matches_jax(monkeypatch, v2):
    monkeypatch.setenv("YTPU_SYNC_DEVICE", "1")
    docs = make_docs(6)
    jeng, teng = engines(docs)
    # mixed targets: empty, full, and partial state vectors
    partial = {100 + 3: 4}
    full = teng.state_vector(4)
    requests = [(0, None), (1, {}), (3, partial), (5, None), (4, full)]
    before = dict(tk.launches)
    calls = _spy(monkeypatch, "diff_mask_kernel_plain")
    replies = teng.sync_step2_batch(requests, v2=v2)
    assert len(calls) == 1  # one batched diff for all five requests
    assert tk.launches == before  # CPU tensors: the plain versions
    assert replies == jeng.sync_step2_batch(requests, v2=v2)
    for (i, sv), u in zip(requests, replies):
        assert u == teng.encode_state_as_update(i, encoded_sv(sv), v2=v2)
        if sv:
            continue
        fresh = T.Doc(gc=False)
        (T.apply_update_v2 if v2 else T.apply_update)(fresh, u)
        assert fresh.get_text("text").to_string() == docs[i].get_text(
            "text").to_string()
        assert fresh.get_map("m").to_json() == docs[i].get_map("m").to_json()


def test_sync_step2_batch_serves_fallback_docs_beside_device_docs(monkeypatch):
    monkeypatch.setenv("YTPU_SYNC_DEVICE", "1")
    docs = make_docs(3)
    docs[1].get_map("meta").set("sub", Y.Doc(guid="child"))  # subdocument
    jeng, teng = engines(docs)
    assert 1 in teng.fallback and 1 in jeng.fallback
    requests = [(0, None), (1, None), (2, {102: 3})]
    assert teng.sync_step2_batch(requests) == jeng.sync_step2_batch(requests)


def test_partial_target_resyncs_stale_client(monkeypatch):
    monkeypatch.setenv("YTPU_SYNC_DEVICE", "1")
    docs = make_docs(4)
    jeng, teng = engines(docs)
    stale = Y.Doc(gc=False)
    stale.client_id = 900
    # the stale client knows a prefix of doc 2
    d = docs[2]
    Y.apply_update(stale, Y.encode_state_as_update(d))
    d.get_text("text").insert(3, "[new]")
    u = Y.encode_state_as_update(d, Y.encode_state_vector(stale))
    for e in (jeng, teng):
        e.queue_update(2, u)
        e.flush()
    sv = Y.decode_state_vector(Y.encode_state_vector(stale))
    (reply,) = teng.sync_step2_batch([(2, sv)])
    assert reply == jeng.sync_step2_batch([(2, sv)])[0]
    Y.apply_update(stale, reply)
    assert stale.get_text("text").to_string() == d.get_text("text").to_string()
    assert teng.text(2) == d.get_text("text").to_string()


def test_encode_states_batched_device_branch_round_trips(monkeypatch):
    """The checkpoint's snapshot producer (every doc against the empty
    state vector) through the diff kernel equals the native encoder's
    full states."""
    docs = make_docs(5)
    _jeng, teng = engines(docs)
    native = teng.encode_states_batched(list(range(5)))
    monkeypatch.setenv("YTPU_SYNC_DEVICE", "1")
    device = teng.encode_states_batched(list(range(5)))
    assert [Y.merge_updates([u]) for u in device] == [
        Y.merge_updates([u]) for u in native
    ]
    assert [Y.merge_updates([u]) for u in device] == [
        Y.merge_updates([Y.encode_state_as_update(d)]) for d in docs
    ]
