"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips, with its reason,
when no CUDA device is present (decided inside the test, never at
import).  On a machine with a card run them with
``python -m pytest -m cuda tests/test_torch_cuda.py``; the first call
builds ``yjs_tpu_torch/csrc/*.cu`` with nvcc.

The seeded numpy case builders at the top are shared with
``test_torch_kernels.py``, which holds the same cases' plain versions
against the JAX kernels on the CPU.  This file imports no JAX: the
machine with the card has none.
"""

import random

import numpy as np
import pytest
import torch

import yjs_tpu_torch as Y
from yjs_tpu_torch.ops import BatchEngine, kernels

NULL = -1


def _bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def apply_case(seed: int, b: int, n1: int, s1: int, dtype=np.int32):
    """One seeded K1 case: tables, a lanes buffer and its widths.

    Counts are random per doc (some zero); each section's real targets
    are unique within its doc; padding lanes follow the packer (dense
    values NULL, sparse/delete rows ``n1``, head segments ``s1``); a few
    real lanes carry an out-of-bounds row (dropped) or ``-1`` (which
    JAX's scatter wraps to the last column)."""
    g = np.random.default_rng(seed)
    cap = n1 - 1
    right = g.integers(-1, cap, size=(b, n1)).astype(np.int32)
    deleted = g.random((b, n1)) < 0.3
    starts = g.integers(-1, cap, size=(b, s1)).astype(np.int32)

    def counts(hi):
        c = g.integers(0, hi + 1, size=b)
        c[g.random(b) < 0.3] = 0
        return c

    cnt_dn = counts(cap)
    cnt_sp = counts(min(cap, 12))
    cnt_h = counts(min(s1 - 1, 4))
    cnt_d = counts(min(cap, 10))
    dense_v = np.concatenate(
        [g.integers(-1, cap, size=c) for c in cnt_dn]
    ).astype(np.int64)

    def rows(cnt, hi, oob):
        rs, vs = [], []
        for c in cnt:
            r = g.choice(hi, size=c, replace=False).astype(np.int64)
            if c >= 3:
                r[0] = oob  # a real lane whose target is dropped
                if oob == n1:
                    r[1] = -1  # wraps to column n1-1, unique: r < hi
            rs.append(r)
            vs.append(g.integers(-1, cap, size=c))
        return np.concatenate(rs), np.concatenate(vs).astype(np.int64)

    sp_r, sp_v = rows(cnt_sp, cap - 1, n1)
    hd_s, hd_v = rows(cnt_h, s1 - 1, s1)
    dl_r, _ = rows(cnt_d, cap - 1, n1)
    k_dn = _bucket(len(dense_v), 64)
    k_sp = _bucket(len(sp_r), 64)
    k_h = _bucket(len(hd_s), 8)
    k_d = _bucket(len(dl_r), 64)

    def pad(a, k, fill):
        out = np.full(k, fill, np.int64)
        out[: len(a)] = a
        return out

    lanes = np.concatenate([
        cnt_dn, cnt_sp, cnt_h, cnt_d,
        pad(dense_v, k_dn, NULL),
        pad(sp_r, k_sp, n1), pad(sp_v, k_sp, NULL),
        pad(hd_s, k_h, s1), pad(hd_v, k_h, NULL),
        pad(dl_r, k_d, n1),
    ]).astype(dtype)
    return (right, deleted, starts), lanes, (k_dn, k_sp, k_h, k_d)


def scatter_case(seed: int, b: int, n1: int, s1: int, k: int):
    """One seeded K2 case: tables, a sorted unique ``idx`` subset and
    its new rows."""
    g = np.random.default_rng(seed)
    right = g.integers(-1, n1 - 1, size=(b, n1)).astype(np.int32)
    deleted = g.random((b, n1)) < 0.5
    starts = g.integers(-1, n1 - 1, size=(b, s1)).astype(np.int32)
    idx = np.sort(g.choice(b, size=k, replace=False)).astype(np.int32)
    new_right = g.integers(-1, n1 - 1, size=(k, n1)).astype(np.int32)
    new_deleted = g.random((k, n1)) < 0.5
    new_starts = g.integers(-1, n1 - 1, size=(k, s1)).astype(np.int32)
    return (right, deleted, starts), (idx, new_right, new_deleted, new_starts)


def ranks_case(seed: int, b: int, n1: int):
    """One seeded K8 case: per doc, a random permutation of some rows
    linked into one list (the rest NULL or in a second list), with
    ``valid`` marking the first list's rows only."""
    g = np.random.default_rng(seed)
    right = np.full((b, n1), NULL, np.int32)
    valid = np.zeros((b, n1), bool)
    for d in range(b):
        n = int(g.integers(0, n1))
        order = g.permutation(n1 - 1)[:n]
        cut = int(g.integers(0, n + 1))
        for part, is_valid in ((order[:cut], True), (order[cut:], False)):
            for a, c in zip(part[:-1], part[1:]):
                right[d, a] = c
            valid[d, part] = is_valid
    return right, valid


def sync_case(seed: int, b: int, n: int, n_slots: int, wide: bool = False):
    """One seeded K9/K10 case: ``row_slot, row_clock, row_end [b, n]`` and
    a remote ``sv [b, n_slots]``, all int32.

    Slots cover NULL rows (-1, and a few other negatives) and rows whose
    slot lies at or past ``n_slots`` (dropped by K9, read as INT32_MIN by
    K10).  Clocks follow the engine's shape (``row_end`` past
    ``row_clock``, ``sv`` near the rows' clocks) unless ``wide``, where
    every column spans the whole int32 range so ``remote - clock``
    wraps."""
    g = np.random.default_rng(seed)
    row_slot = g.integers(0, n_slots, size=(b, n))
    r = g.random((b, n))
    row_slot[r < 0.15] = -1
    row_slot[(r >= 0.15) & (r < 0.17)] = -7
    over = (r >= 0.17) & (r < 0.2)
    row_slot[over] = n_slots + g.integers(0, 4, size=int(over.sum()))
    if wide:
        lo, hi = -(2**31), 2**31 - 1
        row_clock = g.integers(lo, hi, size=(b, n), endpoint=True)
        row_end = g.integers(lo, hi, size=(b, n), endpoint=True)
        sv = g.integers(lo, hi, size=(b, n_slots), endpoint=True)
    else:
        row_clock = g.integers(0, 5000, size=(b, n))
        row_end = row_clock + g.integers(1, 40, size=(b, n))
        sv = g.integers(0, 5100, size=(b, n_slots))
        sv[g.random((b, n_slots)) < 0.2] = 0
    return tuple(
        a.astype(np.int32) for a in (row_slot, row_clock, row_end, sv)
    )


def _torch(arrays, device):
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


APPLY_SHAPES = [
    (1, 65, 9), (3, 129, 17), (64, 1025, 9), (4096, 2049, 9),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("shape", APPLY_SHAPES)
def test_apply_lanes_kernel_matches_plain(cuda_device, shape, dtype):
    b, n1, s1 = shape
    tables, lanes, widths = apply_case(7 + b, b, n1, s1, dtype)
    ref = kernels.apply_lanes_plain(
        _torch(tables, cuda_device), torch.from_numpy(lanes).to(cuda_device),
        *widths,
    )
    before = kernels.launches["apply_lanes"]
    got = kernels.apply_lanes(
        _torch(tables, cuda_device), torch.from_numpy(lanes).to(cuda_device),
        *widths,
    )
    torch.cuda.synchronize()
    assert kernels.launches["apply_lanes"] == before + 1
    for r, o in zip(ref, got):
        assert torch.equal(r, o)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 65, 9, 2), (4096, 2049, 17, 700)])
def test_scatter_rows_kernel_matches_plain(cuda_device, shape):
    b, n1, s1, k = shape
    tables, rows = scatter_case(11 + b, b, n1, s1, k)
    ref = kernels.scatter_rows_plain(
        *_torch(tables, cuda_device), *_torch(rows, cuda_device)
    )
    got = kernels.scatter_rows(
        *_torch(tables, cuda_device), *_torch(rows, cuda_device)
    )
    torch.cuda.synchronize()
    for r, o in zip(ref, got):
        assert torch.equal(r, o)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (1, 65), (5, 300), (1, 4097)])
def test_list_ranks_kernel_matches_plain(cuda_device, shape):
    b, n1 = shape
    right, valid = _torch(ranks_case(13 + n1, b, n1), cuda_device)
    ref = kernels.list_ranks_plain(right, valid)
    got = kernels.list_ranks(right, valid)
    torch.cuda.synchronize()
    assert torch.equal(ref, got)


@pytest.mark.cuda
def test_default_engine_lives_on_the_card(cuda_device):
    eng = BatchEngine(2)
    assert eng.device.type == "cuda"
    eng.queue_update(0, edit_trace(0, n_ops=3)[0])
    eng.flush()
    assert eng._right.is_cuda and eng._deleted.dtype == torch.bool


@pytest.mark.cuda
def test_wrappers_raise_on_mixed_devices(cuda_device):
    right, valid = ranks_case(1, 1, 9)
    with pytest.raises(ValueError):
        kernels.list_ranks(
            torch.from_numpy(right).to(cuda_device), torch.from_numpy(valid)
        )


def edit_trace(seed: int, n_ops: int = 40) -> list[bytes]:
    """Incremental updates of three seeded editors (the port's own core:
    this file imports no JAX), with occasional syncs between them."""
    gen = random.Random(seed)
    docs = []
    for k in range(3):
        d = Y.Doc(gc=False)
        d.client_id = 500 + k
        docs.append(d)
    out = []
    for _ in range(n_ops):
        d = docs[gen.randrange(3)]
        t = d.get_text("text")
        sv = Y.encode_state_vector(d)
        if len(t) and gen.random() < 0.3:
            t.delete(gen.randrange(len(t)), 1)
        else:
            t.insert(gen.randrange(len(t) + 1), gen.choice("abcdef "))
        out.append(Y.encode_state_as_update(d, sv))
        if gen.random() < 0.3:
            other = docs[gen.randrange(3)]
            if other is not d:
                Y.apply_update(other, Y.encode_state_as_update(d))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_engine_on_card_matches_cpu_twin(cuda_device, pipeline, monkeypatch):
    """Many small pipelined flushes with one doc per chunk, so every
    flush reuses both staging slots while their copies may be in
    flight: after each flush the card's tables equal the CPU twin's, and
    device exports equal a CPU Doc."""
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", pipeline)
    monkeypatch.setenv("YTPU_FLUSH_CHUNK", "1")
    monkeypatch.setenv("YTPU_EXPORT_DEVICE", "1")
    per_doc = [edit_trace(seed) for seed in range(4)]
    eng = BatchEngine(4, device=cuda_device)
    twin = BatchEngine(4, device="cpu")
    for j in range(len(per_doc[0])):
        for e in (eng, twin):
            for i, ups in enumerate(per_doc):
                e.queue_update(i, ups[j])
        if j % 2:
            eng.flush()
            twin.flush()
            for a, b in zip(
                (eng._right, eng._deleted, eng._starts),
                (twin._right, twin._deleted, twin._starts),
            ):
                assert torch.equal(a.cpu(), b)
    eng.flush()
    for i, ups in enumerate(per_doc):
        doc = Y.Doc(gc=False)
        for u in ups:
            Y.apply_update(doc, u)
        assert eng.text(i) == doc.get_text("text").to_string()


SYNC_SHAPES = [
    (1, 1, 1), (3, 70, 4), (17, 2049, 8), (5, 3000, 64), (4096, 2048, 8),
    (2, 4096, 20000),  # n_slots past shared memory: the global-atomics path
]


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("shape", SYNC_SHAPES)
def test_state_vector_kernel_matches_plain(cuda_device, shape, wide):
    b, n, n_slots = shape
    row_slot, _clock, row_end, _sv = _torch(
        sync_case(17 + b + n, b, n, n_slots, wide), cuda_device
    )
    ref = kernels.state_vector_kernel_plain(row_slot, row_end, n_slots)
    before = kernels.launches["state_vector"]
    got = kernels.state_vector_kernel(row_slot, row_end, n_slots)
    torch.cuda.synchronize()
    assert kernels.launches["state_vector"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (b, n_slots)
    assert torch.equal(ref, got)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("shape", SYNC_SHAPES)
def test_diff_mask_kernel_matches_plain(cuda_device, shape, wide):
    b, n, n_slots = shape
    args = _torch(sync_case(19 + b + n, b, n, n_slots, wide), cuda_device)
    ref = kernels.diff_mask_kernel_plain(*args)
    before = kernels.launches["diff_mask"]
    got = kernels.diff_mask_kernel(*args)
    torch.cuda.synchronize()
    assert kernels.launches["diff_mask"] == before + 1
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    for r, o in zip(ref, got):
        assert torch.equal(r, o)


@pytest.mark.cuda
def test_provider_on_card_matches_cpu_twin(cuda_device, monkeypatch, tmp_path):
    """The default provider lives on the card; a reconnect storm through
    the device diff kernel and a checkpoint answer byte for byte as the
    CPU twin does, and the WAL recovers on the card."""
    from yjs_tpu_torch.lib0.decoding import Decoder
    from yjs_tpu_torch.lib0.encoding import Encoder
    from yjs_tpu_torch.provider import TpuProvider
    from yjs_tpu_torch.sync import protocol

    monkeypatch.setenv("YTPU_SYNC_DEVICE", "1")
    prov = TpuProvider(4, wal_dir=str(tmp_path / "card"))
    twin = TpuProvider(4, device="cpu", wal_dir=str(tmp_path / "cpu"))
    assert prov.engine.device.type == "cuda"
    clients = []
    for i, ups in enumerate(edit_trace(seed) for seed in range(4)):
        for u in ups:
            prov.receive_update(f"r{i}", u)
            twin.receive_update(f"r{i}", u)
        d = Y.Doc(gc=False)
        for u in ups[: len(ups) // 2 * (i % 2)]:
            Y.apply_update(d, u)
        clients.append(d)
    msgs = []
    for i, d in enumerate(clients):
        enc = Encoder()
        protocol.write_sync_step1(enc, d)
        msgs.append((f"r{i}", enc.to_bytes()))
    before = kernels.launches["diff_mask"]
    replies = prov.handle_sync_step1_batch(msgs)
    assert kernels.launches["diff_mask"] == before + 1
    assert replies == twin.handle_sync_step1_batch(msgs)
    for i, (d, reply) in enumerate(zip(clients, replies)):
        protocol.read_sync_message(Decoder(reply), Encoder(), d)
        assert d.get_text("text").to_string() == prov.text(f"r{i}")
    svs = prov.engine.state_vectors_batched(list(range(4)))
    assert svs == [prov.engine.state_vector(i) for i in range(4)]
    prov.checkpoint()
    twin.checkpoint()
    prov.wal.abandon()
    rec = TpuProvider.recover(str(tmp_path / "card"))
    assert rec.engine.device.type == "cuda"
    for i in range(4):
        assert rec.text(f"r{i}") == twin.text(f"r{i}")


# -- K3-K6: the on-device YATA lanes ---------------------------------------------

# client ids below and at or above 2**31: YATA case 1 orders them unsigned
YATA_CLIENTS = (7, 2**31 + 5, 2**32 - 3, 1000)


def yata_session(seed: int, n_ops: int = 60, clients=YATA_CLIENTS,
                 sync_p: float = 0.1) -> list[bytes]:
    """Incremental updates of concurrent seeded editors that mostly type
    near the start of the text (same-origin conflicts: YATA case 1) and
    sometimes delete (run splits and deletes); rare full syncs."""
    gen = random.Random(seed)
    docs = []
    for c in clients:
        d = Y.Doc(gc=False)
        d.client_id = c
        docs.append(d)
    out = []
    for _ in range(n_ops):
        d = docs[gen.randrange(len(docs))]
        t = d.get_text("text")
        sv = Y.encode_state_vector(d)
        if len(t) > 3 and gen.random() < 0.25:
            t.delete(gen.randrange(len(t) - 1), gen.randint(1, 2))
        else:
            pos = min(len(t), gen.randrange(3)) if gen.random() < 0.7 else (
                gen.randrange(len(t) + 1)
            )
            t.insert(pos, gen.choice(["ab", "c", "xyz"]))
        out.append(Y.encode_state_as_update(d, sv))
        if gen.random() < sync_p:
            for a in docs:
                for b in docs:
                    if a is not b:
                        Y.apply_update(b, Y.encode_state_as_update(a))
    return out


YATA_FILLS = (
    ("client_key", 0), ("origin_slot", NULL), ("origin_clock", 0),
    ("right_slot", NULL), ("right_clock", 0), ("origin_row", NULL),
)


def yata_case(seed: int, b: int, n_stages: int = 3, n_ops: int = 60,
              w_pad: int = 1, cap_min: int = 64, clients=YATA_CLIENTS,
              uniform: bool = False):
    """A seeded multi-flush YATA case built from the port's own planner:
    doc i ingests its session in ``n_stages`` slices and plans each
    (``DocMirror.prepare_step(want_levels=True)``), packed the way the
    engine packs them.

    Returns ``(cap, s1, stages)``: row capacity (``N+1 = cap+1``), the
    starts width, and per stage a dict of numpy arrays — the six statics
    ``[b, cap+1]`` (``client_key`` as its int32 bit pattern) after that
    stage's plan, ``splits [b, S, 2]``, ``sched [b, M, 4]``, ``lv [b, L,
    W, 8]`` (W at least ``w_pad``), ``dels [b, D]``, ``scratch [b]``;
    ``uniform`` pads every stage to the same widths (one compiled shape
    for the JAX kernels).  The Python mirror plans on the NumPy segment
    planner, so the case needs no device."""
    import os

    from yjs_tpu_torch.ops.columns import DocMirror

    saved = os.environ.get("YTPU_PLAN_SEGMENT")
    os.environ["YTPU_PLAN_SEGMENT"] = "np"
    try:
        return _yata_case(seed, b, n_stages, n_ops, w_pad, cap_min, clients,
                          uniform, DocMirror)
    finally:
        if saved is None:
            del os.environ["YTPU_PLAN_SEGMENT"]
        else:
            os.environ["YTPU_PLAN_SEGMENT"] = saved


def _yata_case(seed, b, n_stages, n_ops, w_pad, cap_min, clients, uniform,
               DocMirror):
    sessions = [yata_session(seed * 100 + i % 3, n_ops, clients)
                for i in range(b)]
    mirrors = [DocMirror("text") for _ in range(b)]
    raw = []
    for st in range(n_stages):
        plans, cols, rows = [], [], []
        for i, (m, ups) in enumerate(zip(mirrors, sessions)):
            cut = len(ups) * st // n_stages, len(ups) * (st + 1) // n_stages
            if i % 4 == 3:  # a doc that joins one flush late
                cut = (0, cut[1]) if st == 1 else (cut if st else (0, 0))
            for u in ups[cut[0] : cut[1]]:
                m.ingest(u)
            plans.append(m.prepare_step(want_levels=True))
            cols.append(m.static_columns())
            rows.append(m.n_rows)
        raw.append((plans, cols, rows))
    w = max([w_pad] + [p.max_width for pl, _c, _r in raw for p in pl])
    n_rows = max(max(r) for _p, _c, r in raw)
    cap = _bucket(max(cap_min, n_rows + 2 * w), 64)
    s1 = _bucket(max(m.n_segs for m in mirrors), 8) + 1
    every = [p for pl, _c, _r in raw for p in pl]

    def width(vals, plans):
        return max([1] + [len(v) for v in vals(every if uniform else plans)])

    stages = []
    for plans, cols, rows in raw:
        st = {}
        for key, fill in YATA_FILLS:
            col = np.full((b, cap + 1), fill, np.int64)
            for i, c in enumerate(cols):
                col[i, : rows[i]] = c[key]
            st[key] = col.astype(np.uint32).view(np.int32) if key == (
                "client_key") else col.astype(np.int32)

        n_lv = max([1] + [p.n_levels for p in (every if uniform else plans)])
        splits = np.full(
            (b, width(lambda ps: [p.splits for p in ps], plans), 2), NULL,
            np.int32,
        )
        sched = np.full(
            (b, width(lambda ps: [p.sched for p in ps], plans), 4), NULL,
            np.int32,
        )
        dels = np.full(
            (b, width(lambda ps: [p.delete_rows for p in ps], plans)), NULL,
            np.int32,
        )
        lv = np.full((b, n_lv, w, 8), NULL, np.int32)
        for i, p in enumerate(plans):
            if len(p.splits):
                splits[i, : len(p.splits)] = p.splits
            if len(p.sched):
                sched[i, : len(p.sched)] = p.sched
            if len(p.delete_rows):
                dels[i, : len(p.delete_rows)] = p.delete_rows
            for j, entries in enumerate(p.packed_levels()):
                if entries:
                    lv[i, j, : len(entries)] = entries
        st.update(splits=splits, sched=sched, lv=lv, dels=dels,
                  scratch=np.asarray(rows, np.int32))
        stages.append(st)
    return cap, s1, stages


def yata_tables(b: int, cap: int, s1: int):
    """Fresh resident tables as the engine allocates them (numpy)."""
    return (np.full((b, cap + 1), NULL, np.int32),
            np.zeros((b, cap + 1), bool), np.full((b, s1), NULL, np.int32))


def run_yata(kernel, stage, dyn, statics_of, to):
    """One stage through ``kernel`` ("seq" or "levels" of the port's
    ``kernels`` module, or a plain version): ``statics_of(stage)`` gives
    the statics dict, ``to`` places a numpy array."""
    statics = statics_of(stage)
    if kernel in (kernels.batch_step, kernels.batch_step_plain):
        return kernel(statics, dyn, to(stage["splits"]), to(stage["sched"]),
                      to(stage["dels"]))
    return kernel(statics, dyn, to(stage["splits"]), to(stage["lv"]),
                  to(stage["dels"]), to(stage["scratch"]))


@pytest.fixture
def hang_guard():
    """Ends the process with a traceback if a test outlives 300 s: a
    kernel that loops forever blocks the interpreter inside a CUDA call,
    where no Python-level timeout can reach it."""
    import faulthandler

    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def statics_case(seed: int, b: int, n1: int, k: int):
    """One seeded K3 case: six columns and a packed ``[8, k]`` block whose
    real lanes hit unique (doc, row) targets below row n1-2; the tail are
    padding lanes writing the fills to (0, n1-1); of the real lanes, one
    targets an out-of-range row and one an out-of-range doc (dropped),
    one row -2 (wrapped to n1-2, which no other lane targets)."""
    g = np.random.default_rng(seed)
    cols = [g.integers(-1, n1, size=(b, n1)).astype(np.int32) for _ in range(6)]
    real = max(0, k - 5)
    flat = g.choice(b * (n1 - 2), size=real, replace=False)
    packed = np.empty((8, k), np.int64)
    packed[0, :real], packed[1, :real] = flat // (n1 - 2), flat % (n1 - 2)
    packed[2:, :real] = g.integers(-(2**31), 2**31, size=(6, real))
    packed[0, real:], packed[1, real:] = 0, n1 - 1
    for j, (_key, fill) in enumerate(YATA_FILLS):
        packed[2 + j, real:] = fill
    if real >= 3:
        packed[1, 0] = n1 + 3   # dropped
        packed[0, 1] = b + 1    # dropped
        packed[1, 2] = -2       # wraps to row n1-2
    return cols, packed.astype(np.int32)


def _statics_dict(cols):
    return dict(zip(kernels.STATIC_KEYS, cols))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 65, 8), (3, 129, 200), (64, 2049, 70000)])
def test_scatter_statics_kernel_matches_plain(cuda_device, shape):
    b, n1, k = shape
    cols, packed = statics_case(23 + b, b, n1, k)
    ref = kernels.scatter_statics_plain(
        _statics_dict(_torch(cols, cuda_device)),
        torch.from_numpy(packed).to(cuda_device),
    )
    before = kernels.launches["scatter_statics"]
    got = kernels.scatter_statics(
        _statics_dict(_torch(cols, cuda_device)),
        torch.from_numpy(packed).to(cuda_device),
    )
    torch.cuda.synchronize()
    assert kernels.launches["scatter_statics"] == before + 1
    for key in kernels.STATIC_KEYS:
        assert torch.equal(ref[key], got[key]), key


# (b, w_pad, cap_min, clients): W of 1, 33 and 2048 (the thread stride
# over lanes), a visit row past 48 KB (cap_min), small client ids only
YATA_SHAPES = [
    (4, 1, 64, YATA_CLIENTS),
    (3, 33, 64, YATA_CLIENTS),
    (2, 2048, 64, YATA_CLIENTS),
    (2, 1, 16384, YATA_CLIENTS),
    (5, 1, 64, (11, 12, 13)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("epoch_max", [None, 40])
@pytest.mark.parametrize("shape", YATA_SHAPES)
def test_yata_kernels_match_plain(cuda_device, hang_guard, shape, epoch_max,
                                  monkeypatch):
    """K5 and K6 against their plain versions, flush by flush, on the same
    tables; ``epoch_max`` 40 forces the visit-epoch restart often."""
    if epoch_max is not None:
        monkeypatch.setattr(kernels, "EPOCH_MAX", epoch_max)
    b, w_pad, cap_min, clients = shape
    cap, s1, stages = yata_case(31 + b, b, w_pad=w_pad, cap_min=cap_min,
                                clients=clients)

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)

    def statics_of(stage):
        return {k: to(stage[k]) for k in kernels.STATIC_KEYS}

    for kernel, plain, name in (
        (kernels.batch_step, kernels.batch_step_plain, "batch_step"),
        (kernels.batch_step_levels, kernels.batch_step_levels_plain,
         "batch_step_levels"),
    ):
        ref = _torch(yata_tables(b, cap, s1), cuda_device)
        got = _torch(yata_tables(b, cap, s1), cuda_device)
        for stage in stages:
            run_yata(plain, stage, ref, statics_of, to)
            before = kernels.launches[name]
            out = run_yata(kernel, stage, got, statics_of, to)
            torch.cuda.synchronize()
            assert kernels.launches[name] == before + 1
            assert all(o is g for o, g in zip(out, got))
            for r, o in zip(ref, got):
                assert torch.equal(r, o), name


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [0, 3])
def test_yata_kernels_on_an_empty_schedule(cuda_device, hang_guard, levels):
    """No work: the tables come back untouched, apart from the NULL writes
    the level kernel's masked lanes make to the scratch rows."""
    b, cap, s1, w = 3, 63, 9, 4
    tables = yata_tables(b, cap, s1)
    stage = {
        "splits": np.full((b, 1, 2), NULL, np.int32),
        "sched": np.full((b, levels, 4), NULL, np.int32),
        "lv": np.full((b, levels, w, 8), NULL, np.int32),
        "dels": np.full((b, 1), NULL, np.int32),
        "scratch": np.full(b, 10, np.int32),
    }
    g = np.random.default_rng(5)
    for key, fill in YATA_FILLS:
        stage[key] = g.integers(-1, cap, size=(b, cap + 1)).astype(np.int32)

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)

    def statics_of(st):
        return {k: to(st[k]) for k in kernels.STATIC_KEYS}

    for kernel, plain in (
        (kernels.batch_step, kernels.batch_step_plain),
        (kernels.batch_step_levels, kernels.batch_step_levels_plain),
    ):
        ref = run_yata(plain, stage, _torch(tables, cuda_device), statics_of, to)
        got = run_yata(kernel, stage, _torch(tables, cuda_device), statics_of, to)
        torch.cuda.synchronize()
        for r, o in zip(ref, got):
            assert torch.equal(r, o)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["1", "0"])
@pytest.mark.parametrize("lane", ["levels", "seq"])
def test_yata_engine_on_card_matches_cpu_twin(cuda_device, hang_guard, lane,
                                              pipeline, monkeypatch):
    """The device lanes on the card: after each flush the tables and the
    six statics equal the CPU twin's untrimmed; exports equal a CPU Doc.
    Client ids at and above 2**31 edit concurrently."""
    monkeypatch.setenv("YTPU_KERNEL", lane)
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", pipeline)
    monkeypatch.setenv("YTPU_EXPORT_DEVICE", "1")
    monkeypatch.setenv("YTPU_BLOCK_LEVELS", "2")
    per_doc = [yata_session(seed, n_ops=40) for seed in range(4)]
    eng = BatchEngine(4, device=cuda_device)
    twin = BatchEngine(4, device="cpu")
    for j in range(len(per_doc[0])):
        for e in (eng, twin):
            for i, ups in enumerate(per_doc):
                e.queue_update(i, ups[j])
        if j % 5 == 4:
            eng.flush()
            twin.flush()
            torch.cuda.synchronize()
            for a, b in zip(
                (eng._right, eng._deleted, eng._starts),
                (twin._right, twin._deleted, twin._starts),
            ):
                assert torch.equal(a.cpu(), b)
            for key in kernels.STATIC_KEYS:
                assert torch.equal(eng._statics[key].cpu(), twin._statics[key])
    eng.flush()
    for i, ups in enumerate(per_doc):
        doc = Y.Doc(gc=False)
        for u in ups:
            Y.apply_update(doc, u)
        assert eng.text(i) == doc.get_text("text").to_string()


# -- K7, K11, K12: the broadcast kernels and the segment planner's --------------

INT64_MAX = np.iinfo(np.int64).max


def planner_corpus(shape: str, seed: int, n_ops: int = 90) -> list[bytes]:
    """Seeded incremental updates from concurrent editors, one list per
    (shape, seed): ``prepend_storm``, ``interleaved``, ``storm`` (four
    clients typing near the start) or ``b4_head`` (single-char typing and
    backspace runs at a mostly sequential cursor, periodic syncs).  The
    corpus generator of the JAX package's segment-planner tests, written
    against this package's core (the bytes are the same)."""
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
        sv = Y.encode_state_vector(d)
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
        out.append(Y.encode_state_as_update(d, sv))
        sync_p = 0.05 if shape == "storm" else 0.3
        if gen.random() < sync_p:
            k = gen.randrange(n_clients)
            if k != j:
                Y.apply_update(docs[k], Y.encode_state_as_update(d))
    return out


PLANNER_SHAPES = ("prepend_storm", "interleaved", "storm", "b4_head")


def scan_case(seed: int, n: int, n_docs: int = 0, pad: int = 0,
              wide: bool = False):
    """One seeded K12 case: ``(cols, doc_id)`` with the seven int64
    columns (client, clock, length, o_cl, o_ck, r_cl, r_ck) of ``n`` real
    refs plus ``pad`` padding lanes as the planner pads them (client -1,
    doc -1, clocks and lengths 0), and a sorted doc-id column over
    ``n_docs`` docs (None when 0).  Origins often fall inside, at the
    edges of, or just past the previous ref's id range; ``wide`` moves
    clocks and client ids past 2**31 (true int64)."""
    g = np.random.default_rng(seed)
    client = g.integers(0, 4, n)
    length = g.integers(1, 5, n)
    clock = np.cumsum(length + g.integers(0, 2, n)) - length
    prev_cl, prev_ck = np.roll(client, 1), np.roll(clock, 1)
    prev_len = np.roll(length, 1)

    def anchor(p_same):
        same = g.random(n) < p_same
        cl = np.where(same, prev_cl, g.integers(-1, 4, n))
        ck = prev_ck + (g.random(n) * (prev_len + 2)).astype(np.int64) - 1
        return cl, ck

    o_cl, o_ck = anchor(0.7)
    r_cl, r_ck = anchor(0.4)
    if wide:
        big = 2**33
        client, o_cl, r_cl = (np.where(c >= 0, c + big, c)
                              for c in (client, o_cl, r_cl))
        clock, o_ck, r_ck = clock + big, o_ck + big, r_ck + big
    cols = [np.asarray(c, np.int64) for c in
            (client, clock, length, o_cl, o_ck, r_cl, r_ck)]
    fills = (-1, 0, 0, -1, 0, -1, 0)
    cols = [np.concatenate([c, np.full(pad, f, np.int64)])
            for c, f in zip(cols, fills)]
    doc_id = None
    if n_docs:
        doc_id = np.concatenate([np.sort(g.integers(0, n_docs, n)),
                                 np.full(pad, -1)]).astype(np.int64)
    return cols, doc_id


def lookup_case(seed: int, n_hay: int, n_q: int, wide: bool = False,
                pad: bool = True):
    """One seeded K11 case: ``(flat_key, q_key)`` int64.  The haystack
    is sorted and distinct, padded to a power of two with int64.max when
    ``pad``; the queries mix exact keys, keys one off, keys below and
    above every real key and -1 (absent anchors), -1 padded when ``pad``.
    ``wide`` puts every real key past 2**31."""
    g = np.random.default_rng(seed)
    keys = np.sort(g.choice(10 * n_hay + 10, n_hay, replace=False))
    keys = keys.astype(np.int64)
    if wide:
        keys = keys * 2**20 + 2**33
    pick = keys[g.integers(0, max(1, n_hay), n_q)] if n_hay else np.zeros(
        n_q, np.int64)
    q = pick + g.integers(-1, 2, n_q)
    kind = g.random(n_q)
    q = np.where(kind < 0.1, -1, q)
    q = np.where((kind >= 0.1) & (kind < 0.15), 2**62, q)
    q = q.astype(np.int64)
    if pad:
        keys = np.concatenate(
            [keys, np.full(_bucket(max(1, n_hay), 64) - n_hay, INT64_MAX)])
        q = np.concatenate([q, np.full(_bucket(n_q, 64) - n_q, -1)])
    return keys.astype(np.int64), q.astype(np.int64)


def shared_case(seed: int, n_docs: int, n_ops: int = 60):
    """One seeded broadcast (B4-shape) case: a seeded session planned
    once by a Python mirror with the levels plan (its segment planner on
    the CPU), packed as one shared delta and one shared levels plan:
    ``statics`` (six ``[cap+1]`` int32 columns, ``client_key`` as its bit
    pattern), ``splits [S, 2]``, ``lv [L, W, 8]``, ``dels [D]``, the K7a
    ``lanes`` with ``k_l``, ``k_h``, ``k_d``, fresh ``tables`` for
    ``n_docs`` docs, ``scratch [n_docs]``, and ``n``, ``n_segs``."""
    from yjs_tpu_torch.ops.columns import DocMirror

    mirror = DocMirror("text", device="cpu")
    for u in yata_session(seed, n_ops):
        mirror.ingest(u)
    plan = mirror.prepare_step(want_levels=True)
    n = mirror.n_rows
    w_pad = max(plan.max_width, 1)
    cap = max(64, n + 2 * w_pad)
    s1 = max(8, mirror.n_segs) + 1
    cols = mirror.static_columns()
    statics = {}
    for key, fill in YATA_FILLS:
        col = np.full(cap + 1, fill, np.int64)
        col[:n] = cols[key]
        statics[key] = (col.astype(np.uint32).view(np.int32)
                        if key == "client_key" else col.astype(np.int32))
    packed = plan.packed_levels()
    lv = np.full((max(1, len(packed)), w_pad, 8), NULL, np.int32)
    for j, entries in enumerate(packed):
        if entries:
            lv[j, : len(entries)] = entries
    splits = np.full((max(1, len(plan.splits)), 2), NULL, np.int32)
    if plan.splits:
        splits[: len(plan.splits)] = np.asarray(plan.splits, np.int32)
    dels = np.full(max(1, len(plan.delete_rows)), NULL, np.int32)
    if plan.delete_rows:
        dels[: len(plan.delete_rows)] = np.asarray(plan.delete_rows, np.int32)

    def pad_lanes(idx, vals, minimum, oob):
        i = np.full(_bucket(max(1, len(idx)), minimum), oob, np.int32)
        i[: len(idx)] = np.asarray(idx, np.int32)
        if vals is None:
            return i, None
        v = np.full(len(i), NULL, np.int32)
        v[: len(idx)] = np.asarray(vals, np.int32)
        return i, v

    rows, vals = pad_lanes(plan.link_rows, plan.link_vals, 64, cap + 1)
    segs, hvals = pad_lanes(plan.head_segs, plan.head_vals, 8, s1)
    dl, _ = pad_lanes(plan.delete_rows, None, 64, cap + 1)
    return {
        "statics": statics, "splits": splits, "lv": lv, "dels": dels,
        "lanes": np.concatenate([rows, vals, segs, hvals, dl]),
        "k_l": len(rows), "k_h": len(segs), "k_d": len(dl),
        "tables": yata_tables(n_docs, cap, s1),
        "scratch": np.full(n_docs, n, np.int32),
        "n": n, "n_segs": mirror.n_segs,
    }


def replicated(case):
    """K1's lanes buffer and K6's per-doc inputs carrying ``case``'s
    shared delta and levels plan once per doc."""
    b = case["tables"][0].shape[0]
    lanes, k_l, k_h = case["lanes"], case["k_l"], case["k_h"]
    rows, vals = lanes[:k_l], lanes[k_l : 2 * k_l]
    segs = lanes[2 * k_l : 2 * k_l + k_h]
    hvals = lanes[2 * k_l + k_h : 2 * k_l + 2 * k_h]
    dels = lanes[2 * k_l + 2 * k_h :]
    counts = np.concatenate([np.zeros(b), np.full(b, k_l), np.full(b, k_h),
                             np.full(b, len(dels))]).astype(np.int32)
    k1 = np.concatenate([counts, np.tile(rows, b), np.tile(vals, b),
                         np.tile(segs, b), np.tile(hvals, b),
                         np.tile(dels, b)]).astype(np.int32)
    widths = (0, b * k_l, b * k_h, b * len(dels))
    k6 = {key: np.array(np.broadcast_to(v, (b, *v.shape)))
          for key, v in case["statics"].items()}
    for key in ("splits", "lv", "dels"):
        k6[key] = np.array(
            np.broadcast_to(case[key], (b, *case[key].shape)))
    return k1, widths, k6


def trimmed(dyn, n: int, n_segs: int):
    right, deleted, starts = (np.asarray(t.cpu()) for t in dyn)
    return right[:, :n], deleted[:, :n], starts[:, :n_segs]


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("shape", [(1, 0, 0), (5, 0, 59), (1023, 0, 1),
                                   (3000, 7, 1096), (600_000, 1024, 448_576),
                                   (3_000_000, 4096, 145_728)])
def test_conflict_scan_kernel_matches_plain(cuda_device, shape, wide):
    """K12, per-doc and chunk, against its plain version; the two largest
    cases have 2**20 and 3 * 2**20 lanes (1024 and 3072 tiles: the
    offsets pass then carries its running total over three rounds)."""
    n, n_docs, pad = shape
    cols, doc_id = scan_case(n + n_docs, n, max(1, n_docs), pad, wide)
    ts = _torch(cols, cuda_device)
    doc = torch.from_numpy(doc_id).to(cuda_device)
    for d, key in ((None, "conflict_scan"), (doc, "conflict_scan_chunk")):
        ref = kernels.conflict_scan_plain(*ts, d)
        before = kernels.launches[key]
        got = kernels.conflict_scan(*ts, d)
        torch.cuda.synchronize()
        assert kernels.launches[key] == before + 1
        for r, g in zip(ref, got):
            assert r.dtype == g.dtype and torch.equal(r, g), key


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("sizes", [(0, 5), (1, 64), (37, 300),
                                   (70_000, 500_000)])
def test_anchor_lookup_kernel_matches_plain(cuda_device, sizes, wide):
    """K11 against its plain version: keys past 2**31, int64.max padding
    sorting last, -1 queries, an empty haystack."""
    flat, q = lookup_case(sizes[0] + 7, *sizes, wide=wide)
    flat_t, q_t = _torch((flat, q), cuda_device)
    before = kernels.launches["anchor_lookup"]
    got = kernels.anchor_lookup(flat_t, q_t)
    torch.cuda.synchronize()
    assert kernels.launches["anchor_lookup"] == before + 1
    assert torch.equal(got.cpu(), kernels.anchor_lookup_plain(
        torch.from_numpy(flat), torch.from_numpy(q)))
    np.testing.assert_array_equal(
        got.cpu().numpy(), np.searchsorted(flat, q, side="right") - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_docs", [1, 5, 4096])
def test_broadcast_kernels_match_plain_and_replicated(cuda_device, n_docs):
    """K7a and K7b against their plain versions, against K1 and K6 fed
    the same delta and plan replicated per doc (K6 still launches once),
    and against each other on the live rows."""
    case = shared_case(3, n_docs)
    tables = case["tables"]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    lanes = to(case["lanes"])
    widths = (case["k_l"], case["k_h"], case["k_d"])
    statics = {k: to(v) for k, v in case["statics"].items()}
    shared = (to(case["splits"]), to(case["lv"]), to(case["dels"]),
              to(case["scratch"]))
    k1, k1_widths, k6 = replicated(case)

    ref = kernels.apply_plan_shared_plain(_torch(tables, cuda_device), lanes,
                                          *widths)
    before = kernels.launches["apply_plan_shared"]
    got_a = kernels.apply_plan_shared(_torch(tables, cuda_device), lanes,
                                      *widths)
    torch.cuda.synchronize()
    assert kernels.launches["apply_plan_shared"] == before + 1
    rep = kernels.apply_lanes(_torch(tables, cuda_device), to(k1), *k1_widths)
    for r, g, x in zip(ref, got_a, rep):
        assert torch.equal(r, g) and torch.equal(x, g)

    ref = kernels.batch_step_levels_shared_plain(
        statics, _torch(tables, cuda_device), *shared)
    before = dict(kernels.launches)
    got_b = kernels.batch_step_levels_shared(
        statics, _torch(tables, cuda_device), *shared)
    rep = kernels.batch_step_levels(
        {k: to(k6[k]) for k in kernels.STATIC_KEYS},
        _torch(tables, cuda_device), to(k6["splits"]), to(k6["lv"]),
        to(k6["dels"]), shared[3])
    torch.cuda.synchronize()
    assert kernels.launches["batch_step_levels_shared"] == (
        before["batch_step_levels_shared"] + 1)
    assert kernels.launches["batch_step_levels"] == (
        before["batch_step_levels"] + 1)
    for r, g, x in zip(ref, got_b, rep):
        assert torch.equal(r, g) and torch.equal(x, g)
    for a, b in zip(trimmed(got_a, case["n"], case["n_segs"]),
                    trimmed(got_b, case["n"], case["n_segs"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["interleaved", "storm"])
def test_planner_engine_on_card_matches_cpu_twin(cuda_device, shape,
                                                 monkeypatch):
    """The Python mirror's default (device) planner mode on the card: the
    chunk planner launches K12 (and K11 once anchors stay open), the
    tables equal the CPU twin's after every flush, nothing is demoted."""
    monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    monkeypatch.delenv("YTPU_PLAN_SEGMENT", raising=False)
    monkeypatch.setenv("YTPU_PLAN_CACHE", "0")
    per_doc = [planner_corpus(shape, seed=70 + i, n_ops=60) for i in range(4)]
    eng = BatchEngine(4, device=cuda_device)
    twin = BatchEngine(4, device="cpu")
    before = dict(kernels.launches)
    for j in range(60):
        for e in (eng, twin):
            for i, ups in enumerate(per_doc):
                e.queue_update(i, ups[j])
        if j % 20 == 19:
            eng.flush()
            twin.flush()
            torch.cuda.synchronize()
            assert eng.last_flush_metrics["n_demoted"] == 0
            assert eng.last_flush_metrics["plan_threads"] == 4
            for a, b in zip((eng._right, eng._deleted, eng._starts),
                            (twin._right, twin._deleted, twin._starts)):
                assert torch.equal(a.cpu(), b)
    assert kernels.launches["conflict_scan_chunk"] >= before[
        "conflict_scan_chunk"] + 3
    assert kernels.launches["anchor_lookup"] > before["anchor_lookup"]
    for i, ups in enumerate(per_doc):
        doc = Y.Doc(gc=False)
        for u in ups:
            Y.apply_update(doc, u)
        assert eng.text(i) == doc.get_text("text").to_string()
