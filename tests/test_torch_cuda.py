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
