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


# K8's staged limit on a card whose blocks opt into 227 KB (H100, H200):
# a doc's four planes of d and p, 16 bytes a row
# (kernels.LIST_RANKS_ROW_BYTES), fit up to this N+1
H100_SMEM_OPTIN = 232448
H100_STAGED_ROWS = H100_SMEM_OPTIN // 16
RANK_KINDS = ("chain", "cycle", "wild")


def rank_kind_case(kind: str, seed: int, b: int, n1: int):
    """One seeded K8 case of ``kind`` per doc: "chain", one list through
    every row in a random order, all valid; "cycle", a random order whose
    tail links back into it, with a tail of other rows feeding the cycle
    and some rows valid; "wild", links anywhere in ``[-2 (N+1), 2 (N+1)]``
    and at the int32 extremes (JAX's gather reads a negative link from
    the end and anything else outside ``[0, N+1)`` as INT32_MIN)."""
    g = np.random.default_rng(seed)
    right = np.full((b, n1), NULL, np.int32)
    valid = g.random((b, n1)) < 0.7
    for d in range(b):
        order = g.permutation(n1)
        if kind == "chain":
            right[d, order[:-1]] = order[1:]
            valid[d] = True
        elif kind == "cycle":
            k = int(g.integers(1, n1 + 1))  # rows on the cycle
            ring = order[:k]
            right[d, ring] = np.roll(ring, -1)
            feed = order[k:]
            if len(feed):
                right[d, feed] = g.choice(ring, size=len(feed))
        else:
            right[d] = g.integers(-2 * n1, 2 * n1 + 1, size=n1)
            ext = g.random(n1)
            right[d, ext < 0.05] = np.iinfo(np.int32).min
            right[d, (ext >= 0.05) & (ext < 0.1)] = np.iinfo(np.int32).max
            right[d, (ext >= 0.1) & (ext < 0.3)] = NULL
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


def without_sections(case, drop):
    """``case`` (from :func:`apply_case`) with the sections named in
    ``drop`` ("dense", "sparse", "heads", "dels") emptied: their counts
    zeroed and their lanes cut, so their widths are 0."""
    tables, lanes, widths = case
    b = tables[0].shape[0]
    names = ("dense", "sparse", "heads", "dels")
    per = (1, 2, 2, 1)  # lanes a section's entry takes
    counts = lanes[: 4 * b].reshape(4, b).copy()
    parts, o, out_w = [], 4 * b, []
    for v, (name, w) in enumerate(zip(names, widths)):
        sec = lanes[o : o + per[v] * w]
        o += per[v] * w
        if name in drop:
            counts[v] = 0
            out_w.append(0)
        else:
            parts.append(sec)
            out_w.append(w)
    lanes = np.concatenate([counts.reshape(-1), *parts]).astype(lanes.dtype)
    return tables, lanes, tuple(out_w)


def overlap_case(seed: int, b: int, n1: int, s1: int, dtype):
    """A K1 case whose sparse lanes rewrite rows that its dense lanes
    write in the same doc, with other values: the reference's sequential
    scatters leave the sparse value there."""
    g = np.random.default_rng(seed)
    cap = n1 - 1
    tables = (np.full((b, n1), NULL, np.int32), np.zeros((b, n1), bool),
              np.full((b, s1), NULL, np.int32))
    cnt_dn = g.integers(4, cap, size=b)
    cnt_sp = np.minimum(cnt_dn, 3)
    dense = [g.integers(0, 100, size=c) for c in cnt_dn]
    sp_r = [g.choice(c, size=k, replace=False) for c, k in zip(cnt_dn, cnt_sp)]
    sp_v = [g.integers(1000, 2000, size=k) for k in cnt_sp]
    k_dn, k_sp = int(cnt_dn.sum()), int(cnt_sp.sum())
    lanes = np.concatenate([
        cnt_dn, cnt_sp, np.zeros(2 * b, np.int64), *dense, *sp_r, *sp_v,
    ]).astype(dtype)
    want = [(d, int(r), int(v)) for d in range(b)
            for r, v in zip(sp_r[d], sp_v[d])]
    return tables, lanes, (k_dn, k_sp, 0, 0), want


def _apply_both(device, case, counter: bool = False):
    """K1 and its plain version on fresh copies of ``case``'s tables;
    returns ``(ref, got)`` (with the ``[2]`` counters when asked)."""
    tables, lanes, widths = case
    lanes_d = torch.from_numpy(lanes).to(device)
    c_ref = torch.zeros(2, dtype=torch.int32, device=device) if counter else None
    c_got = torch.zeros(2, dtype=torch.int32, device=device) if counter else None
    ref = kernels.apply_lanes_plain(_torch(tables, device), lanes_d, *widths,
                                    counter=c_ref)
    got = kernels.apply_lanes(_torch(tables, device), lanes_d, *widths,
                              counter=c_got)
    if counter:
        return (*ref, c_ref), (*got, c_got)
    return ref, got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("shape", [(1, 65, 9), (7, 129, 17), (300, 1025, 9)])
def test_apply_lanes_sparse_wins_over_dense(cuda_device, hang_guard, shape, dtype):
    """Dense and sparse lanes write the same rows of one doc: the one
    launch leaves the sparse value, as the plain version's second scatter
    does."""
    tables, lanes, widths, want = overlap_case(41 + shape[0], *shape, dtype)
    ref, got = _apply_both(cuda_device, (tables, lanes, widths))
    torch.cuda.synchronize()
    for r, o in zip(ref, got):
        assert torch.equal(r, o)
    right = got[0].cpu().numpy()
    assert all(right[d, r] == v for d, r, v in want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("drop", [("sparse",), ("dense",), ("dense", "sparse"),
                                  ("heads", "dels"),
                                  ("dense", "sparse", "heads", "dels")])
def test_apply_lanes_empty_sections(cuda_device, hang_guard, drop, dtype):
    """Sections of width 0 (no sparse lanes, no dense lanes, neither, no
    heads or deletes, none at all): tables and counters equal the plain
    version's, one launch a call."""
    case = without_sections(apply_case(23, 64, 129, 17, dtype), drop)
    assert all(w == 0 for w, name in zip(case[2], ("dense", "sparse",
                                                   "heads", "dels"))
               if name in drop)
    before = kernels.launches["apply_lanes"]
    ref, got = _apply_both(cuda_device, case, counter=True)
    torch.cuda.synchronize()
    assert kernels.launches["apply_lanes"] == before + 1
    for r, o in zip(ref, got):
        assert torch.equal(r, o)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("shape", [
    (1, 9, 3), (1, 4097, 9), ("staged_max", 17, 5), ("staged_max+1", 17, 5),
    (65536, 17, 5)])
def test_apply_lanes_doc_count_edges(cuda_device, hang_guard, shape, dtype):
    """B = 1 (one doc, the scan a single tile), the most docs the
    "staged" variant takes on this card and one more ("global"), and
    B = 65,536 (eight scan tiles a count vector), with counters."""
    b, n1, s1 = shape
    limit = kernels._cuda.smem_optin(torch.device("cuda", 0))
    top = kernels.apply_stage_max(limit)
    b = {"staged_max": top, "staged_max+1": top + 1}.get(b, b)
    ref, got = _apply_both(cuda_device, apply_case(31 + b, b, n1, s1, dtype),
                           counter=True)
    torch.cuda.synchronize()
    assert (kernels.last_variant["apply_lanes"]
            == kernels.apply_variant(b, limit))
    for r, o in zip(ref, got):
        assert torch.equal(r, o)


@pytest.mark.cuda
def test_apply_lanes_counters_reset_between_calls(cuda_device, hang_guard):
    """200 calls back to back on one stream, and so on one scratch, of
    cases with other grid sizes in turn: each equals the plain version,
    so each launch found the counters zero."""
    cases = [apply_case(51 + i, b, n1, 9, dt) for i, (b, n1, dt) in enumerate(
        ((3, 65, np.int32), (64, 1025, np.int16), (17, 257, np.int32)))]
    refs = []
    for tables, lanes, widths in cases:
        lanes_d = torch.from_numpy(lanes).to(cuda_device)
        refs.append(kernels.apply_lanes_plain(_torch(tables, cuda_device),
                                              lanes_d, *widths))
    inputs = [(_torch(t, cuda_device), torch.from_numpy(l).to(cuda_device), w)
              for t, l, w in cases]
    key = (cuda_device if cuda_device.index is not None
           else torch.device("cuda", torch.cuda.current_device()))
    for i in range(200):
        tables, lanes_d, widths = inputs[i % 3]
        fresh = tuple(t.clone() for t in tables)
        got = kernels.apply_lanes(fresh, lanes_d, *widths)
        torch.cuda.synchronize()
        for r, o in zip(refs[i % 3], got):
            assert torch.equal(r, o), f"call {i}"
    scratch = [v for (dev, _s), v in kernels._apply_scratch_by_stream.items()
               if dev == key]
    assert scratch and all(
        not bool(v[:kernels._cuda.APPLY_SYNC_INTS].any()) for v in scratch)


@pytest.mark.cuda
def test_apply_lanes_two_streams_own_scratch(cuda_device, hang_guard):
    """K1 enqueued on two streams in turn, neither waiting on the other:
    each stream keeps its own scratch, and every result equals the plain
    version."""
    case = apply_case(61, 256, 1025, 9, np.int16)
    tables, lanes, widths = case
    lanes_d = torch.from_numpy(lanes).to(cuda_device)
    ref = kernels.apply_lanes_plain(_torch(tables, cuda_device), lanes_d,
                                    *widths)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    outs = {0: [], 1: []}
    made = {}
    torch.cuda.synchronize()
    for i in range(20):
        k = i % 2
        with torch.cuda.stream(streams[k]):
            fresh = tuple(t.clone() for t in _torch(tables, cuda_device))
            outs[k].append(kernels.apply_lanes(fresh, lanes_d, *widths))
            dev = lanes_d.device
            made[k] = kernels._apply_scratch_by_stream[
                (dev, streams[k].cuda_stream)]
    torch.cuda.synchronize()
    assert made[0] is not made[1]
    assert made[0].data_ptr() != made[1].data_ptr()
    for k in (0, 1):
        for got in outs[k]:
            for r, o in zip(ref, got):
                assert torch.equal(r, o)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("n_shards", [1, 4, 16, 17, 33, "global"])
def test_sharded_apply_shard_counts(cuda_device, hang_guard, n_shards, dtype):
    """K14 over 1, 4, 16, 17 and 33 shards of one card, and over four
    shards whose largest takes the "global" variant, with counters:
    tables and counters equal the plain version's, one launch per 16
    shards."""
    limit = kernels._cuda.smem_optin(torch.device("cuda", 0))
    if n_shards == "global":
        sizes = [5, kernels.apply_stage_max(limit) + 1, 0, 3]
        n_shards = len(sizes)
    else:
        sizes = [3 + (s % 5) for s in range(n_shards)]
    tables, lanes, widths = sharded_apply_case(97 + n_shards, sizes, 65, 9,
                                               dtype)
    rows = [torch.from_numpy(r).to(cuda_device) for r in lanes]
    ref = [_torch(t, cuda_device) for t in tables]
    got = [_torch(t, cuda_device) for t in tables]
    ref_c = list(torch.zeros((n_shards, 2), dtype=torch.int32,
                             device=cuda_device))
    got_c = list(torch.zeros((n_shards, 2), dtype=torch.int32,
                             device=cuda_device))
    for s in range(n_shards):
        kernels.apply_lanes_plain(ref[s], rows[s], *widths, counter=ref_c[s])
    before = kernels.launches["sharded_apply_plan"]
    kernels.sharded_apply_lanes(got, rows, widths, got_c)
    torch.cuda.synchronize()
    live = sum(1 for b in sizes if b)
    assert (kernels.launches["sharded_apply_plan"]
            == before + -(-live // 16))
    assert (kernels.last_variant["sharded_apply_plan"]
            == kernels.apply_variant(max(sizes), limit))
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            assert torch.equal(a, b)
    for r, g in zip(ref_c, got_c):
        assert torch.equal(r, g)


def scatter_edge_case(seed: int, b: int, n1: int, s1: int, k: int):
    """A K2 case from :func:`scatter_case` with some of its ``idx`` written
    negative (counting back from the end to the same docs) and indices
    outside ``[-B, B)`` added (dropped), with rows of their own."""
    tables, (idx, nr, nd, ns) = scatter_case(seed, b, n1, s1, k)
    g = np.random.default_rng(seed + 1)
    idx = idx.astype(np.int64)
    neg = g.random(k) < 0.3
    idx[neg] -= b
    wild = np.array([b, b + 7, -b - 1, -2 * b][: max(1, min(4, k))])
    extra = len(wild)
    idx = np.concatenate([idx, wild]).astype(np.int32)
    nr = np.concatenate([nr, g.integers(-1, n1, size=(extra, n1))]).astype(
        np.int32)
    nd = np.concatenate([nd, g.random((extra, n1)) < 0.5])
    ns = np.concatenate([ns, g.integers(-1, n1, size=(extra, s1))]).astype(
        np.int32)
    perm = g.permutation(len(idx))
    return tables, (idx[perm], nr[perm], nd[perm], ns[perm])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (64, 1024, 17, 20), (64, 1025, 9, 20), (64, 1026, 5, 20),
    (64, 1027, 33, 20),  # N+1 mod 4 = 0, 1, 2, 3
    (16, 65, 301, 5),  # S+1 larger than N+1
    (32, 4097, 9, 1), (32, 4100, 9, 32),  # k = 1, k = B
    (8, 16385, 17, 8),  # rows wider than one block copies
])
def test_scatter_rows_alignments_and_indices(cuda_device, shape):
    """K2 on every row alignment mod 16 (N+1 mod 4 = 0-3 over random doc
    and source rows), S+1 above N+1, one row and every row, rows wider
    than one block, negative and out-of-range ``idx``: equal to the plain
    version, one launch a call."""
    b, n1, s1, k = shape
    tables, rows = scatter_edge_case(71 + n1, b, n1, s1, k)
    ref = kernels.scatter_rows_plain(
        *_torch(tables, cuda_device), *_torch(rows, cuda_device))
    before = kernels.launches["scatter_rows"]
    got = kernels.scatter_rows(
        *_torch(tables, cuda_device), *_torch(rows, cuda_device))
    torch.cuda.synchronize()
    assert kernels.launches["scatter_rows"] == before + 1
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
    assert kernels.last_variant["list_ranks"] == "staged"


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [None, "staged", "global"])
@pytest.mark.parametrize("kind", ("lists",) + RANK_KINDS)
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 2049), (1, 4097),
                                   (5, 300), (1, H100_STAGED_ROWS),
                                   (1, H100_STAGED_ROWS + 1)])
def test_list_ranks_variants_match_plain(cuda_device, shape, kind, variant,
                                         monkeypatch):
    """K8 in each variant, forced (None: the one the size picks), against
    its plain version on lists, one chain through the row, cycles and
    wild links, with the rounds run counted alike; the staged variant
    only where a doc's planes fit the card's opt-in shared memory."""
    from yjs_tpu_torch.ops import _cuda

    b, n1 = shape
    limit = _cuda.smem_optin(cuda_device)
    natural = kernels.list_ranks_variant(n1, limit)
    if variant == "staged" and natural != "staged":
        variant = None  # past the limit the staged launch is refused
    if variant is not None:
        monkeypatch.setattr(kernels, "list_ranks_variant",
                            lambda _n1, _limit: variant)
    case = (ranks_case(13 + n1, b, n1) if kind == "lists"
            else rank_kind_case(kind, 17 + n1, b, n1))
    right, valid = _torch(case, cuda_device)
    ref_c = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got_c = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    ref = kernels.list_ranks_plain(right, valid, ref_c)
    before = kernels.launches["list_ranks"]
    got = kernels.list_ranks(right, valid, got_c)
    torch.cuda.synchronize()
    assert kernels.launches["list_ranks"] == before + 1
    assert kernels.last_variant["list_ranks"] == (variant or natural)
    assert natural == ("staged" if n1 <= H100_STAGED_ROWS else "global")
    assert torch.equal(ref, got)
    assert torch.equal(ref_c, got_c)


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


# K10 at its edges: N not a multiple of 4 (a thread's four rows cross
# doc boundaries), one row a doc, B past a grid's y limit, the checkpoint's
# empty state vectors, and state-vector rows past the block's staging
DIFF_EDGE_SHAPES = [
    (5, 1, 1), (7, 3, 2), (9, 5, 3), (4096, 1102, 3), (70_000, 3, 2),
    (3, 1102, 3000),  # one doc's state vector past the staging limit
    (2000, 1, 3),  # a block's 1024 docs x 3 slots past the staging limit
]


def diff_case(kind: str, seed: int, b: int, n: int, n_slots: int):
    """One K10 case: ``sync_case``'s, its ``wide`` variant (``remote -
    clock`` wraps), or the checkpoint's (``empty``: a zero remote state
    vector, so every row with a slot is needed)."""
    case = sync_case(seed, b, n, n_slots, wide=kind == "wide")
    if kind == "empty":
        case = (*case[:3], np.zeros_like(case[3]))
    return case


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.flatten())
    return buf[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["seeded", "wide", "empty"])
@pytest.mark.parametrize("shape", DIFF_EDGE_SHAPES)
def test_diff_mask_kernel_edges(cuda_device, shape, kind):
    b, n, n_slots = shape
    case = diff_case(kind, 23 + n, b, n, n_slots)
    args = _torch(case, cuda_device)
    ref = kernels.diff_mask_kernel_plain(*args)
    before = kernels.launches["diff_mask"]
    got = kernels.diff_mask_kernel(*args)
    torch.cuda.synchronize()
    assert kernels.launches["diff_mask"] == before + 1
    for r, o in zip(ref, got):
        assert o.shape == (b, n) and torch.equal(r, o)
    if kind == "empty":  # the checkpoint: every row with a slot
        assert torch.equal(got[0].cpu(), torch.from_numpy(case[0] >= 0))


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(9, 5, 3), (64, 1102, 4)])
def test_diff_mask_kernel_unaligned_views(cuda_device, shape, which):
    """A column that starts off a 16-byte boundary takes the scalar
    loads; the result is the same."""
    b, n, n_slots = shape
    args = list(_torch(sync_case(29 + n, b, n, n_slots), cuda_device))
    args[which] = unaligned(args[which])
    assert args[which].data_ptr() % 16 == 4
    ref = kernels.diff_mask_kernel_plain(*args)
    got = kernels.diff_mask_kernel(*args)
    torch.cuda.synchronize()
    for r, o in zip(ref, got):
        assert torch.equal(r, o)


@pytest.mark.cuda
def test_diff_mask_kernel_output_views_and_checks(cuda_device):
    """One buffer holds offset and needed (the layout of
    ``_cuda.diff_layout``); wrong inputs raise before any launch."""
    b, n = 6, 7
    args = _torch(sync_case(3, b, n, 4), cuda_device)
    needed, offset = kernels.diff_mask_kernel(*args)
    at, _nbytes = kernels._cuda.diff_layout(b * n)
    assert offset.untyped_storage().data_ptr() == \
        needed.untyped_storage().data_ptr() == offset.data_ptr()
    assert needed.data_ptr() == offset.data_ptr() + at
    before = dict(kernels.launches)
    for bad, err in ((args[0].long(), TypeError),
                     (args[0][:, :5], ValueError),
                     (args[0].t(), ValueError),
                     (args[0].cpu(), ValueError)):
        with pytest.raises(err):
            kernels.diff_mask_kernel(bad, *args[1:])
    with pytest.raises(ValueError):
        kernels.diff_mask_kernel(*args[:3], args[3][:, :0])
    assert kernels.launches == before


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


@pytest.mark.cuda
def test_fleet_on_card_matches_cpu_twin(cuda_device, hang_guard, tmp_path):
    """A fleet's shards all live on the card and share its scratch: after
    a flush, a live migration, a kill with its failover and a revive,
    every shard's trimmed tables and every room's state equal a CPU twin
    fleet's fed the same bytes; ``apply_lanes`` launches on the flushes."""
    from yjs_tpu_torch.fleet import FleetRouter
    from yjs_tpu_torch.ops.carry import trim_tables

    card = FleetRouter(2, 64, wal_dir=str(tmp_path / "card"), device="cuda")
    twin = FleetRouter(2, 64, wal_dir=str(tmp_path / "cpu"), device="cpu")
    assert all(p.engine.device.type == "cuda" for p in card.shards)
    rooms = [f"r{i}" for i in range(24)]
    for i, g in enumerate(rooms):
        for u in edit_trace(i):
            card.receive_update(g, u)
            twin.receive_update(g, u)

    def equal(what):
        card.flush()
        twin.flush()
        assert card.table.epoch == twin.table.epoch, what
        for k, (a, b) in enumerate(zip(card.shards, twin.shards)):
            assert card._is_stub(k) == twin._is_stub(k), what
            if card._is_stub(k):
                continue
            assert a._guids == b._guids, what
            for x, y in zip(trim_tables(a.engine), trim_tables(b.engine)):
                assert (x is None) == (y is None), what
                if x is not None:
                    for u, v in zip(x, y):
                        np.testing.assert_array_equal(u, v, err_msg=what)
        for g in rooms:
            assert card.owner_of(g) == twin.owner_of(g), what
            assert (card.encode_state_as_update(g)
                    == twin.encode_state_as_update(g)), (what, g)

    before = kernels.launches["apply_lanes"]
    equal("flush")
    assert kernels.launches["apply_lanes"] >= before + 2
    for f in (card, twin):
        f.migrate_doc("r0", 1 - f.owner_of("r0"))
    equal("migration")
    victim = card.owner_of("r1")
    for f in (card, twin):
        f.tick()  # replica copies seeded
        f.kill_shard(victim)
    assert card.fail_over(victim) == twin.fail_over(victim)
    equal("failover")
    assert card.revive_shard(victim) == twin.revive_shard(victim)
    assert card.shards[victim].engine.device.type == "cuda"
    equal("revive")
    for g in rooms[:4]:
        assert card.text(g) == twin.text(g) != ""


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
# over lanes; at 2048 the doc holds 8193 rows), docs of 16385 rows, small
# client ids only, then docs of 2049 and 65537 rows
YATA_SHAPES = [
    (4, 1, 64, YATA_CLIENTS),
    (3, 33, 64, YATA_CLIENTS),
    (2, 2048, 64, YATA_CLIENTS),
    (2, 1, 16384, YATA_CLIENTS),
    (5, 1, 64, (11, 12, 13)),
    (2, 1, 2048, YATA_CLIENTS),
    (2, 1, 65536, YATA_CLIENTS),
]
# the variant a doc of N+1 rows and few segments takes on a card whose
# blocks opt into 227 KB (H100, H200): staged whole while an SM holds
# sixteen such docs (these tests' docs of 129 and 257 rows), without its
# visit row while it holds sixteen of those, else not staged
H100_VARIANT = {2049: "rows", 8193: "global", 16385: "global",
                65537: "global"}


def launched_variant(name: str, n1: int, s1: int, w: int):
    """The variant the YATA wrapper ``name`` launched last: the one
    ``kernels.yata_variant`` picks for the card, H100_VARIANT's for a
    doc of ``n1`` rows, else "shared"."""
    from yjs_tpu_torch.ops import _cuda

    want, _ = kernels.yata_variant(n1, s1, w,
                                   _cuda.smem_optin(torch.device("cuda")))
    assert kernels.last_variant[name] == want
    assert want == H100_VARIANT.get(n1, "shared")
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("epoch_max", [None, 40])
@pytest.mark.parametrize("shape", YATA_SHAPES)
def test_yata_kernels_match_plain(cuda_device, hang_guard, shape, epoch_max,
                                  monkeypatch):
    """K5 and K6 against their plain versions, flush by flush, on the same
    tables, in the variant each shape's size picks; ``epoch_max`` 40
    forces the visit-epoch restart often."""
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
            w = 0 if name == "batch_step" else max(1, stage["lv"].shape[2])
            launched_variant(name, cap + 1, s1, w)
            assert all(o is g for o, g in zip(out, got))
            for r, o in zip(ref, got):
                assert torch.equal(r, o), name


@pytest.mark.cuda
@pytest.mark.parametrize("epoch_max", [None, 40])
@pytest.mark.parametrize("cap_min", [64, 2048, 65536])
def test_shared_and_sharded_levels_variants_match_plain(
        cuda_device, hang_guard, cap_min, epoch_max, monkeypatch):
    """K7b (doc 0's plan read by four docs) and K15 (two shards of two
    docs on the card, counting) against their plain versions stage by
    stage, in each variant: whole docs staged, the visit row global,
    nothing staged; ``epoch_max`` 40 restarts the visit epoch often."""
    if epoch_max is not None:
        monkeypatch.setattr(kernels, "EPOCH_MAX", epoch_max)
    b = 4
    cap, s1, stages = yata_case(61, b, w_pad=8, cap_min=cap_min)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    ref_b = _torch(yata_tables(b, cap, s1), cuda_device)
    got_b = _torch(yata_tables(b, cap, s1), cuda_device)
    ref_s = [_torch([t[:2] for t in yata_tables(b, cap, s1)], cuda_device),
             _torch([t[2:] for t in yata_tables(b, cap, s1)], cuda_device)]
    got_s = [tuple(t.clone() for t in tabs) for tabs in ref_s]
    ref_c = list(torch.zeros((2, 2), dtype=torch.int32, device=cuda_device))
    got_c = list(torch.zeros((2, 2), dtype=torch.int32, device=cuda_device))
    for st in stages:
        one = {k: to(st[k][0]) for k in kernels.STATIC_KEYS}
        shared = (to(st["splits"][0]), to(st["lv"][0]), to(st["dels"][0]),
                  to(np.full(b, st["scratch"][0], np.int32)))
        kernels.batch_step_levels_shared_plain(one, ref_b, *shared)
        kernels.batch_step_levels_shared(one, got_b, *shared)
        statics = [{k: to(st[k][h]) for k in kernels.STATIC_KEYS}
                   for h in (slice(0, 2), slice(2, 4))]
        args = [[to(st[k][:2]), to(st[k][2:])]
                for k in ("splits", "lv", "dels", "scratch")]
        for h in range(2):
            kernels.batch_step_levels_plain(statics[h], ref_s[h],
                                            *(a[h] for a in args),
                                            counter=ref_c[h])
        kernels.sharded_batch_step_levels(statics, got_s, *args, got_c)
        torch.cuda.synchronize()
        w = max(1, st["lv"].shape[2])
        launched_variant("batch_step_levels_shared", cap + 1, s1, w)
        launched_variant("sharded_batch_step", cap + 1, s1, w)
        for r, g in zip(ref_b, got_b):
            assert torch.equal(r, g)
        for rs, gs in zip(ref_s, got_s):
            for r, g in zip(rs, gs):
                assert torch.equal(r, g)
    for r, g in zip(ref_c, got_c):
        assert torch.equal(r, g)
    assert int(sum(c[0] for c in got_c)) > 0


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


# K12's cases at its tiles' edges (a tile: _cuda.SCAN_THREADS x
# _cuda.SCAN_LANES lanes)
SCAN_KINDS = ("seeded", "chained", "unchained", "doc_edges")


def scan_edge_case(kind: str, n: int, tile: int, seed: int = 0,
                   wide: bool = False):
    """One K12 case of ``n`` lanes built to cross tiles of ``tile`` lanes:
    ``(cols, doc_id)`` as :func:`scan_case` gives them.

    - ``seeded``: :func:`scan_case` over about one doc per 300 refs;
    - ``chained``: every lane's origin inside the lane before's id range,
      one doc: a single run through every tile (run_id all 1);
    - ``unchained``: no origin at all (run_id ``1..n``);
    - ``doc_edges``: ``chained``'s columns with a new doc at every
      multiple of ``tile``, so the chunk form's chains break exactly at
      the tile edges and the per-doc form's run through them.

    ``wide`` moves clocks and client ids past 2**31."""
    if kind == "seeded":
        return scan_case(seed, n, max(1, n // 300), 0, wide)
    g = np.random.default_rng(seed)
    big = 2**33 if wide else 0
    length = g.integers(1, 5, n)
    clock = np.cumsum(length) - length + big
    client = np.full(n, 3 + big)
    o_ck = np.roll(clock + length - 1 - g.integers(0, length), 1)
    o_cl = client.copy()
    if kind == "unchained":
        o_cl[:] = -1
    r_cl, r_ck = np.full(n, -1), np.zeros(n, np.int64)
    doc = (np.arange(n) // tile if kind == "doc_edges"
           else np.zeros(n, np.int64))
    cols = [np.asarray(c, np.int64) for c in
            (client, clock, length, o_cl, o_ck, r_cl, r_ck)]
    return cols, doc.astype(np.int64)


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


def scan_kernels_a_call(fn, n: int = 3) -> dict | None:
    """The CUDA kernels one call of ``fn()`` launches, by name, from a
    ``torch.profiler`` trace of ``n`` calls after a warm-up call (counts
    divided by ``n``; a trace may lose an event); None when the trace
    records no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            out[e.key] = out.get(e.key, 0) + e.count / n
    return out or None


def _scan_both(cols, doc, check_kernels: bool = True):
    """K12 per doc and per chunk on the card against the plain version:
    one launch a call by the wrapper's count and, where the trace records
    events, one kernel a call by ``torch.profiler``."""
    for d, key in ((None, "conflict_scan"), (doc, "conflict_scan_chunk")):
        ref = kernels.conflict_scan_plain(*cols, d)
        before = kernels.launches[key]
        got = kernels.conflict_scan(*cols, d)
        torch.cuda.synchronize()
        assert kernels.launches[key] == before + 1
        for r, g in zip(ref, got):
            assert r.dtype == g.dtype and r.is_contiguous()
            assert torch.equal(r, g), key
        if check_kernels:
            # a trace may lose an event, so a count can fall short of the
            # launches but never exceed them
            seen = scan_kernels_a_call(lambda: kernels.conflict_scan(*cols, d),
                                       n=10)
            if seen is not None:
                assert len(seen) == 1 and "conflict_scan_kernel" in (
                    next(iter(seen))), seen
                assert 0 < next(iter(seen.values())) <= 1, seen


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("shape", [(1, 0, 0), (5, 0, 59), (1023, 0, 1),
                                   (3000, 7, 1096), (600_000, 1024, 448_576),
                                   (3_000_000, 4096, 145_728),
                                   (2047, 3, 0), (2048, 3, 0), (2049, 3, 0),
                                   (4_000_000, 4096, 194_304)])
def test_conflict_scan_kernel_matches_plain(cuda_device, hang_guard, shape,
                                            wide):
    """K12, per-doc and chunk, against its plain version, one kernel a
    call: 2**20 and 3 * 2**20 lanes (512 and 1536 tiles of 2048), a tile
    less one, a tile and a tile and one, and 2**22 lanes (2048 tiles: a
    deep look-back)."""
    n, n_docs, pad = shape
    cols, doc_id = scan_case(n + n_docs, n, max(1, n_docs), pad, wide)
    _scan_both(_torch(cols, cuda_device),
               torch.from_numpy(doc_id).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("kind", SCAN_KINDS)
@pytest.mark.parametrize("at", ["-1", "0", "+1", "2t-1", "2t+1", "2**20",
                                "2**22"])
def test_conflict_scan_tile_edges(cuda_device, hang_guard, at, kind, wide):
    """K12 a lane before, at and past one and two tiles' edges and at
    2**20 and 2**22 lanes (512 and 2048 tiles): seeded, every lane chained
    (one run through every tile), none chained, and a doc boundary at
    every tile edge, with values past 2**31 as well."""
    tile = kernels._cuda.SCAN_THREADS * kernels._cuda.SCAN_LANES
    n = {"-1": tile - 1, "0": tile, "+1": tile + 1, "2t-1": 2 * tile - 1,
         "2t+1": 2 * tile + 1, "2**20": 1 << 20, "2**22": 1 << 22}[at]
    cols, doc_id = scan_edge_case(kind, n, tile, seed=n, wide=wide)
    assert kernels._cuda.scan_tiles(n) == -(-n // tile)
    _scan_both(_torch(cols, cuda_device),
               torch.from_numpy(doc_id).to(cuda_device),
               check_kernels=at in ("+1", "2**20"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 2049, 1 << 20])
@pytest.mark.parametrize("which", ["client", "doc_id", "all"])
def test_conflict_scan_unaligned_views(cuda_device, hang_guard, which, n):
    """Columns that are views one element into a larger tensor (8-byte but
    not 16-byte aligned), one of them or all: the kernel's scalar loads
    give what the plain version does."""
    cols, doc_id = scan_case(n + 5, n, max(1, n // 300), 0)
    ts = list(_torch(cols, cuda_device))
    doc = torch.from_numpy(doc_id).to(cuda_device)

    def shifted(t):
        wide = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        wide[1:] = t
        view = wide[1:]
        assert view.is_contiguous() and view.data_ptr() % 16 == 8
        return view

    if which in ("client", "all"):
        ts[0] = shifted(ts[0])
    if which == "all":
        ts[1:] = [shifted(t) for t in ts[1:]]
    if which in ("doc_id", "all"):
        doc = shifted(doc)
    _scan_both(ts, doc, check_kernels=False)


@pytest.mark.cuda
def test_conflict_scan_two_streams(cuda_device, hang_guard):
    """K12 enqueued on two streams in turn, neither waiting on the other,
    at several tile counts: each stream keeps its own scratch, every
    result equals the plain version and each scratch is zero after."""
    cases = []
    for i, n in enumerate((1 << 20, 5000, 3 * (1 << 18) + 7)):
        cols, doc_id = scan_case(90 + i, n, max(1, n // 300), 0)
        ts = _torch(cols, cuda_device)
        doc = torch.from_numpy(doc_id).to(cuda_device)
        cases.append((ts, doc, kernels.conflict_scan_plain(*ts, doc)))
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for i in range(24):
        k = i % 2
        ts, doc, _ref = cases[i % 3]
        with torch.cuda.stream(streams[k]):
            outs.append((i % 3, kernels.conflict_scan(*ts, doc)))
    torch.cuda.synchronize()
    dev = cases[0][1].device
    made = [kernels._scan_scratch_by_stream[(dev, s.cuda_stream)]
            for s in streams]
    assert made[0].data_ptr() != made[1].data_ptr()
    for c, got in outs:
        for r, g in zip(cases[c][2], got):
            assert torch.equal(r, g)
    for buf in made:
        assert not bool(buf.any())


@pytest.mark.cuda
def test_conflict_scan_graph_replay(cuda_device, hang_guard):
    """50 chunk calls captured in one CUDA graph and replayed three times,
    and a per-doc call beside them: the scratch left zero by each launch
    is what the next finds, so every replayed result equals the plain
    version."""
    n = 3 * (1 << 18) + 11
    cols, doc_id = scan_case(77, n, 900, 0)
    ts = _torch(cols, cuda_device)
    doc = torch.from_numpy(doc_id).to(cuda_device)
    ref = kernels.conflict_scan_plain(*ts, doc)
    small = [t[:64] for t in ts]
    ref_small = kernels.conflict_scan_plain(*small)
    # a wrapper's first call at a signature synchronises (the kernel
    # profiler times its compile), which a capture may not
    kernels.conflict_scan(*ts, doc)
    kernels.conflict_scan(*small)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for i in range(50):
            outs.append(kernels.conflict_scan(*ts, doc) if i % 10
                        else kernels.conflict_scan(*small))
    for _ in range(3):
        for out in outs:
            for t in out:
                t.fill_(0)
        graph.replay()
        torch.cuda.synchronize()
        for i, out in enumerate(outs):
            for r, g in zip(ref if i % 10 else ref_small, out):
                assert torch.equal(r, g), i


@pytest.mark.cuda
def test_conflict_scan_checks(cuda_device):
    """The wrapper's one check pass: a wrong dtype raises ``TypeError``,
    a 2-D or strided column and a length that differs ``ValueError``,
    before any launch."""
    cols, doc_id = scan_case(5, 300, 3, 0)
    ts = list(_torch(cols, cuda_device))
    doc = torch.from_numpy(doc_id).to(cuda_device)
    before = dict(kernels.launches)
    for bad, err in ((ts[2].int(), TypeError), (ts[2].view(3, 100), ValueError),
                     (torch.cat([ts[2], ts[2]])[::2], ValueError),
                     (ts[2][:299], ValueError)):
        with pytest.raises(err):
            kernels.conflict_scan(*ts[:2], bad, *ts[3:], doc)
    with pytest.raises(TypeError):
        kernels.conflict_scan(*ts, doc.int())
    with pytest.raises(ValueError):
        kernels.conflict_scan(*ts, doc.cpu())
    assert kernels.launches == before


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


def shared_edge_case(seed: int, b: int, n1: int, s1: int,
                     live: tuple[int, int, int], pad: bool = True,
                     kind: str = ""):
    """One seeded K7a case: tables of ``b`` docs (``[b, n1]`` right links
    and deleted marks, ``[b, s1]`` heads, seeded, so that untouched
    entries are checked too) and one lanes vector with ``live`` = (links,
    heads, deletes) real targets a section.

    Real targets are unique within a section after JAX's wrap; about a
    quarter are written in their negative form (counting from the end),
    and up to two a section lie outside the table (dropped).  With
    ``pad``, each section is padded to a power of two as
    ``chip_smoke.shared_plan`` pads it: padding lanes target one past the
    table's last column, padding values are NULL.  ``kind`` holds ``a``:
    the delete targets are one run of neighbouring rows around the
    table's middle, shuffled, so marks share 4-byte words; ``r``: the
    link targets are one run in ascending order (the dropped ones among
    them), as a fresh replay links its rows.  Returns ``(tables, lanes,
    (k_l, k_h, k_d))``."""
    g = np.random.default_rng(seed)

    def section(width, k, runs=False, ordered=False):
        k = min(k, width)
        if runs or ordered:
            start = (width - k) // 2
            r = np.arange(start, start + k)
            if not ordered:
                g.shuffle(r)
        else:
            r = g.choice(width, size=k, replace=False)
        r = r.astype(np.int64)
        neg = g.random(k) < 0.25
        r[neg] -= width
        wild = np.array([width + 3, -(width + 5)][: 2 if k >= 2 else k],
                        np.int64)
        if ordered:
            r = np.insert(r, g.integers(0, len(r) + 1, size=len(wild)), wild)
        else:
            r = np.concatenate([r, wild])
            g.shuffle(r)
        if pad and len(r):
            r = np.concatenate([r, np.full(_bucket(len(r), 1) - len(r),
                                           width)])
        return r

    rows = section(n1, live[0], ordered="r" in kind)
    segs = section(s1, live[1])
    dels = section(n1, live[2], runs="a" in kind)

    def vals(r, oob):
        v = g.integers(-1, n1 - 1, size=len(r))
        v[r == oob] = NULL
        return v

    lanes = np.concatenate([rows, vals(rows, n1), segs, vals(segs, s1), dels])
    tables = (g.integers(-1, n1 - 1, (b, n1)).astype(np.int32),
              g.random((b, n1)) < 0.2,
              g.integers(-1, n1 - 1, (b, s1)).astype(np.int32))
    return tables, lanes.astype(np.int32), (len(rows), len(segs), len(dels))


# (b, n1, s1, live links, heads, deletes, kind): widths not a multiple of
# 4 (rows at every 4-byte phase), each section empty in turn, links as one
# run and scattered, several tiles a section, B past a grid's y limit,
# marks across a delete tile's edge (65,504 rows)
SHARED_EDGES = [
    (1, 1, 1, (1, 1, 1), ""), (3, 3, 2, (2, 1, 2), "a"),
    (5, 5, 3, (4, 2, 3), "ar"), (7, 9373, 9, (0, 3, 40), "a"),
    (6, 1501, 9, (900, 0, 300), ""), (4, 1501, 9, (700, 2, 0), "ar"),
    (9, 9373, 9, (9372, 1, 4216), "r"),
    (17, 20000, 65, (5000, 60, 4500), "a"), (70_000, 6, 3, (5, 2, 4), "ar"),
    (3, 70_001, 9, (3000, 4, 2500), ""),
    (2, 131_011, 9, (6000, 1, 3000), "ar"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("edge", SHARED_EDGES)
def test_apply_plan_shared_kernel_edges(cuda_device, hang_guard, edge, pad):
    b, n1, s1, live, kind = edge
    tables, lanes, widths = shared_edge_case(n1 + b, b, n1, s1, live, pad,
                                             kind)
    lanes_t = torch.from_numpy(lanes).to(cuda_device)
    ref = kernels.apply_plan_shared_plain(_torch(tables, cuda_device),
                                          lanes_t, *widths)
    before = kernels.launches["apply_plan_shared"]
    got = kernels.apply_plan_shared(_torch(tables, cuda_device), lanes_t,
                                    *widths)
    torch.cuda.synchronize()
    assert kernels.launches["apply_plan_shared"] == before + (
        1 if sum(widths) else 0)
    for r, o in zip(ref, got):
        assert torch.equal(r, o)


@pytest.mark.cuda
@pytest.mark.parametrize("waves", [1, 4])
def test_apply_plan_shared_on_the_b4_plan(cuda_device, hang_guard,
                                          monkeypatch, waves):
    """The B4 fixture planned once by the port's native mirror, padded as
    the smoke pads it, over a few docs (and one doc a block or many)."""
    from yjs_tpu_torch.ops.native_mirror import NativeMirror

    sp = b4_plan(NativeMirror)
    monkeypatch.setattr(kernels, "SHARED_WAVES", waves)
    b = 37
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    fresh = yata_tables(b, sp["cap"], sp["s1"])
    lanes = to(sp["lanes"])
    widths = (sp["k_l"], sp["k_h"], sp["k_d"])
    ref = kernels.apply_plan_shared_plain(_torch(fresh, cuda_device), lanes,
                                          *widths)
    got = kernels.apply_plan_shared(_torch(fresh, cuda_device), lanes,
                                    *widths)
    torch.cuda.synchronize()
    for r, o in zip(ref, got):
        assert torch.equal(r, o)
    assert int(got[1][0].sum()) == len(sp["delete_rows"])


def b4_plan(mirror_cls):
    """The B4 fixture (``tests/fixtures/b4_trace.bin``) planned once by
    ``mirror_cls`` and packed as ``bench.py``'s B4 replay packs it: each
    section padded to a power of two (links and deletes at least 64,
    heads 8), padding one past the table (``cap + 1``)."""
    from pathlib import Path

    update = (Path(__file__).resolve().parent / "fixtures"
              / "b4_trace.bin").read_bytes()
    mirror = mirror_cls("text")
    mirror.ingest(update, False)
    plan = mirror.prepare_step()
    n = mirror.n_rows
    cap = max(64, n)
    s1 = max(8, mirror.n_segs) + 1

    def pad(idx, vals, minimum, oob):
        i = np.full(_bucket(max(1, len(idx)), minimum), oob, np.int32)
        i[: len(idx)] = np.asarray(idx, np.int32)
        v = np.full(len(i), NULL, np.int32)
        if vals is not None:
            v[: len(idx)] = np.asarray(vals, np.int32)
        return i, v

    rows, vals = pad(plan.link_rows, plan.link_vals, 64, cap + 1)
    segs, hvals = pad(plan.head_segs, plan.head_vals, 8, s1)
    dels, _ = pad(plan.delete_rows, None, 64, cap + 1)
    return {
        "lanes": np.concatenate([rows, vals, segs, hvals, dels]),
        "k_l": len(rows), "k_h": len(segs), "k_d": len(dels), "n": n,
        "cap": cap, "s1": s1, "delete_rows": np.asarray(plan.delete_rows),
    }


@pytest.mark.cuda
def test_apply_plan_shared_checks(cuda_device):
    """Wrong inputs raise before any launch; empty sections or no docs
    launch nothing."""
    tables, lanes, widths = shared_edge_case(5, 3, 40, 9, (10, 2, 5))
    dyn = _torch(tables, cuda_device)
    lanes_t = torch.from_numpy(lanes).to(cuda_device)
    before = dict(kernels.launches)
    k_l, k_h, k_d = widths
    for bad_dyn, bad_lanes, w, err in (
            (dyn, lanes_t.long(), widths, TypeError),
            ((dyn[0], dyn[1].int(), dyn[2]), lanes_t, widths, TypeError),
            (dyn, lanes_t[1:], widths, ValueError),
            (dyn, lanes_t, (k_l + 1, k_h, k_d - 1), ValueError),
            ((dyn[0].t(), dyn[1], dyn[2]), lanes_t, widths, ValueError),
            ((dyn[0], dyn[1][:2], dyn[2]), lanes_t, widths, ValueError),
            (dyn, lanes_t.cpu(), widths, ValueError)):
        with pytest.raises(err):
            kernels.apply_plan_shared(bad_dyn, bad_lanes, *w)
    empty = torch.empty(0, dtype=torch.int32, device=cuda_device)
    kernels.apply_plan_shared(dyn, empty, 0, 0, 0)
    none = tuple(t[:0] for t in dyn)
    kernels.apply_plan_shared(none, lanes_t, *widths)
    assert kernels.launches == before


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


# -- the doc mesh: the fold and K13-K16, four shards sharing the card ------------


def _mesh_of(device, n: int = 4, rows: int = 0):
    from yjs_tpu_torch.parallel import DocMesh

    if rows:
        return DocMesh(np.full((n, rows), device, dtype=object),
                       ("docs", "rows"))
    return DocMesh([device] * n)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("n_parts", [1, 4, 64, 130])
def test_shard_fold_kernel_matches_plain(cuda_device, n_parts, op):
    """SUM wraps in int32; more than 64 partials fold in rounds."""
    g = np.random.default_rng(n_parts)
    parts = [torch.from_numpy(
        g.integers(-(2**31), 2**31, size=(257, 3)).astype(np.int32)
    ).to(cuda_device) for _ in range(n_parts)]
    ref = kernels.shard_fold_plain(parts, op)
    before = kernels.launches["shard_fold"]
    got = kernels.shard_fold(parts, op)
    torch.cuda.synchronize()
    rounds = 1 + max(0, -(-(n_parts - 64) // 63))
    assert kernels.launches["shard_fold"] == before + rounds
    assert got.device == parts[0].device and torch.equal(ref, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("shape", APPLY_SHAPES)
def test_apply_lanes_progress_counter_matches_plain(cuda_device, shape, dtype):
    """K14's per-shard counters: K1's count scan adds the dense plus
    sparse and the delete totals into a [2] counter, twice over."""
    b, n1, s1 = shape
    tables, lanes, widths = apply_case(9 + b, b, n1, s1, dtype)
    lanes_d = torch.from_numpy(lanes).to(cuda_device)
    ref = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    got = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    for _ in range(2):
        want = kernels.apply_lanes_plain(_torch(tables, cuda_device), lanes_d,
                                         *widths, counter=ref)
        out = kernels.apply_lanes(_torch(tables, cuda_device), lanes_d,
                                  *widths, counter=got)
        torch.cuda.synchronize()
        for r, o in zip(want, out):
            assert torch.equal(r, o)
    assert torch.equal(ref, got) and int(got[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", YATA_SHAPES[:3])
def test_levels_progress_counter_matches_plain(cuda_device, hang_guard, shape):
    """K15's per-shard counters from K6's block reduce, accumulated over
    the stages; K7b (no counter) is unchanged by them."""
    b, w_pad, cap_min, clients = shape
    cap, s1, stages = yata_case(51 + b, b, w_pad=w_pad, cap_min=cap_min,
                                clients=clients)

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)

    ref_t = _torch(yata_tables(b, cap, s1), cuda_device)
    got_t = _torch(yata_tables(b, cap, s1), cuda_device)
    ref_c = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    got_c = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    for st in stages:
        statics = {k: to(st[k]) for k in kernels.STATIC_KEYS}
        args = [to(st[k]) for k in ("splits", "lv", "dels", "scratch")]
        kernels.batch_step_levels_plain(statics, ref_t, *args, counter=ref_c)
        kernels.batch_step_levels(statics, got_t, *args, counter=got_c)
        torch.cuda.synchronize()
        for r, o in zip(ref_t, got_t):
            assert torch.equal(r, o)
    assert torch.equal(ref_c, got_c) and int(got_c[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("rows", [0, 2])
@pytest.mark.parametrize("wide", [False, True])
def test_sharded_state_vectors_kernel_matches_plain(cuda_device, rows, wide,
                                                    placed):
    """K16 on four doc shards of the card (and 4 x 2 with a rows axis,
    the row shards meeting in one output by atomicMax) against its plain
    version and unsharded K9 (with slots past the shared-memory limit when
    wide), from host arrays and from placed blocks: one launch and no
    fold, the shards sharing the card."""
    from yjs_tpu_torch.parallel import mesh as pm

    n_slots = 13000 if wide else 5
    row_slot, _clock, row_end, _sv = sync_case(61, 64, 300, n_slots)
    mesh = _mesh_of(cuda_device, 4, rows)
    axes = ("docs", "rows") if rows else ("docs", None)
    args = ((pm.state_vector_blocks(mesh, row_slot, *axes),
             pm.state_vector_blocks(mesh, row_end, *axes)) if placed
            else (row_slot, row_end))
    before = dict(kernels.launches)
    got = pm.sharded_state_vectors(mesh, n_slots, *axes)(*args)
    torch.cuda.synchronize()
    assert got.is_cuda
    assert (kernels.launches["sharded_state_vectors"]
            == before["sharded_state_vectors"] + 1)
    assert kernels.launches["shard_fold"] == before["shard_fold"]
    ref = pm.sharded_state_vectors(mesh, n_slots, *axes, plain=True)(*args)
    one = kernels.state_vector_kernel(
        *_torch((row_slot, row_end), cuda_device), n_slots)
    plain = kernels.state_vector_kernel_plain(
        *_torch((row_slot, row_end), cuda_device), n_slots)
    assert torch.equal(ref, got) and torch.equal(one, got)
    assert torch.equal(plain, got)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [5, 13000])
@pytest.mark.parametrize("n_shards", [1, 4, 17, 70])
def test_sharded_state_vector_shard_counts(cuda_device, n_shards, n_slots):
    """K16 over 1 to 70 doc shards of the card (70: two launches, the
    cap being 64 shards), with a doc block of no docs and a row shard of
    no columns among placed blocks: equal to unsharded K9 and its plain
    version, one launch per 64 shards with rows."""
    from yjs_tpu_torch.ops import _cuda
    from yjs_tpu_torch.parallel import mesh as pm

    b = 2 * n_shards
    row_slot, _clock, row_end, _sv = sync_case(71 + n_shards, b, 300, n_slots)
    mesh = _mesh_of(cuda_device, n_shards)
    before = kernels.launches["sharded_state_vectors"]
    got = pm.sharded_state_vectors(mesh, n_slots)(row_slot, row_end)
    torch.cuda.synchronize()
    assert (kernels.launches["sharded_state_vectors"]
            == before + -(-n_shards // _cuda.SV_MAX_SHARDS))
    slot_d, end_d = _torch((row_slot, row_end), cuda_device)
    assert torch.equal(got, kernels.state_vector_kernel(slot_d, end_d,
                                                        n_slots))
    assert torch.equal(got, kernels.state_vector_kernel_plain(slot_d, end_d,
                                                              n_slots))
    # placed blocks: doc block 0 empty, row shard 1 of no columns, the
    # rest views of the whole arrays with their row stride
    cuts = [0, 0] + [2 * k for k in range(1, n_shards + 1)]
    slots = [[slot_d[cuts[k]:cuts[k + 1], :], slot_d[cuts[k]:cuts[k + 1], :0]]
             for k in range(len(cuts) - 1)]
    ends = [[end_d[cuts[k]:cuts[k + 1], :], end_d[cuts[k]:cuts[k + 1], :0]]
            for k in range(len(cuts) - 1)]
    before = kernels.launches["sharded_state_vectors"]
    again = kernels.sharded_state_vector(slots, ends, n_slots)
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    assert (kernels.launches["sharded_state_vectors"]
            == before + -(-n_shards // _cuda.SV_MAX_SHARDS))


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 4, 3])
def test_sharded_lookup_kernel_matches_plain(cuda_device, n_shards,
                                             monkeypatch):
    """K13 through the planner on shards of one card: one launch, one
    host-to-device copy each of the haystack and the queries and one copy
    of the candidates back."""
    from yjs_tpu_torch.ops import segment_planner as sp

    flat, q = lookup_case(71, 3000, 700, wide=True, pad=False)
    fk = kernels._pad_pow2(flat, kernels._bucket_pow2(len(flat)), INT64_MAX)
    qb = kernels._bucket_pow2(len(q))
    qb = -(-qb // n_shards) * n_shards
    qk = kernels._pad_pow2(q, qb, -1)
    devs = [cuda_device] * n_shards
    placed, read = [], []
    put, cpu = sp.put_host, torch.Tensor.cpu
    monkeypatch.setattr(sp, "put_host",
                        lambda x, dev: placed.append(len(x)) or put(x, dev))
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: read.append(t.numel()) or cpu(
                            t, *a, **k))
    before = kernels.launches["sharded_lookup"]
    got = sp._sharded_lookup(devs, fk, qk)
    monkeypatch.undo()
    # one launch for each distinct device: the shards share the card
    assert kernels.launches["sharded_lookup"] == before + 1
    assert placed == [len(fk), len(qk)] and read == [len(qk)]
    ref = np.concatenate([c.numpy() for c in kernels.sharded_anchor_lookup_plain(
        [torch.from_numpy(fk)] * n_shards,
        list(torch.from_numpy(qk).chunk(n_shards)))])
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(
        got[: len(q)], np.searchsorted(flat, q, side="right") - 1)


def staged_case(seed: int, n_hay: int, n_q: int = 5000):
    """A sorted int64 haystack for the lookup's shared-memory sample:
    runs of equal keys, one straddling every sample key (every
    ``ceil(n_hay / LOOKUP_SAMPLE)``-th key, when that is 3 or more), the
    last tenth int64.max padding; queries at each sample key and its
    neighbours, -1, int64.max and random keys."""
    from yjs_tpu_torch.ops._cuda import LOOKUP_SAMPLE

    g = np.random.default_rng(seed)
    keys = np.sort(g.integers(2**33, 2**33 + 3 * n_hay, n_hay)).astype(np.int64)
    stride = -(-n_hay // LOOKUP_SAMPLE)
    if stride >= 3:  # keys b-1, b, b+1 equal at each sample key b
        for b in range(stride, n_hay - 1, stride):
            keys[b - 1 : b + 2] = keys[b - 1]
    keys[n_hay - n_hay // 10 :] = INT64_MAX
    sample = keys[::stride]
    q = np.concatenate([sample, sample - 1, sample + 1, [-1, INT64_MAX],
                        g.integers(-1, 2**33 + 4 * n_hay, n_q)])
    return keys, q.astype(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("n_hay", [1, 127, 129, 2047, (1 << 13) - 1, 1 << 13,
                                   (1 << 13) + 1, 3 * 128 * 53 + 7, 1 << 21])
def test_anchor_lookup_sample_stage_edges(cuda_device, n_hay):
    """The lookup below, at and above the staging threshold (2**13), with
    a haystack that is not a multiple of the sample, equal keys across
    sample boundaries, int64.max padding and -1 queries: K11 and one
    K13 shard equal ``np.searchsorted(side="right") - 1``, and so does
    the kernel with the staging forced on (``stage_min=1``, a sample of
    every key when n_hay is below the sample) and forced off."""
    from yjs_tpu_torch.ops import _cuda

    keys, q = staged_case(n_hay, n_hay)
    want = np.searchsorted(keys, q, side="right") - 1
    hay_t, q_t = _torch((keys, q), cuda_device)
    np.testing.assert_array_equal(kernels.anchor_lookup(hay_t, q_t).cpu(), want)
    (one,) = kernels.sharded_anchor_lookup([hay_t], [q_t])
    np.testing.assert_array_equal(one.cpu(), want)
    for stage_min in (1, 1 << 62):
        out = torch.empty_like(q_t)
        _cuda.anchor_lookup([hay_t.data_ptr(), n_hay, q_t.data_ptr(),
                             out.data_ptr(), len(q)], cuda_device, stage_min)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(out.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [
    [(70_000, 500_000)],
    [(9000, 3000), (0, 17), (300, 0)],
    [(1 << 14, 1000), (5, 1), (0, 0), (20_000, 4096)],
    [((s * 977) % 20_000, 1 + (s * 131) % 900) for s in range(65)],
])
def test_sharded_lookup_launcher_matches_plain(cuda_device, sizes):
    """K13 over shards of one card with haystacks and query blocks of
    uneven sizes, empty ones among them, 65 shards in two rounds: every
    shard equals ``anchor_lookup_plain``, the results are views of one
    buffer, and the launches are one per 64 shards with queries."""
    hays, qs = [], []
    for k, (n_hay, n_q) in enumerate(sizes):
        flat, q = lookup_case(300 + k, n_hay, n_q, wide=True, pad=False)
        hays.append(torch.from_numpy(flat).to(cuda_device))
        qs.append(torch.from_numpy(q).to(cuda_device))
    before = kernels.launches["sharded_lookup"]
    got = kernels.sharded_anchor_lookup(hays, qs)
    torch.cuda.synchronize()
    live = sum(1 for _h, n_q in sizes if n_q)
    assert kernels.launches["sharded_lookup"] == before + -(-live // 64)
    ref = kernels.sharded_anchor_lookup_plain(hays, qs)
    bases = {g.untyped_storage().data_ptr() for g in got if g.numel()}
    assert len(bases) <= 1
    for g, r, q in zip(got, ref, qs):
        assert g.shape == q.shape and g.dtype == torch.int64
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("lane,mirror", [("apply", "native"),
                                         ("levels", "native"),
                                         ("seq", "native"),
                                         ("apply", "python")])
def test_meshed_engine_on_card_matches_cpu_mesh(cuda_device, hang_guard, lane,
                                                mirror, monkeypatch):
    """A 4-shard engine on the card against the same engine on a CPU
    mesh: tables (and statics) after every flush, ``last_metrics`` (the
    card's folded by the fold kernel), batched state vectors, texts."""
    if lane != "apply":
        monkeypatch.setenv("YTPU_KERNEL", lane)
    if mirror == "python":
        monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
        monkeypatch.setenv("YTPU_PLAN_CACHE", "0")
    monkeypatch.setenv("YTPU_EXPORT_DEVICE", "1")
    per_doc = [planner_corpus(("interleaved", "storm")[i % 2], 80 + i, 60)
               for i in range(8)]
    eng = BatchEngine(8, mesh=_mesh_of(cuda_device), compact_min_rows=24)
    twin = BatchEngine(8, mesh=_mesh_of(torch.device("cpu")),
                       compact_min_rows=24)
    assert eng.device.type == "cuda"
    before = dict(kernels.launches)
    for j in range(60):
        for e in (eng, twin):
            for i, ups in enumerate(per_doc):
                e.queue_update(i, ups[j])
        if j % 6 == 5:
            eng.flush()
            twin.flush()
            torch.cuda.synchronize()
            assert eng.last_metrics == twin.last_metrics
            for a, b in zip((eng._right, eng._deleted, eng._starts),
                            (twin._right, twin._deleted, twin._starts)):
                assert torch.equal(a.cpu(), b)
            if lane != "apply":
                for k in kernels.STATIC_KEYS:
                    assert torch.equal(eng._statics[k].cpu(), twin._statics[k])
    for tabs, _st in eng.shard_tables():
        assert all(t.device.type == "cuda" for t in tabs)
    docs = list(range(8))
    assert eng.state_vectors_batched(docs) == twin.state_vectors_batched(docs)
    assert [eng.text(i) for i in docs] == [twin.text(i) for i in docs]
    grew = {k: kernels.launches[k] - before[k] for k in before}
    want = {"apply": "sharded_apply_plan", "levels": "sharded_batch_step",
            "seq": "batch_step"}[lane]
    assert grew[want] > 0 and grew["sharded_state_vectors"] == 1
    if lane != "seq":
        assert grew["shard_fold"] > 0
    if mirror == "python":
        assert grew["sharded_lookup"] > 0


# -- K14 and K15: one launch a device, the shards by value -----------------------


def _offsets(sizes):
    return np.concatenate([[0], np.cumsum(sizes)]).astype(int)


def sharded_apply_case(seed: int, sizes, n1: int, s1: int, dtype):
    """Per-shard K14 inputs of ``sizes`` docs each (0 allowed): each
    shard's tables and lanes from :func:`apply_case`, its sections padded
    to the widths every shard shares with the packer's fills."""
    cases = [apply_case(seed + s, b, n1, s1, dtype) if b else None
             for s, b in enumerate(sizes)]
    widths = tuple(max(c[2][k] for c in cases if c) for k in range(4))
    fills = ((NULL,), (n1, NULL), (s1, NULL), (n1,))
    tables, lanes = [], []
    for b, case in zip(sizes, cases):
        if case is None:
            tables.append((np.zeros((0, n1), np.int32),
                           np.zeros((0, n1), bool), np.zeros((0, s1), np.int32)))
            parts = [np.full(w, f, np.int64) for w, fs in zip(widths, fills)
                     for f in fs]
            lanes.append(np.concatenate(parts).astype(dtype))
            continue
        tabs, ln, own = case
        parts, o = [ln[: 4 * b].astype(np.int64)], 4 * b
        for w, mine, fs in zip(widths, own, fills):
            for f in fs:
                sec = np.full(w, f, np.int64)
                sec[:mine] = ln[o : o + mine]
                parts.append(sec)
                o += mine
        tables.append(tabs)
        lanes.append(np.concatenate(parts).astype(dtype))
    return tables, lanes, widths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("sizes", [[64], [5, 7], [3, 9, 0, 4], [7] * 16 + [2]])
def test_sharded_apply_kernel_matches_plain(cuda_device, sizes, dtype):
    """K14 over 1, 2, 4 and 17 shards of one card, one with no docs:
    every shard's tables equal the plain version's, each counter its
    plain counter (twice over, so they add), and the launches grow by
    one per 16 shards with docs."""
    tables, lanes, widths = sharded_apply_case(81, sizes, 129, 17, dtype)
    rows = [torch.from_numpy(r).to(cuda_device) for r in lanes]
    ref = [_torch(t, cuda_device) for t in tables]
    got = [_torch(t, cuda_device) for t in tables]
    ref_c = list(torch.zeros((len(sizes), 2), dtype=torch.int32,
                             device=cuda_device))
    got_c = list(torch.zeros((len(sizes), 2), dtype=torch.int32,
                             device=cuda_device))
    live = sum(1 for b in sizes if b)
    for _ in range(2):
        for s in range(len(sizes)):
            kernels.apply_lanes_plain(ref[s], rows[s], *widths,
                                      counter=ref_c[s])
        before = dict(kernels.launches)
        out = kernels.sharded_apply_lanes(got, rows, widths, got_c)
        torch.cuda.synchronize()
        assert out is got
        assert (kernels.launches["sharded_apply_plan"]
                == before["sharded_apply_plan"] + -(-live // 16))
        assert kernels.launches["apply_lanes"] == before["apply_lanes"]
        for r, g in zip(ref, got):
            for a, b in zip(r, g):
                assert torch.equal(a, b)
    for r, g in zip(ref_c, got_c):
        assert torch.equal(r, g)
    assert int(sum(c[0] for c in got_c)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[4], [2, 2], [1, 3, 0, 2], [2] * 16 + [1]])
def test_sharded_levels_kernel_matches_plain(cuda_device, hang_guard, sizes):
    """K15 over 1, 2, 4 and 17 shards of one card, one with no docs, stage
    by stage: every shard's tables equal the plain version's, the
    counters accumulated over the stages equal the plain ones, and each
    call makes one launch per 16 shards with docs."""
    b = sum(sizes)
    off = _offsets(sizes)
    cap, s1, stages = yata_case(71 + len(sizes), b, w_pad=33)

    def blocks(a):
        return [torch.from_numpy(np.ascontiguousarray(a[o : o + n])).to(
            cuda_device) for o, n in zip(off, sizes)]

    ref = [tuple(x) for x in zip(*(blocks(t)
                                   for t in yata_tables(b, cap, s1)))]
    got = [tuple(x) for x in zip(*(blocks(t)
                                   for t in yata_tables(b, cap, s1)))]
    ref_c = list(torch.zeros((len(sizes), 2), dtype=torch.int32,
                             device=cuda_device))
    got_c = list(torch.zeros((len(sizes), 2), dtype=torch.int32,
                             device=cuda_device))
    live = sum(1 for n in sizes if n)
    for st in stages:
        cols = {k: blocks(st[k]) for k in kernels.STATIC_KEYS}
        statics = [{k: cols[k][s] for k in cols} for s in range(len(sizes))]
        args = [blocks(st[k]) for k in ("splits", "lv", "dels", "scratch")]
        for s in range(len(sizes)):
            kernels.batch_step_levels_plain(statics[s], ref[s],
                                            *(a[s] for a in args),
                                            counter=ref_c[s])
        before = dict(kernels.launches)
        kernels.sharded_batch_step_levels(statics, got, *args, got_c)
        torch.cuda.synchronize()
        assert (kernels.launches["sharded_batch_step"]
                == before["sharded_batch_step"] + -(-live // 16))
        assert (kernels.launches["batch_step_levels"]
                == before["batch_step_levels"])
        for r, g in zip(ref, got):
            for x, y in zip(r, g):
                assert torch.equal(x, y)
    for r, g in zip(ref_c, got_c):
        assert torch.equal(r, g)
    assert int(sum(c[0] for c in got_c)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 4, 17])
def test_sharded_steps_launch_once_a_device(cuda_device, hang_guard,
                                            n_shards):
    """Through the mesh's callables on shards that share the card: one
    launch (K14, K15) a call for up to 16 shards, two for 17; tables and
    folded counters equal the plain callables'."""
    from yjs_tpu_torch.parallel import mesh as pm

    mesh = _mesh_of(cuda_device, n_shards)
    b_loc = 2
    tables, lanes, widths = sharded_apply_case(
        90, [b_loc] * n_shards, 65, 9, np.int32)
    before = kernels.launches["sharded_apply_plan"]
    got, gc = pm.sharded_apply_plan(mesh, "docs", *widths)(
        [_torch(t, cuda_device) for t in tables], np.stack(lanes))
    ref, rc = pm.sharded_apply_plan(mesh, "docs", *widths, plain=True)(
        [_torch(t, cuda_device) for t in tables], np.stack(lanes))
    torch.cuda.synchronize()
    assert (kernels.launches["sharded_apply_plan"]
            == before + -(-n_shards // 16))
    for g, r in zip(got, ref):
        for x, y in zip(g, r):
            assert torch.equal(x, y)
    assert pm.fold_metrics(gc) == pm.fold_metrics(rc, plain=True)

    b = b_loc * n_shards
    cap, s1, stages = yata_case(91, b, w_pad=4)
    st = stages[-1]
    devs = mesh.axis_devices()
    statics = [dict(zip(kernels.STATIC_KEYS, c)) for c in zip(*(
        pm.shard_rows(st[k].copy(), devs) for k in kernels.STATIC_KEYS))]
    args = [st[k] for k in ("splits", "lv", "dels", "scratch")]

    def tables():
        return [tuple(x) for x in zip(*(
            pm.shard_rows(t, devs) for t in yata_tables(b, cap, s1)))]

    before = kernels.launches["sharded_batch_step"]
    got, gc = pm.sharded_batch_step(mesh, "docs")(statics, tables(), *args)
    ref, rc = pm.sharded_batch_step(mesh, "docs", plain=True)(
        statics, tables(), *args)
    torch.cuda.synchronize()
    assert (kernels.launches["sharded_batch_step"]
            == before + -(-n_shards // 16))
    for g, r in zip(got, ref):
        for x, y in zip(g, r):
            assert torch.equal(x, y)
    assert pm.fold_metrics(gc) == pm.fold_metrics(rc, plain=True)


@pytest.mark.cuda
@pytest.mark.parametrize("cap_min", [64, 2048, 65536])
@pytest.mark.parametrize("sharded", [False, True])
def test_levels_visit_scratch_filled_each_call(cuda_device, hang_guard,
                                               sharded, cap_min, monkeypatch):
    """The visit marks are filled for every call, in each variant (each
    block fills its own row in shared memory for docs staged whole; a
    global scratch, one block a device reused from the caching allocator,
    for longer docs): with the allocator's free blocks holding large
    marks (which read as "visited" unless overwritten) and ``epoch_max``
    40 (a refill inside the scan every few items), K6 and K15 equal the
    plain version stage by stage."""
    monkeypatch.setattr(kernels, "EPOCH_MAX", 40)
    b = 6
    cap, s1, stages = yata_case(97, b, w_pad=33, cap_min=cap_min)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    ref = _torch(yata_tables(b, cap, s1), cuda_device)
    got = _torch(yata_tables(b, cap, s1), cuda_device)
    for st in stages:
        statics = {k: to(st[k]) for k in kernels.STATIC_KEYS}
        args = [to(st[k]) for k in ("splits", "lv", "dels", "scratch")]
        kernels.batch_step_levels_plain(statics, ref, *args)
        torch.cuda.synchronize()
        # free blocks of every size the scratch may take, full of marks
        junk = [torch.full((n,), 2**30, dtype=torch.int32, device=cuda_device)
                for n in (b * (cap + 1), 2 * b * (cap + 1), 1 << 20)]
        del junk
        if sharded:
            half = b // 2
            kernels.sharded_batch_step_levels(
                [{k: v[:half] for k, v in statics.items()},
                 {k: v[half:] for k, v in statics.items()}],
                [tuple(t[:half] for t in got), tuple(t[half:] for t in got)],
                *([a[:half], a[half:]] for a in args), [None, None])
        else:
            kernels.batch_step_levels(statics, got, *args)
        torch.cuda.synchronize()
        launched_variant("sharded_batch_step" if sharded
                         else "batch_step_levels", cap + 1, s1,
                         max(1, st["lv"].shape[2]))
        for r, g in zip(ref, got):
            assert torch.equal(r, g)
