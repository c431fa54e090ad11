"""The port's kernel modules against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX kernels
(``yjs_tpu.ops.kernels``, jitted on the CPU) and through the plain
PyTorch versions the port's wrappers take for CPU tensors
(``yjs_tpu_torch.ops.kernels``).  All data is integer, so the
tolerance is 0: results must be equal element for element.  The CUDA
kernels are held against the same plain versions on the card by
``test_torch_cuda.py``, whose case builders this file shares.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import apply_case, ranks_case, scatter_case
from yjs_tpu.ops import kernels as jk
from yjs_tpu.ops import segment_planner as jsp
from yjs_tpu_torch.ops import kernels as tk
from yjs_tpu_torch.ops import segment_planner as tsp


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _torch(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# -- K1: apply_lanes ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize(
    "shape", [(1, 65, 9), (3, 129, 17), (16, 257, 9), (40, 65, 33)]
)
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_lanes_plain_matches_jax(seed, shape, dtype):
    b, n1, s1 = shape
    tables, lanes, widths = apply_case(seed * 100 + b, b, n1, s1, dtype)
    want = jk.apply_lanes(
        tuple(jnp.asarray(a) for a in tables), jnp.asarray(lanes), *widths
    )
    got = tk.apply_lanes(_torch(tables), torch.from_numpy(lanes), *widths)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(w), _np(g))


def test_apply_lanes_case_has_unique_targets():
    """The JAX scatter promises unique_indices: the seeded cases must
    keep that promise or the comparison above means nothing."""
    b, n1, s1 = 16, 257, 9
    (_r, _d, _s), lanes, (k_dn, k_sp, k_h, k_d) = apply_case(5, b, n1, s1)
    lanes = lanes.astype(np.int64)
    o = 4 * b + k_dn
    for cnt, k, width, off in (
        (lanes[b : 2 * b], k_sp, n1, o),
        (lanes[2 * b : 3 * b], k_h, s1, o + 2 * k_sp),
        (lanes[3 * b : 4 * b], k_d, n1, o + 2 * k_sp + 2 * k_h),
    ):
        total = int(cnt.sum())
        docs = np.repeat(np.arange(b), cnt)
        raw = lanes[off : off + total]
        kept = raw != width  # out-of-bounds lanes are dropped
        rows = raw[kept] % width  # JAX wraps -1
        pairs = set(zip(docs[kept].tolist(), rows.tolist()))
        assert len(pairs) == int(kept.sum())
        assert (lanes[off + total : off + k] == width).all()  # padding


def test_apply_plan2_writes_in_place_and_counts_no_cpu_launch():
    tables, lanes, widths = apply_case(3, 4, 65, 9)
    dyn = _torch(tables)
    before = dict(tk.launches)
    out = tk.apply_plan2(dyn, torch.from_numpy(lanes), *widths)
    assert all(o is d for o, d in zip(out, dyn))
    assert tk.launches == before  # the plain version never counts


# -- K2: scatter_rows -----------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 65, 9, 1), (8, 129, 17, 3), (32, 65, 9, 32)])
@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_rows_plain_matches_jax(seed, shape):
    b, n1, s1, k = shape
    tables, rows = scatter_case(seed * 100 + b, b, n1, s1, k)
    want = jk.scatter_rows(
        *(jnp.asarray(a) for a in tables), *(jnp.asarray(a) for a in rows)
    )
    dyn = _torch(tables)
    got = tk.scatter_rows(*dyn, *_torch(rows))
    assert all(o is d for o, d in zip(got, dyn))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(w), _np(g))


# -- K8: list_ranks -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (1, 65), (4, 130), (2, 1025)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_list_ranks_plain_matches_jax(seed, shape):
    b, n1 = shape
    right, valid = ranks_case(seed * 100 + n1, b, n1)
    want = jk.list_ranks(jnp.asarray(right), jnp.asarray(valid))
    got = tk.list_ranks(torch.from_numpy(right), torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(want), _np(got))


def test_list_ranks_orders_a_known_list():
    # rows 2 -> 0 -> 3 -> 1; row 4 is not a member
    right = np.array([[3, -1, 0, 1, -1]], np.int32)
    valid = np.array([[True, True, True, True, False]])
    d = _np(tk.list_ranks(torch.from_numpy(right), torch.from_numpy(valid)))
    assert d.tolist() == [[2, 0, 3, 1, -1]]


# -- K11/K12: the segment-planner kernels' NumPy and kernel backends ---------------


def _planner_case(seed: int, n: int = 40):
    g = np.random.default_rng(seed)
    client = g.integers(0, 3, n).astype(np.int64)
    clock = np.cumsum(g.integers(1, 4, n)).astype(np.int64)
    length = g.integers(1, 4, n).astype(np.int64)
    o_client = np.where(g.random(n) < 0.6, np.roll(client, 1), -1)
    o_clock = np.roll(clock, 1) + g.integers(0, 3, n)
    r_client = np.where(g.random(n) < 0.4, np.roll(client, 1), -1)
    r_clock = np.roll(clock, 1) + g.integers(0, 3, n)
    return client, clock, length, o_client, o_clock, r_client, r_clock


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conflict_scan_matches_jax(seed):
    case = _planner_case(seed)
    want = jk.plan_conflict_scan(*case, backend="jax")
    got = tk.plan_conflict_scan(*case)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("seed", [0, 1])
def test_anchor_lookup_matches_numpy_reference(seed):
    g = np.random.default_rng(seed)
    sizes = g.integers(1, 6, 4)
    flat_slot = np.repeat(np.arange(4), sizes).astype(np.int64)
    flat_clock = np.concatenate(
        [np.sort(g.choice(50, s, replace=False)) for s in sizes]
    ).astype(np.int64)
    q_slot = g.integers(-1, 4, 30).astype(np.int64)
    q_clock = g.integers(0, 60, 30).astype(np.int64)
    want = jk.plan_anchor_lookup(flat_slot, flat_clock, q_slot, q_clock)
    got = tk.plan_anchor_lookup(flat_slot, flat_clock, q_slot, q_clock)
    np.testing.assert_array_equal(want, got)


def test_device_planner_backends_raise():
    """The kernel backends no longer raise: on the CPU (the plain
    versions) they give the NumPy backend's answers."""
    case = _planner_case(0, 8)
    for w, g in zip(tk.plan_conflict_scan(*case),
                    tk.plan_conflict_scan(*case, backend="jax", device="cpu")):
        np.testing.assert_array_equal(w, g)
    np.testing.assert_array_equal(
        tk.plan_anchor_lookup(case[0], case[1], case[0], case[1]),
        tk.plan_anchor_lookup(case[0], case[1], case[0], case[1],
                              backend="jax", device="cpu"),
    )


def _queries(mod, seed: int, n: int = 24):
    client, clock, length, o_cl, o_ck, r_cl, r_ck = _planner_case(seed, n)
    q = mod.SegmentQueries()
    q.n = n
    q.client, q.clock, q.length = client, clock, length
    q.o_cl, q.o_ck, q.o_slot = o_cl, o_ck, np.where(o_cl >= 0, o_cl, -1)
    q.r_cl, q.r_ck, q.r_slot = r_cl, r_ck, np.where(r_cl >= 0, r_cl, -1)
    q.gc = np.zeros(n, bool)
    q.cref = np.zeros(n, np.int64)
    q.pid = np.zeros(n, bool)
    q.pname = np.zeros(n, bool)
    return q


def _snapshot():
    flat_slot = np.repeat(np.arange(3), 10).astype(np.int64)
    flat_clock = np.tile(np.arange(0, 40, 4), 3).astype(np.int64)
    flat_row = np.arange(30, dtype=np.int64)
    row_len = np.full(30, 4, np.int64)
    return flat_slot, flat_clock, flat_row, row_len, 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_doc_and_chunk_match_jax_np_mode(seed):
    for snap in (None, _snapshot):
        want = jsp.plan_doc(_queries(jsp, seed), mode="np", snapshot=snap)
        got = tsp.plan_doc(_queries(tsp, seed), mode="np", snapshot=snap)
        for name in ("chain_l", "chain_r", "run_id", "hint_l", "hint_r"):
            w, g = getattr(want, name), getattr(got, name)
            assert (w is None) == (g is None)
            if w is not None:
                np.testing.assert_array_equal(w, g)
        assert want.spans == got.spans
    items_j = [(_queries(jsp, seed + k), _snapshot) for k in range(3)]
    items_t = [(_queries(tsp, seed + k), _snapshot) for k in range(3)]
    for w, g in zip(jsp.plan_chunk(items_j, mode="np"),
                    tsp.plan_chunk(items_t, mode="np")):
        np.testing.assert_array_equal(w.hint_l, g.hint_l)
        assert w.spans == g.spans
    assert tsp.plan_chunk(items_t, mode="off") == [None] * 3


@pytest.mark.parametrize("mode", ["device", "jax"])
def test_device_segment_modes_raise(mode):
    """The device and jax modes no longer raise: on the CPU (the kernels'
    plain versions) they plan as the np mode does, per doc and per
    chunk."""
    for snap in (None, _snapshot):
        want = tsp.plan_doc(_queries(tsp, 0), mode="np", snapshot=snap)
        got = tsp.plan_doc(_queries(tsp, 0), mode=mode, snapshot=snap,
                           device="cpu")
        for name in ("chain_l", "chain_r", "run_id", "hint_l", "hint_r"):
            w, g = getattr(want, name), getattr(got, name)
            assert (w is None) == (g is None)
            if w is not None:
                np.testing.assert_array_equal(w, g)
        assert want.spans == got.spans
    items = [(_queries(tsp, k), _snapshot) for k in range(3)]
    for w, g in zip(tsp.plan_chunk(items, mode="np"),
                    tsp.plan_chunk(items, mode=mode, device="cpu")):
        np.testing.assert_array_equal(w.hint_l, g.hint_l)
        np.testing.assert_array_equal(w.hint_r, g.hint_r)
        np.testing.assert_array_equal(w.chain_l, g.chain_l)
        assert w.spans == g.spans
