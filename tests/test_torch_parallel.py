"""The port's doc-sharded mesh against the JAX package's, on the CPU.

The JAX side runs on the virtual 8-device host mesh
(``doc_mesh(8, backend="cpu")``, from ``tests/conftest.py``'s XLA flag)
with ``YTPU_FLUSH_PIPELINE=0`` (ROADMAP caveat R1); the port's side on
``yjs_tpu_torch.parallel.doc_mesh(8, backend="cpu")``: eight shards whose
tensors all lie on the CPU, where the kernel wrappers take their plain
versions.  Inputs are made from seeds with numpy; everything compared is
integer, so the tolerance is 0.

- the sharded kernels as functions: ``sharded_apply_plan`` (K14),
  ``sharded_batch_step`` (K15), ``sharded_state_vectors`` (K16, on a 1-D
  mesh and on a 4 x 2 ``("docs", "rows")`` mesh) and the planner's
  sharded anchor lookup (K13), each with its progress counters folded;
- the port's counterparts of the cases of ``tests/test_parallel.py``;
- meshed apply, levels and seq engines on native and Python mirrors,
  flush by flush against the JAX meshed engine: trimmed tables (and
  statics), texts, encoded states, ``last_metrics`` and flush-metric key
  sets;
- the mesh's errors and the single-device fallback of ``shard_meshes``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import yjs_tpu as Y
import yjs_tpu_torch as T
from test_flush_pipeline import SHAPES, make_trace
from test_parallel import build_docs
from test_torch_cuda import planner_corpus, yata_case, yata_tables
from yjs_tpu.obs import FLUSH_METRICS_SCHEMA as JAX_SCHEMA
from yjs_tpu.ops import BatchEngine as JaxEngine
from yjs_tpu.ops import plan_cache as jax_plan_cache
from yjs_tpu.ops import segment_planner as jsp
from yjs_tpu.parallel import mesh as jmesh
from yjs_tpu_torch.obs import FLUSH_METRICS_SCHEMA
from yjs_tpu_torch.ops import BatchEngine as TorchEngine
from yjs_tpu_torch.ops import kernels as tk
from yjs_tpu_torch.ops import plan_cache as torch_plan_cache
from yjs_tpu_torch.ops import segment_planner as tsp
from yjs_tpu_torch.ops.carry import trim_tables
from yjs_tpu_torch.parallel import DocMesh, doc_mesh, shard_meshes
from yjs_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")
H100 = 232448  # the shared memory an H100's blocks may opt into


@pytest.fixture(autouse=True)
def _sync_and_fresh(monkeypatch):
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")
    jax_plan_cache.reset_cache()
    torch_plan_cache.reset_cache()
    yield
    jax_plan_cache.reset_cache()
    torch_plan_cache.reset_cache()


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs 8 virtual cpu devices")
    return jmesh.doc_mesh(8, backend="cpu")


@pytest.fixture(scope="module")
def mesh8():
    return doc_mesh(8, backend="cpu")


def shard_tables(mesh, *arrays):
    """Per-shard copies of ``[B, ...]`` numpy tables on the mesh's doc
    devices (the shape a meshed engine keeps them in)."""
    devs = mesh.axis_devices()
    blocks = [tmesh.shard_rows(np.array(a, copy=True), devs) for a in arrays]
    return [list(t) for t in zip(*blocks)]


def gathered(dyn):
    """Per-shard tables concatenated on the host, one array a table."""
    return [np.concatenate([t[k].numpy() for t in dyn])
            for k in range(len(dyn[0]))]


# -- the sharded kernels as functions -----------------------------------------


def apply_case(seed, n_shards=8, b_loc=2, n1=33, s1=9, widths=(16, 8, 8, 8)):
    """Random per-shard lanes (counts, dense values, sparse, head and
    delete writes, a few targets out of range or negative) and tables."""
    g = np.random.default_rng(seed)
    k_dn, k_sp, k_h, k_d = widths
    lane_w = 4 * b_loc + k_dn + 2 * k_sp + 2 * k_h + k_d
    lanes = np.empty((n_shards, lane_w), np.int32)
    for s in range(n_shards):
        cnt = [g.integers(0, k // b_loc + 1, size=b_loc) for k in widths]
        o = 4 * b_loc
        lanes[s, :o] = np.concatenate(cnt)
        lanes[s, o : o + k_dn] = g.integers(-1, n1, size=k_dn)
        o += k_dn
        lanes[s, o : o + k_sp] = g.integers(-3, n1 + 3, size=k_sp)
        lanes[s, o + k_sp : o + 2 * k_sp] = g.integers(-1, n1, size=k_sp)
        o += 2 * k_sp
        lanes[s, o : o + k_h] = g.integers(-2, s1 + 2, size=k_h)
        lanes[s, o + k_h : o + 2 * k_h] = g.integers(-1, n1, size=k_h)
        o += 2 * k_h
        lanes[s, o : o + k_d] = g.integers(-2, n1 + 2, size=k_d)
    b = n_shards * b_loc
    tables = (g.integers(-1, n1, size=(b, n1)).astype(np.int32),
              g.random((b, n1)) < 0.3,
              g.integers(-1, n1, size=(b, s1)).astype(np.int32))
    return widths, lanes, tables


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("seed", [1, 2])
def test_sharded_apply_plan_matches_jax(jmesh8, mesh8, seed, dtype):
    widths, lanes, tables = apply_case(seed)
    lanes = lanes.astype(dtype)
    fn = jmesh.sharded_apply_plan(jmesh8, "docs", *widths)
    out, metrics = fn(tuple(jnp.asarray(t) for t in tables), jnp.asarray(lanes))
    want = [np.asarray(t) for t in out]
    want_m = {k: int(v) for k, v in metrics.items()}
    assert want_m["integrated"] > 0 and want_m["deleted"] > 0
    for plain in (False, True):
        dyn = shard_tables(mesh8, *tables)
        fn = tmesh.sharded_apply_plan(mesh8, "docs", *widths, plain=plain)
        dyn, counters = fn(dyn, lanes)
        for w, g in zip(want, gathered(dyn)):
            np.testing.assert_array_equal(w, g)
        assert tmesh.fold_metrics(counters, plain=plain) == want_m


@pytest.fixture(scope="module")
def levels_case():
    cap, s1, stages = yata_case(41, 8, w_pad=4, uniform=True)
    return cap, s1, stages


def _stage_statics(stage):
    return {k: stage[k].view(np.uint32) if k == "client_key" else stage[k]
            for k in tk.STATIC_KEYS}


def test_sharded_batch_step_matches_jax(jmesh8, mesh8, levels_case):
    """Flush by flush over three planned stages: the tables and each
    stage's folded counters equal the JAX shard_map step's; counters
    passed back in carry on (the engine's level blocks add up)."""
    cap, s1, stages = levels_case
    step = jmesh.sharded_batch_step(jmesh8, "docs")
    dyn_j = tuple(jnp.asarray(a) for a in yata_tables(8, cap, s1))
    fn = tmesh.sharded_batch_step(mesh8, "docs")
    dyn = shard_tables(mesh8, *yata_tables(8, cap, s1))
    dyn2 = shard_tables(mesh8, *yata_tables(8, cap, s1))
    total = {"integrated": 0, "deleted": 0}
    carried = None
    for st in stages:
        statics = {k: jnp.asarray(v) for k, v in _stage_statics(st).items()}
        dyn_j, m = step(statics, dyn_j, *(jnp.asarray(st[k]) for k in
                                          ("splits", "lv", "dels", "scratch")))
        want_m = {k: int(v) for k, v in m.items()}
        cols = [dict(zip(tk.STATIC_KEYS, c)) for c in zip(*(
            tmesh.shard_rows(st[k].copy(), mesh8.axis_devices())
            for k in tk.STATIC_KEYS))]
        args = [st[k] for k in ("splits", "lv", "dels", "scratch")]
        dyn, counters = fn(cols, dyn, *args)
        assert tmesh.fold_metrics(counters) == want_m
        dyn2, carried = fn(cols, dyn2, *args, counters=carried)
        total = {k: total[k] + want_m[k] for k in total}
        for w, g, g2 in zip(dyn_j, gathered(dyn), gathered(dyn2)):
            np.testing.assert_array_equal(np.asarray(w), g)
            np.testing.assert_array_equal(g, g2)
    assert total["integrated"] > 0 and total["deleted"] > 0
    assert tmesh.fold_metrics(carried) == total


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_sharded_apply_plan_sub_mesh_matches_jax(n_shards, dtype):
    """K14 (the kernel path, which takes the plain version for CPU
    shards, and ``plain=True``) on 1- and 2-shard meshes against the JAX
    ``shard_map`` kernel on a mesh of the same size."""
    jm = jmesh.doc_mesh(n_shards, backend="cpu")
    tm = doc_mesh(n_shards, backend="cpu")
    widths, lanes, tables = apply_case(20 + n_shards, n_shards=n_shards,
                                       b_loc=3)
    lanes = lanes.astype(dtype)
    out, metrics = jmesh.sharded_apply_plan(jm, "docs", *widths)(
        tuple(jnp.asarray(t) for t in tables), jnp.asarray(lanes))
    want_m = {k: int(v) for k, v in metrics.items()}
    assert want_m["integrated"] > 0 and want_m["deleted"] > 0
    for plain in (False, True):
        fn = tmesh.sharded_apply_plan(tm, "docs", *widths, plain=plain)
        dyn, counters = fn(shard_tables(tm, *tables), lanes)
        for w, g in zip(out, gathered(dyn)):
            np.testing.assert_array_equal(np.asarray(w), g)
        assert tmesh.fold_metrics(counters, plain=plain) == want_m


@pytest.mark.parametrize("n_shards", [1, 2])
def test_sharded_batch_step_sub_mesh_matches_jax(n_shards, levels_case):
    """K15 on 1- and 2-shard meshes against the JAX ``shard_map`` step on
    a mesh of the same size, stage by stage: tables and folded counters,
    the counters also carried across the stages."""
    cap, s1, stages = levels_case
    jm = jmesh.doc_mesh(n_shards, backend="cpu")
    tm = doc_mesh(n_shards, backend="cpu")
    step = jmesh.sharded_batch_step(jm, "docs")
    dyn_j = tuple(jnp.asarray(a) for a in yata_tables(8, cap, s1))
    runs = {plain: [tmesh.sharded_batch_step(tm, "docs", plain=plain),
                    shard_tables(tm, *yata_tables(8, cap, s1)), None]
            for plain in (False, True)}
    total = {"integrated": 0, "deleted": 0}
    for st in stages:
        statics = {k: jnp.asarray(v) for k, v in _stage_statics(st).items()}
        dyn_j, m = step(statics, dyn_j, *(jnp.asarray(st[k]) for k in
                                          ("splits", "lv", "dels", "scratch")))
        want_m = {k: int(v) for k, v in m.items()}
        total = {k: total[k] + want_m[k] for k in total}
        cols = [dict(zip(tk.STATIC_KEYS, c)) for c in zip(*(
            tmesh.shard_rows(st[k].copy(), tm.axis_devices())
            for k in tk.STATIC_KEYS))]
        args = [st[k] for k in ("splits", "lv", "dels", "scratch")]
        for plain, run in runs.items():
            fn, dyn, carried = run
            _, once = fn(cols, shard_tables(tm, *gathered(dyn)), *args)
            run[1], run[2] = fn(cols, dyn, *args, counters=carried)
            assert tmesh.fold_metrics(once, plain=plain) == want_m
            for w, g in zip(dyn_j, gathered(run[1])):
                np.testing.assert_array_equal(np.asarray(w), g)
    assert total["integrated"] > 0 and total["deleted"] > 0
    for plain, (_fn, _dyn, carried) in runs.items():
        assert tmesh.fold_metrics(carried, plain=plain) == total


def sv_case(seed, b=8, n=16, slots=4):
    g = np.random.default_rng(seed)
    return (g.integers(-1, slots + 1, size=(b, n)).astype(np.int32),
            g.integers(1, 100, size=(b, n)).astype(np.int32))


def test_sharded_state_vectors_1d_matches_jax(jmesh8, mesh8):
    row_slot, row_end = sv_case(3)
    want = np.asarray(jmesh.sharded_state_vectors(jmesh8, 4)(row_slot, row_end))
    for plain in (False, True):
        got = tmesh.sharded_state_vectors(mesh8, 4, plain=plain)(row_slot, row_end)
        np.testing.assert_array_equal(want, got.numpy())
        assert got.dtype == torch.int32


def test_sharded_state_vectors_2d_matches_jax():
    """A 4 x 2 ("docs", "rows") mesh: each row shard's partial, then the
    max over the two row shards (pmax / the MAX fold)."""
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual cpu devices")
    jm = Mesh(np.array(devs[:8]).reshape(4, 2), ("docs", "rows"))
    tm = DocMesh(np.full((4, 2), CPU, dtype=object), ("docs", "rows"))
    assert tm.shape == {"docs": 4, "rows": 2}
    for seed in (4, 5):
        row_slot, row_end = sv_case(seed, n=32, slots=6)
        fn = jmesh.sharded_state_vectors(jm, 6, "docs", "rows")
        want = np.asarray(fn(row_slot, row_end))
        for plain in (False, True):
            got = tmesh.sharded_state_vectors(tm, 6, "docs", "rows",
                                              plain=plain)(row_slot, row_end)
            np.testing.assert_array_equal(want, got.numpy())
        # the fold is what joins the row shards: one row shard is wrong
        half = tmesh.sharded_state_vectors(
            DocMesh(np.full((4, 1), CPU, dtype=object), ("docs", "rows")),
            6, "docs", "rows",
        )(row_slot[:, :16], row_end[:, :16])
        assert not np.array_equal(want, half.numpy())


# (mesh devices, axes, B, N): one device or two, distinct from the CPU
# (their tensors are never made: the layout is pure)
SV_LAYOUTS = {
    "1d8": ([CPU] * 8, ("docs",), 16, 12),
    "4x2_one_device": (np.full((4, 2), CPU, dtype=object),
                       ("docs", "rows"), 8, 16),
    "two_devices": (["cuda:0", "cuda:1"], ("docs",), 8, 10),
    "rows_on_two_devices": (np.array([["cuda:0", "cuda:1"]] * 2,
                                     dtype=object), ("docs", "rows"), 6, 8),
    "interleaved": (["cuda:0", "cuda:1"] * 2, ("docs",), 8, 5),
    "zero_docs": (np.full((4, 2), CPU, dtype=object), ("docs", "rows"), 0,
                  16),
}


@pytest.mark.parametrize("name", list(SV_LAYOUTS))
def test_state_vector_layout_matches_blocks(name):
    """K16's host layout: each device's one copy holds the rows of the doc
    blocks it has a shard of, and each shard's offset, row stride, docs
    and columns read exactly the block ``state_vector_blocks`` cuts (on a
    CPU mesh of the same shape); its out_row is its doc block's place in
    the device's output, which stacks the held blocks in order."""
    devices, axes, b, n = SV_LAYOUTS[name]
    mesh = DocMesh(devices, axes)
    row_axis = axes[1] if len(axes) == 2 else None
    twin = DocMesh(np.full(np.shape(np.array(devices, dtype=object)), CPU,
                           dtype=object), axes)
    h = np.arange(b * n, dtype=np.int32).reshape(b, n)
    want = tmesh.state_vector_blocks(twin, h, axes[0], row_axis)
    layout = tmesh.state_vector_layout(mesh, b, n, axes[0], row_axis)
    grid = np.array(devices, dtype=object).reshape(len(want), -1)
    seen = set()
    bd = b // len(want)
    for dev, (held, shards) in layout.items():
        assert held == sorted(held)
        assert {d for d, *_ in shards} == set(held)
        copy = np.concatenate([h[d * bd:(d + 1) * bd] for d in held])
        flat = np.concatenate([copy.ravel(), np.zeros(1, np.int32)])
        for d, r, offset, stride, docs, cols, out_row in shards:
            assert tmesh._resolve(grid[d, r]) == dev
            assert (docs, cols) == tuple(want[d][r].shape)
            assert stride == n and out_row == held.index(d) * bd
            got = np.lib.stride_tricks.as_strided(
                flat[offset:], (docs, cols), (4 * stride, 4))
            np.testing.assert_array_equal(got, want[d][r].numpy())
            np.testing.assert_array_equal(copy[out_row:out_row + docs],
                                          h[d * bd:(d + 1) * bd])
            seen.add((d, r))
    assert seen == {(d, r) for d in range(len(want))
                    for r in range(len(want[0]))}
    distinct = {tmesh._resolve(x) for x in grid.flat}
    assert list(layout) == list(dict.fromkeys(
        tmesh._resolve(x) for x in grid.flat))
    assert len(layout) == len(distinct)


@pytest.mark.parametrize("b,n", [(7, 16), (8, 15)])
def test_state_vector_layout_bad_split_raises(b, n):
    mesh = DocMesh(np.full((4, 2), CPU, dtype=object), ("docs", "rows"))
    with pytest.raises(ValueError, match="does not split"):
        tmesh.state_vector_layout(mesh, b, n, "docs", "rows")
    row_slot, row_end = sv_case(1, b=b, n=n)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.sharded_state_vectors(mesh, 4, "docs", "rows")(row_slot,
                                                             row_end)


def test_state_vector_groups_stack_held_blocks_in_order():
    """Out rows: a device's doc blocks, stacked in order of ``d``; a doc
    block's row shards on two devices appear in both."""
    a, c = torch.device("cuda", 0), torch.device("cuda", 1)
    groups = tk.state_vector_groups([[c, a], [a, a], [c, c]], [3, 0, 5])
    assert list(groups) == [c, a]
    assert groups[c] == ({0: 0, 2: 3}, [(0, 0), (2, 0), (2, 1)])
    assert groups[a] == ({0: 0, 1: 3}, [(0, 1), (1, 0), (1, 1)])


def test_sharded_state_vector_placed_blocks_of_uneven_docs():
    """Placed blocks on the CPU, doc blocks of 3, 0 and 5 docs over two
    row shards of unequal width (a view with a row stride among them):
    the rows of each doc equal the plain version on the whole row."""
    g = np.random.default_rng(3)
    sizes, widths, n_slots = [3, 0, 5], [7, 4], 5
    slot = g.integers(-2, n_slots + 2, size=(8, 11)).astype(np.int32)
    end = g.integers(-5, 90, size=(8, 11)).astype(np.int32)
    st, en = torch.from_numpy(slot), torch.from_numpy(end)
    starts = np.cumsum([0] + sizes)
    cuts = np.cumsum([0] + widths)
    slots = [[st[starts[d]:starts[d + 1], cuts[r]:cuts[r + 1]]
              for r in range(2)] for d in range(3)]
    ends = [[en[starts[d]:starts[d + 1], cuts[r]:cuts[r + 1]]
             for r in range(2)] for d in range(3)]
    assert not slots[0][1].is_contiguous()
    got = tk.sharded_state_vector(slots, ends, n_slots)
    want = tk.state_vector_kernel_plain(st, en, n_slots)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    with pytest.raises(ValueError):
        tk.sharded_state_vector(slots, ends[:2], n_slots)
    bad = [row[:] for row in ends]
    bad[2][1] = bad[2][1][:4]
    with pytest.raises(ValueError, match="must be one"):
        tk.sharded_state_vector(slots, bad, n_slots)
    bad[2][1] = ends[2][1].long()
    with pytest.raises(TypeError):
        tk.sharded_state_vector(slots, bad, n_slots)
    cols = [row[:] for row in slots]  # columns apart: the kernel cannot
    cols[0][0] = slots[0][0].t().contiguous().t()
    assert cols[0][0].stride(1) != 1
    with pytest.raises(ValueError, match="unit column"):
        tk.sharded_state_vector(cols, ends, n_slots)


def test_shard_fold_plain_sums_in_int32_and_takes_max():
    g = np.random.default_rng(7)
    parts = [torch.from_numpy(g.integers(-(2**31), 2**31, size=(3, 5),
                                         dtype=np.int64).astype(np.int32))
             for _ in range(5)]
    stacked = np.stack([p.numpy() for p in parts]).astype(np.int64)
    want_sum = ((stacked.sum(0) + 2**31) % 2**32 - 2**31).astype(np.int32)
    got = tk.shard_fold(parts, "sum")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_sum)
    np.testing.assert_array_equal(tk.shard_fold(parts, "max").numpy(),
                                  stacked.max(0))
    with pytest.raises(ValueError, match="op"):
        tk.shard_fold(parts, "min")


def lookup_case(seed, n_hay=256, n_q=200):
    """Sorted int64 haystack keys below 2**31 (no padding: the length is
    a power of two) and queries, some absent (-1), some past the end."""
    g = np.random.default_rng(seed)
    hay = np.sort(g.choice(2**31 - 1, size=n_hay, replace=False)).astype(np.int64)
    q = np.concatenate([g.choice(hay, n_q // 2),
                        g.integers(-1, 2**31 - 1, size=n_q - n_q // 2)])
    q[::17] = -1
    return hay, q.astype(np.int64)


def test_sharded_lookup_matches_jax_and_one_shard(jmesh8, mesh8):
    hay, q = lookup_case(8)
    qb = tk._bucket_pow2(len(q))
    q_pad = tk._pad_pow2(q, qb, -1)
    want = np.asarray(jsp._sharded_lookup(jmesh8, "docs")(hay, q_pad))
    got = tsp._sharded_lookup(mesh8.axis_devices(), hay, q_pad)
    np.testing.assert_array_equal(want, got)
    one = tk.lookup_keys(hay, q, "jax", "cpu")
    np.testing.assert_array_equal(got[: len(q)], one)
    np.testing.assert_array_equal(
        got[: len(q)], np.searchsorted(hay, q, side="right") - 1
    )


def test_sharded_lookup_true_int64_keys(mesh8):
    """Keys past int32 with int64.max padding (ROADMAP R2): the sharded
    lookup equals the port's K11 and the ``np`` mode."""
    g = np.random.default_rng(9)
    hay = np.sort(g.integers(0, 2**40, size=300)).astype(np.int64)
    q = np.concatenate([hay[::3] + 1, g.integers(-1, 2**41, size=50)])
    fb, qb = tk._bucket_pow2(len(hay)), tk._bucket_pow2(len(q))
    got = tsp._sharded_lookup(
        mesh8.axis_devices(),
        tk._pad_pow2(hay, fb, np.iinfo(np.int64).max),
        tk._pad_pow2(q, qb, -1),
    )[: len(q)]
    np.testing.assert_array_equal(got, tk.lookup_keys(hay, q, "jax", "cpu"))
    np.testing.assert_array_equal(
        got, np.searchsorted(hay, q, side="right") - 1
    )


CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("devices,want", [
    ([CUDA0] * 4, {CUDA0: [0, 1, 2, 3]}),
    ([CUDA0, CUDA1, CUDA0, CUDA1], {CUDA0: [0, 2], CUDA1: [1, 3]}),
    ([CUDA1, CUDA1, CUDA0], {CUDA1: [0, 1], CUDA0: [2]}),
    ([CPU] * 3, {CPU: [0, 1, 2]}),
    ([], {}),
])
def test_device_groups(devices, want):
    """Shards grouped by device, devices in first-seen order, shards in
    order within each (one launch and one buffer a group)."""
    got = tk._device_groups(devices)
    assert got == want and list(got) == list(want)


def test_sharded_lookup_records_one_profiled_call(mesh8):
    """One K13 call is one profiled ``sharded_lookup`` span: its shards go
    to the lookup directly, not through the profiled K11 wrapper."""
    from yjs_tpu_torch.obs.prof import kernel_profiler

    if not kernel_profiler().enabled:
        pytest.skip("the kernel profiler is off in this process")
    hay, q = lookup_case(10)
    hays = [torch.from_numpy(hay)] * 4
    qs = list(torch.from_numpy(tk._pad_pow2(q, 256, -1)).chunk(4))

    def calls():
        snap = kernel_profiler().snapshot()["kernels"]
        return {k: snap.get(k, {}).get("compiles", 0) + snap.get(k, {}).get(
            "hits", 0) for k in ("sharded_lookup", "anchor_lookup")}

    before = calls()
    got = tk.sharded_anchor_lookup(hays, qs)
    after = calls()
    assert after["sharded_lookup"] == before["sharded_lookup"] + 1
    assert after["anchor_lookup"] == before["anchor_lookup"]
    for g, w in zip(got, tk.sharded_anchor_lookup_plain(hays, qs)):
        assert torch.equal(g, w)


def test_sharded_lookup_one_copy_each_way_a_device(mesh8, monkeypatch):
    """The eight shards share the CPU: the planner's sharded lookup places
    the haystack and the queries with one copy each (``put_host``), runs
    one profiled lookup, and gives the same candidates as ``np`` mode."""
    hay, q = lookup_case(11)
    q_pad = tk._pad_pow2(q, 256, -1)
    placed = []
    real = tsp.put_host
    monkeypatch.setattr(tsp, "put_host",
                        lambda x, dev: placed.append(len(x)) or real(x, dev))
    got = tsp._sharded_lookup(mesh8.axis_devices(), hay, q_pad)
    assert placed == [len(hay), len(q_pad)]
    np.testing.assert_array_equal(
        got, np.searchsorted(hay, q_pad, side="right") - 1)


@pytest.mark.parametrize("seed", [1, 2])
def test_zero_counters_one_block_a_device(jmesh8, mesh8, seed):
    """The sharded steps' counters are the rows of one zeroed ``[S, 2]``
    block a device (here the eight CPU shards share one), and
    ``fold_metrics`` over them equals the JAX package's psum."""
    widths, lanes, tables = apply_case(seed)
    _out, metrics = jmesh.sharded_apply_plan(jmesh8, "docs", *widths)(
        tuple(jnp.asarray(t) for t in tables), jnp.asarray(lanes))
    want = {k: int(v) for k, v in metrics.items()}
    dyn, counters = tmesh.sharded_apply_plan(mesh8, "docs", *widths)(
        shard_tables(mesh8, *tables), lanes)
    block = counters[0]._base
    assert block is not None and block.shape == (8, 2)
    for s, c in enumerate(counters):
        assert c._base is block and c.shape == (2,)
        assert c.data_ptr() == block.data_ptr() + 8 * s
    assert tmesh.fold_metrics(counters) == want
    assert tmesh.fold_metrics(counters, plain=True) == want
    assert want["integrated"] > 0


def test_zero_counters_interleaved_devices():
    """Shards on two devices, interleaved: a block a device, each shard's
    row from its own device's block, all zero."""
    meta = torch.device("meta")
    devs = [CPU, meta, CPU, meta, meta]
    dyn = [(torch.empty(1, device=d),) for d in devs]
    counters = tmesh._zero_counters(dyn)
    assert [c.device.type for c in counters] == [d.type for d in devs]
    cpu_block = counters[0]._base
    assert cpu_block.shape == (2, 2) and counters[2]._base is cpu_block
    assert counters[1]._base is counters[3]._base is counters[4]._base
    assert counters[1]._base.shape == (3, 2)
    assert int(cpu_block.abs().sum()) == 0


# -- K14/K15 launch descriptors: one launch a device, shards by value ----------

ROUNDS = {1: 1, 4: 1, 16: 1, 17: 2, 33: 3}  # shards -> launches, 16 a round


def record_entry(monkeypatch, row: int) -> dict:
    """Replaces ``_cuda._call``: records the entry, its scalars and the
    descriptor the entry would read (``row`` ints a shard)."""
    import ctypes

    from yjs_tpu_torch.ops import _cuda

    seen = {}

    def fake(entry, device, ptr, n, *scalars):
        seen.update(entry=entry, device=device, n=n, scalars=scalars,
                    rows=list((ctypes.c_longlong * (row * n)).from_address(ptr)))

    monkeypatch.setattr(_cuda, "_call", fake)
    return seen


def levels_shards(n, b=2, n1=9, s1=5, w=3, n_lv=2, zero=()):
    """Per-shard K15 inputs on the CPU (shards in ``zero`` hold no docs):
    statics dicts, tables, splits, lv, dels, scratch_base and counter
    rows of one block."""
    g = np.random.default_rng(n)
    out = [[] for _ in range(7)]
    block = torch.zeros((n, 2), dtype=torch.int32)
    for s in range(n):
        bs = 0 if s in zero else b

        def full(*shape, v=tk.NULL):
            return torch.full(shape, v, dtype=torch.int32)

        out[0].append({k: torch.from_numpy(
            g.integers(-1, n1, (bs, n1)).astype(np.int32))
            for k in tk.STATIC_KEYS})
        out[1].append((full(bs, n1), torch.zeros((bs, n1), dtype=torch.bool),
                       full(bs, s1)))
        for k, t in enumerate((full(bs, 1, 2), full(bs, n_lv, w, 8),
                               full(bs, 2), full(bs, v=n1 - 2 * w - 1)), 2):
            out[k].append(t)
        out[6].append(block[s])
    return out



@pytest.mark.parametrize("n_shards", sorted(ROUNDS))
def test_levels_descriptor_rows_and_rounds(n_shards, monkeypatch):
    """K15's descriptor: 17 ints a shard in shard order (the six statics,
    right, deleted, starts, its rows of the device's one visit and one
    fast scratch, splits, lv, dels, scratch_base, counter, doc count), the
    shared dims once, and one launch per 16 shards, the entry reading
    exactly these rows.  No shared memory to opt into: the global
    variant, with both scratches."""
    from yjs_tpu_torch.ops import _cuda

    case = levels_shards(n_shards)
    statics, dyn, splits, lv, dels, scratch, counters = case
    desc, dims, (visit, fast) = tk._levels_desc(CPU, list(range(n_shards)),
                                                *case, limit=0)
    assert dims == (9, 5, 1, 2, 3, 2, 3, tk.YATA_VARIANTS.index("global"),
                    0, 0, 0, 0)
    assert visit.shape == (2 * n_shards, 9) and visit.dtype == torch.int32
    assert fast.shape == (2 * n_shards, 3) and fast.dtype == torch.uint8
    assert len(desc) == _cuda.LEVELS_ROW * n_shards
    for s in range(n_shards):
        want = [*(statics[s][k].data_ptr() for k in tk.STATIC_KEYS),
                *(t.data_ptr() for t in dyn[s]), visit[2 * s].data_ptr(),
                fast[2 * s].data_ptr(),
                *(t.data_ptr() for t in (splits[s], lv[s], dels[s],
                                         scratch[s], counters[s])), 2]
        assert desc[17 * s : 17 * (s + 1)] == want
    seen = record_entry(monkeypatch, _cuda.LEVELS_ROW)
    assert _cuda.batch_step_levels(desc, CPU, dims, 123) == ROUNDS[n_shards]
    assert seen["entry"] == "ytpu_batch_step_levels_sharded"
    assert seen["n"] == n_shards and seen["rows"] == desc
    assert seen["scalars"] == (0, *dims, 123)


def _least_limit(variant: str) -> int:
    """The least opt-in limit at which an SM holds YATA_MIN_DOCS_SM docs
    of N+1 = 9, S+1 = 5 and W = 3 staged as ``variant`` (whole, or
    without the visit row), each beside the static and reserved bytes."""
    block = (tk.yata_smem_bytes(9, 5, 3, variant) + tk.YATA_STATIC_SMEM
             + tk.YATA_RESERVED_SMEM)
    return tk.YATA_MIN_DOCS_SM * block - tk.YATA_RESERVED_SMEM


_SHARED, _ROWS = _least_limit("shared"), _least_limit("rows")


@pytest.mark.parametrize("variant, limit", [
    ("shared", 232448), ("shared", _SHARED), ("rows", _SHARED - 1),
    ("rows", _ROWS), ("global", _ROWS - 1), ("global", 0)])
def test_levels_descriptor_variants(variant, limit):
    """The variant comes from N+1, S+1, W and the card's opt-in limit
    alone, with its layout in the dims; a staged visit row leaves no
    visit scratch (its pointer 0), a staged fast-flag row no fast scratch;
    the scratch that stays is one for the device, each shard pointing at
    its rows."""
    case = levels_shards(4)
    desc, dims, (visit, fast) = tk._levels_desc(CPU, [0, 1, 2, 3], *case,
                                                limit=limit)
    assert tk.YATA_VARIANTS[dims[7]] == variant
    assert dims[8:] == tk.yata_layout(9, 5, 3, variant)
    assert (visit is None) == (variant == "shared")
    assert (fast is None) == (variant != "global")
    for s in range(4):
        row = desc[17 * s : 17 * (s + 1)]
        assert row[9] == (0 if visit is None else visit[2 * s].data_ptr())
        assert row[10] == (0 if fast is None else fast[2 * s].data_ptr())
    if visit is not None:
        assert visit.shape == (8, 9) and bool((visit == tk.NULL).all())


@pytest.mark.parametrize("n_shards", sorted(ROUNDS))
def test_apply_descriptor_rows_and_rounds(n_shards, monkeypatch):
    """K14's descriptor: 7 ints a shard in shard order (lanes, its cum rows
    — none, 0, in the "staged" variant these small shards take — right,
    deleted, starts, counter, doc count), and one launch per 16 shards,
    the entry handed the scratch's zeroed counters and the variant;
    int16 lanes take the i16 entry, and a second call keeps the same
    scratch."""
    from yjs_tpu_torch.ops import _cuda

    sync = _cuda.APPLY_SYNC_INTS
    widths, lanes, tables = apply_case(n_shards, n_shards=n_shards, b_loc=2,
                                       n1=9, s1=5, widths=(4, 2, 2, 2))
    dyn = shard_tables(doc_mesh(n_shards, backend="cpu"), *tables)
    for dtype in (torch.int32, torch.int16):
        rows = [torch.from_numpy(r).to(dtype) for r in lanes]
        counters = list(torch.zeros((n_shards, 2), dtype=torch.int32))
        counters[-1] = None  # a shard may count nothing
        desc, dims, scratch = tk._apply_desc(CPU, list(range(n_shards)), dyn,
                                             rows, counters, widths,
                                             limit=H100)
        assert dims == (dtype == torch.int32, 9, 5, 1)
        assert scratch.dtype == torch.int32 and scratch.numel() >= sync
        assert not bool(scratch[:sync].any())
        for s in range(n_shards):
            c = counters[s]
            assert desc[7 * s : 7 * (s + 1)] == [
                rows[s].data_ptr(), 0, *(t.data_ptr() for t in dyn[s]),
                0 if c is None else c.data_ptr(), 2]
        seen = record_entry(monkeypatch, _cuda.APPLY_ROW)
        got = _cuda.apply_lanes(desc, CPU, scratch.data_ptr(), *dims, *widths)
        assert got == ROUNDS[n_shards]
        assert seen["entry"] == ("ytpu_apply_lanes_sharded_i32"
                                 if dtype == torch.int32
                                 else "ytpu_apply_lanes_sharded_i16")
        assert seen["n"] == n_shards and seen["rows"] == desc
        assert seen["scalars"] == (scratch.data_ptr(), 9, 5, 1, *widths)
        again = tk._apply_desc(CPU, list(range(n_shards)), dyn, rows,
                               counters, widths, limit=H100)
        assert again[2] is scratch and again[0] == desc


def test_apply_variant_by_size():
    """K1/K14's variant comes from the largest shard's doc count and the
    card's opt-in limit alone: "staged" while 4 bytes a doc and the
    block's other 1 KB fit the limit (on an H100, 232448 bytes: 57,856
    docs), "global" past it."""
    assert tk.apply_stage_max(H100) == 57856
    assert tk.apply_stage_max(48 * 1024) == 12032
    assert tk.apply_stage_max(0) == 0
    for limit in (H100, 48 * 1024):
        top = tk.apply_stage_max(limit)
        assert 4 * top + tk.APPLY_STATIC_SMEM <= limit
        assert [tk.apply_variant(b, limit)
                for b in (0, 1, 4096, top, top + 1, 65536)] == \
            ["staged"] * 4 + ["global"] * 2


def test_apply_descriptor_global_variant_rows():
    """A shard past the staged limit makes the launch "global": every
    shard's cum rows are ``4 * b`` int32 of the scratch, after the
    counters, in shard order (a shard with no docs has none)."""
    from yjs_tpu_torch.ops import _cuda

    sync = _cuda.APPLY_SYNC_INTS
    widths = (4, 2, 2, 2)
    lane_w = 4 + 2 * 2 + 2 * 2 + 2
    limit = 4096
    sizes = [3, tk.apply_stage_max(limit) + 1, 0, 5]
    dyn = [(torch.zeros((b, 9), dtype=torch.int32),
            torch.zeros((b, 9), dtype=torch.bool),
            torch.zeros((b, 5), dtype=torch.int32)) for b in sizes]
    rows = [torch.zeros(4 * b + lane_w, dtype=torch.int16) for b in sizes]
    desc, dims, scratch = tk._apply_desc(CPU, range(4), dyn, rows,
                                         [None] * 4, widths, limit=limit)
    assert dims == (False, 9, 5, 0)
    assert scratch.numel() >= sync + 4 * sum(sizes)
    at = sync
    for k, b in enumerate(b for b in sizes if b):
        assert desc[7 * k + 1] == scratch[at:].data_ptr()
        assert desc[7 * k + 6] == b
        at += 4 * b
    _desc, dims, _scratch = tk._apply_desc(CPU, range(4), dyn, rows,
                                           [None] * 4, widths, limit=H100)
    assert dims[3] == 1  # an H100's opt-in limit stages them


def test_apply_scratch_kept_per_stream(monkeypatch):
    """K1/K14's scratch is one a device and stream: a call on the same
    stream reuses it, another stream gets its own, and a call that needs
    more cum rows grows it to a power of two with zeroed counters."""
    from yjs_tpu_torch.ops import _cuda

    stream = [11]
    monkeypatch.setattr(tk, "_stream_key", lambda dev: stream[0])
    monkeypatch.setattr(tk, "_apply_scratch_by_stream", {})
    sync = _cuda.APPLY_SYNC_INTS
    a = tk._apply_scratch(CPU, 40)
    assert a.numel() == 2048 and not bool(a.any())
    assert tk._apply_scratch(CPU, 1000) is a
    stream[0] = 12
    b = tk._apply_scratch(CPU, 40)
    assert b is not a and b.data_ptr() != a.data_ptr()
    stream[0] = 11
    grown = tk._apply_scratch(CPU, 3 * sync)
    assert grown is not a and grown.numel() == 4096
    assert not bool(grown[:sync].any())
    assert tk._apply_scratch(CPU, 8) is grown
    assert set(tk._apply_scratch_by_stream) == {(CPU, 11), (CPU, 12)}


def test_levels_descriptor_checks_each_shard():
    """A shard whose N+1, S+1, split, level, lane or delete width differs
    from the first's, whose scratch_base loses the doc axis, or whose
    tensor lies on another device raises ``ValueError`` naming it; a
    shard with no docs is left out of the rows."""
    n = 17
    shards = list(range(n))
    for s, field, bad, match in (
        (16, 3, torch.full((2, 2, 4, 8), -1, dtype=torch.int32), "W 4"),
        (5, 2, torch.full((2, 3, 2), -1, dtype=torch.int32), "splits 3"),
        (9, 4, torch.full((2, 5), -1, dtype=torch.int32), "deletes 5"),
        (3, 5, torch.zeros(3, dtype=torch.int32), r"scratch_base \[B\]"),
        (7, 6, torch.zeros(2, dtype=torch.int32, device="meta"),
         "counter on meta"),
    ):
        case = levels_shards(n)
        case[field][s] = bad
        with pytest.raises(ValueError, match=match):
            tk._levels_desc(CPU, shards, *case, limit=0)
    case = levels_shards(n)
    case[1][4] = (torch.full((2, 11), -1, dtype=torch.int32),
                  torch.zeros((2, 11), dtype=torch.bool),
                  torch.full((2, 5), -1, dtype=torch.int32))
    case[0][4] = {k: torch.zeros((2, 11), dtype=torch.int32)
                  for k in tk.STATIC_KEYS}
    with pytest.raises(ValueError, match=r"shard 4: N\+1 11 \(shard 0: 9\)"):
        tk._levels_desc(CPU, shards, *case, limit=0)
    case = levels_shards(n, zero=(0, 6))
    desc, dims, (visit, _fast) = tk._levels_desc(CPU, shards, *case, limit=0)
    assert len(desc) == 17 * (n - 2) and visit.shape == (2 * (n - 2), 9)
    assert [desc[17 * k + 15] for k in range(n - 2)] == [
        case[6][s].data_ptr() for s in shards if s not in (0, 6)]


def test_apply_descriptor_checks_each_shard():
    """A shard whose lanes dtype, N+1 or S+1 differs from the first's,
    whose lanes length does not match the widths, or whose tensor lies
    on another device raises ``ValueError``; a shard with no docs is left
    out of the rows and the cum rows."""
    widths, lanes, tables = apply_case(3, n_shards=4, b_loc=2, n1=9, s1=5,
                                       widths=(4, 2, 2, 2))
    dyn = shard_tables(doc_mesh(4, backend="cpu"), *tables)
    counters = [None] * 4

    def rows():
        return [torch.from_numpy(r.copy()) for r in lanes]

    bad = rows()
    bad[2] = bad[2].to(torch.int16)
    with pytest.raises(ValueError, match=r"shard 2: \(int32 lanes"):
        tk._apply_desc(CPU, range(4), dyn, bad, counters, widths)
    bad = rows()
    bad[1] = bad[1][:-1]
    with pytest.raises(ValueError, match="shard 1: lanes length"):
        tk._apply_desc(CPU, range(4), dyn, bad, counters, widths)
    wide = list(dyn)
    wide[3] = (torch.zeros((2, 9), dtype=torch.int32),
               torch.zeros((2, 9), dtype=torch.bool),
               torch.zeros((2, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"shard 3: \(int32 lanes"):
        tk._apply_desc(CPU, range(4), wide, rows(), counters, widths)
    with pytest.raises(ValueError, match="shard 0: counter on meta"):
        tk._apply_desc(CPU, range(4), dyn, rows(),
                       [torch.zeros(2, dtype=torch.int32, device="meta")]
                       + counters[1:], widths)
    empty = list(dyn)
    empty[1] = tuple(t[:0] for t in dyn[1])
    r = rows()
    r[1] = r[1][8:]  # no counts: the sections alone
    desc, _dims, scratch = tk._apply_desc(CPU, range(4), empty, r, counters,
                                          widths, limit=H100)
    assert len(desc) == 21
    assert [desc[7 * k] for k in range(3)] == [r[s].data_ptr()
                                               for s in (0, 2, 3)]
    assert [desc[7 * k + 1] for k in range(3)] == [0, 0, 0]


def test_sharded_steps_record_one_profiled_call(mesh8, levels_case):
    """One K14 or K15 call is one profiled span under the reference's name,
    whatever the shard count: the shards do not go through the profiled
    one-shard wrappers."""
    from yjs_tpu_torch.obs.prof import kernel_profiler

    if not kernel_profiler().enabled:
        pytest.skip("the kernel profiler is off in this process")
    names = ("sharded_apply_plan", "apply_lanes", "sharded_batch_step",
             "batch_step_levels")

    def calls():
        snap = kernel_profiler().snapshot()["kernels"]
        return {k: snap.get(k, {}).get("compiles", 0)
                + snap.get(k, {}).get("hits", 0) for k in names}

    widths, lanes, tables = apply_case(4)
    before = calls()
    tmesh.sharded_apply_plan(mesh8, "docs", *widths)(
        shard_tables(mesh8, *tables), lanes)
    cap, s1, stages = levels_case
    st = stages[0]
    cols = [dict(zip(tk.STATIC_KEYS, c)) for c in zip(*(
        tmesh.shard_rows(st[k].copy(), mesh8.axis_devices())
        for k in tk.STATIC_KEYS))]
    tmesh.sharded_batch_step(mesh8, "docs")(
        cols, shard_tables(mesh8, *yata_tables(8, cap, s1)),
        *(st[k] for k in ("splits", "lv", "dels", "scratch")))
    grew = {k: v - before[k] for k, v in calls().items()}
    assert grew == {"sharded_apply_plan": 1, "apply_lanes": 0,
                    "sharded_batch_step": 1, "batch_step_levels": 0}


# -- the cases of tests/test_parallel.py, on the port ---------------------------


def test_sharded_flush_matches_cpu(mesh8):
    n = 16
    docs = build_docs(n)
    eng = TorchEngine(n, mesh=mesh8)
    assert eng.device == CPU
    for i, d in enumerate(docs):
        eng.queue_update(i, Y.encode_state_as_update(d))
    eng.flush()
    assert eng.last_metrics is not None and eng.last_metrics["integrated"] > 0
    for i, d in enumerate(docs):
        assert eng.text(i) == d.get_text("text").to_string()
        assert eng.state_vector(i) == {
            c: v for c, v in Y.get_state_vector(d.store).items() if v > 0
        }


def test_sharded_incremental_concurrent(mesh8):
    n = 8
    docs = build_docs(n)
    eng = TorchEngine(n, mesh=mesh8)
    for i, d in enumerate(docs):
        eng.queue_update(i, Y.encode_state_as_update(d))
    eng.flush()
    for i, d in enumerate(docs):
        remote = Y.Doc(gc=False)
        remote.client_id = 2000 + i
        Y.apply_update(remote, Y.encode_state_as_update(d))
        remote.get_text("text").insert(0, "R:")
        u = Y.encode_state_as_update(remote, Y.encode_state_vector(d))
        Y.apply_update(d, u)
        eng.queue_update(i, u)
    eng.flush()
    for i, d in enumerate(docs):
        assert eng.text(i) == d.get_text("text").to_string()


def test_engine_batched_svs_use_sharded_kernel(mesh8):
    n = 8
    docs = build_docs(n)
    eng = TorchEngine(n, mesh=mesh8)
    for i, d in enumerate(docs):
        eng.queue_update(i, Y.encode_state_as_update(d))
    eng.flush()
    subset = [0, 3, 5]  # not a multiple of the axis size: exercises padding
    svs = eng.state_vectors_batched(subset)
    for j, i in enumerate(subset):
        assert svs[j] == {
            c: v for c, v in Y.get_state_vector(docs[i].store).items() if v > 0
        }
    assert eng._sharded_sv


def test_sharded_levels_kernel_path(mesh8, monkeypatch):
    monkeypatch.setenv("YTPU_KERNEL", "levels")
    n = 8
    docs = build_docs(n)
    eng = TorchEngine(n, mesh=mesh8)
    for i, d in enumerate(docs):
        eng.queue_update(i, Y.encode_state_as_update(d))
    eng.flush()
    assert eng.last_metrics is not None
    assert eng.last_metrics["integrated"] > 0
    for i, d in enumerate(docs):
        assert eng.text(i) == d.get_text("text").to_string()


def test_meshed_engine_arrays_stay_on_mesh(mesh8, monkeypatch):
    """Every table of a meshed engine is one tensor a shard on that
    shard's mesh device, through flushes, the statics scatter, capacity
    growth, compaction and the sync kernels."""
    devs = mesh8.axis_devices()
    n = 8
    docs = build_docs(n)
    eng = TorchEngine(n, mesh=mesh8, compact_min_rows=4)

    def check_all(statics: bool):
        shards = eng.shard_tables()
        assert len(shards) == len(devs)
        for (tabs, st), dev in zip(shards, devs):
            for t in tabs:
                assert t.device == dev and t.shape[0] == n // len(devs)
            assert (st is not None) == statics
            for v in (st or {}).values():
                assert v.device == dev and v.shape == tabs[0].shape

    for i, d in enumerate(docs):
        eng.queue_update(i, Y.encode_state_as_update(d))
    eng.flush()
    check_all(False)
    cap = eng._cap
    for i, d in enumerate(docs):
        sv = Y.encode_state_vector(d)
        for _ in range(70):  # prepends: one row each, so capacity grows
            d.get_text("text").insert(0, "x")
        eng.queue_update(i, Y.encode_state_as_update(d, sv))
    eng.flush()
    assert eng._cap > cap
    check_all(False)
    monkeypatch.setenv("YTPU_KERNEL", "levels")
    for i, d in enumerate(docs):
        sv = Y.encode_state_vector(d)
        d.get_text("text").insert(3, "lv")
        eng.queue_update(i, Y.encode_state_as_update(d, sv))
    eng.flush()
    monkeypatch.delenv("YTPU_KERNEL")
    assert eng.last_compaction  # the rows scatter, shard by shard
    check_all(True)
    eng.state_vectors_batched(list(range(n)))
    eng.sync_step2_batch([(i, None) for i in range(n)])
    check_all(True)
    for i, d in enumerate(docs):
        assert eng.text(i) == d.get_text("text").to_string()


def test_sharded_state_vector_kernel(mesh8):
    b, n, slots = 8, 16, 4
    rng = np.random.RandomState(0)
    row_slot = rng.randint(-1, slots, size=(b, n)).astype(np.int32)
    row_end = rng.randint(1, 100, size=(b, n)).astype(np.int32)
    sv = tmesh.sharded_state_vectors(mesh8, slots)(row_slot, row_end).numpy()
    for bi in range(b):
        for s in range(slots):
            mask = row_slot[bi] == s
            expect = row_end[bi][mask].max() if mask.any() else 0
            assert sv[bi, s] == expect


def test_meshed_provider_full_surface(mesh8):
    """The port's provider surface on a sharded engine: receive/flush,
    sync handshake, snapshot and scoped render, server undo."""
    from yjs_tpu_torch.lib0.decoding import Decoder
    from yjs_tpu_torch.lib0.encoding import Encoder
    from yjs_tpu_torch.provider import TpuProvider
    from yjs_tpu_torch.sync import protocol

    prov = TpuProvider(n_docs=16, mesh=mesh8)
    prov.enable_undo("room-0", capture_timeout=0)
    clients = []
    for i in range(16):
        d = T.Doc(gc=False)
        d.client_id = 3000 + i
        d.get_text("text").insert(0, f"room{i} hello")
        clients.append(d)
        prov.receive_update(
            f"room-{i}", T.encode_state_as_update(d), undoable=(i == 0)
        )
    prov.flush()
    snap = prov.snapshot("room-3")
    for i, d in enumerate(clients):
        d.get_text("text").insert(0, "more! ")
        prov.receive_update(
            f"room-{i}", T.encode_state_as_update(d, None), undoable=(i == 0)
        )
    prov.flush()
    assert prov.engine.last_metrics["integrated"] > 0
    for i, d in enumerate(clients):
        assert prov.text(f"room-{i}") == d.get_text("text").to_string()
    assert prov.to_delta("room-3", snapshot=snap) == [{"insert": "room3 hello"}]
    peer = T.Doc(gc=False)
    enc = Encoder()
    protocol.write_sync_step1(enc, peer)
    reply = prov.handle_sync_message("room-5", enc.to_bytes())
    assert reply
    protocol.read_sync_message(Decoder(reply), Encoder(), peer, "prov")
    assert (peer.get_text("text").to_string()
            == clients[5].get_text("text").to_string())
    prov.undo("room-0")
    assert prov.text("room-0") == "room0 hello"
    prov.redo("room-0")
    assert prov.text("room-0") == "more! room0 hello"
    assert prov.engine.fallback == {}


# -- meshed engines against the JAX meshed engine ---------------------------------


def drive(engine, per_doc, flush_every=6, statics=False):
    """Queue step j's update of every doc, flushing every
    ``flush_every`` steps; returns what the comparison reads."""
    n = engine.n_docs
    seen = {"tables": [], "metrics": [], "keysets": set()}
    steps = max(len(u) for u in per_doc)
    for j in range(steps):
        for i, ups in enumerate(per_doc):
            if j < len(ups):
                engine.queue_update(i, ups[j])
        if (j + 1) % flush_every == 0 or j == steps - 1:
            engine.flush()
            seen["keysets"].add(frozenset(engine.last_flush_metrics))
            seen["metrics"].append(engine.last_metrics)
            seen["tables"].append(trim_tables(engine, statics=statics))
    seen["texts"] = [engine.text(i) for i in range(n)]
    seen["states"] = [Y.merge_updates([engine.encode_state_as_update(i)])
                      for i in range(n)]
    seen["svs"] = engine.state_vectors_batched(list(range(0, n, 3)))
    return seen


def assert_runs_equal(want, got):
    assert got["texts"] == want["texts"]
    assert got["states"] == want["states"]
    assert got["svs"] == want["svs"]
    assert got["metrics"] == want["metrics"]
    assert got["keysets"] == {frozenset(FLUSH_METRICS_SCHEMA)}
    assert want["keysets"] == {frozenset(JAX_SCHEMA)}
    assert len(got["tables"]) == len(want["tables"])
    for tw, tg in zip(want["tables"], got["tables"]):
        for dw, dg in zip(tw, tg):
            assert (dw is None) == (dg is None)
            if dw is None:
                continue
            for a, b in zip(dw[:3], dg[:3]):
                np.testing.assert_array_equal(a, b)
            if len(dw) > 3 and dw[3] is not None:
                for k in dw[3]:
                    np.testing.assert_array_equal(dw[3][k], dg[3][k])


ENGINE_CASES = [
    (mode, mirror) for mirror in ("native", "python")
    for mode in ("apply", "levels", "seq")
]


@pytest.mark.parametrize("mode,mirror", ENGINE_CASES)
def test_meshed_engine_matches_jax(jmesh8, mesh8, mode, mirror, monkeypatch):
    if mode != "apply":
        monkeypatch.setenv("YTPU_KERNEL", mode)
    if mirror == "python":
        monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    calls = []
    real = tsp._sharded_lookup
    monkeypatch.setattr(
        tsp, "_sharded_lookup", lambda *a: calls.append(1) or real(*a)
    )
    # interleaving editors: the Python mirrors' chunk plans need anchor
    # lookups (K13 on the mesh)
    per_doc = [planner_corpus(("interleaved", "storm")[i % 2], 70 + i, 60)
               for i in range(16)]
    yata = mode != "apply"
    want = drive(JaxEngine(16, mesh=jmesh8, compact_min_rows=24), per_doc,
                 statics=yata)
    eng = TorchEngine(16, mesh=mesh8, compact_min_rows=24)
    got = drive(eng, per_doc, statics=yata)
    assert_runs_equal(want, got)
    if mode == "seq":
        assert all(m is None for m in got["metrics"])
    else:
        assert all(m["integrated"] > 0 for m in got["metrics"])
    assert eng.last_compaction
    assert type(eng.mirrors[0]).__name__ == (
        "DocMirror" if mirror == "python" else "NativeMirror"
    )
    if mirror == "python" and mode == "apply":
        assert calls, "the chunk planner never ran the sharded lookup"


def test_meshed_engine_matches_unmeshed(mesh8):
    """One shard or eight: the same tables, texts and states; only the
    meshed engine reports ``last_metrics``."""
    per_doc = [make_trace(SHAPES[i % 3], seed=90 + i, n_ops=30)
               for i in range(8)]
    one = drive(TorchEngine(8, device="cpu"), per_doc)
    many = drive(TorchEngine(8, mesh=mesh8), per_doc)
    assert all(m is None for m in one["metrics"])
    one["metrics"] = many["metrics"]
    assert_runs_equal({**one, "keysets": {frozenset(JAX_SCHEMA)}}, many)


# -- errors and fallbacks -------------------------------------------------------


def test_mesh_errors_and_fallbacks():
    with pytest.raises(ValueError, match="multiple of the 'docs' axis"):
        TorchEngine(6, mesh=doc_mesh(4, backend="cpu"))
    with pytest.raises(ValueError, match="conflicts with the mesh"):
        TorchEngine(4, mesh=doc_mesh(4, backend="cpu"), device="cuda")
    with pytest.raises(ValueError, match="requested"):
        doc_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="positive"):
        shard_meshes(0)
    # one CPU device, more shards than devices: every shard unmeshed
    assert shard_meshes(3, backend="cpu") == [None, None, None]
    (only,) = shard_meshes(1, backend="cpu")
    assert only.shape == {"docs": 1} and only.axis_devices() == [CPU]
    m = doc_mesh(3, axis="d", backend="cpu")
    assert m.axis_names == ("d",) and m.devices.size == 3
    with pytest.raises(ValueError, match="axes"):
        DocMesh([CPU, CPU], ("docs", "rows"))
