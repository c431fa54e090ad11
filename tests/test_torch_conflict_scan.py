"""K12 (``conflict_scan``) on the CPU: its plain version against the JAX
kernels at the CUDA kernel's tile edges, and the host side of its
single-pass launch.

The plain PyTorch version, which the port's wrapper takes for CPU tensors
and which the card's tests hold the kernel to bit for bit
(``tests/test_torch_cuda.py``), is held against the jitted
``_conflict_scan_jax`` and ``_chunk_conflict_scan_jax`` on cases built to
cross the kernel's tiles: a lane less, at and past one and two tiles, and
at the half and double tile widths, with every lane chained, none
chained, and a doc boundary at every tile edge.
Values fit int32, where the JAX kernels compute what int64 does (ROADMAP
R2).  All data is integer: results are equal element for element.

The rest checks what the kernel and its wrapper must agree on without a
card: the constants and the C entry's arguments of ``ops/_cuda.py``
against ``csrc/conflict_scan.cu`` read as text, the output buffer's
layout and the scratch kept a device and stream.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_cuda import SCAN_KINDS, scan_edge_case
from yjs_tpu.ops import kernels as jk
from yjs_tpu_torch.ops import _cuda
from yjs_tpu_torch.ops import kernels as tk

SOURCE = Path(_cuda.CSRC) / "conflict_scan.cu"
TILE = _cuda.SCAN_THREADS * _cuda.SCAN_LANES


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


@pytest.mark.parametrize("kind", SCAN_KINDS)
@pytest.mark.parametrize("offset", [-1, 0, 1])
@pytest.mark.parametrize("tile", [TILE // 2, TILE, 2 * TILE])
def test_plain_matches_jax_at_tile_edges(tile, offset, kind):
    """Both forms a lane before, at and past a tile's edge, for the
    kernel's tile and half and twice it (a doc edge every such tile)."""
    n = tile + offset
    cols, doc_id = scan_edge_case(kind, n, tile, seed=n)
    got = tk.conflict_scan(*_t(cols))
    for w, g in zip(jk._conflict_scan_jax(*cols), got):
        _eq(w, g)
    got_chunk = tk.conflict_scan(*_t(cols), torch.from_numpy(doc_id))
    for w, g in zip(jk._chunk_conflict_scan_jax(doc_id, *cols), got_chunk):
        _eq(w, g)
    for w, g in zip(tk.conflict_scan_plain(*_t(cols),
                                           torch.from_numpy(doc_id)),
                    got_chunk):
        assert torch.equal(w, g)


@pytest.mark.parametrize("tile", [TILE // 2, TILE, 2 * TILE])
def test_edge_cases_are_what_they_say(tile):
    """The builders' cases: all chained is one run through every tile,
    none chained a run a lane, and with a doc at every tile edge the
    chunk form breaks exactly there while the per-doc form runs on."""
    n = 2 * tile + 1
    cols, doc = scan_edge_case("chained", n, tile)
    _l, _r, run_id = tk.conflict_scan(*_t(cols), torch.from_numpy(doc))
    assert run_id.tolist() == [1] * n
    cols, doc = scan_edge_case("unchained", n, tile)
    _l, _r, run_id = tk.conflict_scan(*_t(cols), torch.from_numpy(doc))
    assert run_id.tolist() == list(range(1, n + 1))
    cols, doc = scan_edge_case("doc_edges", n, tile)
    left, _r, run_id = tk.conflict_scan(*_t(cols), torch.from_numpy(doc))
    assert (~left).nonzero().flatten().tolist() == [0, tile, 2 * tile]
    assert run_id[-1] == 3
    assert tk.conflict_scan(*_t(cols))[2][-1] == 1


@pytest.mark.parametrize("tile", [TILE // 2, TILE, 2 * TILE])
def test_wide_edge_cases_match_numpy(tile):
    """Clocks and client ids past 2**31 (the JAX kernels would truncate
    them): the plain version equals the NumPy planner."""
    for kind in SCAN_KINDS:
        cols, doc = scan_edge_case(kind, tile + 1, tile, wide=True)
        assert cols[0].max() > 2**31
        got = tk.conflict_scan(*_t(cols), torch.from_numpy(doc))
        for w, g in zip(tk.plan_chunk_conflict_scan(doc, *cols), got):
            _eq(w, g)


def _source_int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return int(m.group(1))


def test_constants_match_the_source():
    """Threads a block, lanes a thread, the scratch's head words and the
    output alignment, as the source declares them."""
    assert _source_int("kThreads") == _cuda.SCAN_THREADS
    assert _source_int("kLanes") == _cuda.SCAN_LANES
    assert _source_int("kHead") == _cuda.SCAN_HEAD
    assert _source_int("kAlign") == _cuda.SCAN_ALIGN
    assert _source_int("kTicket") < _source_int("kDone") < _cuda.SCAN_HEAD
    # lanes 2t and 2t+1 of each 64-lane chunk a thread: whole chunks
    assert _cuda.SCAN_LANES % 2 == 0


def test_entry_arguments_match_the_source():
    """``ytpu_conflict_scan``'s ctypes argument types follow its C
    parameters: pointers as ``c_void_p``, the lane count as int64."""
    text = SOURCE.read_text()
    m = re.search(r'extern "C" int ytpu_conflict_scan\(([^)]*)\)', text)
    assert m
    params = [p.strip() for p in m.group(1).split(",")]
    want = []
    for p in params:
        if "*" in p:
            want.append(_cuda._vp)
        else:
            assert p.startswith("long long"), p
            want.append(_cuda._i64)
    lib, argtypes = _cuda._ENTRIES["ytpu_conflict_scan"]
    assert lib == "conflict_scan"
    assert argtypes == want


def test_binding_passes_pointers_in_order(monkeypatch):
    """``_cuda.conflict_scan`` hands the entry the doc column (None for
    the per-doc form), the seven columns, the output buffer, the scratch
    (None for one tile) and the lane count."""
    calls = []
    monkeypatch.setattr(_cuda, "_call", lambda *a: calls.append(a))
    cols = [torch.zeros(5, dtype=torch.int64) for _ in range(7)]
    doc = torch.zeros(5, dtype=torch.int64)
    out = torch.empty(_cuda.scan_layout(5)[2], dtype=torch.uint8)
    scratch = torch.zeros(64, dtype=torch.int64)
    _cuda.conflict_scan(doc, cols, out, scratch, 5)
    _cuda.conflict_scan(None, cols, out, None, 5)
    ptrs = [c.data_ptr() for c in cols]
    assert calls[0] == ("ytpu_conflict_scan", out.device, doc.data_ptr(),
                        *ptrs, out.data_ptr(), scratch.data_ptr(), 5)
    assert calls[1] == ("ytpu_conflict_scan", out.device, None, *ptrs,
                        out.data_ptr(), None, 5)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 15, 16, 17, 64, 2047, 2049,
                               1 << 20, (1 << 22) + 3])
def test_layout(n):
    """run_id's ``8 n`` bytes first, then left and right, each on a
    16-byte boundary and with room for a whole 16-byte word past its last
    lane's."""
    left_at, right_at, nbytes = _cuda.scan_layout(n)
    a = _cuda.SCAN_ALIGN
    assert left_at % a == 0 and right_at % a == 0
    assert 8 * n <= left_at < 8 * n + a
    assert right_at - left_at == nbytes - right_at == -(-n // a) * a


def test_tiles():
    assert [_cuda.scan_tiles(n) for n in
            (1, TILE - 1, TILE, TILE + 1, 1 << 22)] == [
                1, 1, 1, 2, (1 << 22) // TILE]


def test_scratch_kept_a_stream_and_grown(monkeypatch):
    """One zeroed int64 scratch a device and stream, grown to a power of
    two with room for the head words and a status word a tile; a grown
    scratch's old buffer is kept (a captured graph may still use it)."""
    monkeypatch.setattr(tk, "_scan_scratch_by_stream", {})
    monkeypatch.setattr(tk, "_scan_scratch_retired", [])
    dev = torch.device("cpu")
    a = tk._scan_scratch(dev, 5)
    assert a.dtype == torch.int64 and a.numel() == 64
    assert not a.any()
    assert tk._scan_scratch(dev, 32) is a
    b = tk._scan_scratch(dev, 100)
    assert b.numel() == 256 and b is not a
    assert tk._scan_scratch_retired == [a]
    assert tk._scan_scratch(dev, 7) is b


def test_wrapper_refuses_mixed_and_other_devices():
    """Columns on two devices raise ``ValueError`` naming the column; a
    device that is neither the CPU nor CUDA raises too."""
    cols = [torch.zeros(4, dtype=torch.int64) for _ in range(7)]
    with pytest.raises(ValueError, match="doc_id"):
        tk.conflict_scan(*cols, torch.zeros(4, dtype=torch.int64,
                                            device="meta"))
    with pytest.raises(ValueError, match="r_ck"):
        tk.conflict_scan(*cols[:6], cols[6].to("meta"))
    with pytest.raises(ValueError):
        tk.conflict_scan(*(c.to("meta") for c in cols))
