"""Build and bind the hand-written CUDA kernels of ``yjs_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers)
and is compiled by its own ``nvcc`` process for ``sm_90a`` into
``yjs_tpu_torch/_build/`` at first use (see :mod:`..buildlib`); all
sources compile in parallel.  The libraries are loaded with ``ctypes``:
pointers and the stream pass as ``c_void_p``, sizes as ``c_int`` (the
planner kernels' int64 lane counts as ``c_int64``), and a launch's
per-shard pointers as one ``array.array`` the entry copies from.
Kernels launch on PyTorch's current stream, neither allocate nor
synchronise, and each C entry returns ``cudaGetLastError()``, which the
binding here turns into a :class:`KernelError`.  A launch enters no
device context when the tensors' device is already current and reads the
stream's raw handle with one C call.  A source that does not
build or load raises the same error: callers that contain faults of the
data (the engine's per-doc isolation) let it through, so a dead kernel
stops the flush instead of sending docs to the CPU.

Nothing here runs at import time: importing the module needs neither
``nvcc`` nor a card.
"""

from __future__ import annotations

import array
import ctypes
import functools
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..buildlib import build_shared

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
SOURCES = (
    "apply_lanes", "scatter_rows", "list_ranks", "state_vector", "diff_mask",
    "statics", "yata", "conflict_scan", "anchor_lookup", "shard_fold",
    "apply_shared",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_int = ctypes.c_int
_i64 = ctypes.c_int64
_u32 = ctypes.c_uint
# C entry points: name -> (library, argtypes)
_ENTRIES = {
    "ytpu_apply_lanes_sharded_i32": ("apply_lanes",
                                     [_vp, _int, _vp] + [_int] * 7 + [_vp]),
    "ytpu_apply_lanes_sharded_i16": ("apply_lanes",
                                     [_vp, _int, _vp] + [_int] * 7 + [_vp]),
    "ytpu_scatter_rows": ("scatter_rows", [_vp] * 7 + [_int] * 4 + [_vp]),
    "ytpu_list_ranks": ("list_ranks", [_vp] * 5 + [_int] * 4 + [_vp]),
    "ytpu_empty_launch": ("list_ranks", [_vp]),
    "ytpu_state_vector_sharded": ("state_vector", [_vp, _int, _int, _vp]),
    "ytpu_diff_mask": ("diff_mask", [_vp] * 6 + [_int] * 3 + [_u32] * 2
                       + [_vp]),
    "ytpu_scatter_statics": ("statics", [_vp] * 7 + [_int] * 3 + [_vp]),
    "ytpu_batch_step": ("yata", [_vp] * 13 + [_int] * 11 + [_vp]),
    "ytpu_batch_step_levels_sharded": ("yata", [_vp] + [_int] * 15 + [_vp]),
    "ytpu_smem_optin": ("yata", [_vp, _vp]),
    "ytpu_yata_occupancy": ("yata", [_int] * 3 + [_vp, _vp]),
    "ytpu_apply_plan_shared": ("apply_shared",
                               [_vp] * 4 + [_i64] + [_int] * 6 + [_vp]),
    "ytpu_conflict_scan": ("conflict_scan", [_vp] * 10 + [_i64, _vp]),
    "ytpu_anchor_lookup_sharded": ("anchor_lookup", [_vp, _int, _i64, _vp]),
    "ytpu_shard_fold": ("shard_fold", [_vp, _int, _i64, _int, _vp, _vp]),
}
# the most partials one shard_fold launch takes (kMaxParts in the source)
FOLD_MAX_PARTS = 64
# the most shards one anchor-lookup launch takes (kMaxShards in the source)
LOOKUP_MAX_SHARDS = 64
# the most shards one state-vector launch takes (kMaxShards in
# state_vector.cu), and the ints of a shard's row in its descriptor
SV_MAX_SHARDS = 64
SV_ROW = 7
# the most shards one apply-lanes or levels launch takes (kMaxShards in
# apply_lanes.cu and yata.cu), and the ints of a shard's row in their
# descriptors
MESH_MAX_SHARDS = 16
APPLY_ROW = 7
# the int32 counters in front of an apply-lanes scratch's cum rows
# (kSyncInts in apply_lanes.cu), zero between launches
APPLY_SYNC_INTS = 1024
LEVELS_ROW = 17
# the least haystack length the anchor lookup stages in shared memory,
# and the keys of that sample (kSample in the source)
LOOKUP_STAGE_MIN = 1 << 13
LOOKUP_SAMPLE = 128
# K12 (csrc/conflict_scan.cu): threads a block (kThreads), lanes a thread
# (kLanes), the int64 words in front of a scratch's status words (kHead,
# zero between launches) and the alignment of the output buffer's parts
# (kAlign)
SCAN_THREADS = 256
SCAN_LANES = 8
SCAN_HEAD = 32
SCAN_ALIGN = 16
# K7a (csrc/apply_shared.cu): threads a block (kThreads), lanes a link or
# head tile (kTile), table rows a delete tile (kDelRows), the most tiles a
# launch (kMaxTiles), blocks an SM holds (kMinBlocks, its launch bound)
SHARED_THREADS = 256
SHARED_TILE = 2048
SHARED_DEL_ROWS = (SHARED_TILE - 1) * 32
SHARED_MAX_TILES = 65535
SHARED_BLOCKS_SM = 5
# K10 (csrc/diff_mask.cu): the alignment of its output buffer's parts
DIFF_ALIGN = 16


def scan_tiles(n: int) -> int:
    """K12's tiles over ``n`` lanes."""
    return -(-n // (SCAN_THREADS * SCAN_LANES))


def scan_layout(n: int) -> tuple[int, int, int]:
    """K12's output buffer over ``n`` lanes: ``(left_at, right_at,
    nbytes)``; run_id (int64) fills its first ``8 * n`` bytes, left and
    right (a byte a lane) start at the byte offsets given, each a multiple
    of :data:`SCAN_ALIGN`."""
    a = SCAN_ALIGN
    left_at = -(-8 * n // a) * a
    span = -(-n // a) * a
    return left_at, left_at + span, left_at + 2 * span


def shared_tiles(k_l: int, k_h: int, k_d: int, n1: int) -> int:
    """K7a's tiles: the link and head sections' tiles of
    :data:`SHARED_TILE` lanes, then (with any delete lane) the delete
    tiles of :data:`SHARED_DEL_ROWS` rows of the ``n1``-wide table."""
    dels = -(-n1 // SHARED_DEL_ROWS) if k_d > 0 and n1 > 0 else 0
    return -(-k_l // SHARED_TILE) - (-k_h // SHARED_TILE) + dels


def diff_layout(total: int) -> tuple[int, int]:
    """K10's output buffer over ``total`` rows: ``(needed_at, nbytes)``;
    offset (int32) fills its first ``4 * total`` bytes, needed (a byte a
    row) starts at byte ``needed_at``, a multiple of :data:`DIFF_ALIGN`;
    ``nbytes`` is a multiple of it too."""
    a = DIFF_ALIGN
    needed_at = -(-4 * total // a) * a
    return needed_at, needed_at + -(-total // a) * a


@functools.lru_cache(maxsize=64)
def fast_div(n: int) -> tuple[int, int]:
    """``(mul, shift)`` with ``x // n == (x * mul) >> (32 + shift)`` for
    every ``0 <= x < 2**31`` (``mul`` 0 for ``n`` 1, where the quotient
    is ``x``): K10's division by the row count, a multiply-high and a
    shift on the card."""
    if n < 1:
        raise ValueError(f"fast_div needs n >= 1, got {n}")
    if n == 1:
        return 0, 0
    p = 31 + (n - 1).bit_length()
    return ((1 << p) + n - 1) // n, p - 32


class KernelError(RuntimeError):
    """A CUDA kernel could not be built, loaded or launched, or a kernel
    was asked for on a host without CUDA."""


_fns: dict | None = None
# per source: {"seconds": build wall time (0.0 when cached), "ptxas": the
# compiler's -Xptxas -v report, "path": the library}
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build_one(name: str, nvcc: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")

    def cmd(out):
        return [nvcc, *NVCC_FLAGS, "-o", out, src]

    t0 = time.perf_counter()
    path, built, out = build_shared(f"cuda_{name}", [src], cmd, timeout=900)
    build_info[name] = {
        "seconds": time.perf_counter() - t0 if built else 0.0,
        "ptxas": out,
        "path": path,
    }
    return path


def build_all() -> dict:
    """Compile every source (one nvcc each, all at once) and bind the
    entry points; returns :data:`build_info`.  Idempotent."""
    global _fns
    if _fns is not None:
        return build_info
    nvcc = _nvcc()
    try:
        with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
            paths = dict(
                zip(SOURCES, pool.map(lambda n: _build_one(n, nvcc), SOURCES))
            )
        libs = {name: ctypes.CDLL(p) for name, p in paths.items()}
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or b""
        if isinstance(detail, bytes):
            detail = detail.decode(errors="replace")
        raise KernelError(
            f"the CUDA kernels did not build or load: {e}\n{detail[-4000:]}"
        ) from e
    fns = {}
    for entry, (lib, argtypes) in _ENTRIES.items():
        fn = getattr(libs[lib], entry)
        fn.argtypes = argtypes
        fn.restype = _int
        fns[entry] = fn
    _bind_streams()
    _fns = fns
    return build_info


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel from an ``-Xptxas -v`` report: its mangled
    name, registers and spill bytes."""
    out = []
    kernel = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel, spill = m.group(1), "spill not reported"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            spill = f"spill {m.group(1)}B/{m.group(2)}B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append(f"{kernel}: {m.group(1)} registers, {spill}")
            kernel = None
    return out


# bound by build_all: the current device's index and the raw handle of
# a device's current stream, one C call each where this PyTorch has them
# (``stream_lookup`` names the one bound)
_current_device = None
_raw_stream = None
stream_lookup = None


def _stream_object_handle(idx: int) -> int:
    return torch.cuda.current_stream(idx).cuda_stream


def _bind_streams() -> None:
    global _current_device, _raw_stream, stream_lookup
    _current_device = getattr(torch._C, "_cuda_getDevice",
                              torch.cuda.current_device)
    _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream",
                          _stream_object_handle)
    stream_lookup = getattr(_raw_stream, "__name__", str(_raw_stream))


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, which the next
    launch on ``device`` takes."""
    if _raw_stream is None:
        _bind_streams()
    idx = device.index
    return _raw_stream(_current_device() if idx is None else idx)


def _call(entry: str, device: torch.device, *args) -> None:
    """Launch ``entry`` on the current stream of ``device``, switching the
    current device only when it is another one (a mesh over several
    cards)."""
    if _fns is None:
        build_all()
    idx = device.index
    cur = _current_device()
    if idx is None or idx == cur:
        err = _fns[entry](*args, _raw_stream(cur))
    else:
        with torch.cuda.device(idx):
            err = _fns[entry](*args, _raw_stream(idx))
    if err:
        raise KernelError(f"{entry}: CUDA error {err} at launch")


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


def _opt(t):
    return None if t is None else t.data_ptr()


def rounds(n_shards: int, per: int = MESH_MAX_SHARDS) -> int:
    """The launches of ``n_shards`` shards with work, ``per`` a round."""
    return -(-n_shards // per)


def apply_lanes(desc: list, device: torch.device, sync: int, wide: bool,
                n1, s1, staged, k_dn, k_sp, k_h, k_d) -> int:
    """Every shard of ``desc`` (flat rows of :data:`APPLY_ROW` ints: the
    ``data_ptr`` of lanes, cum, right, deleted, starts and counter, 0 for
    none, then the doc count; all on ``device``) scattered by one launch
    per :data:`MESH_MAX_SHARDS` shards; ``sync``: the ``data_ptr`` of the
    :data:`APPLY_SYNC_INTS` zeroed counters of the scratch kept for the
    current stream; ``wide``: int32 lanes, else int16; ``staged``: 1 for
    the variant whose lane blocks scan their counts in shared memory.
    Returns the launches."""
    n = len(desc) // APPLY_ROW
    rows = array.array("q", desc)  # read by the entry before it returns
    _call("ytpu_apply_lanes_sharded_i32" if wide
          else "ytpu_apply_lanes_sharded_i16", device, rows.buffer_info()[0],
          n, sync, n1, s1, staged, k_dn, k_sp, k_h, k_d)
    return rounds(n)


def scatter_rows(idx, new_right, new_deleted, new_starts, right, deleted,
                 starts, k, b, n1, s1) -> None:
    _call("ytpu_scatter_rows", idx.device, _p(idx), _p(new_right),
          _p(new_deleted), _p(new_starts), _p(right), _p(deleted),
          _p(starts), k, b, n1, s1)


def list_ranks(right, valid, scratch, out, counter, b, n1, rounds) -> None:
    """``scratch``: the ``[b, 4, n1]`` int32 planes of the global variant,
    None for the staged one; ``counter``: a ``[1]`` int32 or None."""
    _call("ytpu_list_ranks", right.device, _p(right), _p(valid),
          _opt(scratch), _p(out), _opt(counter), b, n1, rounds,
          int(scratch is None))


def empty_launch(device: torch.device) -> None:
    """One launch of an empty kernel on ``device`` (the floor under a
    one-launch call)."""
    _call("ytpu_empty_launch", device)


def state_vector(desc: list, device: torch.device, n_slots: int) -> int:
    """Every shard of ``desc`` (flat rows of :data:`SV_ROW` ints: the
    ``data_ptr`` of its slot and end blocks, their row stride, docs and
    columns, its output rows' ``data_ptr`` and row stride; all on
    ``device``, docs and columns at least 1) reduced in one launch per
    :data:`SV_MAX_SHARDS` shards; returns the launches."""
    n = len(desc) // SV_ROW
    rows = array.array("q", desc)  # read by the entry before it returns
    _call("ytpu_state_vector_sharded", device, rows.buffer_info()[0], n,
          n_slots)
    return rounds(n, SV_MAX_SHARDS)


def diff_mask(device, row_slot, row_clock, row_end, sv, needed, offset, b,
              n, n_slots) -> None:
    """``row_slot`` .. ``offset``: ``data_ptr``s on ``device``."""
    _call("ytpu_diff_mask", device, row_slot, row_clock, row_end, sv, needed,
          offset, b, n, n_slots, *fast_div(n))


def scatter_statics(packed, cols, k, b, n1) -> None:
    _call("ytpu_scatter_statics", packed.device, _p(packed),
          *(_p(c) for c in cols), k, b, n1)


# the most dynamic shared memory a block may opt into, by device index
_smem_optin: dict = {}


def smem_optin(device: torch.device) -> int:
    """``cudaDevAttrMaxSharedMemoryPerBlockOptin`` of ``device`` (bytes),
    read once a device."""
    if _fns is None:
        build_all()
    idx = device.index if device.index is not None else _current_device()
    if idx not in _smem_optin:
        out = ctypes.c_int(0)
        _call("ytpu_smem_optin", torch.device("cuda", idx), ctypes.byref(out))
        _smem_optin[idx] = out.value
    return _smem_optin[idx]


def yata_occupancy(device: torch.device, kind: int, variant: int,
                   smem: int) -> tuple[int, int]:
    """Threads a block and blocks an SM of a YATA step (``kind`` 0: K5,
    1: K6 and K15, 2: K7b) in variant ``variant`` with ``smem`` dynamic
    shared bytes on ``device`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_int * 2)()
    _call("ytpu_yata_occupancy", device, kind, variant, smem, out)
    return out[0], out[1]


def batch_step(cols, dyn, visit, splits, sched, dels, epoch_max,
               variant: int, layout) -> None:
    """``cols``: the six static columns in ``kernels.STATIC_KEYS`` order;
    ``visit``: the ``[B, N+1]`` visit scratch, None for the shared
    variant (0), which keeps it in shared memory; ``layout``: the
    variant's ``kernels.yata_layout`` (K5 stages no fast flags)."""
    right, _deleted, starts = dyn
    b, n1 = right.shape
    st_at, visit_at, _fast_at, nbytes = layout
    _call("ytpu_batch_step", right.device, *(_p(t) for t in (*cols, *dyn)),
          _opt(visit), _p(splits), _p(sched), _p(dels), b, n1,
          starts.shape[1], splits.shape[1], sched.shape[1], dels.shape[1],
          epoch_max, variant, st_at, visit_at, nbytes)


def batch_step_levels(desc: list, device: torch.device, dims,
                      epoch_max: int, shared: bool = False) -> int:
    """Every shard of ``desc`` (flat rows of :data:`LEVELS_ROW` ints, all
    on ``device``; see ``ytpu_batch_step_levels_sharded``) stepped by one
    launch per :data:`MESH_MAX_SHARDS` shards.  ``dims``: ``n1, s1,
    n_splits, n_lv, w, n_del, fast_w``, every shard's, then the variant's
    index in ``kernels.YATA_VARIANTS`` and its ``kernels.yata_layout``
    (``st_at, visit_at, fast_at, nbytes``).  ``shared``: K7b, whose statics,
    splits, lv and dels are one doc's, read by all.  Returns the
    launches."""
    n = len(desc) // LEVELS_ROW
    rows = array.array("q", desc)  # read by the entry before it returns
    _call("ytpu_batch_step_levels_sharded", device, rows.buffer_info()[0], n,
          int(shared), *dims, epoch_max)
    return rounds(n)


# SMs by device index
_sm_count: dict = {}


def sm_count(device: torch.device) -> int:
    """``device``'s streaming multiprocessors, read once a device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _sm_count.get(idx)
    if n is None:
        n = _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def apply_plan_shared(device, lanes, right, deleted, starts, b, n1, s1, k_l,
                      k_h, k_d, docs) -> None:
    """``lanes`` .. ``starts``: ``data_ptr``s on ``device``; ``docs``: the
    docs a block (``kernels.shared_docs_a_block``)."""
    _call("ytpu_apply_plan_shared", device, lanes, right, deleted, starts, b,
          n1, s1, k_l, k_h, k_d, docs)


def conflict_scan(doc_id, cols, out, scratch, n: int) -> None:
    """``cols``: client, clock, length, o_cl, o_ck, r_cl, r_ck; ``doc_id``
    None for the per-doc form; ``out``: the :func:`scan_layout` buffer;
    ``scratch``: :data:`SCAN_HEAD` + :func:`scan_tiles` zeroed int64 of
    the current stream, None for one tile."""
    client, clock, length, o_cl, o_ck, r_cl, r_ck = cols
    _call("ytpu_conflict_scan", out.device, _opt(doc_id), client.data_ptr(),
          clock.data_ptr(), length.data_ptr(), o_cl.data_ptr(),
          o_ck.data_ptr(), r_cl.data_ptr(), r_ck.data_ptr(), out.data_ptr(),
          _opt(scratch), n)


def anchor_lookup(desc: list, device: torch.device,
                  stage_min: int = LOOKUP_STAGE_MIN) -> int:
    """Every shard of ``desc`` (flat rows of ``hay_ptr, n_hay, q_ptr,
    out_ptr, n_q``, all on ``device``, ``n_q >= 1``) searched in one
    launch per :data:`LOOKUP_MAX_SHARDS` shards; returns the launches.
    ``stage_min``: the least haystack staged in shared memory."""
    n = len(desc) // 5
    rows = array.array("q", desc)  # read by the entry before it returns
    _call("ytpu_anchor_lookup_sharded", device, rows.buffer_info()[0], n,
          stage_min)
    return rounds(n, LOOKUP_MAX_SHARDS)


def shard_fold(ptrs: list, n: int, op: int, out) -> int:
    """``ptrs``: the ``data_ptr`` of each int32 partial of ``n`` elements on
    ``out``'s device; ``op`` 0 is SUM, 1 is MAX.  Returns the launches
    (one per :data:`FOLD_MAX_PARTS` partials, then one per
    ``FOLD_MAX_PARTS - 1``)."""
    parts = array.array("Q", ptrs)  # read by the entry before it returns
    _call("ytpu_shard_fold", out.device, parts.buffer_info()[0], len(ptrs),
          n, op, out.data_ptr())
    return 1 + max(0, -(-(len(ptrs) - FOLD_MAX_PARTS) // (FOLD_MAX_PARTS - 1)))
