"""Build and bind the hand-written CUDA kernels of ``yjs_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers)
and is compiled by its own ``nvcc`` process for ``sm_90a`` into
``yjs_tpu_torch/_build/`` at first use (see :mod:`..buildlib`); all
sources compile in parallel.  The libraries are loaded with ``ctypes``:
pointers and the stream pass as ``c_void_p``, sizes as ``c_int`` (the
planner kernels' int64 lane counts as ``c_int64``).
Kernels launch on PyTorch's current stream, neither allocate nor
synchronise, and each C entry returns ``cudaGetLastError()``, which the
binding here turns into a :class:`KernelError`.  A source that does not
build or load raises the same error: callers that contain faults of the
data (the engine's per-doc isolation) let it through, so a dead kernel
stops the flush instead of sending docs to the CPU.

Nothing here runs at import time: importing the module needs neither
``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
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
    "statics", "yata", "conflict_scan", "anchor_lookup",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_int = ctypes.c_int
_i64 = ctypes.c_int64
# C entry points: name -> (library, argtypes)
_ENTRIES = {
    "ytpu_apply_lanes_i32": ("apply_lanes", [_vp] * 5 + [_int] * 7 + [_vp]),
    "ytpu_apply_lanes_i16": ("apply_lanes", [_vp] * 5 + [_int] * 7 + [_vp]),
    "ytpu_scatter_rows": ("scatter_rows", [_vp] * 7 + [_int] * 4 + [_vp]),
    "ytpu_list_ranks": ("list_ranks", [_vp] * 4 + [_int] * 3 + [_vp]),
    "ytpu_state_vector": ("state_vector", [_vp] * 3 + [_int] * 3 + [_vp]),
    "ytpu_diff_mask": ("diff_mask", [_vp] * 6 + [_int] * 3 + [_vp]),
    "ytpu_scatter_statics": ("statics", [_vp] * 7 + [_int] * 3 + [_vp]),
    "ytpu_batch_step": ("yata", [_vp] * 13 + [_int] * 7 + [_vp]),
    "ytpu_batch_step_levels": ("yata", [_vp] * 15 + [_int] * 9 + [_vp]),
    "ytpu_batch_step_levels_shared": (
        "yata", [_vp] * 15 + [_int] * 9 + [_vp]
    ),
    "ytpu_apply_plan_shared": ("apply_lanes", [_vp] * 4 + [_int] * 6 + [_vp]),
    "ytpu_conflict_scan": ("conflict_scan", [_vp] * 12 + [_i64, _vp]),
    "ytpu_anchor_lookup": ("anchor_lookup", [_vp, _i64, _vp, _vp, _i64, _vp]),
}

class KernelError(RuntimeError):
    """A CUDA kernel could not be built, loaded or launched, or a kernel
    was asked for on a host without CUDA."""


_fns: dict | None = None
# per source: {"seconds": build wall time (0.0 when cached), "ptxas": the
# compiler's -Xptxas -v report}
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


def _call(entry: str, device: torch.device, *args) -> None:
    if _fns is None:
        build_all()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _fns[entry](*args, _vp(stream))
    if err:
        raise KernelError(f"{entry}: CUDA error {err} at launch")


def _p(t: torch.Tensor):
    return _vp(t.data_ptr())


def apply_lanes(lanes, cum, right, deleted, starts, b, n1, s1,
                k_dn, k_sp, k_h, k_d) -> None:
    entry = (
        "ytpu_apply_lanes_i16" if lanes.dtype == torch.int16
        else "ytpu_apply_lanes_i32"
    )
    _call(entry, lanes.device, _p(lanes), _p(cum), _p(right), _p(deleted),
          _p(starts), b, n1, s1, k_dn, k_sp, k_h, k_d)


def scatter_rows(idx, new_right, new_deleted, new_starts, right, deleted,
                 starts, k, b, n1, s1) -> None:
    _call("ytpu_scatter_rows", idx.device, _p(idx), _p(new_right),
          _p(new_deleted), _p(new_starts), _p(right), _p(deleted),
          _p(starts), k, b, n1, s1)


def list_ranks(right, valid, scratch, out, b, n1, rounds) -> None:
    _call("ytpu_list_ranks", right.device, _p(right), _p(valid),
          _p(scratch), _p(out), b, n1, rounds)


def state_vector(row_slot, row_end, sv, b, n, n_slots) -> None:
    _call("ytpu_state_vector", row_slot.device, _p(row_slot), _p(row_end),
          _p(sv), b, n, n_slots)


def diff_mask(row_slot, row_clock, row_end, sv, needed, offset, b, n,
              n_slots) -> None:
    _call("ytpu_diff_mask", row_slot.device, _p(row_slot), _p(row_clock),
          _p(row_end), _p(sv), _p(needed), _p(offset), b, n, n_slots)


def scatter_statics(packed, cols, k, b, n1) -> None:
    _call("ytpu_scatter_statics", packed.device, _p(packed),
          *(_p(c) for c in cols), k, b, n1)


def _yata_tables(cols, dyn, visit):
    return [_p(t) for t in (*cols, *dyn, visit)]


def batch_step(cols, dyn, visit, splits, sched, dels, epoch_max) -> None:
    """``cols``: the six static columns in ``kernels.STATIC_KEYS`` order."""
    right, _deleted, starts = dyn
    b, n1 = right.shape
    _call("ytpu_batch_step", right.device, *_yata_tables(cols, dyn, visit),
          _p(splits), _p(sched), _p(dels), b, n1, starts.shape[1],
          splits.shape[1], sched.shape[1], dels.shape[1], epoch_max)


def batch_step_levels(cols, dyn, visit, fast, splits, lv, dels,
                      scratch_base, epoch_max, shared: bool = False) -> None:
    """``shared``: K7b — ``cols`` are ``[N+1]``, ``splits [S, 2]``, ``lv
    [L, W, 8]`` and ``dels [D]``, read by every doc."""
    right, _deleted, starts = dyn
    b, n1 = right.shape
    ax = 0 if shared else 1  # the schedules' first non-doc axis
    entry = "ytpu_batch_step_levels_shared" if shared else "ytpu_batch_step_levels"
    _call(entry, right.device,
          *_yata_tables(cols, dyn, visit), _p(fast), _p(splits), _p(lv),
          _p(dels), _p(scratch_base), b, n1, starts.shape[1],
          splits.shape[ax], lv.shape[ax], lv.shape[ax + 1], dels.shape[ax],
          fast.shape[1], epoch_max)


def apply_plan_shared(lanes, right, deleted, starts, k_l, k_h, k_d) -> None:
    b, n1 = right.shape
    _call("ytpu_apply_plan_shared", lanes.device, _p(lanes), _p(right),
          _p(deleted), _p(starts), b, n1, starts.shape[1], k_l, k_h, k_d)


def conflict_scan(doc_id, cols, left, right, run_id, tile_sum) -> None:
    """``cols``: client, clock, length, o_cl, o_ck, r_cl, r_ck; ``doc_id``
    None for the per-doc variant."""
    n = left.shape[0]
    doc = _vp(None) if doc_id is None else _p(doc_id)
    _call("ytpu_conflict_scan", left.device, doc, *(_p(c) for c in cols),
          _p(left), _p(right), _p(run_id), _p(tile_sum), n)


def anchor_lookup(flat_key, q_key, out) -> None:
    _call("ytpu_anchor_lookup", q_key.device, _p(flat_key),
          flat_key.shape[0], _p(q_key), _p(out), q_key.shape[0])
