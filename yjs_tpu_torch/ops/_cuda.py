"""Build and bind the hand-written CUDA kernels of ``yjs_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers)
and is compiled by its own ``nvcc`` process for ``sm_90a`` into
``yjs_tpu_torch/_build/`` at first use (see :mod:`..buildlib`); all
sources compile in parallel.  The libraries are loaded with ``ctypes``:
pointers and the stream pass as ``c_void_p``, sizes as ``c_int``.
Kernels launch on PyTorch's current stream, neither allocate nor
synchronise, and each C entry returns ``cudaGetLastError()``, which the
binding here turns into a ``RuntimeError``.

Nothing here runs at import time: importing the module needs neither
``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..buildlib import build_shared

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
SOURCES = (
    "apply_lanes", "scatter_rows", "list_ranks", "state_vector", "diff_mask",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_int = ctypes.c_int
# C entry points: name -> (library, argtypes)
_ENTRIES = {
    "ytpu_apply_lanes_i32": ("apply_lanes", [_vp] * 5 + [_int] * 7 + [_vp]),
    "ytpu_apply_lanes_i16": ("apply_lanes", [_vp] * 5 + [_int] * 7 + [_vp]),
    "ytpu_scatter_rows": ("scatter_rows", [_vp] * 7 + [_int] * 4 + [_vp]),
    "ytpu_list_ranks": ("list_ranks", [_vp] * 4 + [_int] * 3 + [_vp]),
    "ytpu_state_vector": ("state_vector", [_vp] * 3 + [_int] * 3 + [_vp]),
    "ytpu_diff_mask": ("diff_mask", [_vp] * 6 + [_int] * 3 + [_vp]),
}

_fns: dict | None = None
# per source: {"seconds": build wall time (0.0 when cached), "ptxas": the
# compiler's -Xptxas -v report}
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
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
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = dict(
            zip(SOURCES, pool.map(lambda n: _build_one(n, nvcc), SOURCES))
        )
    libs = {name: ctypes.CDLL(p) for name, p in paths.items()}
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
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")


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
