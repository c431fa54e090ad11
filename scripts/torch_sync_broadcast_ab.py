#!/usr/bin/env python3
"""The broadcast replay's scatter (K7a, ``apply_plan_shared``) and the sync
diff (K10, ``diff_mask_kernel``) of one checkout, for comparing checkouts
on one card.

    python3 scripts/torch_sync_broadcast_ab.py --root PATH [--label NAME]
        [--cells NAME,...] [--waves W,...] [--out FILE]

Imports ``yjs_tpu_torch`` from the checkout at ``PATH`` (its kernels build
into that checkout), and the timing helpers of this checkout's
``chip_smoke.py``; needs a CUDA card.  The cells, every input made here
from a seed or from the repository's fixtures, the same for every
checkout:

- ``k7a_smoke``: the first distinct fixture trace planned once by a
  Python mirror (``chip_smoke.shared_plan``), over 4096 docs;
- ``k7a_b4_16384``, ``k7a_b4_100k``: the B4 fixture
  (``tests/fixtures/b4_trace.bin``) planned once by the port's native
  mirror and padded as ``bench.py`` pads it (``chip_smoke.b4_plan``),
  over 16384 docs (the B4
  bench's ``YTPU_BENCH_DOCS``) and 100,000 docs (``BASELINE.json``'s
  north star);
- ``k10_storm``: a reconnect storm's columns, B = 4096, N = 1102, two
  slots a doc: a third of the remote state vectors empty, a third at half
  each slot's clock, a third up to date;
- ``k10_checkpoint``: the same columns against empty state vectors (every
  live row needed, as in a WAL checkpoint);
- ``k10_16384x9373``: seeded columns, B = 16384, N = 9373 (B4's table
  width at the bench's doc count).

With ``--waves``, the K7a cells run again for each value of
``kernels.SHARED_WAVES`` (a checkout that has it), as cells
``<cell>_w<W>``.

Each K7a result is checked against the plain version first (on the first
1024 docs, then every doc against doc 0), each K10 result against the
plain version.  For each cell one JSON line: events ms and device ms
(``torch.profiler``) with the L2 cache flushed before every call by a 64
MB write (the flush's own kernel left out of the device ms), the same two
back to back (``ms_warm``, ``device_ms_warm``), one call's host µs split
as ``chip_smoke.host_split`` splits it, the wrapper's launches and the
kernels by name over one call, K7a's ``library_ms`` (``index_put_`` x3 on
the in-bound lanes, filtered once outside the timed call, as
``chip_smoke.shared_index_put`` does; flushed and warm), a ``digest`` of the outputs (blake2b; K7a's tables after one call
on fresh tables, every 64th doc at 100k docs), and the byte bound
(``bound_ms``: inputs read once, outputs written once, K10's clocks only
where a row is needed; ``bound_ms_all_read``: every clock read).  Every
line carries the card's name and power limit.  Compare checkouts in
turns (A, B, B, A) in one call: the host's speed and the card's clocks
change between machines.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
N_CALLS = 50
FLUSH_BYTES = 64 << 20
CELLS = ("k7a_smoke", "k7a_b4_16384", "k7a_b4_100k", "k10_storm",
         "k10_checkpoint", "k10_16384x9373")
CHECK_DOCS = 1024
NULL = -1


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync_columns(seed: int, b: int, n: int, kind: str):
    """Seeded ``row_slot, row_clock, row_end [b, n]`` and ``sv [b,
    n_slots]`` (int32 numpy).  ``storm``: two slots a doc, each doc's
    rows its clients' runs (about a tenth of a doc's rows past its live
    ones, slot -1), a third of the state vectors empty, a third at half
    each slot's clock, a third up to date; ``checkpoint``: the same rows
    against empty state vectors; ``seeded``: four slots, any clocks."""
    g = np.random.default_rng(seed)
    n_slots = 4 if kind == "seeded" else 2
    row_slot = g.integers(0, n_slots, size=(b, n)).astype(np.int64)
    live = (np.arange(n)[None, :]
            < (n * g.uniform(0.85, 1.0, size=(b, 1))).astype(np.int64))
    row_slot[~live] = -1
    length = g.integers(1, 6, size=(b, n))
    row_clock = np.zeros((b, n), np.int64)
    for s in range(n_slots):  # each slot's rows in clock order
        mine = row_slot == s
        run = np.cumsum(np.where(mine, length, 0), axis=1)
        row_clock = np.where(mine, run - length, row_clock)
    row_end = row_clock + length
    top = np.stack([np.where(row_slot == s, row_end, 0).max(axis=1)
                    for s in range(n_slots)], axis=1)
    if kind == "seeded":
        sv = g.integers(0, np.maximum(top, 1) + 1)
    else:
        third = np.arange(b) % 3
        sv = np.where(third[:, None] == 0, 0,
                      np.where(third[:, None] == 1, top // 2, top))
        if kind == "checkpoint":
            sv = np.zeros_like(sv)
    return tuple(a.astype(np.int32) for a in (row_slot, row_clock, row_end, sv))


def digest(tensors, every: int = 1) -> str:
    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        x = t[::every] if every > 1 else t
        h.update(np.ascontiguousarray(x.cpu().numpy()).tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--waves", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sync_broadcast_ab: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = load("chip_smoke_helpers", HERE / "chip_smoke.py")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yjs_tpu_torch.ops import _cuda
    from yjs_tpu_torch.ops import kernels as K

    if not Path(K.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {K.__file__}, not from {root}")
    _cuda.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    label = args.label or str(root)
    sink = open(args.out, "a") if args.out else None
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def flush_l2():
        flush.fill_(7)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush_l2()
        torch.cuda.synchronize()
    flush_keys = {e.key for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}

    def flushed_ms(fn):
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(N_CALLS):
            flush_l2()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / N_CALLS

    def flushed_device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(N_CALLS):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.key not in flush_keys)
        return us / 1e3 / N_CALLS if us > 0 else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def timings(fn):
        return {
            "launches_a_call": cs.launches_a_call(K, fn),
            "kernels_a_call": cs.kernels_a_call(fn),
            "ms": flushed_ms(fn), "device_ms": flushed_device_ms(fn),
            "ms_warm": cs.cuda_ms(fn), "device_ms_warm": cs.device_ms(fn),
            "host_us": cs.host_split(fn),
        }

    b4 = None

    def k7a(cell, waves=None):
        nonlocal b4
        if cell == "k7a_smoke":
            sp = cs.shared_plan(cs.load_traces()[0], torch.device("cpu"))
            lanes = sp["lanes"].to(dev)
            k_l, k_h, k_d = sp["k_l"], sp["k_h"], sp["k_d"]
            n1, s1, b = sp["cap"] + 1, sp["s1"], cs.N_BROADCAST_DOCS
        else:
            if b4 is None:
                b4 = cs.b4_plan()
            lanes = torch.from_numpy(b4["lanes"]).to(dev)
            k_l, k_h, k_d = b4["k_l"], b4["k_h"], b4["k_d"]
            n1, s1 = b4["cap"] + 1, b4["s1"]
            b = 16384 if cell.endswith("16384") else 100_000

        def fresh(docs):
            return (torch.full((docs, n1), NULL, dtype=torch.int32, device=dev),
                    torch.zeros((docs, n1), dtype=torch.bool, device=dev),
                    torch.full((docs, s1), NULL, dtype=torch.int32, device=dev))

        saved = getattr(K, "SHARED_WAVES", None)
        if waves is not None:
            K.SHARED_WAVES = waves
        try:
            c = min(b, CHECK_DOCS)
            ref = K.apply_plan_shared_plain(fresh(c), lanes, k_l, k_h, k_d)
            dyn = fresh(b)
            got = K.apply_plan_shared(dyn, lanes, k_l, k_h, k_d)
            torch.cuda.synchronize()
            for name, r, x in zip(("right", "deleted", "starts"), ref, got):
                if not (torch.equal(r, x[:c]) and bool((x == x[:1]).all())):
                    raise SystemExit(f"apply_plan_shared {cell}: {name} "
                                     "differs from its plain version")
            dig = digest(got, 64 if b > 16384 else 1)
            w_l, w_h, w_d = cs.shared_lane_writes(lanes, k_l, k_h, n1, s1)
            nbytes = lanes.nbytes + b * (4 * w_l + 4 * w_h + w_d)

            def fn():
                return K.apply_plan_shared(dyn, lanes, k_l, k_h, k_d)

            rec = {"label": label, "card": smi,
                   "cell": cell if waves is None else f"{cell}_w{waves}",
                   "name": "apply_plan_shared", "waves": waves,
                   "docs": b, "lanes": [k_l, k_h, k_d],
                   "in_bound": [w_l, w_h, w_d], **timings(fn)}
        finally:
            if waves is not None:
                K.SHARED_WAVES = saved
        # the library yardstick: index_put_ x3 on the in-bound lanes
        put = cs.shared_index_put(lanes, k_l, k_h, n1, s1)
        lib = put(fresh(c))
        if not all(torch.equal(r, x) for r, x in zip(ref, lib)):
            raise SystemExit(f"index_put_ x3 {cell} differs from the plain "
                             "version")
        del lib

        def library():
            return put(dyn)

        rec["library_ms"] = flushed_ms(library)
        rec["library_ms_warm"] = cs.cuda_ms(library)
        rec["digest"] = dig
        rec["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
        emit(rec)
        del dyn, got, ref
        torch.cuda.empty_cache()

    def k10(cell):
        b, n = (16384, 9373) if cell.endswith("9373") else (4096, 1102)
        kind = {"k10_storm": "storm", "k10_checkpoint": "checkpoint"}.get(
            cell, "seeded")
        args_ = [torch.from_numpy(a).to(dev)
                 for a in sync_columns(b + n, b, n, kind)]
        ref = K.diff_mask_kernel_plain(*args_)
        got = K.diff_mask_kernel(*args_)
        if not all(torch.equal(r, g) for r, g in zip(ref, got)):
            raise SystemExit(f"diff_mask {cell} differs from its plain version")

        def fn():
            return K.diff_mask_kernel(*args_)

        needed = int(got[0].sum())
        ins = sum(t.nbytes for t in args_)
        outs = got[0].nbytes + got[1].nbytes
        rec = {"label": label, "card": smi, "cell": cell, "name": "diff_mask",
               "shape": [b, n, args_[3].shape[1]], "needed_rows": needed,
               **timings(fn), "digest": digest(got),
               "bound_ms": (ins - args_[1].nbytes + 4 * needed + outs)
               / cs.HBM_BYTES_PER_S * 1e3,
               "bound_ms_all_read": (ins + outs) / cs.HBM_BYTES_PER_S * 1e3}
        emit(rec)
        del args_, ref, got
        torch.cuda.empty_cache()

    waves = [int(w) for w in args.waves.split(",") if w]
    for cell in args.cells.split(","):
        if cell.startswith("k7a"):
            k7a(cell)
            if hasattr(K, "SHARED_WAVES"):
                for w in waves:
                    k7a(cell, w)
        else:
            k10(cell)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("YTPU_PLAN_SEGMENT", "device")
    sys.exit(main())
