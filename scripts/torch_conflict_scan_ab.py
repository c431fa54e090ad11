#!/usr/bin/env python3
"""The segment planner's conflict scan (K12, chunk and per doc) of one
checkout, for comparing checkouts on one card.

    python3 scripts/torch_conflict_scan_ab.py --root PATH --inputs FILE
        [--label NAME] [--cells NAME,...] [--out FILE]

Imports ``yjs_tpu_torch`` from the checkout at ``PATH`` (its kernels build
into that checkout), and the timing helpers of this checkout's
``chip_smoke.py``; needs a CUDA card.

Inputs: when ``--inputs`` does not exist yet, the smoke planner path's
flush-1 chunk is built on the host as ``segment_planner.plan_chunk``
builds it (the phase-A queries of 1024 Python mirrors, one fixture trace
each, concatenated doc-major with a doc column and padded to a power of
two as ``kernels._scan_on`` pads them) and kept in that file; later runs
read it, so every checkout sees the same bytes.  The cells:

- ``smoke``: that chunk (2**20 lanes, doc column);
- ``seeded_2^16``, ``seeded_2^20``, ``seeded_2^22``: seeded chunks of that
  many lanes, about one doc a 300 refs, most origins near the lane
  before's id range;
- ``chained_2^20``: every lane chained, one doc (one run through every
  tile); ``unchained_2^20``: no lane chained;
- ``doc_64``: the per-doc form on the chunk's first 64 lanes (doc 0's
  refs, the size of the smoke's per-doc call).

Each result is checked against the plain version first.  For each cell
one JSON line: events ms
and device ms (``torch.profiler``) with the L2 cache flushed before every
call by a 64 MB write (the flush's own kernel left out of the device
ms), as the planner finds its columns fresh from a host copy; the same
two back to back (``ms_warm``, ``device_ms_warm``); ``graph_ms`` (50
calls replayed from a CUDA graph); one call's host µs, split as
``chip_smoke.host_split`` splits it; the wrapper's launches and the
kernels by name over one call; the byte bound.  Every line carries the
card's name and power limit.  Compare checkouts in turns (A, B, B, A) in
one call: the host's speed and the card's clocks change between machines.
"""

from __future__ import annotations

import argparse
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
N_DOCS = 1024
CELLS = ("smoke", "seeded_2^16", "seeded_2^20", "seeded_2^22",
         "chained_2^20", "unchained_2^20", "doc_64")


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture_inputs(cs, K, path: Path) -> None:
    """The smoke planner path's flush-1 chunk scan input, built on the
    host from 1024 Python mirrors' phase-A queries and saved to
    ``path`` as padded int64 numpy columns (doc column last)."""
    from yjs_tpu_torch.ops import segment_planner as sp
    from yjs_tpu_torch.ops.columns import DocMirror

    traces = cs.load_traces()[:N_DOCS]
    qs = []
    for trace in traces:
        mirror = DocMirror("text", device="cpu")
        mirror.ingest(trace, False)
        q = mirror.prepare_step_begin().queries
        if q is not None and q.n >= sp.MIN_RUN:
            qs.append(q)
    ns = np.array([q.n for q in qs], np.int64)
    doc_id = np.repeat(np.arange(len(qs), dtype=np.int64), ns)
    cols = [np.concatenate([getattr(q, name) for q in qs])
            for name in ("client", "clock", "length", "o_cl", "o_ck",
                         "r_cl", "r_ck")]
    nb = K._bucket_pow2(int(ns.sum()))
    padded = [K._pad_pow2(c, nb, f) for c, f in zip(cols, K._SCAN_FILLS)]
    padded.append(K._pad_pow2(doc_id, nb, -1))
    with open(path, "wb") as f:
        np.savez(f, *padded)


def seeded(seed: int, n: int, kind: str = "seeded"):
    """Seeded chunk columns of ``n`` lanes (int64 numpy, doc column
    last): about one doc a 300 refs, origins often inside, at the edges
    of or just past the lane before's id range; ``chained``: every lane's
    origin inside the lane before's range, one doc; ``unchained``: no
    origins."""
    g = np.random.default_rng(seed)
    length = g.integers(1, 5, n)
    clock = np.cumsum(length + g.integers(0, 2, n)) - length
    if kind == "seeded":
        client = g.integers(0, 4, n)
        prev_ck, prev_len = np.roll(clock, 1), np.roll(length, 1)

        def anchor(p_same):
            same = g.random(n) < p_same
            cl = np.where(same, np.roll(client, 1), g.integers(-1, 4, n))
            ck = prev_ck + (g.random(n) * (prev_len + 2)).astype(np.int64) - 1
            return cl, ck

        o_cl, o_ck = anchor(0.7)
        r_cl, r_ck = anchor(0.4)
        doc = np.sort(g.integers(0, max(1, n // 300), n))
    else:
        client = np.full(n, 3)
        o_cl = client if kind == "chained" else np.full(n, -1)
        o_ck = np.roll(clock + length - 1, 1)
        r_cl, r_ck = np.full(n, -1), np.zeros(n, np.int64)
        doc = np.zeros(n, np.int64)
    return [np.asarray(c, np.int64) for c in
            (client, clock, length, o_cl, o_ck, r_cl, r_ck, doc)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_conflict_scan_ab: needs a CUDA card", file=sys.stderr)
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
    inputs = Path(args.inputs)
    if not inputs.exists():
        capture_inputs(cs, K, inputs)
    with np.load(inputs) as z:
        smoke = [z[f"arr_{i}"] for i in range(8)]
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

    wanted = args.cells.split(",")
    for cell in wanted:
        if cell == "smoke":
            host = smoke
        elif cell == "doc_64":
            host = [c[:64] for c in smoke[:7]]
        else:
            kind, size = cell.split("_")
            n = 1 << int(size.removeprefix("2^"))
            host = seeded(n + len(kind), n, kind)
        ts = [torch.from_numpy(c).to(dev) for c in host]
        cols, doc = ts[:7], (ts[7] if len(ts) > 7 else None)
        ref = K.conflict_scan_plain(*cols, doc)
        n = cols[0].numel()
        nbytes = sum(t.nbytes for t in ts) + sum(t.nbytes for t in ref)
        got = K.conflict_scan(*cols, doc)
        if not all(torch.equal(r, g) for r, g in zip(ref, got)):
            raise SystemExit(f"conflict_scan {cell} differs from its plain "
                             "version")

        def fn():
            return K.conflict_scan(*cols, doc)

        rec = {
            "label": label, "card": smi, "cell": cell,
            "name": "conflict_scan" if doc is None else "conflict_scan_chunk",
            "lanes": n,
            "launches_a_call": cs.launches_a_call(K, fn),
            "kernels_a_call": cs.kernels_a_call(fn),
            "ms": flushed_ms(fn), "device_ms": flushed_device_ms(fn),
            "ms_warm": cs.cuda_ms(fn), "device_ms_warm": cs.device_ms(fn),
            "graph_ms": cs.graph_ms(fn), "host_us": cs.host_split(fn),
            "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
        }
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        del ts, cols, doc, ref, got
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("YTPU_PLAN_SEGMENT", "device")
    sys.exit(main())
