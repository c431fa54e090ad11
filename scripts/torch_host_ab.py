#!/usr/bin/env python3
"""Host cost of the port's fold, sharded lookup (K13) and anchor lookup (K11),
for comparing two checkouts on one card.

    python3 scripts/torch_host_ab.py --root PATH [--label NAME]

Imports ``yjs_tpu_torch`` from the checkout at ``PATH`` (its kernels build
into that checkout) and the timing helpers of this checkout's
``chip_smoke.py``; needs a CUDA card.  Inputs are made from a seed at the
smoke's shapes: the fold is the MAX of two ``[2048, 4]`` int32 partials,
K11 searches 2**16 queries in a 2**21-key int64 haystack (1.5M sorted keys,
the rest int64.max padding; queries at keys, one past them, or -1), K13
the same queries split over four shards of the card.  For each kernel it
prints one JSON line: events ms (50 calls), the same with the profiler off,
device ms (``torch.profiler``), the library call's ms and one call's host
µs split (``chip_smoke.host_split``, 1000 calls), with the card's name and
power limit.  To compare A and B, run it in turns (A, B, B, A) on one
machine, one right after the other: the host's speed and the card's
clocks change from one machine, and one hour, to the next.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_host_ab: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    # this checkout's timing helpers, whichever checkout is measured
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from yjs_tpu_torch.ops import _cuda
    from yjs_tpu_torch.ops import kernels as K

    if not Path(K.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {K.__file__}, not from {root}")
    _cuda.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    g = np.random.default_rng(6)
    dev = torch.device("cuda", 0)
    n_real = 1_500_000
    hay = np.sort(g.choice(2**40, n_real, replace=False)).astype(np.int64)
    hay = np.concatenate(
        [hay, np.full((1 << 21) - n_real, np.iinfo(np.int64).max)])
    q = hay[g.integers(0, n_real, 1 << 16)] + g.integers(0, 2, 1 << 16)
    q[g.random(1 << 16) < 0.1] = -1
    flat = torch.from_numpy(hay).to(dev)
    qt = torch.from_numpy(q).to(dev)
    hays, qs = [flat] * 4, list(qt.chunk(4))
    parts = [torch.from_numpy(g.integers(0, 2**31, (2048, 4)).astype(np.int32))
             .to(dev) for _ in range(2)]
    want = torch.searchsorted(flat, qt, right=True) - 1

    cases = {
        "shard_fold": (lambda: K.shard_fold(parts, "max"),
                       lambda: torch.maximum(*parts),
                       torch.equal(K.shard_fold(parts, "max"),
                                   torch.maximum(*parts))),
        "sharded_lookup": (lambda: K.sharded_anchor_lookup(hays, qs),
                           lambda: [torch.searchsorted(flat, p, right=True) - 1
                                    for p in qs],
                           torch.equal(torch.cat(
                               K.sharded_anchor_lookup(hays, qs)), want)),
        "anchor_lookup": (lambda: K.anchor_lookup(flat, qt),
                          lambda: torch.searchsorted(flat, qt, right=True) - 1,
                          torch.equal(K.anchor_lookup(flat, qt), want)),
    }
    label = args.label or str(root)
    for name, (call, library, ok) in cases.items():
        if not ok:
            raise SystemExit(f"{name} differs from its library call")
        print(json.dumps({
            "label": label, "name": name, "card": smi,
            "ms": cs.cuda_ms(call),
            "ms_obs_off": cs.obs_off(lambda: cs.cuda_ms(call)),
            "device_ms": cs.device_ms(call),
            "library_ms": cs.cuda_ms(library),
            "host_us": cs.host_split(call),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
