#!/usr/bin/env python3
"""The export ranks (K8) and the state vectors, unsharded (K9) and
sharded (K16), of one checkout, for comparing checkouts on one card.

    python3 scripts/torch_export_sv_ab.py --root PATH [--label NAME]
        [--n1 2049,4097,8193,16385] [--out FILE]

Imports ``yjs_tpu_torch`` from the checkout at ``PATH`` (its kernels build
into that checkout), and the timing helpers of this checkout's
``chip_smoke.py`` and the seeded sync case (``sync_case``) of its
``tests/test_torch_cuda.py``; needs a CUDA card.

- K8: the smoke's export input, one doc's right links and membership as
  ``BatchEngine._order`` hands them to ``list_ranks`` (the fixture's first
  trace flushed by ``BatchEngine(1)`` on the card, exported from the
  device tables), widened to each ``--n1`` (N+1) with NULL links and
  rows that are not members, so the list and the rounds it needs stay
  the same and only the row grows.
- K9 and K16: the smoke's sync columns' shape (B = 4096, N = 1102, 4
  slots, from ``sync_case``), K9 in one batch on the card, K16 on meshes
  whose shards share the card: 1-D of 4 and 16 shards, 2 x 2 and 8 x 2
  ("docs", "rows"), each from placed blocks (``state_vector_blocks``) and
  from host arrays.

One JSON line a kernel and input: events ms (``cuda_ms``: 50 calls back
to back), device ms (``torch.profiler``), host µs a call (the calls only
enqueue), the launches one call makes and, for K8, the variant and
rounds where the checkout reports them and an empty kernel's events and
device ms where it has one; each result is checked against the plain
version.  Every line carries the card's name and power limit.  Compare
checkouts in turns (A, B, B, A) in one call: the host's speed and the
card's clocks change from one machine to the next.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
SV_SHAPE = (4096, 1102, 4)  # the smoke's sync columns: B, N, slots
MESHES = (("1-D x4", (4,)), ("2x2", (2, 2)), ("1-D x16", (16,)),
          ("8x2", (8, 2)))


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def export_input(cs, K, dev):
    """The ``(right_link, valid)`` one device export hands to K8."""
    import yjs_tpu_torch as Y
    from yjs_tpu_torch.ops import BatchEngine

    trace = cs.load_traces()[0]
    os.environ["YTPU_EXPORT_DEVICE"] = "1"
    eng = BatchEngine(1, device=dev)
    eng.queue_update(0, trace)
    eng.flush()
    seen = []
    orig = K.list_ranks

    def keep(right, valid, *rest):
        seen.append((right.clone(), valid.clone()))
        return orig(right, valid, *rest)

    K.list_ranks = keep
    try:
        text = eng.text(0)
    finally:
        K.list_ranks = orig
    doc = Y.Doc(gc=False)
    Y.apply_update(doc, trace)
    if text != doc.get_text("text").to_string():
        raise SystemExit("the device export differs from the CPU Doc")
    return max(seen, key=lambda a: int(a[1].sum()))


def widen(right, valid, n1: int):
    b, w = right.shape
    if n1 < w:
        raise SystemExit(f"--n1 {n1} is below the export's width {w}")
    r = torch.full((b, n1), -1, dtype=right.dtype, device=right.device)
    v = torch.zeros((b, n1), dtype=valid.dtype, device=valid.device)
    r[:, :w] = right
    v[:, :w] = valid
    return r, v


def grew(K, call) -> dict:
    before = dict(K.launches)
    call()
    torch.cuda.synchronize()
    return {k: v - before.get(k, 0) for k, v in K.launches.items()
            if v != before.get(k, 0)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--n1", default="2049,4097,8193,16385")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_export_sv_ab: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = load("chip_smoke_helpers", HERE / "chip_smoke.py")
    tc = load("torch_cuda_cases", HERE / "tests" / "test_torch_cuda.py")
    from yjs_tpu_torch.ops import _cuda
    from yjs_tpu_torch.ops import kernels as K
    from yjs_tpu_torch.parallel import DocMesh
    from yjs_tpu_torch.parallel import mesh as pm

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

    def emit(rec):
        line = json.dumps({"label": label, "card": smi, **rec})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    # K8 at the export's input, widened
    right0, valid0 = export_input(cs, K, dev)
    empty = getattr(_cuda, "empty_launch", None)
    if empty is not None:
        emit({"name": "empty_launch", "ms": cs.cuda_ms(lambda: empty(dev)),
              "device_ms": cs.device_ms(lambda: empty(dev)),
              "host_us": cs.host_us(lambda: empty(dev))})
    counted = "counter" in inspect.signature(K.list_ranks).parameters
    for n1 in (int(x) for x in args.n1.split(",")):
        right, valid = widen(right0, valid0, n1)
        ref = K.list_ranks_plain(right, valid)
        if not torch.equal(K.list_ranks(right, valid), ref):
            raise SystemExit(f"list_ranks at N+1={n1} differs from plain")
        rec = {"name": "list_ranks", "n1": n1,
               "members": int(valid.sum()),
               "launches_a_call": grew(K, lambda: K.list_ranks(right, valid)),
               "ms": cs.cuda_ms(lambda: K.list_ranks(right, valid)),
               "device_ms": cs.device_ms(lambda: K.list_ranks(right, valid)),
               "host_us": cs.host_us(lambda: K.list_ranks(right, valid))}
        if counted:
            ran = torch.zeros(1, dtype=torch.int32, device=dev)
            K.list_ranks(right, valid, ran)
            rec["rounds"] = int(ran.item())
            rec["variant"] = K.last_variant.get("list_ranks")
        emit(rec)

    # K16 on meshes of the card, placed blocks and host arrays
    b, n, n_slots = SV_SHAPE
    row_slot, _clock, row_end, _sv = tc.sync_case(61, b, n, n_slots)
    want = K.state_vector_kernel_plain(
        torch.from_numpy(row_slot).to(dev), torch.from_numpy(row_end).to(dev),
        n_slots)
    # K9, the unsharded call, on the same columns in one batch
    slot_d = torch.from_numpy(row_slot).to(dev)
    end_d = torch.from_numpy(row_end).to(dev)
    if not torch.equal(K.state_vector_kernel(slot_d, end_d, n_slots), want):
        raise SystemExit("K9 differs from plain")
    emit({"name": "state_vector", "shards": 1,
          "launches_a_call": grew(
              K, lambda: K.state_vector_kernel(slot_d, end_d, n_slots)),
          "ms": cs.cuda_ms(lambda: K.state_vector_kernel(slot_d, end_d,
                                                        n_slots)),
          "device_ms": cs.device_ms(
              lambda: K.state_vector_kernel(slot_d, end_d, n_slots)),
          "host_us": cs.host_us(lambda: K.state_vector_kernel(slot_d, end_d,
                                                             n_slots))})
    for name, shape in MESHES:
        axes = ("docs",) if len(shape) == 1 else ("docs", "rows")
        row_axis = axes[1] if len(axes) == 2 else None
        mesh = DocMesh(np.full(shape, dev, dtype=object), axes)
        fn = pm.sharded_state_vectors(mesh, n_slots, "docs", row_axis)
        placed = (pm.state_vector_blocks(mesh, row_slot, "docs", row_axis),
                  pm.state_vector_blocks(mesh, row_end, "docs", row_axis))
        for mode, inputs in (("placed", placed),
                             ("host arrays", (row_slot, row_end))):
            if not torch.equal(fn(*inputs), want):
                raise SystemExit(f"K16 on {name} ({mode}) differs from plain")
            emit({"name": "sharded_state_vectors", "mesh": name,
                  "shards": int(np.prod(shape)), "input": mode,
                  "launches_a_call": grew(K, lambda: fn(*inputs)),
                  "ms": cs.cuda_ms(lambda: fn(*inputs)),
                  "device_ms": cs.device_ms(lambda: fn(*inputs)),
                  "host_us": cs.host_us(lambda: fn(*inputs))})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
