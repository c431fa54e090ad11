#!/usr/bin/env python3
"""The bulk apply (K1, and K14 on four shards) and the whole-row copy
(K2) of one checkout, for comparing checkouts on one card.

    python3 scripts/torch_apply_rows_ab.py --root PATH --inputs FILE
        [--label NAME] [--kernels K1,K14,K2] [--out FILE]

Imports ``yjs_tpu_torch`` from the checkout at ``PATH`` (its kernels build
into that checkout), and the timing helpers of this checkout's
``chip_smoke.py``; needs a CUDA card.

Inputs: the smoke's own.  When ``--inputs`` does not exist yet, a
``BatchEngine(4096)`` of this checkout runs the smoke's main path on the
card (flush 1 of the fixture's traces, flush 2 of the seeded editors'
edits after compaction) and keeps the largest ``apply_lanes`` and
``scatter_rows`` inputs, with the tables as they were before the call,
in that file; later runs read it, so every checkout sees the same bytes.
The cells:

- K1 at the smoke's input (B = 4096), at its first 1024 docs and at
  its 4096 docs four times over (B = 16384);
- K14: the smoke's input as four shards of 1024 docs on the card, each
  shard's sections padded to the widths all four share, with counters;
- K2 at the smoke's compaction shapes, and on seeded random rows
  (``rows_case``) of the same B, k and S+1 at N+1 = 1025, 1028, 4097
  and 4100 (rows unaligned and aligned).

For each cell one JSON line: events ms and device ms (``torch.profiler``)
with the L2 cache flushed before every call by a 64 MB write, as the
real caller finds its lanes and rows fresh from a host copy (the flush's
own kernel left out of the device ms); the same two back to back without
the flush (``ms_warm``, ``device_ms_warm``, as ``chip_smoke.py`` times
them); one call's host µs, split as ``chip_smoke.host_split`` splits
it; the wrappers' launches over one call; each result checked against
the plain version first.  Every line carries the card's
name and power limit.  Compare checkouts in turns (A, B, B, A) in one
call: the host's speed and the card's clocks change between machines.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
N_CALLS = 50
FLUSH_BYTES = 64 << 20
K2_WIDTHS = (1025, 1028, 4097, 4100)
N_SHARDS = 4


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture_inputs(cs, K, path: Path) -> None:
    """The smoke's main path on the card (no twin): the largest K1 and K2
    inputs it gives, saved to ``path``."""
    import yjs_tpu_torch as Y
    from yjs_tpu_torch.ops import BatchEngine

    traces = cs.load_traces()
    edits = cs.seeded_edits(Y, traces)
    eng = BatchEngine(cs.N_DOCS, device="cuda")
    with cs.Capture(K, cs.MAIN_KERNELS[:2]) as cap:
        for i in range(cs.N_DOCS):
            eng.queue_update(i, traces[i % len(traces)])
        eng.flush()
        for t, ups in edits.items():
            for i in range(t, cs.N_DOCS, len(traces)):
                for u in ups:
                    eng.queue_update(i, u)
        eng.flush()
    torch.cuda.synchronize()
    if set(cap.seen) != {"apply_lanes", "scatter_rows"}:
        raise SystemExit(f"the main path gave {sorted(cap.seen)}")
    torch.save({k: cs._clone(v) for k, v in cap.seen.items()}, path)


def pick_docs(lanes: torch.Tensor, b: int, widths, docs: torch.Tensor):
    """The lanes of docs ``docs`` (indices into the ``b`` docs of
    ``lanes``, repeats allowed), in that order, each section exactly as
    wide as its lanes; returns ``(lanes, widths)``."""
    v = lanes.long()
    cnt = v[: 4 * b].view(4, b)
    k_dn, k_sp, k_h, k_d = widths
    o = 4 * b
    # a section's entries: (count row, [its lane arrays])
    secs = []
    for row, (w, per) in enumerate(((k_dn, 1), (k_sp, 2), (k_h, 2),
                                    (k_d, 1))):
        secs.append((row, [v[o + j * w : o + (j + 1) * w]
                           for j in range(per)]))
        o += per * w
    parts, out_w = [cnt[:, docs].reshape(-1)], []
    for row, arrays in secs:
        c = cnt[row]
        start = torch.cumsum(c, 0) - c
        take = c[docs]
        total = int(take.sum())
        first = torch.repeat_interleave(start[docs], take)
        within = torch.arange(total, device=v.device) - torch.repeat_interleave(
            torch.cumsum(take, 0) - take, take)
        idx = first + within
        parts.extend(a[idx] for a in arrays)
        out_w.append(total)
    return torch.cat(parts).to(lanes.dtype), tuple(out_w)


def pad_sections(lanes: torch.Tensor, b: int, widths, to, n1: int, s1: int):
    """``lanes`` of ``widths`` with each section padded to ``to`` by the
    packer's fills (dense NULL, sparse rows N+1, heads S+1, deletes
    N+1)."""
    fills = ((-1,), (n1, -1), (s1, -1), (n1,))
    out, o = [lanes[: 4 * b]], 4 * b
    for w, wide, fs in zip(widths, to, fills):
        for f in fs:
            sec = torch.full((wide,), f, dtype=lanes.dtype,
                             device=lanes.device)
            sec[:w] = lanes[o : o + w]
            out.append(sec)
            o += w
    return torch.cat(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernels", default="K1,K14,K2")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    wanted = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("torch_apply_rows_ab: needs a CUDA card", file=sys.stderr)
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
    seen = torch.load(inputs, map_location=dev)
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

    def emit(rec, fn):
        rec.update(
            launches_a_call=cs.launches_a_call(K, fn),
            ms=flushed_ms(fn), device_ms=flushed_device_ms(fn),
            ms_warm=cs.cuda_ms(fn), device_ms_warm=cs.device_ms(fn),
            host_us=cs.host_split(fn))
        line = json.dumps({"label": label, "card": smi, **rec})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def same(a, b, what):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise SystemExit(f"{what} differs from its plain version")

    tables, lanes, *widths = seen["apply_lanes"]
    if "K1" in wanted:
        k1_cells(K, emit, same, tables, lanes, tuple(widths), dev)
    if "K14" in wanted:
        k14_cell(K, emit, same, tables, lanes, tuple(widths), dev)
    if "K2" in wanted:
        k2_cells(K, emit, same, seen["scatter_rows"], dev)
    if sink:
        sink.close()
    return 0


def k1_cells(K, emit, same, tables, lanes, widths, dev) -> None:
    """K1 at the smoke's input, its first 1024 docs, and four times over."""
    b, n1 = tables[0].shape
    s1 = tables[2].shape[1]
    cells = [("smoke", tables, lanes, widths)]
    for name, docs in (("B=1024", torch.arange(1024, device=dev)),
                       ("B=16384", torch.arange(b, device=dev).repeat(4))):
        ln, wd = pick_docs(lanes, b, widths, docs)
        cells.append((name, tuple(t[docs].contiguous() for t in tables), ln,
                      wd))
    for cell, tabs, ln, wd in cells:
        got = K.apply_lanes(tuple(t.clone() for t in tabs), ln, *wd)
        same(got, K.apply_lanes_plain(tuple(t.clone() for t in tabs), ln,
                                      *wd), f"apply_lanes {cell}")
        base = tuple(t.clone() for t in tabs)
        emit({"name": "apply_lanes", "cell": cell,
              "shape": f"B={tabs[0].shape[0]} N+1={n1} S+1={s1} "
                       f"lanes={ln.numel()} {ln.dtype} widths={list(wd)}"},
             lambda base=base, ln=ln, wd=wd: K.apply_lanes(base, ln, *wd))


def k14_cell(K, emit, same, tables, lanes, widths, dev) -> None:
    """K14: four shards of the smoke's docs on the card, widths shared."""
    b, n1 = tables[0].shape
    s1 = tables[2].shape[1]
    per = b // N_SHARDS
    parts = [pick_docs(lanes, b, widths,
                       torch.arange(s * per, (s + 1) * per, device=dev))
             for s in range(N_SHARDS)]
    shared = tuple(max(p[1][j] for p in parts) for j in range(4))
    rows = [pad_sections(ln, per, wd, shared, n1, s1) for ln, wd in parts]
    shard_tabs = [tuple(t[s * per : (s + 1) * per].clone() for t in tables)
                  for s in range(N_SHARDS)]
    got = [tuple(t.clone() for t in tabs) for tabs in shard_tabs]
    ref = [tuple(t.clone() for t in tabs) for tabs in shard_tabs]
    gc = list(torch.zeros((N_SHARDS, 2), dtype=torch.int32, device=dev))
    rc = list(torch.zeros((N_SHARDS, 2), dtype=torch.int32, device=dev))
    K.sharded_apply_lanes(got, rows, shared, gc)
    for s in range(N_SHARDS):
        K.apply_lanes_plain(ref[s], rows[s], *shared, counter=rc[s])
    same([t for g in got for t in g] + gc, [t for r in ref for t in r] + rc,
         "sharded_apply_plan")
    counters = list(torch.zeros((N_SHARDS, 2), dtype=torch.int32, device=dev))
    emit({"name": "sharded_apply_plan", "cell": f"{N_SHARDS} shards",
          "shape": f"B_loc={per} N+1={n1} S+1={s1} "
                   f"lanes={rows[0].numel()} {rows[0].dtype} "
                   f"widths={list(shared)}"},
         lambda: K.sharded_apply_lanes(got, rows, shared, counters))


def rows_case(seed: int, b: int, n1: int, s1: int, k: int, dev):
    """Seeded K2 inputs on ``dev``: random tables of ``b`` docs, ``k``
    distinct docs in order and their new rows."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def ints(*shape):
        return torch.randint(-1, n1 - 1, shape, generator=g,
                             dtype=torch.int32).to(dev)

    def flags(*shape):
        return (torch.rand(shape, generator=g) < 0.5).to(dev)

    idx = torch.randperm(b, generator=g)[:k].sort().values.to(torch.int32)
    return ([ints(b, n1), flags(b, n1), ints(b, s1)],
            (idx.to(dev), ints(k, n1), flags(k, n1), ints(k, s1)))


def k2_cells(K, emit, same, seen_k2, dev) -> None:
    """K2 at the compaction's shapes, then seeded rows at other widths."""
    *tables, idx, new_right, new_deleted, new_starts = seen_k2
    b, n1 = tables[0].shape
    s1 = tables[2].shape[1]
    k = idx.numel()
    cells = [("smoke", tables, (idx, new_right, new_deleted, new_starts))]
    for width in K2_WIDTHS:
        cells.append((f"N+1={width}",
                      *rows_case(100 + width, b, width, s1, k, dev)))
    for cell, tabs, new in cells:
        got = K.scatter_rows(*(t.clone() for t in tabs), *new)
        same(got, K.scatter_rows_plain(*(t.clone() for t in tabs), *new),
             f"scatter_rows {cell}")
        base = [t.clone() for t in tabs]
        emit({"name": "scatter_rows", "cell": cell,
              "shape": f"k={k} B={b} N+1={tabs[0].shape[1]} S+1={s1}"},
             lambda base=base, new=new: K.scatter_rows(*base, *new))


if __name__ == "__main__":
    sys.exit(main())
