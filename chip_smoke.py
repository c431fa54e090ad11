#!/usr/bin/env python3
"""Drive the PyTorch port's apply-lane flush on one CUDA card and check it.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with an NVIDIA card
(sm_90a: H100/H200).  It imports nothing of JAX or of the JAX package.
Phases, each printed on its own lines; any failed check raises and the
script exits non-zero:

1. device: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: the native plan core (g++) and the three CUDA kernels (one
   nvcc per source, all at once), with build seconds and each kernel's
   registers and spills;
3. main path: a room server's fleet, ``BatchEngine(n_docs=4096)`` on the
   card beside a CPU twin ``BatchEngine(4096, device="cpu")`` that runs
   the kernels' plain versions on the same bytes:
   - flush 1 gives every doc one of the fixture's 1024 distinct 1500-op
     traces, cycled (dense apply lanes);
   - flush 2 sends a seeded editor's edits of 64 traces to every doc
     holding them (sparse and delete lanes), after compacting every doc
     of at least 512 rows (scatter_rows);
   - 16 docs go through export_doc_columns / reset_doc /
     hydrate_doc_columns (scatter_rows);
   - 32 sampled docs export text() and encode_state_as_update() from the
     device tables (list_ranks), checked against a CPU ``Doc`` fed the
     same bytes;
   after each step the card's three tables must equal the twin's;
4. kernels: each kernel against its plain version on the card at the
   main path's shapes (exact), with times from CUDA events (``ms``: per
   call, launch gaps included), device time from ``torch.profiler``
   (``device_ms``) and the byte bound, printed as one
   ``{"kernels": [...]}`` line;
5. the last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import random
import struct
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "distinct_traces_1500.bin.z"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
N_DOCS = 4096  # the README's TpuProvider(n_docs=4096) fleet
N_EDITED = 64
N_HYDRATED = 16
N_EXPORTED = 32
TIMED_LAUNCHES = 50


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def load_traces() -> list[bytes]:
    """The fixture's distinct traces: ``<II`` count and ops, then
    ``<I``-length-prefixed updates (one per trace)."""
    raw = zlib.decompress(FIXTURE.read_bytes())
    count, n_ops = struct.unpack_from("<II", raw, 0)
    check(n_ops == 1500, f"fixture holds {n_ops}-op traces")
    out, o = [], 8
    for _ in range(count):
        (ln,) = struct.unpack_from("<I", raw, o)
        out.append(raw[o + 4 : o + 4 + ln])
        o += 4 + ln
    return out


def editor_edits(Y, trace: bytes, seed: int) -> list[bytes]:
    """A few incremental edits by a seeded editor holding ``trace``."""
    gen = random.Random(seed)
    doc = Y.Doc(gc=False)
    doc.client_id = 70000 + seed
    Y.apply_update(doc, trace)
    text = doc.get_text("text")
    out = []
    for _ in range(4):
        sv = Y.encode_state_vector(doc)
        if len(text) > 8 and gen.random() < 0.5:
            text.delete(gen.randrange(len(text) - 4), gen.randint(1, 3))
        else:
            text.insert(gen.randrange(len(text) + 1), gen.choice(["ab", "xyz "]))
        out.append(Y.encode_state_as_update(doc, sv))
    return out


# -- phase 1 and 2 ----------------------------------------------------------------


def device_phase() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}")
    log(smi)
    return {"name": name, "count": count, "smi": smi}


def build_phase() -> None:
    from yjs_tpu_torch import native
    from yjs_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        plan = pool.submit(native.load)
        kernels = pool.submit(_cuda.build_all)
        info = kernels.result()
        lib = plan.result()
    check(lib is not None and native.has_plancore(), "native plan core built")
    log(f"[build] wall {time.perf_counter() - t0:.2f}s; "
        f"g++ plan core {native.build_seconds:.2f}s")
    for name, rec in info.items():
        log(f"[build] nvcc {name}.cu {rec['seconds']:.2f}s")
        for line in _cuda.ptxas_summary(rec["ptxas"]):
            log(f"[build]   {line}")


# -- phase 3 ----------------------------------------------------------------------


class Capture:
    """Keeps the largest input each kernel wrapper saw on the main path
    (for phase 4), delegating every call to the wrapper itself."""

    def __init__(self, kernels, device_type: str = "cuda"):
        self.kernels = kernels
        self.device_type = device_type
        self.seen: dict = {}
        self._orig = {}

    def __enter__(self):
        k = self.kernels
        for name, size in (
            ("apply_lanes", lambda a: a[1].numel()),
            ("scatter_rows", lambda a: a[4].numel()),
            ("list_ranks", lambda a: a[0].numel()),
        ):
            orig = getattr(k, name)
            self._orig[name] = orig

            def wrapped(*args, _orig=orig, _name=name, _size=size):
                best = self.seen.get(_name)
                # the CPU twin's calls are not kept
                if args[1].device.type == self.device_type:
                    if best is None or _size(args) > _size(best):
                        self.seen[_name] = tuple(
                            tuple(t.clone() for t in a)
                            if isinstance(a, tuple)
                            else (a.clone() if isinstance(a, torch.Tensor) else a)
                            for a in args
                        )
                return _orig(*args)

            setattr(k, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.kernels, name, orig)
        return False


def assert_twins(eng, twin, what: str) -> None:
    for name in ("_right", "_deleted", "_starts"):
        a, b = getattr(eng, name), getattr(twin, name)
        check(a.shape == b.shape, f"{what}: {name} shape {a.shape} vs {b.shape}")
        check(torch.equal(a.cpu(), b), f"{what}: {name} differs from the CPU twin")
    log(f"[main] {what}: device tables equal the CPU twin "
        f"({tuple(eng._right.shape)} right, {tuple(eng._starts.shape)} starts)")


def timed_flush(eng) -> float:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    eng.flush()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return time.perf_counter() - t0


def warm_up(trace: bytes) -> None:
    """One small flush and export on the card before the timed path:
    CUDA context, module loads and allocator pools are set-up, not
    flush time."""
    from yjs_tpu_torch.ops import BatchEngine

    eng = BatchEngine(2, device="cuda")
    eng.queue_update(0, trace)
    eng.flush()
    eng.text(0)
    torch.cuda.synchronize()


def main_path(device: str, n_docs: int, traces: list[bytes]) -> dict:
    """Drive the engine on ``device`` beside a CPU twin; returns the
    figures.  Exports read the device tables (YTPU_EXPORT_DEVICE=1)."""
    import yjs_tpu_torch as Y
    from yjs_tpu_torch.ops import BatchEngine

    os.environ["YTPU_EXPORT_DEVICE"] = "1"
    eng = BatchEngine(n_docs, device=device)
    twin = BatchEngine(n_docs, device="cpu")
    held = [traces[i % len(traces)] for i in range(n_docs)]
    log_of = {i: [held[i]] for i in range(n_docs)}

    # flush 1: one distinct trace per doc (dense lanes)
    for e in (eng, twin):
        for i in range(n_docs):
            e.queue_update(i, held[i])
    t1 = timed_flush(eng)
    twin.flush()
    m1 = dict(eng.last_flush_metrics)
    elements = sum(sum(eng.state_vector(i).values()) for i in range(n_docs))
    assert_twins(eng, twin, "flush 1")

    # flush 2: edits of N_EDITED traces to every doc holding them, after
    # compaction of every doc of at least 512 rows
    for t in range(min(N_EDITED, len(traces))):
        edits = editor_edits(Y, traces[t], t)
        for i in range(t, n_docs, len(traces)):
            for u in edits:
                eng.queue_update(i, u)
                twin.queue_update(i, u)
            log_of[i].extend(edits)
    t2 = timed_flush(eng)
    twin.flush()
    m2 = dict(eng.last_flush_metrics)
    n_compacted = len(eng.last_compaction or [])
    check(n_compacted > 0, "flush 2 compacted no doc")
    check(twin.last_compaction == eng.last_compaction, "compaction stats differ")
    assert_twins(eng, twin, "flush 2")

    # warm-tier round trip (deferred scatter_rows on the next read-back)
    gen = random.Random(1)
    hydrated = sorted(gen.sample(range(n_docs), min(N_HYDRATED, n_docs)))
    for e in (eng, twin):
        for i in hydrated:
            mirror = e.export_doc_columns(i)
            e.reset_doc(i)
            e.hydrate_doc_columns(i, mirror)

    # exports from the device tables, held against the CPU core: every
    # hydrated doc plus others drawn at random
    others = [i for i in range(n_docs) if i not in set(hydrated)]
    sample = sorted(hydrated + gen.sample(
        others, min(len(others), N_EXPORTED - len(hydrated))
    ))
    for i in sample:
        doc = Y.Doc(gc=False)
        for u in log_of[i]:
            Y.apply_update(doc, u)
        want = doc.get_text("text").to_string()
        check(eng.text(i) == want, f"doc {i}: device text differs from the CPU Doc")
        state = Y.merge_updates([eng.encode_state_as_update(i)])
        check(state == Y.merge_updates([Y.encode_state_as_update(doc)]),
              f"doc {i}: encoded state differs from the CPU Doc")
        check(twin.text(i) == want, f"doc {i}: twin text differs")
    if device == "cuda":
        torch.cuda.synchronize()
    assert_twins(eng, twin, "after hydration and export")
    log(f"[main] {len(sample)} sampled docs: texts and encoded states equal "
        f"the CPU Doc ({len(hydrated)} hydrated)")

    table_bytes = int(eng._right.nbytes + eng._deleted.nbytes + eng._starts.nbytes)
    return {
        "t_flush1_s": t1, "t_flush2_s": t2, "elements": elements,
        "flush1": m1, "flush2": m2, "n_compacted": n_compacted,
        "table_bytes": table_bytes,
    }


# -- phase 4 ----------------------------------------------------------------------


def cuda_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Mean ms of ``fn()`` over ``n`` calls, from CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = TIMED_LAUNCHES):
    """Mean device time per call of ``fn()``'s kernels, from
    ``torch.profiler`` (None when the profiler records no device time):
    set beside :func:`cuda_ms`, it separates kernel time from launch
    gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    )
    return us / 1e3 / n if us > 0 else None


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.long() - b.long()).abs().max().item()) if a.numel() else 0.0


def apply_lanes_bytes(lanes: torch.Tensor, b: int, widths, n1: int, s1: int) -> int:
    """Lanes read once plus one element written per in-bounds target."""
    k_dn, k_sp, k_h, k_d = widths
    v = lanes.long().cpu().numpy()
    cnt = v[: 4 * b].reshape(4, b).sum(axis=1)
    o = 4 * b
    n_dense = int(cnt[0])
    sp = v[o + k_dn : o + k_dn + int(cnt[1])]
    o2 = o + k_dn + 2 * k_sp
    hd = v[o2 : o2 + int(cnt[2])]
    o3 = o2 + 2 * k_h
    dl = v[o3 : o3 + int(cnt[3])]

    def inb(x, n):
        x = np.where(x < 0, x + n, x)
        return int(((x >= 0) & (x < n)).sum())

    return (lanes.nbytes + 4 * (n_dense + inb(sp, n1) + inb(hd, s1))
            + inb(dl, n1))


def kernel_phase(seen: dict, launches: dict) -> list[dict]:
    """Each kernel against its plain version on the largest input the
    main path gave it (tables as they were before that call)."""
    from yjs_tpu_torch.ops import kernels as K

    rows = []
    saved = dict(K.launches)

    # apply_lanes at flush 1's shapes
    tables, lanes, *widths = seen["apply_lanes"]
    b, n1 = tables[0].shape
    s1 = tables[2].shape[1]

    def fresh():
        return tuple(t.clone() for t in tables)

    got = K.apply_lanes(fresh(), lanes, *widths)
    ref = K.apply_lanes_plain(fresh(), lanes, *widths)
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    base = fresh()
    ms = cuda_ms(lambda: K.apply_lanes(base, lanes, *widths))
    dev_ms = device_ms(lambda: K.apply_lanes(base, lanes, *widths))
    plain_ms = cuda_ms(lambda: K.apply_lanes_plain(base, lanes, *widths))
    nbytes = apply_lanes_bytes(lanes, b, widths, n1, s1)
    rows.append({
        "name": "apply_lanes", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/apply_lanes.cu",
        "replaces": "yjs_tpu/ops/kernels.py:406",
        "shape": f"B={b} N+1={n1} S+1={s1} lanes={lanes.numel()} {lanes.dtype}",
        "launches": launches["apply_lanes"], "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    })

    # scatter_rows at the compaction's shapes
    *tables, idx, new_right, new_deleted, new_starts = seen["scatter_rows"]
    new = (idx, new_right, new_deleted, new_starts)
    b, n1 = tables[0].shape
    s1 = tables[2].shape[1]
    got = K.scatter_rows(*fresh(), *new)
    ref = K.scatter_rows_plain(*fresh(), *new)
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    base = fresh()
    ms = cuda_ms(lambda: K.scatter_rows(*base, *new))
    dev_ms = device_ms(lambda: K.scatter_rows(*base, *new))
    plain_ms = cuda_ms(lambda: K.scatter_rows_plain(*base, *new))
    idx64 = idx.long()

    def library():
        base[0].index_copy_(0, idx64, new_right)
        base[1].index_copy_(0, idx64, new_deleted)
        base[2].index_copy_(0, idx64, new_starts)

    lib_ms = cuda_ms(library)
    k = idx.numel()
    nbytes = idx.nbytes + 2 * (new_right.nbytes + new_deleted.nbytes
                               + new_starts.nbytes)
    rows.append({
        "name": "scatter_rows", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "yjs_tpu/ops/kernels.py:479",
        "shape": f"k={k} B={b} N+1={n1} S+1={s1}",
        "launches": launches["scatter_rows"], "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": lib_ms,
    })

    # list_ranks at the export's shapes (one doc row)
    right1, valid1 = seen["list_ranks"]
    got = K.list_ranks(right1, valid1)
    ref = K.list_ranks_plain(right1, valid1)
    err = max_abs_err(got, ref)
    ms = cuda_ms(lambda: K.list_ranks(right1, valid1))
    dev_ms = device_ms(lambda: K.list_ranks(right1, valid1))
    plain_ms = cuda_ms(lambda: K.list_ranks_plain(right1, valid1))
    nbytes = right1.nbytes + valid1.nbytes + right1.nbytes
    rows.append({
        "name": "list_ranks", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/list_ranks.cu",
        "replaces": "yjs_tpu/ops/kernels.py:674",
        "shape": f"b={right1.shape[0]} N+1={right1.shape[1]}",
        "launches": launches["list_ranks"], "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    })
    torch.cuda.synchronize()
    # comparison and timing launches are not the main path's
    K.launches.update(saved)
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} never launched on the main path")
        check(row["max_abs_err"] == 0, f"{row['name']} differs from its plain version")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "yjs_tpu_torch").is_dir() or not FIXTURE.exists():
        print("chip_smoke: run from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from yjs_tpu_torch.ops import kernels as K

    dev = device_phase()
    build_phase()
    traces = load_traces()
    warm_up(traces[0])
    K.reset_launches()
    t0 = time.perf_counter()
    with Capture(K) as cap:
        figures = main_path("cuda", N_DOCS, traces)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    log(f"[main] wall {time.perf_counter() - t0:.1f}s; launches {launches}")
    for name in ("flush1", "flush2"):
        log(f"[main] {name} metrics " + json.dumps(figures[name], sort_keys=True))
    log(f"[main] flush 2: realloc_bytes {figures['flush2']['realloc_bytes']} "
        f"flush_donated {figures['flush2']['flush_donated']} "
        f"compacted {figures['n_compacted']} docs")
    log(f"[main] table bytes {figures['table_bytes']}")
    rate = figures["elements"] / figures["t_flush1_s"]
    log(f"[main] flush 1: {figures['elements']} elements in "
        f"{figures['t_flush1_s']:.3f}s = {rate:.0f} elements/s; flush 2 "
        f"{figures['t_flush2_s']:.3f}s ({dev['smi']})")
    rows = kernel_phase(cap.seen, launches)
    log(json.dumps({"kernels": rows}))
    log(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
