#!/usr/bin/env python3
"""The YATA steps K5, K6, K7b and K15 of one checkout at the smoke's input
and at that input widened, for comparing checkouts, variants and level
block sizes on one card.

    python3 scripts/torch_yata_ab.py --root PATH [--label NAME]
        [--variants shared,rows,global] [--level-threads 128,64,32]
        [--n1 4097,8193,16385] [--kernels K,...]
        [--first-trace | --seeded N_OPS] [--out FILE]

Imports ``yjs_tpu_torch`` from the checkout at ``PATH`` (its kernels build
into that checkout) and the helpers of this checkout's ``chip_smoke.py``;
needs a CUDA card.  Inputs are the smoke's: ``BatchEngine(4096)`` flushes
every doc one of the fixture's 1024 distinct traces (cycled) on the seq
and the levels lane, and the largest K5 and K6 inputs are kept; K7b's
are the broadcast path's (one trace fanned over 4096 docs); K15 runs K6's
input as four shards of 1024 docs that share the card, counting.  With
``--first-trace`` every doc gets the fixture's first trace (docs of 2049
rows); with ``--seeded N_OPS`` the inputs are the last flush of four
docs' seeded sessions of N_OPS edits (``yata_case`` of
``tests/test_torch_cuda.py``, docs of 1025 rows), tiled to 4096 docs on
the tables their first two flushes left.  Each input is widened to each ``--n1`` (N+1; 0: its own width)
with the engine's fills: the schedules name rows below the old width,
so the work is the same and only the doc's rows grow.

- ``--variants``: each kernel runs in each named variant of
  ``kernels.YATA_VARIANTS``, forced (the checkout must have them);
  without it, in the variant the checkout picks.
- ``--level-threads``: the checkout's ``yata.cu`` with every level
  instantiation at each of these threads a block, built beside its
  kernels; K6, K7b and K15 run in each build, K5 in the first.

Every (build, variant) runs once, then again in the reverse order.  One
JSON line each: device ms (``torch.profiler``, a 10-call trace, tables
restored before every call, their copies left out), events ms (CUDA
events around each launch alone, 10 calls), the variant's staged bytes,
threads a block and blocks an SM where the checkout reports them, and
the output tables' digest (the same for every checkout, variant and
build of a kernel and width), with the card's name and power limit; and
one line a build with its registers and spills.  Compare checkouts in
turns (A, B, B, A) in one call: the host's speed and the card's clocks
change from one machine to the next.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
TIMED = 10  # calls a reading
N_SHARDS = 4  # K15: the smoke's mesh, four shards sharing the card
KERNELS = ("batch_step", "batch_step_levels", "batch_step_levels_shared",
           "sharded_batch_step")


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shard_args(a, n: int):
    """K6's inputs ``a`` cut into ``n`` shards of contiguous docs (views),
    with a zeroed ``[2]`` counter a shard: K15's arguments."""
    statics, dyn, splits, lv, dels, scratch = a
    b = dyn[0].shape[0]
    cuts = [(i * b // n, (i + 1) * b // n) for i in range(n)]

    def cut(t):
        return [t[x:y] for x, y in cuts]

    counters = list(torch.zeros((n, 2), dtype=torch.int32,
                                device=dyn[0].device))
    return ([{k: v[x:y] for k, v in statics.items()} for x, y in cuts],
            [tuple(t[x:y] for t in dyn) for x, y in cuts],
            cut(splits), cut(lv), cut(dels), cut(scratch), counters)


def thread_build(_cuda, threads: int) -> dict:
    """The checkout's yata.cu with every level instantiation at
    ``threads`` a block, built beside its kernels: its bound entries and
    its -Xptxas -v report."""
    from yjs_tpu_torch.buildlib import BUILD_DIR, build_shared

    text = Path(_cuda.CSRC, "yata.cu").read_text()
    pat = re.compile(r"constexpr int kLevelThreads =[^;]*;")
    if not pat.search(text):
        raise SystemExit("yata.cu sets no kLevelThreads")
    src = Path(BUILD_DIR, f"yata_t{threads}.cu")
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(pat.sub(f"constexpr int kLevelThreads = {threads};", text))
    nvcc = _cuda._nvcc()
    path, _built, report = build_shared(
        f"yata_ab_t{threads}", [str(src)],
        lambda o: [nvcc, *_cuda.NVCC_FLAGS, "-o", o, str(src)], timeout=900)
    lib = ctypes.CDLL(path)
    fns = {}
    for name, (stem, argtypes) in _cuda._ENTRIES.items():
        if stem == "yata":
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name] = fn
    return {"fns": fns, "ptxas": report}


def inputs(cs, first: bool) -> dict:
    """The largest K5 and K6 inputs of the smoke's flush 1 on the seq and
    levels lanes (``first``: every doc the first trace), and K7b's
    broadcast inputs."""
    from yjs_tpu_torch.ops import BatchEngine
    from yjs_tpu_torch.ops import kernels as K

    traces = cs.load_traces()
    seen = {}
    for lane, name in (("seq", "batch_step"), ("levels", "batch_step_levels")):
        os.environ["YTPU_KERNEL"] = lane
        eng = BatchEngine(cs.N_DOCS, device="cuda")
        for i in range(cs.N_DOCS):
            eng.queue_update(i, traces[0 if first else i % len(traces)])
        with cs.Capture(K, cs.YATA_KERNELS) as cap:
            eng.flush()
        torch.cuda.synchronize()
        seen[name] = cap.seen[name]
        del eng
    os.environ.pop("YTPU_KERNEL", None)
    seen["batch_step_levels_shared"] = cs.broadcast_path(traces[0])[
        "batch_step_levels_shared"]
    seen["sharded_batch_step"] = seen["batch_step_levels"]
    return seen


def seeded_inputs(cs, n_ops: int) -> dict:
    """The last of three flushes of four docs' seeded sessions, tiled to
    the smoke's 4096 docs, on the tables the first two left: each step's
    arguments (K7b: doc 0's plan read by every doc)."""
    from yjs_tpu_torch.ops import kernels as K

    tc = load("torch_cuda_cases", HERE / "tests" / "test_torch_cuda.py")
    dev = torch.device("cuda")
    cap, s1, stages = tc.yata_case(13, 4, n_ops=n_ops, cap_min=1024)
    reps = cs.N_DOCS // 4

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def tile(t):
        return t.repeat((reps,) + (1,) * (t.dim() - 1))

    seen = {}
    for name, sched in (("batch_step", ("splits", "sched", "dels")),
                        ("batch_step_levels",
                         ("splits", "lv", "dels", "scratch"))):
        tab = [to(a) for a in tc.yata_tables(4, cap, s1)]
        for st in stages[:2]:
            getattr(K, name)({k: to(st[k]) for k in K.STATIC_KEYS}, tab,
                             *(to(st[k]) for k in sched))
        st = stages[2]
        seen[name] = ({k: tile(to(st[k])) for k in K.STATIC_KEYS},
                      tuple(tile(t) for t in tab),
                      *(tile(to(st[k])) for k in sched))
    statics, dyn, splits, lv, dels, scratch = seen["batch_step_levels"]
    seen["batch_step_levels_shared"] = (
        {k: v[0] for k, v in statics.items()}, tuple(t.clone() for t in dyn),
        splits[0], lv[0], dels[0], torch.full_like(scratch, scratch[0]))
    seen["sharded_batch_step"] = seen["batch_step_levels"]
    return seen


def widen(a, n1: int):
    """A YATA step's arguments ``a`` with the statics and tables widened to
    ``n1`` rows by the engine's fills (K7b's statics are one doc's row)."""
    from yjs_tpu_torch.ops import kernels as K
    from yjs_tpu_torch.ops.engine import _STATIC_COLS

    statics, dyn, *rest = a

    def wide(t, fill):
        if t.shape[-1] == n1 or n1 == 0:
            return t
        o = torch.full((*t.shape[:-1], n1), fill, dtype=t.dtype,
                       device=t.device)
        o[..., : t.shape[-1]] = t
        return o

    return ({k: wide(statics[k], fill) for k, fill, _dt in _STATIC_COLS},
            (wide(dyn[0], K.NULL), wide(dyn[1], False), dyn[2]), *rest)


def digest(tables) -> str:
    h = hashlib.sha256()
    for t in tables:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--variants", default=None)
    ap.add_argument("--level-threads", default=None)
    ap.add_argument("--n1", default="4097,8193,16385")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--first-trace", action="store_true")
    ap.add_argument("--seeded", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_yata_ab: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = load("chip_smoke_helpers", HERE / "chip_smoke.py")
    from yjs_tpu_torch.ops import _cuda
    from yjs_tpu_torch.ops import kernels as K

    if not Path(K.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {K.__file__}, not from {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    label = args.label or str(root)
    lines = []

    def emit(rec):
        rec.update(label=label, card=smi)
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    _cuda.build_all()
    builds = {"as built": {"fns": dict(_cuda._fns),
                           "ptxas": _cuda.build_info["yata"]["ptxas"]}}
    if args.level_threads:
        builds = {f"t{n}": thread_build(_cuda, int(n))
                  for n in args.level_threads.split(",")}
    for name, b in builds.items():
        emit({"build": name, "ptxas": _cuda.ptxas_summary(b["ptxas"])})
    pick = K.__dict__.get("yata_variant")
    variants = args.variants.split(",") if args.variants else [None]

    def forced(v):
        """The wrappers' variant rule, or one that always takes ``v``."""
        if v is None:
            return pick
        return lambda n1, s1, w, limit: (v, K.yata_smem_bytes(n1, s1, w, v))

    def run(name, a):
        if name == "sharded_batch_step":
            K.sharded_batch_step_levels(*shard_args(a, N_SHARDS))
        else:
            getattr(K, name)(*a)

    seen = (seeded_inputs(cs, args.seeded) if args.seeded
            else inputs(cs, args.first_trace))
    for n1 in (int(x) for x in args.n1.split(",")):
        for name in args.kernels.split(","):
            a = widen(seen[name], n1)
            statics, dyn, *rest = a
            # K5 in the first build only: level threads do not touch it
            combos = [(bn, v) for bn in builds for v in variants
                      if name != "batch_step" or bn == next(iter(builds))]
            work = cs._clone(dyn)
            want = None

            def restore(work=work, dyn=dyn):
                for w, o in zip(work, dyn):
                    w.copy_(o)

            for turn, (bn, v) in enumerate(combos + combos[::-1]):
                _cuda._fns.update(builds[bn]["fns"])
                if pick is not None:
                    K.yata_variant = forced(v)

                def launch(name=name, work=work, statics=statics, rest=rest):
                    run(name, (statics, work, *rest))

                restore()
                launch()
                torch.cuda.synchronize()
                if want is None:
                    want = cs._clone(work)
                    sha = digest(want)
                elif not all(torch.equal(w, g) for w, g in zip(work, want)):
                    raise SystemExit(f"{name} at N+1={dyn[0].shape[1]}: "
                                     f"{bn} {v} differs")
                rec = {"kernel": name, "build": bn, "turn": turn,
                       "shape": f"B={dyn[0].shape[0]} "
                                f"N+1={dyn[0].shape[1]} "
                                f"S+1={dyn[2].shape[1]} "
                                f"schedule={tuple(rest[1].shape)}",
                       "device_ms": cs.device_ms(launch, TIMED, restore),
                       "events_ms": cs.cuda_ms_restored(launch, restore,
                                                        TIMED),
                       "digest": sha}
                if pick is not None:
                    rec["variant"] = K.last_variant[name]
                    w = 0 if name == "batch_step" else max(1, rest[1].shape[-2])
                    smem = K.yata_smem_bytes(dyn[0].shape[1],
                                             dyn[2].shape[1], w,
                                             rec["variant"])
                    rec["smem_bytes"] = smem
                    rec["threads"], rec["blocks_per_sm"] = (
                        _cuda.yata_occupancy(
                            dyn[0].device, cs.YATA_KINDS[name],
                            K.YATA_VARIANTS.index(rec["variant"]), smem))
                emit(rec)
            del a, statics, dyn, rest, work, want
            torch.cuda.empty_cache()
    if pick is not None:
        K.yata_variant = pick
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
