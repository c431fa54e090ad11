#!/usr/bin/env python3
"""The doc mesh's sharded apply (K14) and level step (K15) beside their
one-shard calls (K1, K6), for comparing two checkouts on one card.

    python3 scripts/torch_mesh_ab.py --root PATH [--label NAME]

Imports ``yjs_tpu_torch`` from the checkout at ``PATH`` (its kernels build
into that checkout), and the timing helpers of this checkout's
``chip_smoke.py`` and the seeded YATA cases (``yata_case``) of its
``tests/test_torch_cuda.py``; needs a CUDA card.  Inputs are made from a
seed at the smoke's shapes, 4096 docs in four shards of 1024 that share
the card:

- K1 and K14: an int16 lanes buffer a shard, each doc 0-680 dense lanes
  (about 340 on average, as the fixture's traces give) and a few sparse,
  head and delete lanes, into fresh ``[1024, 2049]`` tables; K1 takes
  the four shards' docs as one batch of 4096;
- K6 and K15: four docs' three-stage YATA case (``yata_case``, lanes
  padded to W = 512), its last stage tiled to 4096 docs, on the tables
  the first two stages left.

For each kernel it prints one JSON line: events ms (``cuda_ms``; the
level steps restore their tables before each timed launch), device ms
(``torch.profiler``), the kernels one call launches and one call's host
µs split (``chip_smoke.host_split``; the level steps on an empty schedule
of the same shapes), with the card's name and power limit.  Run it in
turns (A, B, B, A) in one call: the host's speed and the card's clocks
change from one machine to the next.
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
N_SHARDS, B_LOC, N1, S1 = 4, 1024, 2049, 9


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lanes_case(g, b: int):
    """One shard's int16 lanes and its section widths (padding lanes as
    the packer writes them: NULL values, rows N1, segments S1)."""
    counts = [g.integers(0, hi, b) for hi in (681, 4, 2, 4)]
    k = [int(c.sum()) for c in counts]
    dense = g.integers(-1, N1 - 1, k[0])
    sp_r = np.concatenate([g.choice(N1 - 1, c, replace=False)
                           for c in counts[1]])
    hd_s = np.concatenate([g.choice(S1 - 1, c, replace=False)
                           for c in counts[2]])
    dl_r = np.concatenate([g.choice(N1 - 1, c, replace=False)
                           for c in counts[3]])
    return [*counts, dense, sp_r, g.integers(-1, N1 - 1, k[1]), hd_s,
            g.integers(-1, N1 - 1, k[2]), dl_r]


def pack(parts, widths):
    """``lanes_case`` parts padded to the shared ``widths``."""
    k_dn, k_sp, k_h, k_d = widths
    fills = ((k_dn, -1), (k_sp, N1), (k_sp, -1), (k_h, S1), (k_h, -1),
             (k_d, N1))
    out = list(parts[:4])
    for sec, (w, fill) in zip(parts[4:], fills):
        pad = np.full(w, fill, np.int64)
        pad[: len(sec)] = sec
        out.append(pad)
    return np.concatenate(out).astype(np.int16)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mesh_ab: needs a CUDA card", file=sys.stderr)
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
    mesh = DocMesh([dev] * N_SHARDS)
    g = np.random.default_rng(7)
    label = args.label or str(root)
    out = []

    # K1 and K14
    parts = [lanes_case(g, B_LOC) for _ in range(N_SHARDS)]
    widths = tuple(max(len(p[4 + j]) for p in parts) for j in (0, 1, 3, 5))
    rows = [torch.from_numpy(pack(p, widths)).to(dev) for p in parts]
    whole = [np.concatenate([p[j] for p in parts]) for j in range(10)]
    w1 = tuple(len(whole[4 + j]) for j in (0, 1, 3, 5))
    one = torch.from_numpy(pack(whole, w1)).to(dev)

    def tables(b):
        return (torch.full((b, N1), -1, dtype=torch.int32, device=dev),
                torch.zeros((b, N1), dtype=torch.bool, device=dev),
                torch.full((b, S1), -1, dtype=torch.int32, device=dev))

    dyn = [tables(B_LOC) for _ in range(N_SHARDS)]
    k14 = pm.sharded_apply_plan(mesh, "docs", *widths)
    got, _c = k14([tuple(t.clone() for t in d) for d in dyn], rows)
    ref, _c = pm.sharded_apply_plan(mesh, "docs", *widths, plain=True)(
        [tuple(t.clone() for t in d) for d in dyn], rows)
    ok = all(torch.equal(a, b) for x, y in zip(got, ref) for a, b in zip(x, y))
    big = tables(N_SHARDS * B_LOC)
    k1 = K.apply_lanes(tuple(t.clone() for t in big), one, *w1)
    ok = ok and all(torch.equal(a, torch.cat([r[j] for r in ref]))
                    for j, a in enumerate(k1))
    out.append(("sharded_apply_plan", lambda: k14(dyn, rows), None, None))
    out.append(("apply_lanes", lambda: K.apply_lanes(big, one, *w1), None,
                None))

    # K6 and K15
    cap, s1, stages = tc.yata_case(13, 4, w_pad=512, cap_min=N1 - 1)
    reps = N_SHARDS * B_LOC // 4
    tab = [torch.from_numpy(a).to(dev) for a in tc.yata_tables(4, cap, s1)]
    for st in stages[:2]:  # in place; the same tensors come back
        tab = K.batch_step_levels(
            {k: torch.from_numpy(st[k]).to(dev) for k in K.STATIC_KEYS}, tab,
            *(torch.from_numpy(st[k]).to(dev)
              for k in ("splits", "lv", "dels", "scratch")))
    st = stages[2]

    def tile(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.tile(a, (reps,) + (1,) * (a.ndim - 1)))).to(dev)

    statics = {k: tile(st[k]) for k in K.STATIC_KEYS}
    sched = [tile(st[k]) for k in ("splits", "lv", "dels", "scratch")]
    base = [t.repeat((reps,) + (1,) * (t.dim() - 1)) for t in tab]
    empty = [torch.full_like(t, -1) for t in sched[:3]] + [sched[3]]

    def shard(x):
        return list(x.chunk(N_SHARDS))

    s_statics = [dict(zip(statics, c)) for c in zip(
        *(shard(v) for v in statics.values()))]
    s_sched = [shard(t) for t in sched]
    s_empty = [shard(t) for t in empty]
    work = [t.clone() for t in base]
    s_work = [tuple(x) for x in zip(*(shard(t) for t in work))]
    k15 = pm.sharded_batch_step(mesh, "docs")

    def restore():
        for w, b in zip(work, base):
            w.copy_(b)

    restore()
    k15(s_statics, s_work, *s_sched)
    ref = [t.clone() for t in base]
    K.batch_step_levels_plain(statics, ref, *sched)
    ok = ok and all(torch.equal(a, b) for a, b in zip(work, ref))
    restore()
    work = K.batch_step_levels(statics, work, *sched)
    ok = ok and all(torch.equal(a, b) for a, b in zip(work, ref))
    if not ok:
        raise SystemExit("a kernel differs from its plain version")
    idle = [t.clone() for t in base]
    s_idle = [tuple(x) for x in zip(*(shard(t) for t in idle))]
    out.append(("sharded_batch_step",
                lambda: k15(s_statics, s_work, *s_sched), restore,
                lambda: k15(s_statics, s_idle, *s_empty)))
    out.append(("batch_step_levels",
                lambda: K.batch_step_levels(statics, work, *sched), restore,
                lambda: K.batch_step_levels(statics, idle, *empty)))

    for name, call, rest, host in out:
        if rest is None:
            ms = cs.cuda_ms(call)
            dev_ms = cs.device_ms(call)
        else:
            ms = cs.cuda_ms_restored(call, rest)
            dev_ms = cs.device_ms(call, cs.YATA_TIMED_LAUNCHES, rest)
        print(json.dumps({
            "label": label, "name": name, "card": smi, "ms": ms,
            "device_ms": dev_ms,
            "kernels_a_call": cs.kernels_a_call(call, rest),
            "host_us": cs.host_split(host or call),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
