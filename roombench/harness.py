"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes all traffic from the seed, builds the provider, loads every
room in one flush and runs one warm tick of the cell's own shapes.  The
window then runs the ticks that start within ``--seconds``, whole, and
its time runs to the end of the last one.  Between the program's calls
the harness only slices its next update from a flat buffer and reads its
clock.  After the window the reference checks what the program produced,
and the run prints each number compared beside its limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time

from . import bases as bases_mod
from . import check, host, manifest, metrics, traffic
from .traffic import rng_for

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "yjs_tpu")
FAULTS = ("lost_ack", "unchanged", "half_batch", "altered", "k1_noop")


def log(msg: str) -> None:
    print(f"roombench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({k.split(".", 1)[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="roombench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the tests and the control runs, never passed by the check
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--fault", choices=FAULTS, help=argparse.SUPPRESS)
    p.add_argument("--rooms", type=int, help=argparse.SUPPRESS)
    p.add_argument("--sized-for", type=float, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def set_env(cfg: dict, cpus: dict) -> None:
    """The run's environment: the planner's pool sized to the CPUs
    granted, build caches at fixed paths in the checkout, the WAL's
    durability as the configuration states it."""
    os.environ["YTPU_PLAN_THREADS"] = str(cpus["granted"])
    cache = os.path.join(ROOT, ".roombench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["YTPU_WAL_FSYNC"] = cfg["wal"]["fsync"]
    os.environ["YTPU_WAL_FSYNC_INTERVAL"] = str(cfg["wal"]["fsync_interval"])
    os.environ.pop("YTPU_WAL_DIR", None)


def deal(cfg: dict, n_histories: int, order: list[int]) -> list[int]:
    """Room -> history: each history to ``rooms_per_history`` rooms, by
    the rooms' popularity rank (``order``, hottest first), so that every
    seed puts the same histories under the same share of the traffic."""
    k = cfg["history"]["rooms_per_history"]
    if n_histories * k < len(order):
        raise ValueError(f"{n_histories} histories x {k} < {len(order)} rooms")
    out = [0] * len(order)
    for rank, r in enumerate(order):
        out[r] = rank // k
    return out


def _faulty(prov, fault: str) -> None:
    """Break the program underneath the window's calls (tests, controls)."""
    eng = prov.engine
    n = [0]
    if fault == "lost_ack":  # 1 in 512 edits acknowledged and dropped
        inner = prov.receive_update

        def receive_update(guid, update, *a, **k):
            n[0] += 1
            return True if n[0] % 512 == 0 else inner(guid, update, *a, **k)
        prov.receive_update = receive_update
    elif fault == "unchanged":  # the step leaves the state as it was
        eng.flush = lambda *a, **k: None
    elif fault == "half_batch":  # every second update left out
        inner_q = eng.queue_update

        def queue_update(doc, update, *a, **k):
            n[0] += 1
            return True if n[0] % 2 else inner_q(doc, update, *a, **k)
        eng.queue_update = queue_update
    elif fault == "altered":  # a character, and every reply, altered
        inner_q = eng.queue_update
        inner_s = eng.sync_step2_batch

        def queue_update(doc, update, *a, **k):
            n[0] += 1
            u = bytes(update)
            if n[0] % 7 == 0 and len(u) > 2 and u[0] == 1:
                u = u[:-2] + bytes([ord("A") if u[-2] != ord("A") else ord("B")]) + u[-1:]
            return inner_q(doc, u, *a, **k)

        def sync_step2_batch(requests, *a, **k):
            return [u[:-1] + bytes([u[-1] ^ 1]) for u in inner_s(requests, *a, **k)]
        eng.queue_update = queue_update
        eng.sync_step2_batch = sync_step2_batch
    elif fault == "k1_noop":  # the device step writes nothing to the tables
        from yjs_tpu_torch.ops import kernels

        kernels.apply_plan2 = lambda dyn, *a, **k: dyn


def _newest_span(tracer, name: str, since: float) -> float | None:
    """The duration (s) of the newest ``name`` span that started after
    ``since`` (``time.perf_counter``), from the program's tracer."""
    if tracer is None or not tracer.enabled:
        return None
    ev = tracer._events
    for k in range(1, min(len(ev), 64) + 1):
        e = ev[-k]
        if e[0] == name:
            if tracer._t0 + e[2] * 1e-6 >= since:
                return e[3] * 1e-6
            return None
    return None


def _span_sum(tracer, name: str, since: float) -> tuple[float, int]:
    if tracer is None or not tracer.enabled:
        return 0.0, 0
    t0 = tracer._t0
    s, n = 0.0, 0
    for e in list(tracer._events):
        if e[0] == name and t0 + e[2] * 1e-6 >= since:
            s += e[3] * 1e-6
            n += 1
    return s, n


FLUSH_KEYS = ("t_plan_s", "t_pack_s", "t_dispatch_s", "t_device_wait_s", "t_emit_s")


def window(prov, tr, first: int, seconds: float | None, ann, keep: bytearray):
    """Run ticks from ``first``: one tick when ``seconds`` is None (the
    warm tick), else every tick that starts within ``seconds``.  Returns
    the record of what ran (see :mod:`.metrics`)."""
    recv = prov.receive_update
    flush = prov.flush
    batch = prov.handle_sync_step1_batch
    eng = prov.engine
    tracer = getattr(eng.obs, "tracer", None)
    guids = tr.guids
    ebuf, eoff, eroom, tedits = tr.edit_buf, tr.edit_off, tr.edit_room, tr.tick_edits
    jbuf, joff, jroom, tjoins = tr.join_buf, tr.join_off, tr.join_room, tr.tick_joins
    pc = time.perf_counter
    ingest = 0.0
    received = refused = joins = missing = 0
    fl = dict.fromkeys(FLUSH_KEYS, 0.0)
    fl["n"] = 0
    bt = {"n": 0, "wall_s": 0.0, "flush_s": 0.0, "flush_spans": 0}
    lat: list[float] = []
    replies: dict[int, bytes] = {}
    join_tick: dict[int, int] = {}
    k1 = {"rows": 0, "deletes": 0, "rooms": 0}
    last_m = eng.last_flush_metrics
    t = first
    w0 = pc()
    with ann("roombench.window"):
        while True:
            if t >= tr.n_ticks:
                raise traffic.TrafficExhausted(
                    f"tick {t}: the traffic made in set-up is used up")
            e0, e1 = tedits[t], tedits[t + 1]
            with ann("tick.ingest"):
                for i in range(e0, e1):
                    a = pc()
                    ok = recv(guids[eroom[i]], ebuf[eoff[i]:eoff[i + 1]])
                    ingest += pc() - a
                    if not ok:
                        refused += 1
            received += e1 - e0
            j0, j1 = tjoins[t], tjoins[t + 1]
            if j1 > j0:
                msgs = [(guids[jroom[j]], jbuf[joff[j]:joff[j + 1]]) for j in range(j0, j1)]
                with ann("tick.joins"):
                    a = pc()
                    reps = batch(msgs)
                    b = pc()
                bt["n"] += 1
                bt["wall_s"] += b - a
                fs = _newest_span(tracer, "ytpu.provider.flush", a)
                if fs is not None:
                    bt["flush_s"] += fs
                    bt["flush_spans"] += 1
                got = min(len(reps), j1 - j0)
                missing += (j1 - j0) - got
                joins += got
                lat.extend([b - a] * got)
                for j in range(j0, j0 + got):
                    if keep[j]:
                        replies[j] = reps[j - j0]
                        join_tick[j] = t
            else:
                with ann("tick.flush"):
                    flush()
            m = eng.last_flush_metrics
            if m is not last_m:
                last_m = m
                fl["n"] += 1
                for k in FLUSH_KEYS:
                    fl[k] += m[k]
            k1["rows"] += tr.k1_rows[t]
            k1["deletes"] += tr.k1_deletes[t]
            k1["rooms"] += tr.k1_rooms[t]
            t += 1
            now = pc()
            if seconds is None or now - w0 >= seconds:
                break
    window_s = now - w0
    edits = received - refused
    span_s, span_n = _span_sum(tracer, "ytpu.provider.receive_update", w0)
    return {
        "window_s": window_s, "ticks": t - first, "end_tick": t,
        "n_received": received, "refused": refused, "edits": edits,
        "joins": joins, "replies_missing": missing,
        "work": joins if tjoins[-1] else edits,
        "ingest_s": ingest, "ingest_span_s": span_s, "ingest_spans": span_n,
        "flush": fl, "batches": bt, "join_latency_s": lat,
        "replies": replies, "join_tick": join_tick, "k1": k1,
    }


def _wal_numbers(prov) -> dict:
    w = prov._wal_metrics

    def val(x):
        x = getattr(x, "value", x)
        return x() if callable(x) else x

    h = w.append_seconds
    return {"fsyncs": val(w.fsyncs), "appends": val(h.count),
            "append_s": val(h.sum)}


def read_from_device(prov) -> None:
    """Serve the exports the check reads (texts) from the card's tables:
    the doc's resident links ranked on the device and read back with its
    delete marks, so that the comparison judges what the device step
    wrote and not the host's mirror of it."""
    eng = prov.engine
    if not hasattr(eng, "export_from_device"):
        raise RuntimeError("the engine has no export_from_device switch")
    eng.export_from_device = True


def run(args, t0: float, bench: dict | None = None) -> int:
    """One run of ``args.workload``; ``bench`` is the manifest (by default
    ``BENCHMARK.json``)."""
    if bench is None:
        m = manifest.load(ROOT)
    else:
        manifest.validate(bench)
        m = bench
    cell, centry = manifest.cell(m, args.workload)
    with open(os.path.join(ROOT, centry["file"])) as f:
        cfg = json.load(f)
    if args.rooms:  # the tests' small copies of a configuration
        cfg["rooms"] = args.rooms
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    if args.sized_for:  # the tests' faster small copies
        mix["sized_for_ticks_per_s"] = args.sized_for
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            log(f"needs {cell['chips']} CUDA device(s); "
                f"available={torch.cuda.is_available()}")
            return 2
    cpus = host.granted_cpus()
    set_env(cfg, cpus)
    log(f"host cpus={cpus['host']} affinity={cpus['affinity']} "
        f"quota={cpus['quota']} granted={cpus['granted']} "
        f"YTPU_PLAN_THREADS={os.environ['YTPU_PLAN_THREADS']} "
        f"loadavg={host.load_average()}")

    hist = bases_mod.histories(ROOT, cfg["history"])
    room_base = deal(cfg, len(hist), traffic.ranking(cfg["rooms"], args.seed))
    workers = min(cfg["history"].get("workers", 1), cpus["granted"])

    def pool_map(fn, jobs):
        return traffic.pool_map(fn, jobs, workers)

    bases = bases_mod.integrated(cfg["history"], hist, cfg["root"],
                                 sorted(set(room_base)), pool_map)
    t_bases = time.perf_counter() - t0
    n_ticks = traffic.ticks_needed(mix, args.seconds)
    tr = traffic.make(cfg, mix, hist, bases, room_base, args.seed, n_ticks, workers)
    tr.edit_buf = bytes(tr.edit_buf)
    tr.join_buf = bytes(tr.join_buf)
    # the joins to check: drawn from the seed among those of the ticks a
    # window at the mix's fastest rate would run, so most fall inside it
    keep = bytearray(len(tr.join_room))
    likely = tr.tick_joins[min(tr.n_ticks, 1 + round(mix["sized_for_ticks_per_s"] * args.seconds))]
    n_keep = min(cfg["check"]["sampled_joins"], likely)
    for j in rng_for(args.seed, "check-joins").sample(range(likely), n_keep):
        keep[j] = 1
    t_traffic = time.perf_counter() - t0
    log(f"traffic ticks={tr.n_ticks} edits={len(tr.edit_room)} "
        f"joins={len(tr.join_room)} bases at {t_bases:.3f}s, "
        f"traffic at {t_traffic:.3f}s")

    from yjs_tpu_torch.ops import kernels
    from yjs_tpu_torch.provider import TpuProvider

    tmp = os.environ.get("TMPDIR") or tempfile.gettempdir()
    wal_dir = tempfile.mkdtemp(prefix="roombench-wal-", dir=tmp)
    try:
        prov = TpuProvider(cfg["rooms"], root_name=cfg["root"],
                           backend=cfg["provider"]["backend"],
                           device=args.device, wal_dir=wal_dir)
        for r, u in tr.load:
            if not prov.receive_update(tr.guids[r], u):
                raise RuntimeError(f"{tr.guids[r]}: history refused")
        prov.flush()
        def no_ann(name):
            return contextlib.nullcontext()

        window(prov, tr, 0, None, no_ann, keep)  # the warm tick
        if args.device == "cuda":
            torch.cuda.synchronize()
        if args.fault:
            _faulty(prov, args.fault)
        gc.collect()
        gc.freeze()
        k1_before = kernels.launches.get("apply_lanes", 0)
        setup_s = time.perf_counter() - t0
        log(f"setup_s={setup_s:.3f} loadavg={host.load_average()} wal={_wal_numbers(prov)}")
        if args.trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if args.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof, ann = profile(activities=acts), record_function
        else:
            prof, ann = contextlib.nullcontext(), no_ann
        with prof:
            rec = window(prov, tr, 1, args.seconds, ann, keep)
            if args.device == "cuda":
                torch.cuda.synchronize()
        trace = None
        if args.trace:
            from . import devtrace

            path = os.path.join(wal_dir, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            trace = devtrace.read_trace(path)
            os.remove(path)
        k1_launches = kernels.launches.get("apply_lanes", 0) - k1_before
        mem = torch.cuda.max_memory_allocated() if args.device == "cuda" else 0
        wal_end = _wal_numbers(prov)
        log(f"window ticks={rec['ticks']} window_s={rec['window_s']:.6f} "
            f"edits={rec['edits']} joins={rec['joins']} k1_launches={k1_launches} "
            f"loadavg={host.load_average()} wal={wal_end}")
        log(f"ingest harness_s={rec['ingest_s']:.6f} "
            f"program_span_s={rec['ingest_span_s']:.6f} spans={rec['ingest_spans']} "
            f"of {rec['n_received']}")
        gc.unfreeze()
        prov.close(checkpoint=False)
        read_from_device(prov)
        t_check = time.perf_counter()
        checks, notes = check.compare(prov, tr, bases, room_base, cfg, args.seed,
                                      rec, wal_dir)
        log(f"check_s={time.perf_counter() - t_check:.3f}")
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)
    rec.update(setup_s=setup_s, trace=trace, k1_launches=k1_launches,
               device_kind=(torch.cuda.get_device_name(0)
                            if args.device == "cuda" else "cpu"))
    out = {}
    for x in manifest.metrics_for(m, args.workload, bool(args.trace)):
        v = metrics.read(x["name"], rec)
        if v is not None:
            out[x["name"]] = {"value": v, "unit": x["unit"]}
    correct = all(v <= lim for v, lim in checks.values())
    device = {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "kind": rec["device_kind"],
        "count": cell["chips"] if args.device == "cuda" else 0,
        "memory_peak_bytes": mem,
    }
    result = {"correct": correct,
              "attempted": rec["n_received"] + rec["joins"] + rec["replies_missing"],
              "failed": rec["refused"] + rec["replies_missing"],
              "metrics": out, "device": device}
    if trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        result["breakdown"] = trace["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}")
        return 3
    for n in notes:
        log(n)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv, t0: float, bench: dict | None = None) -> int:
    return run(parse(argv), t0, bench)
