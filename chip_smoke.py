#!/usr/bin/env python3
"""Drive the PyTorch port's flush and provider paths on one CUDA card and check them.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with an NVIDIA card
(sm_90a: H100/H200).  It imports nothing of JAX or of the JAX package.
Phases, each printed on its own lines; any failed check raises and the
script exits non-zero:

1. device: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: the native plan core (g++) and the five CUDA kernels (one
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
4. provider path: the README's ``TpuProvider(n_docs=4096)`` on the card
   beside a CPU twin ``TpuProvider(4096, device="cpu")``, each
   journaling to its own WAL directory, under ``YTPU_SYNC_DEVICE=1``
   (the device sync branch):
   - every room gets its fixture trace, ``flush()``, then the seeded
     editors' edits, ``flush()`` (tables equal the twin's after each);
   - a reconnect storm: 4096 sync-step-1 messages in one
     ``handle_sync_step1_batch`` (one ``diff_mask_kernel`` launch), a
     third from new clients, a third from clients holding the state
     after flush 1, a third up to date; replies equal the twin's byte
     for byte, and 32 sampled clients converge to the room's text and
     state vector after applying theirs;
   - ``engine.state_vectors_batched`` over all rooms
     (``state_vector_kernel``) equals every per-doc state vector;
   - ``checkpoint()`` (one diff-mask launch over the fleet), then
     ``TpuProvider.recover`` on the card: every room's state vector
     equals the twin's and sampled texts equal the CPU ``Doc``;
   with the host times of the storm's phases, the checkpoint and the
   recovery;
5. kernels: each kernel against its plain version on the card at its
   path's largest shapes (exact), with times from CUDA events (``ms``:
   per call, launch gaps included), device time from ``torch.profiler``
   (``device_ms``) and the byte bound, printed as one
   ``{"kernels": [...]}`` line; each row's ``launches`` is its path's
   count (counts are zeroed just before each path and read just after);
6. the last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import random
import struct
import subprocess
import sys
import tempfile
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
N_SAMPLED_CLIENTS = 32
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


MAIN_KERNELS = (
    ("apply_lanes", lambda a: a[1].numel()),
    ("scatter_rows", lambda a: a[4].numel()),
    ("list_ranks", lambda a: a[0].numel()),
)
PROVIDER_KERNELS = (
    ("state_vector_kernel", lambda a: a[0].numel()),
    ("diff_mask_kernel", lambda a: a[0].numel()),
)


class Capture:
    """Keeps the largest input each kernel wrapper saw on a path (for
    the kernel phase), delegating every call to the wrapper itself."""

    def __init__(self, kernels, watched, device_type: str = "cuda"):
        self.kernels = kernels
        self.watched = watched
        self.device_type = device_type
        self.seen: dict = {}
        self._orig = {}

    def __enter__(self):
        k = self.kernels
        for name, size in self.watched:
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


def assert_twins(eng, twin, what: str, tag: str = "main") -> None:
    for name in ("_right", "_deleted", "_starts"):
        a, b = getattr(eng, name), getattr(twin, name)
        check(a.shape == b.shape, f"{what}: {name} shape {a.shape} vs {b.shape}")
        check(torch.equal(a.cpu(), b), f"{what}: {name} differs from the CPU twin")
    log(f"[{tag}] {what}: device tables equal the CPU twin "
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
    from yjs_tpu_torch.ops import kernels as K

    eng = BatchEngine(2, device="cuda")
    eng.queue_update(0, trace)
    eng.flush()
    eng.text(0)
    one = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    K.state_vector_kernel(one, one, 1)
    K.diff_mask_kernel(one, one, one, one)
    torch.cuda.synchronize()


def seeded_edits(Y, traces: list[bytes]) -> dict[int, list[bytes]]:
    """The seeded editors' edits of the first N_EDITED traces."""
    return {t: editor_edits(Y, traces[t], t)
            for t in range(min(N_EDITED, len(traces)))}


def main_path(device: str, n_docs: int, traces: list[bytes],
              edits: dict[int, list[bytes]]) -> dict:
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
    for t, ups in edits.items():
        for i in range(t, n_docs, len(traces)):
            for u in ups:
                eng.queue_update(i, u)
                twin.queue_update(i, u)
            log_of[i].extend(ups)
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


class StormTimer:
    """Host times of one reconnect storm on the card's engine: the
    column build, the H2D copies and the diff kernel are wrapped, each
    between two synchronises, so a phase's device work counts where it
    was queued; the rest of ``sync_step2_batch`` is the read-back and
    the per-reply encode, the rest of ``handle_sync_step1_batch`` the
    provider's decoding and framing."""

    def __init__(self, eng, kernels):
        self.eng = eng
        self.kernels = kernels
        self.t = {"columns": 0.0, "h2d": 0.0, "kernel": 0.0, "step2": 0.0}
        self._kernel = None

    def _wrap(self, key, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.t[key] += time.perf_counter() - t0
            return out

        return timed

    def __enter__(self):
        eng = self.eng
        eng._sync_columns = self._wrap("columns", eng._sync_columns)
        eng._put_r = self._wrap("h2d", eng._put_r)
        eng.sync_step2_batch = self._wrap("step2", eng.sync_step2_batch)
        self._kernel = self.kernels.diff_mask_kernel
        self.kernels.diff_mask_kernel = self._wrap("kernel", self._kernel)
        return self

    def __exit__(self, *exc):
        for name in ("_sync_columns", "_put_r", "sync_step2_batch"):
            delattr(self.eng, name)
        self.kernels.diff_mask_kernel = self._kernel
        return False


def step1_message(sv: bytes) -> bytes:
    """A sync-step-1 frame carrying an encoded state vector."""
    from yjs_tpu_torch.lib0 import encoding
    from yjs_tpu_torch.sync import protocol

    enc = encoding.Encoder()
    encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_1)
    encoding.write_var_uint8_array(enc, sv)
    return enc.to_bytes()


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def provider_path(n_docs: int, traces: list[bytes],
                  edits: dict[int, list[bytes]]) -> dict:
    """Drive ``TpuProvider`` on the card beside a CPU twin through
    ingest, two flushes, a reconnect storm, batched state vectors, a
    checkpoint and a recovery; returns the host times."""
    import gc

    import yjs_tpu_torch as Y
    import yjs_tpu_torch.updates as U
    from yjs_tpu_torch.lib0.decoding import Decoder
    from yjs_tpu_torch.lib0.encoding import Encoder
    from yjs_tpu_torch.ops import kernels as K
    from yjs_tpu_torch.provider import TpuProvider
    from yjs_tpu_torch.sync import protocol

    guid = [f"r{i}" for i in range(n_docs)]
    held = [traces[i % len(traces)] for i in range(n_docs)]
    log_of = {i: [held[i]] for i in range(n_docs)}
    times = {}
    with tempfile.TemporaryDirectory() as card_dir, \
            tempfile.TemporaryDirectory() as twin_dir:
        card = TpuProvider(n_docs, wal_dir=card_dir)
        twin = TpuProvider(n_docs, wal_dir=twin_dir, device="cpu")
        check(card.engine.device.type == "cuda",
              "the default provider is not on the card")

        # ingest (journaled) and flush 1
        _, times["ingest"] = timed(lambda: [
            card.receive_update(guid[i], held[i]) for i in range(n_docs)
        ])
        for i in range(n_docs):
            twin.receive_update(guid[i], held[i])
        _, times["flush1"] = timed(card.flush)
        twin.flush()
        assert_twins(card.engine, twin.engine, "flush 1", "provider")
        doc_of = [card.doc_id(g) for g in guid]
        sv1 = [card.engine.encode_state_vector(doc_of[i]) for i in range(n_docs)]

        # flush 2: the seeded editors' edits
        edited = []
        for t, ups in edits.items():
            for i in range(t, n_docs, len(traces)):
                for u in ups:
                    card.receive_update(guid[i], u)
                    twin.receive_update(guid[i], u)
                log_of[i].extend(ups)
                edited.append(i)
        _, times["flush2"] = timed(card.flush)
        twin.flush()
        assert_twins(card.engine, twin.engine, "flush 2", "provider")

        # the reconnect storm: new, flush-1 and up-to-date clients
        empty = Y.encode_state_vector(Y.Doc())
        client_sv = [
            (empty, sv1[i], card.engine.encode_state_vector(doc_of[i]))[i % 3]
            for i in range(n_docs)
        ]
        msgs = [(guid[i], step1_message(client_sv[i])) for i in range(n_docs)]
        before = K.launches["diff_mask"]
        with StormTimer(card.engine, K) as storm:
            replies, times["storm"] = timed(
                lambda: card.handle_sync_step1_batch(msgs)
            )
        check(K.launches["diff_mask"] == before + 1,
              "the storm did not take exactly one diff_mask launch")
        twin_replies = twin.handle_sync_step1_batch(msgs)
        bad = sum(a != b for a, b in zip(replies, twin_replies))
        check(len(replies) == n_docs and bad == 0,
              f"{bad} storm replies differ from the CPU twin's")
        reply_bytes = sum(len(r) for r in replies)
        gen = random.Random(2)
        others = sorted(set(range(n_docs)) - set(edited))
        half = N_SAMPLED_CLIENTS // 2
        sample = sorted(gen.sample(edited, min(half, len(edited)))
                        + gen.sample(others, min(half, len(others))))
        for i in sample:
            d = Y.Doc(gc=False)
            for u in (
                [], [held[i]], log_of[i]
            )[i % 3]:
                Y.apply_update(d, u)
            protocol.read_sync_message(Decoder(replies[i]), Encoder(), d)
            want = card.text(guid[i])
            check(d.get_text("text").to_string() == want,
                  f"room {guid[i]}: client text differs after the reply")
            check(Y.decode_state_vector(Y.encode_state_vector(d))
                  == card.state_vector(guid[i]),
                  f"room {guid[i]}: client state vector differs")
            oracle = Y.Doc(gc=False)
            for u in log_of[i]:
                Y.apply_update(oracle, u)
            check(oracle.get_text("text").to_string() == want,
                  f"room {guid[i]}: provider text differs from the CPU Doc")
        log(f"[provider] storm: {n_docs} replies ({reply_bytes} bytes) equal "
            f"the CPU twin's; {len(sample)} sampled clients converged")

        # state vectors of the whole fleet in one launch
        before = K.launches["state_vector"]
        svs, times["state_vectors"] = timed(
            lambda: card.engine.state_vectors_batched(doc_of)
        )
        check(K.launches["state_vector"] == before + 1,
              "state_vectors_batched did not take exactly one launch")
        check(svs == [card.engine.state_vector(i) for i in doc_of],
              "batched state vectors differ from the per-doc ones")
        log(f"[provider] state_vectors_batched: {n_docs} state vectors equal "
            "the per-doc ones")

        # checkpoint (one diff-mask launch over the fleet), crash, recover
        before = K.launches["diff_mask"]
        stats, times["checkpoint"] = timed(card.checkpoint)
        check(K.launches["diff_mask"] == before + 1,
              "the checkpoint did not take exactly one diff_mask launch")
        check(stats["docs"] == n_docs, f"checkpoint covered {stats['docs']} docs")
        card.wal.abandon()
        del card
        gc.collect()
        # replay validates every record before it queues it: time that
        # share of the recovery (replay_wal imports the function per call)
        validate = U.validate_update
        spent = [0.0]

        def timed_validate(*args, **kw):
            t0 = time.perf_counter()
            try:
                return validate(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t0

        U.validate_update = timed_validate
        try:
            rec, times["recover"] = timed(lambda: TpuProvider.recover(card_dir))
        finally:
            U.validate_update = validate
        times["recover_validate"] = spent[0]
        check(rec.engine.device.type == "cuda", "recovery left the card")
        lr = rec.last_recovery
        check(lr["outcome"] == "clean" and lr["snapshots_applied"] == n_docs,
              f"recovery: {lr['outcome']}, {lr['snapshots_applied']} snapshots")
        rsv = rec.engine.state_vectors_batched([rec.doc_id(g) for g in guid])
        check(rsv == [twin.state_vector(g) for g in guid],
              "recovered state vectors differ from the CPU twin's")
        for i in sample:
            oracle = Y.Doc(gc=False)
            for u in log_of[i]:
                Y.apply_update(oracle, u)
            check(rec.text(guid[i]) == oracle.get_text("text").to_string(),
                  f"room {guid[i]}: recovered text differs from the CPU Doc")
        log(f"[provider] checkpoint of {n_docs} rooms "
            f"({stats['snapshot_bytes']} snapshot bytes) recovered on the card: "
            f"state vectors equal the twin's, {len(sample)} texts the CPU Doc's")
        times.update({f"storm_{k}": v for k, v in storm.t.items()})
        times["n_replies"] = n_docs
        times["reply_bytes"] = reply_bytes
        del rec, twin
        gc.collect()
    return times


# -- phase 5 ----------------------------------------------------------------------


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


def kernel_phase(seen: dict, launches: dict, pseen: dict,
                 plaunches: dict) -> list[dict]:
    """Each kernel against its plain version on the largest input its
    path gave it (tables as they were before that call); ``launches`` and
    ``plaunches`` are the main and the provider path's counts."""
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
    for row in rows:
        row["path"] = "main"

    # state_vector_kernel at the fleet's state vectors (B = all rooms)
    row_slot, row_end, n_slots = pseen["state_vector_kernel"]
    b, n = row_slot.shape
    got = K.state_vector_kernel(row_slot, row_end, n_slots)
    ref = K.state_vector_kernel_plain(row_slot, row_end, n_slots)
    err = max_abs_err(got, ref)
    ms = cuda_ms(lambda: K.state_vector_kernel(row_slot, row_end, n_slots))
    dev_ms = device_ms(lambda: K.state_vector_kernel(row_slot, row_end, n_slots))
    plain_ms = cuda_ms(
        lambda: K.state_vector_kernel_plain(row_slot, row_end, n_slots)
    )
    # the library call: one scatter_reduce_ "amax" into a zero buffer,
    # out-of-range slots sent to an extra column beforehand
    seg = torch.where((row_slot >= 0) & (row_slot < n_slots), row_slot,
                      torch.full_like(row_slot, n_slots)).long()

    def library():
        return torch.zeros((b, n_slots + 1), dtype=torch.int32,
                           device=row_slot.device).scatter_reduce_(
            1, seg, row_end, "amax", include_self=True)

    check(torch.equal(library()[:, :n_slots], ref),
          "scatter_reduce_ disagrees with the plain state vectors")
    lib_ms = cuda_ms(library)
    nbytes = row_slot.nbytes + row_end.nbytes + got.nbytes
    rows.append({
        "name": "state_vector", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/state_vector.cu",
        "replaces": "yjs_tpu/ops/kernels.py:705",
        "shape": f"B={b} N={n} n_slots={n_slots}", "path": "provider",
        "launches": plaunches["state_vector"], "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": lib_ms,
    })

    # diff_mask_kernel at the reconnect storm's shapes
    row_slot, row_clock, row_end, sv = args = pseen["diff_mask_kernel"]
    b, n = row_slot.shape
    got = K.diff_mask_kernel(*args)
    ref = K.diff_mask_kernel_plain(*args)
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    ms = cuda_ms(lambda: K.diff_mask_kernel(*args))
    dev_ms = device_ms(lambda: K.diff_mask_kernel(*args))
    plain_ms = cuda_ms(lambda: K.diff_mask_kernel_plain(*args))
    nbytes = (row_slot.nbytes + row_clock.nbytes + row_end.nbytes + sv.nbytes
              + got[0].nbytes + got[1].nbytes)
    rows.append({
        "name": "diff_mask", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/diff_mask.cu",
        "replaces": "yjs_tpu/ops/kernels.py:724",
        "shape": f"B={b} N={n} n_slots={sv.shape[1]}", "path": "provider",
        "launches": plaunches["diff_mask"], "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    })
    torch.cuda.synchronize()
    # comparison and timing launches are not the main path's
    K.launches.update(saved)
    for row in rows:
        check(row["launches"] > 0,
              f"{row['name']} never launched on its path ({row['path']})")
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
    import yjs_tpu_torch as Y

    traces = load_traces()
    edits = seeded_edits(Y, traces)
    warm_up(traces[0])
    K.reset_launches()
    t0 = time.perf_counter()
    with Capture(K, MAIN_KERNELS) as cap:
        figures = main_path("cuda", N_DOCS, traces, edits)
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

    # the provider path, with the device sync branch on for the phase
    saved_env = os.environ.get("YTPU_SYNC_DEVICE")
    os.environ["YTPU_SYNC_DEVICE"] = "1"
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        with Capture(K, PROVIDER_KERNELS) as pcap:
            times = provider_path(N_DOCS, traces, edits)
        torch.cuda.synchronize()
    finally:
        if saved_env is None:
            del os.environ["YTPU_SYNC_DEVICE"]
        else:
            os.environ["YTPU_SYNC_DEVICE"] = saved_env
    plaunches = dict(K.launches)
    log(f"[provider] wall {time.perf_counter() - t0:.1f}s; launches {plaunches}")
    for name in ("apply_lanes", "state_vector", "diff_mask"):
        check(plaunches[name] > 0, f"{name} never launched on the provider path")
    st = {k: times[f"storm_{k}"] for k in ("columns", "h2d", "kernel", "step2")}
    encode = st["step2"] - st["columns"] - st["h2d"] - st["kernel"]
    log(f"[provider] host s ({dev['smi']}): ingest {times['ingest']:.3f}, "
        f"flush 1 {times['flush1']:.3f}, flush 2 {times['flush2']:.3f}")
    log(f"[provider] storm of {times['n_replies']} step-1 messages "
        f"({dev['smi']}): total {times['storm']:.4f}s; _sync_columns build "
        f"{st['columns']:.4f}s; H2D {st['h2d']:.4f}s; kernel "
        f"{st['kernel']:.6f}s; D2H + per-reply encode {encode:.4f}s "
        f"({encode / times['n_replies'] * 1e3:.4f} ms a reply); provider "
        f"decode and framing {times['storm'] - st['step2']:.4f}s")
    log(f"[provider] state_vectors_batched {times['state_vectors']:.4f}s; "
        f"checkpoint wall {times['checkpoint']:.3f}s; recover wall "
        f"{times['recover']:.3f}s, of which replay's validate_update "
        f"{times['recover_validate']:.3f}s ({dev['smi']})")
    rows = kernel_phase(cap.seen, launches, pcap.seen, plaunches)
    log(json.dumps({"kernels": rows}))
    log(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
