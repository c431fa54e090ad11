#!/usr/bin/env python3
"""Drive the PyTorch port's flush and provider paths on one CUDA card and check them.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with an NVIDIA card
(sm_90a: H100/H200).  It imports nothing of JAX or of the JAX package.
Phases, each printed on its own lines; any failed check raises and the
script exits non-zero:

1. device: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: the native plan core (g++) and the seven CUDA sources (one
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
5. YATA path: the on-device YATA lanes at the same width and on the same
   bytes:
   - ``YTPU_KERNEL=levels``: ``BatchEngine(4096)`` on the card beside a
     CPU twin ``BatchEngine(4096, device="cpu")``; flush 1 (the traces),
     then flush 2 (the edits, after compacting every doc of at least 512
     rows); after each, the card's three tables and six resident static
     columns equal the twin's byte for byte, untrimmed, its tables trimmed
     to live rows equal the main path's apply engine's, and every doc's
     current statics equal its mirror's ``static_columns()``; 32 sampled
     docs export text and encoded state from the device tables, checked
     against a CPU ``Doc``;
   - ``YTPU_KERNEL=seq``: ``BatchEngine(4096)`` on the card through the
     same flushes, its trimmed tables equal to the levels and the apply
     engines';
   each flush runs under a CUDA activity trace (``torch.profiler``), and
   its host time is split into plan, pack, statics (host pack; pinned
   copy and launch), dispatch, emit and the closing synchronise, its
   device time into kernels and copies, with the device's idle share;
6. kernels: each kernel against its plain version on the card at its
   path's largest shapes (exact), with times from CUDA events (``ms``:
   per call, launch gaps included; the YATA steps restore their tables
   before each timed launch and time it alone), device time from
   ``torch.profiler`` (``device_ms``) and the byte bound, printed as one
   ``{"kernels": [...]}`` line; each row's ``launches`` is its path's
   count (counts are zeroed just before each path and read just after);
   the YATA steps' rows add the longest per-doc chain of dependent loads
   (``dep_chain``), which limits them (``limited_by``), and the measured
   time per load;
7. the last line: ``{"ok": true, "device": {...}}``.
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
YATA_TIMED_LAUNCHES = 20


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


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (tuple, list)) else ()
    )
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    return x


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
                if _first_tensor(args).device.type == self.device_type:
                    if best is None or _size(args) > _size(best):
                        self.seen[_name] = _clone(args)
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
    saved = os.environ.get("YTPU_KERNEL")
    try:
        for mode in ("levels", "seq"):
            os.environ["YTPU_KERNEL"] = mode
            eng = BatchEngine(2, device="cuda")
            eng.queue_update(0, trace)
            eng.flush()
    finally:
        restore_env("YTPU_KERNEL", saved)
    one = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    K.state_vector_kernel(one, one, 1)
    K.diff_mask_kernel(one, one, one, one)
    torch.cuda.synchronize()


def restore_env(name: str, value) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


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
    from yjs_tpu_torch.ops.carry import trim_tables

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
    # each flush's tables trimmed to live rows: the YATA lanes' yardstick
    trimmed = [trim_tables(eng)]

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
    trimmed.append(trim_tables(eng))

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
        "table_bytes": table_bytes, "trimmed": trimmed,
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


YATA_KERNELS = (
    ("scatter_statics", lambda a: a[1].numel()),
    ("batch_step", lambda a: a[3].numel()),
    ("batch_step_levels", lambda a: a[3].numel()),
)


def device_split(prof) -> dict:
    """Device time inside a traced run, in ms, from its CUDA activity
    records: kernels (the statics scatter, the YATA steps, the rest) and
    copies, ``busy`` the union of all their intervals (record_function
    ranges left out), ``statics_h2d`` the host-to-device copy that the
    statics scatter reads (the last one to start before it)."""
    from torch.autograd import DeviceType

    ivs = []
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name.startswith("ytpu.")):
            continue
        ivs.append((e.time_range.start, e.time_range.end, e.name))
    ivs.sort()
    out = dict.fromkeys(("k3", "step", "kernels", "h2d", "statics_h2d",
                         "copies"), 0.0)
    k3_start = min((a for a, _b, n in ivs if "scatter_statics" in n),
                   default=None)
    busy, hi = 0.0, float("-inf")
    for a, b, name in ivs:
        busy += max(0.0, b - max(a, hi))
        hi = max(hi, b)
        dur = (b - a) / 1e3
        if name.startswith("Memcpy HtoD"):
            out["h2d"] += dur
            if k3_start is not None and a < k3_start:
                out["statics_h2d"] = dur
        elif name.startswith(("Memcpy", "Memset")):
            out["copies"] += dur
        else:
            out["kernels"] += dur
            if "scatter_statics" in name:
                out["k3"] += dur
            elif "batch_step" in name:
                out["step"] += dur
    out["busy"] = busy / 1e3
    return out


def yata_flush(eng) -> dict:
    """One timed flush of an engine on the card under a CUDA activity
    trace: its host time split into plan, pack (without the statics),
    statics (host pack; pinned copy and launches), dispatch, emit and the
    closing synchronise, from the flush metrics and the engine's phase
    spans, and its device time from the trace (:func:`device_split`)."""
    from torch.profiler import ProfilerActivity, profile

    eng.obs.tracer.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = timed_flush(eng)
    spans = {}
    for ev in eng.obs.tracer.trace_events():
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e6
    check("ytpu.statics" in spans and "ytpu.statics_pack" in spans,
          "the flush recorded no statics phase")
    m = dict(eng.last_flush_metrics)
    dev = device_split(prof)
    return {
        "wall": wall, "plan": m["t_plan_s"] + m["t_compact_s"],
        "pack": m["t_pack_s"] - spans["ytpu.statics"],
        "statics_pack": spans["ytpu.statics_pack"],
        "statics_rest": spans["ytpu.statics"] - spans["ytpu.statics_pack"],
        "dispatch": m["t_dispatch_s"], "emit": m["t_emit_s"],
        "sync": wall - m["t_total_s"], "n_levels": m["n_levels"],
        "level_width": m["level_width"], "occupancy": m["schedule_occupancy"],
        "realloc_bytes": m["realloc_bytes"], "device": dev,
        "idle": 1.0 - dev["busy"] / (wall * 1e3),
    }


def log_yata_flush(lane: str, name: str, f: dict, smi: str) -> None:
    d = f["device"]
    log(f"[yata] {lane} {name} ({smi}): wall {f['wall']:.3f}s = plan "
        f"{f['plan']:.3f} + pack {f['pack']:.3f} + statics host pack "
        f"{f['statics_pack']:.3f} + statics pinned copy and launch "
        f"{f['statics_rest']:.3f} + dispatch {f['dispatch']:.3f} + emit "
        f"{f['emit']:.3f} + closing sync {f['sync']:.3f}; "
        f"L={f['n_levels']} W={f['level_width']} "
        f"occupancy {f['occupancy']:.4f}")
    log(f"[yata] {lane} {name} device (CUDA activity trace, ms): busy "
        f"{d['busy']:.3f} = kernels {d['kernels']:.3f} (scatter_statics "
        f"{d['k3']:.3f}, {'batch_step' if lane == 'seq' else 'batch_step_levels'} "
        f"{d['step']:.3f}) + H2D {d['h2d']:.3f} (statics {d['statics_h2d']:.3f})"
        f" + other copies {d['copies']:.3f}, overlaps counted once; idle "
        f"{f['idle']:.6f} of the wall")


def assert_yata_twins(eng, twin, what: str) -> None:
    """Untrimmed, byte for byte: the three tables and six statics."""
    from yjs_tpu_torch.ops.kernels import STATIC_KEYS

    assert_twins(eng, twin, what, "yata")
    for key in STATIC_KEYS:
        a, b = eng._statics[key], twin._statics[key]
        check(a.shape == b.shape and torch.equal(a.cpu(), b),
              f"{what}: static column {key} differs from the CPU twin")
    log(f"[yata] {what}: the six static columns equal the CPU twin "
        f"({tuple(eng._statics['client_key'].shape)} each)")


def assert_trimmed(eng, want: list, what: str) -> list:
    """Tables trimmed to each doc's live rows and segments equal
    ``want`` (another lane's, after the same flushes)."""
    from yjs_tpu_torch.ops.carry import trim_tables

    got = trim_tables(eng)
    check(len(got) == len(want), f"{what}: doc counts differ")
    for i, (g, w) in enumerate(zip(got, want)):
        check((g is None) == (w is None), f"{what}: doc {i} served differently")
        if g is not None:
            check(all(np.array_equal(a, b) for a, b in zip(g, w)),
                  f"{what}: doc {i}'s trimmed tables differ")
    log(f"[yata] {what}: trimmed tables equal")
    return got


def assert_statics_current(eng, must: set, what: str) -> None:
    """Every doc whose statics are current (uploaded rows == its row
    count) holds its mirror's static columns; the docs in ``must`` are
    current.  A doc compacted since its last device-lane flush re-uploads
    lazily, on its next one."""
    from yjs_tpu_torch.ops.kernels import STATIC_KEYS

    host = {k: eng._statics[k].cpu().numpy() for k in STATIC_KEYS}
    current = 0
    for i, m in enumerate(eng.mirrors):
        n = m.n_rows
        if eng._uploaded_rows[i] != n:
            check(i not in must, f"{what}: doc {i}'s statics are not current")
            continue
        cols = m.static_columns()
        cols["client_key"] = cols["client_key"].astype(np.uint32).view(np.int32)
        for k in STATIC_KEYS:
            check(np.array_equal(host[k][i, :n], cols[k]),
                  f"{what}: doc {i}'s {k} differs from its mirror")
        current += 1
    log(f"[yata] {what}: statics of {current} docs equal their mirrors' "
        f"static_columns(); {len(eng.mirrors) - current} await a lazy "
        "re-upload after compaction")


def yata_path(traces: list[bytes], edits: dict[int, list[bytes]],
              apply_trimmed: list, smi: str) -> dict:
    """The on-device YATA lanes at the main path's width: a levels engine
    on the card beside a CPU twin, then a seq engine on the card, through
    the main path's two flushes (flush 2 after the compaction of every
    doc of at least 512 rows); returns the flush splits."""
    import yjs_tpu_torch as Y
    from yjs_tpu_torch.ops import BatchEngine

    n_docs = N_DOCS
    held = [traces[i % len(traces)] for i in range(n_docs)]
    log_of = {i: [held[i]] for i in range(n_docs)}
    edited = set()
    for t, ups in edits.items():
        for i in range(t, n_docs, len(traces)):
            log_of[i].extend(ups)
            edited.add(i)
    saved = os.environ.get("YTPU_KERNEL")
    out = {}
    try:
        os.environ["YTPU_KERNEL"] = "levels"
        eng = BatchEngine(n_docs, device="cuda")
        twin = BatchEngine(n_docs, device="cpu")
        for e in (eng, twin):
            for i in range(n_docs):
                e.queue_update(i, held[i])
        out["levels1"] = yata_flush(eng)
        t0 = time.perf_counter()
        twin.flush()
        out["twin1"] = time.perf_counter() - t0
        log_yata_flush("levels", "flush 1", out["levels1"], smi)
        assert_yata_twins(eng, twin, "levels flush 1")
        lev = [assert_trimmed(eng, apply_trimmed[0],
                              "levels flush 1 against the apply lane")]
        assert_statics_current(eng, set(range(n_docs)), "levels flush 1")

        for e in (eng, twin):
            for t, ups in edits.items():
                for i in range(t, n_docs, len(traces)):
                    for u in ups:
                        e.queue_update(i, u)
        out["levels2"] = yata_flush(eng)
        t0 = time.perf_counter()
        twin.flush()
        out["twin2"] = time.perf_counter() - t0
        out["n_compacted"] = len(eng.last_compaction or [])
        check(out["n_compacted"] > 0, "levels flush 2 compacted no doc")
        check(twin.last_compaction == eng.last_compaction,
              "levels compaction stats differ from the twin's")
        log_yata_flush("levels", "flush 2", out["levels2"], smi)
        assert_yata_twins(eng, twin, "levels flush 2")
        lev.append(assert_trimmed(eng, apply_trimmed[1],
                                  "levels flush 2 against the apply lane"))
        assert_statics_current(eng, edited, "levels flush 2")
        del twin

        # exports from the levels engine's device tables
        gen = random.Random(3)
        others = sorted(set(range(n_docs)) - edited)
        half = N_EXPORTED // 2
        sample = sorted(gen.sample(sorted(edited), min(half, len(edited)))
                        + gen.sample(others, min(half, len(others))))
        for i in sample:
            doc = Y.Doc(gc=False)
            for u in log_of[i]:
                Y.apply_update(doc, u)
            check(eng.text(i) == doc.get_text("text").to_string(),
                  f"doc {i}: levels text differs from the CPU Doc")
            check(Y.merge_updates([eng.encode_state_as_update(i)])
                  == Y.merge_updates([Y.encode_state_as_update(doc)]),
                  f"doc {i}: levels encoded state differs from the CPU Doc")
        log(f"[yata] {len(sample)} sampled docs: levels texts and encoded "
            "states equal the CPU Doc")
        out["statics_bytes"] = int(sum(v.nbytes for v in eng._statics.values()))
        del eng

        os.environ["YTPU_KERNEL"] = "seq"
        eng = BatchEngine(n_docs, device="cuda")
        for i in range(n_docs):
            eng.queue_update(i, held[i])
        out["seq1"] = yata_flush(eng)
        log_yata_flush("seq", "flush 1", out["seq1"], smi)
        assert_trimmed(eng, lev[0], "seq flush 1 against the levels lane")
        assert_trimmed(eng, apply_trimmed[0], "seq flush 1 against the apply lane")
        for t, ups in edits.items():
            for i in range(t, n_docs, len(traces)):
                for u in ups:
                    eng.queue_update(i, u)
        out["seq2"] = yata_flush(eng)
        log_yata_flush("seq", "flush 2", out["seq2"], smi)
        assert_trimmed(eng, lev[1], "seq flush 2 against the levels lane")
        assert_trimmed(eng, apply_trimmed[1], "seq flush 2 against the apply lane")
        del eng
    finally:
        restore_env("YTPU_KERNEL", saved)
    return out


# -- phase 6 ----------------------------------------------------------------------


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


def device_ms(fn, n: int = TIMED_LAUNCHES, restore=None):
    """Mean device time per call of ``fn()``'s kernels, from
    ``torch.profiler`` (None when the profiler records no device time):
    set beside :func:`cuda_ms`, it separates kernel time from launch
    gaps.  ``restore()``, run before every call, puts back tables the
    kernel writes in place; its device-to-device copies are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if restore is not None:
        restore()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if restore is not None:
                restore()
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and not (restore is not None and e.key.startswith("Memcpy"))
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


def cuda_ms_restored(launch, restore, n: int = YATA_TIMED_LAUNCHES) -> float:
    """Mean ms of ``launch()`` over ``n`` calls from CUDA events recorded
    around each launch alone, after a warm-up; ``restore()`` puts the
    tables back before every launch (the kernels write them in place)."""
    restore()
    launch()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        restore()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / n


def once_ms(fn) -> float:
    """ms of one call of ``fn()`` from CUDA events (the plain YATA versions
    take seconds on the card: one timed call after the comparison call)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def yata_bytes(name: str, args, stats) -> int:
    """The bytes the step must move on these inputs: every schedule input
    read once; per integrated item (every seq entry, every deferred level
    lane) one gap read and two link writes (12 B), and for an item whose
    conflict scan visits a row (``scanned``; the rest keep their gap and
    need no statics) its five statics and the splice's link read (24 B);
    per conflict-scan step the visited row's six statics, its link and
    its visit mark read and written (36 B); per level lane slot the gap
    read of a real lane (4 B) and the two link writes every slot makes,
    real or scratch (8 B); per split three link reads or writes and two
    deleted bits (14 B); one byte per delete."""
    splits, sched, dels = args[2], args[3], args[4]
    nbytes = sum(t.nbytes for t in args[2:] if isinstance(t, torch.Tensor))
    real = int((sched[..., 0] >= 0).sum())
    n_splits = int((splits[..., 0] >= 0).sum())
    n_dels = int(((dels >= 0) & (dels < args[1][0].shape[1])).sum())
    steps = int(stats["scan_steps"].sum())
    scanned = int(stats["scanned"].sum())
    if name == "batch_step":
        items = real
    else:
        items = int(stats["deferred"].sum())
        nbytes += 4 * real + 8 * sched[..., 0].numel()
    return (nbytes + 12 * items + 24 * scanned + 36 * steps + 14 * n_splits
            + n_dels)


def yata_rows(yseen: dict, ylaunches: dict) -> list[dict]:
    """K3, K5 and K6 against their plain versions at the largest input the
    YATA path gave each (tables as they were before that call)."""
    from yjs_tpu_torch.ops import kernels as K

    rows = []
    # scatter_statics at flush 1's full upload
    statics, packed = yseen["scatter_statics"]
    got = K.scatter_statics(_clone(statics), packed)
    ref = K.scatter_statics_plain(_clone(statics), packed)
    err = max(max_abs_err(got[k], ref[k]) for k in K.STATIC_KEYS)
    base = _clone(statics)
    ms = cuda_ms(lambda: K.scatter_statics(base, packed))
    dev_ms = device_ms(lambda: K.scatter_statics(base, packed))
    plain_ms = cuda_ms(lambda: K.scatter_statics_plain(base, packed), 5)
    d, r = packed[0].long(), packed[1].long()

    def library():
        for j, key in enumerate(K.STATIC_KEYS):
            base[key].index_put_((d, r), packed[2 + j])

    library()
    check(all(torch.equal(base[k], ref[k]) for k in K.STATIC_KEYS),
          "index_put_ x6 disagrees with the plain statics scatter")
    lib_ms = cuda_ms(library)
    b, n1 = statics["client_key"].shape
    k = packed.shape[1]
    rows.append({
        "name": "scatter_statics", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/statics.cu",
        "replaces": "yjs_tpu/ops/engine.py:152",
        "shape": f"K={k} B={b} N+1={n1}", "path": "yata",
        "launches": ylaunches["scatter_statics"], "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": (packed.nbytes + 24 * k) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": lib_ms,
    })

    # batch_step and batch_step_levels at their largest schedule
    for name, plain, source, line in (
        ("batch_step", K.batch_step_plain, "yata.cu", 327),
        ("batch_step_levels", K.batch_step_levels_plain, "yata.cu", 337),
    ):
        statics, dyn, *rest = yseen[name]
        fn = getattr(K, name)
        b, n1 = dyn[0].shape
        got = fn(statics, _clone(dyn), *rest)
        stats = K.new_yata_stats(b, dyn[0].device)
        ref = _clone(dyn)
        plain_ms = once_ms(lambda: plain(statics, ref, *rest, stats=stats))
        err = max(max_abs_err(g, r) for g, r in zip(got, ref))
        work = _clone(dyn)

        def restore(work=work, dyn=dyn):
            for w, o in zip(work, dyn):
                w.copy_(o)

        def launch(fn=fn, statics=statics, work=work, rest=rest):
            fn(statics, work, *rest)

        ms = cuda_ms_restored(launch, restore)
        dev_ms = device_ms(launch, YATA_TIMED_LAUNCHES, restore)
        nbytes = yata_bytes(name, (statics, dyn, *rest), stats)
        chain = int(stats["chain"].max())
        sched = rest[1]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"yjs_tpu_torch/csrc/{source}",
            "replaces": f"yjs_tpu/ops/kernels.py:{line}",
            "shape": f"B={b} N+1={n1} S+1={dyn[2].shape[1]} "
                     f"schedule={tuple(sched.shape)}",
            "path": "yata",
            "launches": ylaunches[name], "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            # what limits them is not a roofline bound but the longest
            # per-doc chain of dependent loads (kernels.new_yata_stats):
            # each load's address comes from the one before it, so the
            # chain runs at one memory round trip a load however few
            # bytes move; ns_per_dep_load is the measured time per load
            "limited_by": "dep_chain", "dep_chain": chain,
            "ns_per_dep_load": (dev_ms or ms) * 1e6 / max(1, chain),
            "scan_steps": int(stats["scan_steps"].sum()),
            "scanned": int(stats["scanned"].sum()),
            "deferred": int(stats["deferred"].sum()),
        })
    return rows


def kernel_phase(seen: dict, launches: dict, pseen: dict,
                 plaunches: dict, yseen: dict, ylaunches: dict) -> list[dict]:
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
    rows.extend(yata_rows(yseen, ylaunches))
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

    # the on-device YATA lanes at the main path's width
    K.reset_launches()
    t0 = time.perf_counter()
    with Capture(K, YATA_KERNELS) as ycap:
        yfig = yata_path(traces, edits, figures["trimmed"], dev["smi"])
    torch.cuda.synchronize()
    ylaunches = dict(K.launches)
    log(f"[yata] wall {time.perf_counter() - t0:.1f}s; launches {ylaunches}")
    for name, _size in YATA_KERNELS:
        check(ylaunches[name] > 0, f"{name} never launched on the YATA path")
    log(f"[yata] CPU twin (plain kernels) flush 1 {yfig['twin1']:.3f}s, "
        f"flush 2 {yfig['twin2']:.3f}s; statics {yfig['statics_bytes']} "
        f"bytes; flush 2 compacted {yfig['n_compacted']} docs")
    del figures["trimmed"]
    rows = kernel_phase(cap.seen, launches, pcap.seen, plaunches, ycap.seen,
                        ylaunches)
    log(json.dumps({"kernels": rows}))
    log(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
