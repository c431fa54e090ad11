"""The port's ``TpuProvider`` against the JAX package's, on the same bytes.

Every scenario here is a port of a case of ``test_provider.py``,
``test_persistence.py``, ``test_crash_recovery.py``,
``test_transport_faults.py``, ``test_tiering.py`` or
``test_engine_sync.py::test_provider_batch_handshake``, at a small size.
It runs once on each side: ``yjs_tpu.provider.TpuProvider`` (JAX on the
CPU) and ``yjs_tpu_torch.provider.TpuProvider(device="cpu")`` (the
kernels' plain PyTorch versions), each with the persistence, sync,
tiering and resilience modules of its own package, fed update bytes made
once from a seed.  Each run checks its own side against a CPU ``Doc``
where the original case does, and returns what it observed (texts, state
vectors, canonical bytes, reply bytes, recovery stats); the two sides'
observations must be equal.  Nothing compares wall clocks: tiering heat,
flush ticks and session timers are left at rest or driven by ticks.

Both sides flush synchronously (``YTPU_FLUSH_PIPELINE=0``): the
pipelined JAX engine sometimes leaves wrong device tables (ROADMAP R1).
Where R1 says the reference disagrees with the oracle (redelivery after
a flush), the port is held to the CPU ``Doc`` first and to the
reference only where the reference agrees with the oracle.
"""

from __future__ import annotations

import json
import random
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import yjs_tpu
import yjs_tpu as Y
import yjs_tpu.persistence
import yjs_tpu.provider
import yjs_tpu.resilience
import yjs_tpu.sync
import yjs_tpu.sync.session
import yjs_tpu.sync.transport
import yjs_tpu.tiering
import yjs_tpu_torch
import yjs_tpu_torch.persistence
import yjs_tpu_torch.provider
import yjs_tpu_torch.resilience
import yjs_tpu_torch.sync
import yjs_tpu_torch.sync.session
import yjs_tpu_torch.sync.transport
import yjs_tpu_torch.tiering
from yjs_tpu.lib0 import encoding as jax_encoding
from yjs_tpu.lib0.decoding import Decoder
from yjs_tpu.lib0.encoding import Encoder
from yjs_tpu_torch.lib0 import encoding as torch_encoding

WAL_FIXTURES = Path(__file__).parent / "fixtures" / "wal"


def _side(pkg, name, **provider_kw):
    prov = pkg.provider.TpuProvider

    def new(n, **kw):
        return prov(n, **provider_kw, **kw)

    def recover(path, **kw):
        return prov.recover(path, **provider_kw, **kw)

    return SimpleNamespace(
        name=name, new=new, recover=recover,
        ProviderFullError=pkg.provider.ProviderFullError,
        persistence=pkg.persistence, resilience=pkg.resilience,
        protocol=pkg.sync.protocol, session=pkg.sync.session,
        transport=pkg.sync.transport, tiering=pkg.tiering,
        encoding=jax_encoding if pkg is yjs_tpu else torch_encoding,
        Y=pkg,
    )


JAX = _side(yjs_tpu, "jax")
PORT = _side(yjs_tpu_torch, "torch", device="cpu")


@pytest.fixture(autouse=True)
def _sync_flush(monkeypatch):
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")


def both(scenario, tmp_path=None, **kw):
    """Run ``scenario(side, workdir, **kw)`` on the JAX and the port
    side (each in its own directory) and require equal observations."""
    seen = {}
    for side in (JAX, PORT):
        work = None
        if tmp_path is not None:
            work = tmp_path / side.name
            work.mkdir()
        seen[side.name] = scenario(side, work, **kw)
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


# -- traffic, made once from seeds ----------------------------------------------


def doc(client_id, text="", gc=False, core=Y):
    """A client ``Doc`` of ``core`` (the package whose sync protocol
    will drive it; both cores write the same bytes)."""
    d = core.Doc(gc=gc)
    d.client_id = client_id
    if text:
        d.get_text("text").insert(0, text)
    return d


def upd(text, cid=1):
    return Y.encode_state_as_update(doc(cid, text))


def client_stream(seed, n_ops=50, n_clients=3, base=1000, alphabet="abcdef "):
    """Per-op incremental updates of independent editing clients and the
    oracle text they merge to."""
    gen = random.Random(seed)
    docs, updates = [], []
    for k in range(n_clients):
        d = doc(base + k)
        d.on("update", lambda u, origin, dd: updates.append(bytes(u)))
        docs.append(d)
    for _ in range(n_ops):
        d = gen.choice(docs)
        t = d.get_text("text")
        if len(t) and gen.random() < 0.3:
            t.delete(gen.randrange(len(t)), 1)
        else:
            t.insert(gen.randrange(len(t) + 1), gen.choice(alphabet))
    return updates, oracle_text(updates)


def oracle_doc(updates, core=Y):
    d = core.Doc(gc=False)
    for u in updates:
        core.apply_update(d, u)
    return d


def oracle_text(updates):
    return oracle_doc(updates).get_text("text").to_string()


def phased_streams(seed, rooms=("alpha", "beta"), phases=(30, 12)):
    """test_persistence.py's per-room, per-phase streams of continuing
    client sessions."""
    out = {}
    for j, room in enumerate(rooms):
        gen = random.Random(seed + j)
        docs, updates = [], []
        for k in range(3):
            d = doc(1000 * (j + 1) + k)
            d.on("update", lambda u, origin, dd: updates.append(bytes(u)))
            docs.append(d)
        room_phases = []
        for n in phases:
            for _ in range(n):
                d = gen.choice(docs)
                t = d.get_text("text")
                if len(t) and gen.random() < 0.3:
                    t.delete(gen.randrange(len(t)), 1)
                else:
                    t.insert(gen.randrange(len(t) + 1), gen.choice("abcdef "))
            room_phases.append(list(updates))
            updates.clear()
        out[room] = room_phases
    return out


def canonical(prov, guid):
    return Y.merge_updates([prov.encode_state_as_update(guid)])


def room_state(prov, rooms):
    return {
        r: (prov.text(r), prov.state_vector(r), canonical(prov, r))
        for r in rooms
    }


def step1(side, d):
    enc = Encoder()
    side.protocol.write_sync_step1(enc, d)
    return enc.to_bytes()


def apply_step2(side, d, reply):
    side.protocol.read_sync_message(Decoder(reply), Encoder(), d)


SMALL = dict(segment_bytes=256, fsync="never")


def small(side):
    return side.persistence.WalConfig(**SMALL)


# -- provider (test_provider.py) ----------------------------------------------


def _single_room_two_clients(side, _work):
    prov = side.new(4)
    a, b = doc(1, "from-a ", core=side.Y), doc(2, "from-b ", core=side.Y)
    prov.receive_update("room", Y.encode_state_as_update(a))
    prov.receive_update("room", Y.encode_state_as_update(b))
    replies = []
    for d in (a, b):
        reply = prov.handle_sync_message("room", step1(side, d))
        apply_step2(side, d, reply)
        replies.append(reply)
    assert a.get_text("text").to_string() == b.get_text("text").to_string()
    assert prov.text("room") == a.get_text("text").to_string()
    return replies, room_state(prov, ["room"])


def _many_rooms_batched(side, _work):
    n = 8
    prov = side.new(n)
    docs = [doc(100 + i, f"room-{i} content") for i in range(n)]
    for i, d in enumerate(docs):
        prov.receive_update(f"room{i}", Y.encode_state_as_update(d))
    prov.flush()
    for i, d in enumerate(docs):
        assert prov.text(f"room{i}") == d.get_text("text").to_string()
    return room_state(prov, [f"room{i}" for i in range(n)])


def _unsupported_room_falls_back(side, _work):
    prov = side.new(2)
    d = doc(5)
    d.get_map("meta").set("sub", Y.Doc(guid="child"))  # ContentDoc
    d.get_text("text").insert(0, "t")
    prov.receive_update("mixed", Y.encode_state_as_update(d))
    prov.flush()
    assert prov.text("mixed") == "t"
    return (prov.n_fallback_docs, prov.demotions, prov.metrics["n_demoted"],
            room_state(prov, ["mixed"]))


def _backend_cpu(side, _work):
    prov = side.new(2, backend="cpu")
    d = doc(5, "cpu-only")
    d.get_map("m").set("sub", Y.Doc(guid="child"))
    prov.receive_update("room", Y.encode_state_as_update(d))
    prov.flush()
    assert prov.text("room") == "cpu-only"
    return prov.n_fallback_docs, prov.demotions, room_state(prov, ["room"])


def _backend_device_forbids_fallback(side, _work):
    prov = side.new(2, backend="device")
    ok = doc(6, "fine")
    prov.receive_update("a", Y.encode_state_as_update(ok))
    prov.flush()
    bad = doc(7)
    bad.get_map("m").set("sub", Y.Doc(guid="child"))
    prov.receive_update("b", Y.encode_state_as_update(bad))
    raised = []
    for _ in range(2):
        with pytest.raises(RuntimeError, match="forbids CPU fallback") as e:
            prov.flush()
        raised.append(str(e.value))
        # the alert persists on every flush while the demotion exists
        prov.receive_update("a", Y.encode_state_as_update(ok))
    return raised, prov.n_fallback_docs


def _nested_and_map_rooms(side, _work):
    prov = side.new(3)
    d = doc(5)
    inner = Y.YMap()
    d.get_map("meta").set("nested", inner)
    inner.set("x", 1)
    prov.receive_update("nested", Y.encode_state_as_update(d))
    a, b = doc(5, "t", core=side.Y), doc(6, core=side.Y)
    a.get_map("meta").set("k", 1)
    b.get_map("meta").set("k", 2)  # concurrent LWW conflict
    prov.receive_update("room", Y.encode_state_as_update(a))
    prov.receive_update("room", Y.encode_state_as_update(b))
    prov.flush()
    assert prov.n_fallback_docs == 0
    replies = []
    for c in (a, b):
        reply = prov.handle_sync_message("room", step1(side, c))
        apply_step2(side, c, reply)
        replies.append(reply)
    assert a.get_map("meta").to_json() == b.get_map("meta").to_json()
    room_map = prov.engine.map_json(prov.doc_id("room"), "meta")
    assert room_map == a.get_map("meta").to_json()
    return (prov.engine.map_json(prov.doc_id("nested"), "meta"), room_map,
            replies)


def _flush_metrics(side, _work):
    prov = side.new(4)
    for room in ("r0", "r1"):
        prov.receive_update(room, upd("hello", cid=7))
    prov.flush()
    m = prov.metrics
    assert m["t_total_s"] >= m["t_plan_s"] >= 0.0
    keys = ("n_docs_flushed", "n_demoted", "n_fallback_docs",
            "n_pending_docs", "pending_depth")
    return {k: m[k] for k in keys}, sorted(m)


def fuzz_schedule(seed):
    """test_provider.py's random delivery fuzz, recorded once: the
    provider-side events and each client's full update queue."""
    gen = random.Random(seed)
    n_clients = 3
    docs = [doc(10 + i) for i in range(n_clients)]
    queues = [[] for _ in range(n_clients)]
    for i, d in enumerate(docs):
        d.on("update", lambda u, o, dd, i=i: queues[i].append(bytes(u)))
    events = []
    for _ in range(60):
        i = gen.randrange(n_clients)
        t = docs[i].get_text("text")
        ln = len(t.to_string())
        if gen.random() < 0.7 or ln == 0:
            t.insert(gen.randint(0, ln), gen.choice(["x", "yy", "zzz", "🙂", "word "]))
        else:
            pos = gen.randrange(ln)
            t.delete(pos, min(gen.randint(1, 3), ln - pos))
        if gen.random() < 0.4:
            src = gen.randrange(n_clients)
            if queues[src]:
                k = gen.randint(1, len(queues[src]))
                events.extend(("recv", u) for u in gen.sample(queues[src], k))
        if gen.random() < 0.3:
            events.append(("flush", None))
    return events, queues


def _fuzz_random_delivery(side, _work, seed):
    events, queues = fuzz_schedule(seed)
    prov = side.new(2)
    for kind, u in events:
        if kind == "recv":
            prov.receive_update("room", u)
        else:
            prov.flush()
    for q in queues:
        for u in q:
            prov.receive_update("room", u)
    prov.flush()
    clients = [oracle_doc(q, side.Y) for q in queues]
    replies = []
    for d in clients:
        reply = prov.handle_sync_message("room", step1(side, d))
        apply_step2(side, d, reply)
        replies.append(reply)
    texts = {d.get_text("text").to_string() for d in clients}
    assert texts == {oracle_text([u for q in queues for u in q])}
    assert prov.text("room") in texts
    assert not prov.engine.has_pending(prov.doc_id("room"))
    return replies, room_state(prov, ["room"])


def _observer_replica(side, _work):
    gen = random.Random(7)
    prov = side.new(2)
    observer = doc(999)
    emitted = []

    def on_update(guid, u):
        if guid == "room":
            emitted.append(bytes(u))
            Y.apply_update(observer, u)

    prov.on_update(on_update)
    a, b = doc(1), doc(2)
    pending = []
    for d in (a, b):
        d.on("update", lambda u, o, dd: pending.append(bytes(u)))
    for step in range(30):
        d = gen.choice((a, b))
        t = d.get_text("text")
        ln = len(t.to_string())
        if gen.random() < 0.7 or ln == 0:
            t.insert(gen.randint(0, ln), gen.choice(["x", "yy", "🙂"]))
        else:
            t.delete(gen.randrange(ln), 1)
        if gen.random() < 0.3:
            a.get_map("meta").set(gen.choice("xyz"), step)
        if gen.random() < 0.5 and pending:
            gen.shuffle(pending)
            for u in pending:
                prov.receive_update("room", u)
            pending.clear()
            prov.flush()
    for u in pending:
        prov.receive_update("room", u)
    prov.flush()
    i = prov.doc_id("room")
    assert observer.get_text("text").to_string() == prov.text("room")
    assert observer.get_map("meta").to_json() == prov.engine.map_json(i, "meta")
    assert not observer.store.pending_clients_struct_refs
    return emitted, room_state(prov, ["room"])


def _emission_after_demotion(side, _work):
    prov = side.new(2)
    observer = doc(998)
    prov.on_update(lambda guid, u: Y.apply_update(observer, u))
    d = doc(3, "pre ")
    prov.receive_update("r", Y.encode_state_as_update(d))
    prov.flush()
    d.get_map("m").set("sub", Y.Doc(guid="child"))
    sv = Y.encode_state_vector(d)
    prov.receive_update("r", Y.encode_state_as_update(d))
    prov.flush()
    assert prov.n_fallback_docs == 1
    d.get_text("text").insert(4, "post")
    prov.receive_update("r", Y.encode_state_as_update(d, sv))
    prov.flush()
    assert observer.get_text("text").to_string() == d.get_text("text").to_string()
    return prov.demotions, room_state(prov, ["r"])


PROVIDER_CASES = {
    "single_room_two_clients": _single_room_two_clients,
    "many_rooms_batched": _many_rooms_batched,
    "unsupported_room_falls_back": _unsupported_room_falls_back,
    "backend_cpu": _backend_cpu,
    "backend_device_forbids_fallback": _backend_device_forbids_fallback,
    "nested_and_map_rooms": _nested_and_map_rooms,
    "flush_metrics": _flush_metrics,
    "observer_replica": _observer_replica,
    "emission_after_demotion": _emission_after_demotion,
}


@pytest.mark.parametrize("case", sorted(PROVIDER_CASES))
def test_provider_case_matches_jax(case):
    both(PROVIDER_CASES[case])


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_random_delivery_matches_jax(seed):
    both(_fuzz_random_delivery, seed=seed)


# -- the reconnect storm (test_engine_sync.py::test_provider_batch_handshake) --


def _batch_handshake(side, _work):
    n = 6
    prov = side.new(n)
    clients, histories = [], []
    for i in range(n):
        updates, _ = client_stream(60 + i, n_ops=12, n_clients=2, base=200 + 10 * i)
        for u in updates:
            prov.receive_update(f"r{i}", u)
        histories.append(updates)
        # new client, prefix holder, up-to-date client
        cut = [0, len(updates) // 2, len(updates)][i % 3]
        clients.append(oracle_doc(updates[:cut], side.Y))
    prov.flush()
    msgs = [(f"r{i}", step1(side, d)) for i, d in enumerate(clients)]
    replies = prov.handle_sync_step1_batch(msgs)
    for i, (d, reply) in enumerate(zip(clients, replies)):
        apply_step2(side, d, reply)
        assert d.get_text("text").to_string() == prov.text(f"r{i}")
        sv = side.Y.decode_state_vector(side.Y.encode_state_vector(d))
        assert sv == prov.state_vector(f"r{i}")
    svs = prov.engine.state_vectors_batched(list(range(n)))
    assert svs == [prov.engine.state_vector(i) for i in range(n)]
    return replies, svs


@pytest.mark.parametrize("sync_device", ["0", "1"])
def test_provider_batch_handshake_matches_jax(monkeypatch, sync_device):
    if sync_device == "1":
        monkeypatch.setenv("YTPU_SYNC_DEVICE", "1")
    else:
        monkeypatch.delenv("YTPU_SYNC_DEVICE", raising=False)
    both(_batch_handshake)


# -- durability (test_persistence.py) -------------------------------------------


def _recover_matches_reference(side, work, backend):
    streams = phased_streams(seed=11)
    ref = side.new(2, backend=backend)
    victim = side.new(2, backend=backend, wal_dir=work, wal_config=small(side))
    for room, (p1, p2) in streams.items():
        for u in p1 + p2:
            ref.receive_update(room, u)
            victim.receive_update(room, u)
    victim.flush()
    assert len(side.persistence.list_segments(work)) > 1
    victim.wal.abandon()
    rec = side.recover(work, backend=backend)
    assert rec.last_recovery["outcome"] == "clean"
    for room in streams:
        assert rec.text(room) == ref.text(room)
        assert canonical(rec, room) == canonical(ref, room)
    return room_state(rec, streams), rec.last_recovery["records_applied"]


@pytest.mark.parametrize("backend", ["cpu", "auto"])
def test_recover_matches_uninterrupted_reference(tmp_path, backend):
    both(_recover_matches_reference, tmp_path, backend=backend)


def _recover_integrates_on_auto(side, work):
    streams = phased_streams(seed=77)
    prov = side.new(2, wal_dir=work, wal_config=small(side))
    for room, (p1, p2) in streams.items():
        for u in p1 + p2:
            prov.receive_update(room, u)
    prov.flush()
    texts = {room: prov.text(room) for room in streams}
    prov.close()
    assert side.persistence.list_segments(work) == []
    rec = side.recover(work)
    assert rec.last_recovery["snapshots_applied"] == 2
    for room in streams:
        assert rec.text(room) == texts[room] == oracle_text(sum(streams[room], []))
    return room_state(rec, streams)


def test_recover_integrates_without_new_traffic_on_auto(tmp_path):
    both(_recover_integrates_on_auto, tmp_path)


def _checkpoint_compacts_and_recovers(side, work, backend):
    streams = phased_streams(seed=22)
    prov = side.new(2, backend=backend, wal_dir=work, wal_config=small(side))
    for room, (p1, _p2) in streams.items():
        for u in p1:
            prov.receive_update(room, u)
    before = len(side.persistence.list_segments(work))
    stats = prov.checkpoint()
    assert stats["docs"] == 2 and stats["segments_removed"] == before
    assert len(side.persistence.list_checkpoints(work)) == 1
    for room, (_p1, p2) in streams.items():
        for u in p2:
            prov.receive_update(room, u)
    prov.flush()
    prov.wal.abandon()
    rec = side.recover(work, backend=backend)
    assert rec.last_recovery["snapshots_applied"] == 2
    for room in streams:
        assert rec.text(room) == oracle_text(sum(streams[room], []))
    rec.checkpoint()
    assert len(side.persistence.list_checkpoints(work)) == 1
    return room_state(rec, streams), {
        k: stats[k] for k in ("docs", "segments_removed")
    }


@pytest.mark.parametrize("sync_device", ["0", "1"])
@pytest.mark.parametrize("backend", ["cpu", "auto"])
def test_checkpoint_compacts_and_recovers(tmp_path, monkeypatch, backend,
                                          sync_device):
    """With ``YTPU_SYNC_DEVICE=1`` on the auto backend the checkpoint's
    snapshots come from the diff kernel (one batched launch)."""
    if sync_device == "1":
        monkeypatch.setenv("YTPU_SYNC_DEVICE", "1")
    else:
        monkeypatch.delenv("YTPU_SYNC_DEVICE", raising=False)
    both(_checkpoint_compacts_and_recovers, tmp_path, backend=backend)


def _close_writes_final_checkpoint(side, work):
    streams = phased_streams(seed=33, phases=(20,))
    prov = side.new(2, wal_dir=work, wal_config=small(side))
    for room, (p1,) in streams.items():
        for u in p1:
            prov.receive_update(room, u)
    prov.close()
    assert len(side.persistence.list_checkpoints(work)) == 1
    assert side.persistence.list_segments(work) == []
    with pytest.raises(RuntimeError):
        prov.wal.append(side.persistence.KIND_UPDATE, "alpha", b"x")
    rec = side.recover(work)
    return room_state(rec, streams)


def test_close_writes_final_checkpoint(tmp_path):
    both(_close_writes_final_checkpoint, tmp_path)


def _torn_tail(side, work):
    streams = phased_streams(seed=44)
    ref = side.new(2, backend="cpu")
    victim = side.new(2, backend="cpu", wal_dir=work, wal_config=small(side))
    for room, (p1, _p2) in streams.items():
        for u in p1:
            ref.receive_update(room, u)
            victim.receive_update(room, u)
    victim.wal.abandon()
    _idx, last = side.persistence.list_segments(work)[-1]
    assert side.resilience.DiskFaultInjector(seed=1234).tear(last) > 0
    rec = side.recover(work, backend="cpu")
    lr = dict(rec.last_recovery)
    assert lr["outcome"] == "torn_tail" and lr["torn_truncations"] >= 1
    for room in streams:
        diff = ref.encode_state_as_update(
            room, Y.encode_state_vector_from_update(canonical(rec, room))
        )
        rec.receive_update(room, diff)
        assert canonical(rec, room) == canonical(ref, room)
    rec.wal.abandon()
    assert side.recover(work, backend="cpu").last_recovery["torn_truncations"] == 0
    return room_state(rec, streams), lr["outcome"], lr["records_applied"]


def test_torn_tail_truncated_and_reconverges(tmp_path):
    both(_torn_tail, tmp_path)


def _midlog_corruption(side, work):
    streams = phased_streams(seed=55)
    prov = side.new(2, backend="cpu", wal_dir=work, wal_config=small(side))
    for room, (p1, p2) in streams.items():
        for u in p1 + p2:
            prov.receive_update(room, u)
    prov.flush()
    prov.wal.abandon()
    segs = side.persistence.list_segments(work)
    off = side.resilience.DiskFaultInjector(seed=5).bitflip(
        segs[0][1], lo=len(side.persistence.SEG_HEADER)
    )
    rec = side.recover(work, backend="cpu")
    lr = rec.last_recovery
    assert lr["outcome"] == "corrupt_records" and lr["corrupt_records"] >= 1
    reasons = [d["reason"] for d in rec.dead_letters()]
    assert any(r.startswith("wal-corrupt") for r in reasons)
    return (off, lr["corrupt_records"], lr["records_applied"], reasons,
            room_state(rec, streams))


def test_midlog_corruption_dead_letters_not_aborts(tmp_path):
    both(_midlog_corruption, tmp_path)


def _recovery_idempotent(side, work):
    streams = phased_streams(seed=66)
    prov = side.new(2, backend="cpu", wal_dir=work, wal_config=small(side))
    for room, (p1, _p2) in streams.items():
        for u in p1:
            prov.receive_update(room, u)
    prov.checkpoint()
    for room, (_p1, p2) in streams.items():
        for u in p2:
            prov.receive_update(room, u)
    prov.flush()
    prov.wal.abandon()
    once = side.recover(work, backend="cpu")
    first = room_state(once, streams)
    side.persistence.replay_wal(once, work, exclude_from=once.wal.first_index)
    assert room_state(once, streams) == first
    docs = sorted(once._guid_of)
    batch = once.engine.encode_states_batched(docs)
    for i, u in zip(docs, batch):
        assert Y.merge_updates([u]) == first[once._guid_of[i]][2]
    twice = side.recover(work, backend="cpu")
    assert room_state(twice, streams) == first
    return first


def test_recovery_idempotent_same_wal_twice(tmp_path):
    both(_recovery_idempotent, tmp_path)


def _prefix_then_full(side, work):
    streams = phased_streams(seed=77)
    prov = side.new(2, backend="cpu", wal_dir=work, wal_config=small(side))
    for room, (p1, p2) in streams.items():
        for u in p1 + p2:
            prov.receive_update(room, u)
    prov.flush()
    prov.wal.abandon()
    segs = side.persistence.list_segments(work)
    cut = segs[len(segs) // 2][0]
    full = side.new(2, backend="cpu")
    side.persistence.replay_wal(full, work, truncate_torn=False)
    prefixed = side.new(2, backend="cpu")
    side.persistence.replay_wal(prefixed, work, exclude_from=cut, truncate_torn=False)
    side.persistence.replay_wal(prefixed, work, truncate_torn=False)
    assert room_state(prefixed, streams) == room_state(full, streams)
    return room_state(full, streams)


def test_recovery_idempotent_prefix_then_full(tmp_path):
    both(_prefix_then_full, tmp_path)


def _dlq_survives_checkpoint(side, work):
    (good,) = phased_streams(seed=88, phases=(20,))["alpha"]
    prov = side.new(2, backend="cpu", wal_dir=work, wal_config=small(side))
    for u in good[:-1]:
        prov.receive_update("alpha", u)
    prov.engine._dead_letter(prov.doc_id("alpha"), good[-1], False, "test-hold")
    prov.checkpoint()
    prov.wal.abandon()
    rec = side.recover(work, backend="cpu")
    assert rec.last_recovery["dlq_restored"] == 1
    assert [d["reason"] for d in rec.dead_letters("alpha")] == ["test-hold"]
    res = rec.replay_dead_letters("alpha")
    assert res["replayed"] == 1
    assert rec.text("alpha") == oracle_text(good)
    return res, room_state(rec, ["alpha"])


def test_dlq_survives_checkpoint_and_replays(tmp_path):
    both(_dlq_survives_checkpoint, tmp_path)


def _recovery_overflow(side, work):
    streams = phased_streams(seed=33, rooms=("alpha", "beta", "gamma"), phases=(10,))
    prov = side.new(3, backend="cpu", wal_dir=work, wal_config=small(side))
    for room, (p1,) in streams.items():
        for u in p1:
            prov.receive_update(room, u)
    prov.flush()
    prov.wal.abandon()
    rec = side.recover(work, n_docs=2, backend="cpu")
    stats = rec.last_recovery
    assert stats["overflowed"] >= 1
    admitted = [r for r in streams if rec.has_doc(r)]
    letters = [e["reason"] for e in rec.dead_letters()
               if e["reason"].startswith("wal-overflow:")]
    assert len(letters) == stats["overflowed"]
    overflow = rec.engine.obs.registry.get("ytpu_wal_recovery_overflow_total")
    assert overflow.value == stats["overflowed"]
    return admitted, letters, room_state(rec, admitted)


def test_recovery_overflow_dead_letters_instead_of_dropping(tmp_path):
    both(_recovery_overflow, tmp_path)


def _release_reuse(side, work):
    streams = phased_streams(seed=99, phases=(15,))
    prov = side.new(2, backend="cpu", wal_dir=work, wal_config=small(side))
    for room, (p1,) in streams.items():
        for u in p1:
            prov.receive_update(room, u)
    with pytest.raises(side.ProviderFullError, match="provider is full"):
        prov.doc_id("gamma")
    slot = prov.doc_id("beta")
    final = prov.release_doc("beta")
    evicted = prov.engine.obs.registry.counter(
        "ytpu_provider_docs_evicted_total").value
    assert evicted == 1
    assert Y.merge_updates([final]) == Y.merge_updates(
        [Y.encode_state_as_update(oracle_doc(streams["beta"][0]))])
    assert prov.doc_id("gamma") == slot and prov.text("gamma") == ""
    prov.receive_update("gamma", streams["beta"][0][0])
    prov.flush()
    prov.wal.abandon()
    rec = side.recover(work, n_docs=2, backend="cpu")
    assert rec.last_recovery["released"] == 1
    assert sorted(rec._guids) == ["alpha", "gamma"]
    return Y.merge_updates([final]), room_state(rec, ["alpha", "gamma"])


def test_full_release_reuse_and_eviction_counter(tmp_path):
    both(_release_reuse, tmp_path)


def _fixture_corpus(side, work, case):
    dest = work / "wal"
    shutil.copytree(WAL_FIXTURES / case["dir"], dest)
    prov = side.recover(dest, backend="cpu")
    lr = prov.last_recovery
    exp = case["expected"]
    assert lr["outcome"] == exp["outcome"]
    assert lr["torn_truncations"] == exp["torn_truncations"]
    assert lr["corrupt_records"] == exp["corrupt_records"]
    texts = {g: prov.text(g) for g in sorted(prov._guids)}
    assert texts == exp["texts"]
    return room_state(prov, sorted(prov._guids))


def _fixture_cases():
    manifest = json.loads((WAL_FIXTURES / "manifest.json").read_text())
    return [pytest.param(c, id=c["dir"]) for c in manifest["cases"]]


@pytest.mark.parametrize("case", _fixture_cases())
def test_fixture_corpus_recovers_as_recorded(tmp_path, case):
    both(_fixture_corpus, tmp_path, case=case)


def test_wal_metric_families_register_on_the_port_registry():
    prov = PORT.new(1)
    names = set(prov.engine.obs.registry.names())
    assert names == set(JAX.new(1).engine.obs.registry.names())
    assert {"ytpu_wal_records_appended_total",
            "ytpu_provider_docs_evicted_total"} <= names
    # the registry is the port's own object, not the JAX package's
    assert type(prov.engine.obs.registry).__module__.startswith("yjs_tpu_torch.")


def test_protocol_counters_move_on_the_port_registry_only():
    from yjs_tpu.obs import global_registry as jax_registry
    from yjs_tpu_torch.obs import global_registry as port_registry

    def frames(reg):
        fam = reg().get("ytpu_sync_messages_total")
        return sorted(
            (tuple(sorted(labels.items())), series.value)
            for labels, series in fam.samples()
        )

    jax_before = frames(jax_registry)
    port_before = frames(port_registry)
    prov = PORT.new(1)
    prov.receive_update("r", upd("hello"))
    prov.handle_sync_message("r", step1(PORT, doc(5, core=PORT.Y)))
    assert frames(jax_registry) == jax_before
    assert frames(port_registry) != port_before


# -- crash chaos (test_crash_recovery.py) --------------------------------------


EVERYTHING = dict(corrupt=0.15, truncate=0.1, duplicate=0.25, reorder=0.6, drop=0.15)


def _frame(side, update):
    enc = Encoder()
    side.encoding.write_var_uint(enc, side.protocol.MESSAGE_YJS_UPDATE)
    side.encoding.write_var_uint8_array(enc, update)
    return enc.to_bytes()


def _sync_repair(pa, pb, room, rounds=5):
    for _ in range(rounds):
        reply = pb.handle_sync_message(room, pa.sync_step1(room))
        if reply is not None:
            pa.handle_sync_message(room, reply)
        reply = pa.handle_sync_message(room, pb.sync_step1(room))
        if reply is not None:
            pb.handle_sync_message(room, reply)


def _crash_recover(side, work, backend, crash_seed):
    updates, _ = client_stream(400 + crash_seed)
    inj = side.resilience.ChaosInjector(
        side.resilience.ChaosConfig(seed=crash_seed, **EVERYTHING), kind="frame"
    )
    faulted = inj.apply([_frame(side, u) for u in updates])
    ref = side.new(2, backend=backend)
    victim = side.new(2, backend=backend, wal_dir=work, wal_config=small(side))
    for f in faulted:
        ref.handle_sync_message("room", f)
    c = random.Random(9000 + crash_seed).randrange(1, len(faulted))
    for k, f in enumerate(faulted[:c]):
        victim.handle_sync_message("room", f)
        if k == c // 2 and k > 0:
            victim.checkpoint()
    victim.wal.abandon()
    disk = side.resilience.DiskFaultInjector(seed=7000 + crash_seed)
    segs = side.persistence.list_segments(work)
    if segs:
        disk.tear(segs[-1][1])
        if len(segs) > 1:
            disk.bitflip(segs[0][1], lo=8)
    victim = side.recover(work, n_docs=2, backend=backend, wal_config=small(side))
    lr = victim.last_recovery
    for f in faulted[c:]:
        victim.handle_sync_message("room", f)
    ref.engine.health.reset(None)
    victim.engine.health.reset(None)
    _sync_repair(ref, victim, "room")
    assert victim.text("room") == ref.text("room")
    assert canonical(victim, "room") == canonical(ref, "room")
    return (len(faulted), dict(inj.fault_counts), lr["outcome"],
            lr["corrupt_records"], room_state(victim, ["room"]))


@pytest.mark.parametrize("backend", ["cpu", "auto"])
@pytest.mark.parametrize("crash_seed", range(3))
def test_crash_recover_reconverges_bytewise(tmp_path, backend, crash_seed):
    both(_crash_recover, tmp_path, backend=backend, crash_seed=crash_seed)


# -- transport faults (test_transport_faults.py) ---------------------------------


def _settle(p, room="r"):
    for _ in range(8):
        p.flush()
        if not p.engine.has_pending(p.doc_id(room)):
            break
    return p.text(room)


def _duplicated(side, _work, seed):
    rng = random.Random(seed)
    updates, oracle = client_stream(seed, base=7000, alphabet="abcdefgh ")
    pa, pb = side.new(1), side.new(1)
    for u in updates:
        for _ in range(rng.randrange(1, 4)):
            pa.receive_update("r", u)
        pb.receive_update("r", u)
    assert _settle(pa) == _settle(pb) == oracle
    assert pa.state_vector("r") == pb.state_vector("r")
    return room_state(pa, ["r"])


def _reordered(side, _work, seed):
    rng = random.Random(seed)
    updates, oracle = client_stream(seed, base=7000, alphabet="abcdefgh ")
    shuffled = list(updates)
    rng.shuffle(shuffled)
    pa, pb = side.new(1), side.new(1)
    for u in shuffled:
        pa.receive_update("r", u)
    for u in updates:
        pb.receive_update("r", u)
    assert _settle(pa) == _settle(pb) == oracle
    return room_state(pa, ["r"])


def _mixed_schedules(side, _work, seed):
    rng = random.Random(seed)
    updates, oracle = client_stream(seed, base=7000, alphabet="abcdefgh ")
    provs = [side.new(1) for _ in range(3)]
    for p in provs:
        sched = list(updates)
        rng.shuffle(sched)
        for u in sched:
            p.receive_update("r", u)
            if rng.random() < 0.5:
                p.receive_update("r", u)
            if rng.random() < 0.1:
                p.flush()
    assert [_settle(p) for p in provs] == [oracle] * 3
    return [room_state(p, ["r"]) for p in provs]


@pytest.mark.parametrize("kind", ["duplicated", "reordered", "mixed"])
@pytest.mark.parametrize("seed", [3, 8])
def test_transport_faults_converge_as_jax(kind, seed):
    fn = {"duplicated": _duplicated, "reordered": _reordered,
          "mixed": _mixed_schedules}[kind]
    both(fn, seed=seed)


def _redelivered(side, _work, seed):
    rng = random.Random(seed)
    updates, oracle = client_stream(seed, base=7000, alphabet="abcdefgh ")
    p = side.new(1)
    seen = []
    for u in updates:
        p.receive_update("r", u)
        seen.append(u)
        if rng.random() < 0.2:
            p.flush()
            for old in rng.sample(seen, min(len(seen), 5)):
                p.receive_update("r", old)
    for u in rng.sample(updates, len(updates)):
        p.receive_update("r", u)
    return _settle(p), oracle, room_state(p, ["r"])


@pytest.mark.parametrize("seed", [3, 8, 21])
def test_redelivered_after_flush_converges(seed):
    """ROADMAP R1: the reference can disagree with the oracle here, so
    the port answers to the CPU Doc first and to the reference only
    where the reference is right."""
    text, oracle, state = _redelivered(PORT, None, seed)
    assert text == oracle
    assert state["r"][2] == Y.merge_updates(
        [Y.encode_state_as_update(oracle_doc(client_stream(
            seed, base=7000, alphabet="abcdefgh ")[0]))])
    jax_text, _o, jax_state = _redelivered(JAX, None, seed)
    if jax_text == oracle:
        assert state == jax_state


# -- tiering (test_tiering.py) ----------------------------------------------------


def tiered(side, **kw):
    kw.setdefault("enabled", True)
    return side.tiering.TierConfig(**kw)


def _warm_and_cold_round_trips(side, work):
    p = side.new(3, wal_dir=work, wal_config=small(side), tier_config=tiered(side))
    q = side.new(2, tier_config=tiered(side))  # no WAL: cold keeps a blob
    out = []
    for prov, guid, tier in ((p, "w", "warm"), (q, "b", "cold"), (p, "c", "cold")):
        prov.receive_update(guid, upd(f"{tier} round-trip {guid}"))
        canon = canonical(prov, guid)
        assert prov.demote_doc(guid, tier)
        assert prov.tiers.tier_of(guid) == tier and not prov.has_doc(guid)
        if tier == "cold":
            e = prov.tiers.cold[guid]
            assert (e.ref is None) == (prov is q)
        assert prov.text(guid) == f"{tier} round-trip {guid}"
        assert prov.tiers.tier_of(guid) == "hot"
        assert canonical(prov, guid) == canon
        out.append(canon)
    return out


def _slots_and_eviction(side, _work):
    p = side.new(2, tier_config=tiered(side))
    p.receive_update("a", upd("keep me hot"))
    p.receive_update("b", upd("barely used", cid=2))
    for _ in range(5):
        p.text("a")
    p.receive_update("c", upd("newcomer", cid=3))
    assert p.has_doc("a") and p.has_doc("c") and not p.has_doc("b")
    assert p.tiers.tier_of("b") == "warm"
    assert p.text("b") == "barely used"
    off = side.new(1)
    off.receive_update("a", upd("first"))
    with pytest.raises(side.ProviderFullError):
        off.receive_update("b", upd("second", cid=2))
    return room_state(p, ["a", "b", "c"])


def _churn(side, _work):
    n_slots, n_docs = 2, 24
    p = side.new(n_slots, tier_config=tiered(side))
    texts = {}
    for k in range(n_docs):
        g = f"doc-{k:03d}"
        texts[g] = f"payload {k}"
        p.receive_update(g, upd(texts[g], cid=k + 1))
    rng = random.Random(4)
    for _ in range(40):
        g = rng.choice(sorted(texts))
        assert p.text(g) == texts[g]
    snap = p.tier_snapshot()
    assert snap["resident"] == n_docs and snap["hot"] <= n_slots
    assert p.engine.n_docs == n_slots
    return {k: snap[k] for k in ("resident", "hot", "warm", "cold")}


def _crash_mid_demotion(side, work):
    p = side.new(2, wal_dir=str(work), wal_config=small(side), tier_config=tiered(side))
    p.receive_update("r", upd("survives the torn demote"))
    p.flush()
    canon = canonical(p, "r")
    state = p.encode_state_as_update("r")
    p.wal.append(side.persistence.KIND_TIER, "r",
                 side.persistence.encode_tier_payload("warm", 1.5, state))
    p.wal.abandon()
    pr = side.recover(str(work), n_docs=2, wal_config=small(side),
                      tier_config=tiered(side))
    assert pr.last_recovery["tier_placements"] == {"r": "warm"}
    assert pr.tiers.tier_of("r") == "warm" and not pr.has_doc("r")
    assert canonical(pr, "r") == canon
    return canon, pr.last_recovery["tier_records"]


def _checkpoint_preserves_tiers(side, work):
    p = side.new(3, wal_dir=str(work), wal_config=small(side), tier_config=tiered(side))
    p.receive_update("hot", upd("stays hot"))
    p.receive_update("w", upd("warm across checkpoint", cid=2))
    p.receive_update("c", upd("cold across checkpoint", cid=3))
    canon_w, canon_c = canonical(p, "w"), canonical(p, "c")
    p.demote_doc("w", "warm")
    p.demote_doc("c", "cold")
    p.checkpoint()
    assert canonical(p, "c") == canon_c
    p.demote_doc("c", "cold")
    p.receive_update("hot", upd("post-checkpoint tail", cid=4))
    p.wal.abandon()
    pr = side.recover(str(work), n_docs=3, wal_config=small(side),
                      tier_config=tiered(side))
    placements = pr.last_recovery["tier_placements"]
    assert placements.get("w") == "warm" and placements.get("c") == "cold"
    assert canonical(pr, "w") == canon_w and canonical(pr, "c") == canon_c
    assert "post-checkpoint tail" in pr.text("hot")
    return placements, room_state(pr, ["hot", "w", "c"])


def _letters_ride_demotion(side, _work):
    p = side.new(2, tier_config=tiered(side))
    p.receive_update("r", upd("round trip"))
    p.engine.dead_letters.append(p.doc_id("r"), b"poison-c", False, "test-injected")
    p.demote_doc("r", "cold")
    assert p.engine.dead_letters.list() == []
    p.text("r")
    back = [(e.update, e.reason) for e in p.engine.dead_letters.list(doc=p.doc_id("r"))]
    assert back == [(b"poison-c", "test-injected")]
    final = p.release_doc("r")
    letters = p.engine.dead_letters.list(doc=-1)
    assert [e.update for e in letters] == [b"poison-c"]
    assert "evicted 'r'" in letters[0].reason
    return Y.merge_updates([final]), letters[0].reason


def _live_session_promotion(side, _work):
    cfg = side.session.SessionConfig(
        heartbeat=0, liveness=0, antientropy=2, hello_timeout=0,
        retry_base=4, retry_jitter=0.0, seed=1,
    )
    pa = side.new(2, tier_config=tiered(side))
    pb = side.new(2, tier_config=tiered(side))
    net = side.transport.PipeNetwork()
    ta, tb = net.pair()
    sa = pa.session("room", "pb", cfg)
    sb = pb.session("room", "pa", cfg)
    sa.connect(ta)
    sb.connect(tb)

    def drive():
        pa.flush()
        pb.flush()
        pa.tick_sessions()
        pb.tick_sessions()

    net.settle((drive,))
    d = doc(11, "kept")
    pb.receive_update("room", Y.encode_state_as_update(d))
    net.settle((drive,))
    assert pa.text("room") == "kept"
    assert pa.demote_doc("room", "warm")
    sv = Y.encode_state_vector(d)
    d.get_text("text").insert(0, "next ")
    pb.receive_update("room", Y.encode_state_as_update(d, sv))
    net.settle((drive,), max_rounds=120, idle_rounds=5)
    assert pa.tiers.tier_of("room") == "hot"
    assert pa.text("room") == pb.text("room") == "next kept"
    assert sa.n_full_resyncs == 1 and sb.n_full_resyncs == 1
    assert sa.state == sb.state == "live"
    return room_state(pa, ["room"]), room_state(pb, ["room"])


def _gc_pass(side, _work):
    p = side.new(2, tier_config=tiered(side, gc_min_rows=4, gc_deleted_ratio=0.25))
    d = doc(7)
    t = d.get_text("text")
    for k in range(16):
        sv = Y.encode_state_vector(d)
        t.insert(len(t.to_string()), f"x{k},")
        p.receive_update("r", Y.encode_state_as_update(d, sv))
        p.flush()
    sv = Y.encode_state_vector(d)
    t.delete(0, len(t.to_string()) - 4)
    p.receive_update("r", Y.encode_state_as_update(d, sv))
    before = p.text("r")
    assert before == t.to_string()
    stats = p.tiers.gc_pass()
    assert stats["docs"] == 1 and stats["rows_reclaimed"] > 0
    assert p.text("r") == before
    # bytes_reclaimed counts the mirror's own column bytes, which differ
    # between the native and the Python mirror
    return stats["docs"], stats["rows_reclaimed"], room_state(p, ["r"])


TIER_CASES = {
    "warm_and_cold_round_trips": _warm_and_cold_round_trips,
    "slots_and_eviction": _slots_and_eviction,
    "churn": _churn,
    "crash_mid_demotion": _crash_mid_demotion,
    "checkpoint_preserves_tiers": _checkpoint_preserves_tiers,
    "letters_ride_demotion": _letters_ride_demotion,
    "live_session_promotion": _live_session_promotion,
    "gc_pass": _gc_pass,
}


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_tiering_case_matches_jax(tmp_path, case):
    both(TIER_CASES[case], tmp_path)


# -- WAL compatibility across the two packages ---------------------------------


def _write_wal(side, work):
    """Journal two phases with a checkpoint between them, a demoted room
    and a dead letter, then crash."""
    streams = phased_streams(seed=123)
    prov = side.new(3, wal_dir=str(work), wal_config=small(side),
                    tier_config=tiered(side))
    for room, (p1, _p2) in streams.items():
        for u in p1:
            prov.receive_update(room, u)
    prov.receive_update("gone-warm", upd("demoted before the crash", cid=9))
    prov.demote_doc("gone-warm", "warm")
    prov.engine._dead_letter(prov.doc_id("alpha"), b"\x01\xff", False, "held")
    prov.checkpoint()
    for room, (_p1, p2) in streams.items():
        for u in p2:
            prov.receive_update(room, u)
    prov.flush()
    prov.wal.abandon()
    return {room: oracle_text(sum(phases, [])) for room, phases in streams.items()}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_wal_recovers_across_packages(tmp_path, writer, reader):
    sides = {"jax": JAX, "torch": PORT}
    wdir, same = tmp_path / "cross", tmp_path / "same"
    texts = _write_wal(sides[writer], wdir)
    _write_wal(sides[writer], same)
    rooms = ["alpha", "beta", "gone-warm"]
    got = sides[reader].recover(str(wdir), wal_config=small(sides[reader]),
                                tier_config=tiered(sides[reader]))
    want = sides[writer].recover(str(same), wal_config=small(sides[writer]),
                                 tier_config=tiered(sides[writer]))
    for room, text in texts.items():
        assert got.text(room) == text
    assert got.text("gone-warm") == "demoted before the crash"
    assert room_state(got, rooms) == room_state(want, rooms)
    for key in ("outcome", "snapshots_applied", "records_applied",
                "dlq_restored", "tier_placements"):
        assert got.last_recovery[key] == want.last_recovery[key]
    assert [d["reason"] for d in got.dead_letters()] == [
        d["reason"] for d in want.dead_letters()
    ]


# -- the port's own contract -------------------------------------------------------


def test_default_provider_needs_cuda(tmp_path):
    """The provider runs on the card unless the caller asks for the CPU:
    without CUDA the constructor and recover raise."""
    from yjs_tpu_torch.provider import TpuProvider

    if torch.cuda.is_available():
        assert TpuProvider(1).engine.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuProvider(1)
    prov = TpuProvider(1, device="cpu", wal_dir=str(tmp_path))
    prov.receive_update("r", upd("x"))
    prov.close()
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuProvider.recover(str(tmp_path))
    assert TpuProvider.recover(str(tmp_path), device="cpu").text("r") == "x"


def test_mesh_raises_not_ported():
    with pytest.raises(NotImplementedError, match="mesh"):
        PORT.new(2, mesh=object())


def test_lazy_provider_full_error_is_the_ports_own():
    """``tiering/manager.py`` and ``persistence/recovery.py`` import
    ``ProviderFullError`` lazily; in the port it must be the port's."""
    from yjs_tpu_torch.provider import ProviderFullError

    assert ProviderFullError is not yjs_tpu.provider.ProviderFullError
    p = PORT.new(1, tier_config=tiered(PORT))
    p.receive_update("a", upd("pinned"))
    p.observe("a", ["text"], lambda g, ev: None)  # observed: not evictable
    with pytest.raises(ProviderFullError):
        p.receive_update("b", upd("no room", cid=2))
