"""The cases of the JAX package's ``tests/test_chaos.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Chaos suite: deterministic fault injection at the sync
seams, asserting replica convergence under every fault mix.

Two provider replicas receive the same client-update stream through
independently seeded :class:`ChaosInjector` instances (different faults
hit each side), then run the normal 2-step sync repair.  The contract:
whatever the transport does — corrupt, truncate, duplicate, reorder,
drop — the replicas end IDENTICAL (text, state vector, encoded SV
bytes).  Content lost by BOTH sides may be absent, but never divergent;
lossless mixes (dup/reorder only) must match the oracle exactly.

Every test is seeded — a failure replays byte-for-byte.  Runs in tier-1
(the ``chaos`` marker deselects it with ``-m 'not chaos'``).
"""

import random

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.lib0 import encoding
from yjs_tpu_torch.lib0.encoding import Encoder
from torch_service import TpuProvider
from yjs_tpu_torch.resilience import ChaosConfig, ChaosInjector
from yjs_tpu_torch.sync import protocol

pytestmark = pytest.mark.chaos

ROOM = "room"
BACKENDS = ("cpu", "auto")


def client_updates(seed: int, n_ops: int = 60, n_clients: int = 3):
    """Per-op incremental updates from independent editing clients (the
    captured doc.on('update') stream a transport would carry)."""
    gen = random.Random(seed)
    docs = []
    updates: list[bytes] = []
    for k in range(n_clients):
        d = Y.Doc(gc=False)
        d.client_id = 1000 + k
        d.on("update", lambda u, origin, doc: updates.append(bytes(u)))
        docs.append(d)
    for _ in range(n_ops):
        d = gen.choice(docs)
        t = d.get_text("text")
        if len(t) and gen.random() < 0.3:
            t.delete(gen.randrange(len(t)), 1)
        else:
            t.insert(gen.randrange(len(t) + 1), gen.choice("abcdef "))
    oracle = Y.Doc(gc=False)
    for u in updates:
        Y.apply_update(oracle, u)
    return updates, oracle.get_text("text").__str__()


def frame(update: bytes) -> bytes:
    enc = Encoder()
    encoding.write_var_uint(enc, protocol.MESSAGE_YJS_UPDATE)
    encoding.write_var_uint8_array(enc, update)
    return enc.to_bytes()


def sync_repair(pa: TpuProvider, pb: TpuProvider, rounds: int = 3) -> None:
    """Clean bidirectional step1/step2 exchange (the post-chaos network
    heal); several rounds unpark causal cascades."""
    for _ in range(rounds):
        reply = pb.handle_sync_message(ROOM, pa.sync_step1(ROOM))
        if reply is not None:
            pa.handle_sync_message(ROOM, reply)
        reply = pa.handle_sync_message(ROOM, pb.sync_step1(ROOM))
        if reply is not None:
            pb.handle_sync_message(ROOM, reply)


def assert_identical(pa: TpuProvider, pb: TpuProvider) -> None:
    assert pa.text(ROOM) == pb.text(ROOM)
    assert pa.state_vector(ROOM) == pb.state_vector(ROOM)
    # byte-level identity: each replica's full state is a strict no-op
    # on the other (the encoded SV itself may order clients differently
    # — both are valid wire encodings of the same vector)
    for src, dst in ((pa, pb), (pb, pa)):
        text_before = dst.text(ROOM)
        dst.receive_update(
            ROOM, src.engine.encode_state_as_update(src.doc_id(ROOM))
        )
        assert dst.text(ROOM) == text_before
        assert dst.state_vector(ROOM) == src.state_vector(ROOM)


FAULT_MIXES = {
    "dup_reorder": dict(duplicate=0.4, reorder=0.8),
    "corrupt": dict(corrupt=0.25),
    "truncate": dict(truncate=0.25),
    "drop": dict(drop=0.25),
    "everything": dict(
        corrupt=0.15, truncate=0.1, duplicate=0.25, reorder=0.6, drop=0.15
    ),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mix", sorted(FAULT_MIXES))
def test_replicas_converge_under_faults(backend, mix):
    updates, oracle_text = client_updates(seed=101)
    frames = [frame(u) for u in updates]
    pa = TpuProvider(2, backend=backend)
    pb = TpuProvider(2, backend=backend)
    inj_a = ChaosInjector(ChaosConfig(seed=7, **FAULT_MIXES[mix]), kind="frame")
    inj_b = ChaosInjector(ChaosConfig(seed=8, **FAULT_MIXES[mix]), kind="frame")
    for f in inj_a.apply(frames):
        pa.handle_sync_message(ROOM, f)
    for f in inj_b.apply(frames):
        pb.handle_sync_message(ROOM, f)
    sync_repair(pa, pb)
    assert_identical(pa, pb)
    # chaos actually happened (deterministic given the seeds)
    assert sum(inj_a.fault_counts.values()) > 0
    assert sum(inj_b.fault_counts.values()) > 0
    if mix == "dup_reorder":
        # lossless faults: the converged replicas match the oracle too
        assert pa.text(ROOM) == oracle_text
    # frame tolerance never demotes or quarantines the room
    assert pa.health(ROOM)["state"] == "healthy"
    assert pb.health(ROOM)["state"] == "healthy"


@pytest.mark.parametrize("backend", BACKENDS)
def test_raw_update_chaos_quarantines_not_wedges(backend):
    """Corrupt RAW updates (no frame seam to reject them early) reach
    the engine: isolation rolls back, health quarantines, and the two
    replicas still converge after sync repair + replay."""
    updates, _ = client_updates(seed=202, n_ops=40)
    pa = TpuProvider(2, backend=backend)
    pb = TpuProvider(2, backend=backend)
    inj = ChaosInjector(ChaosConfig(seed=3, corrupt=0.2), kind="update")
    for u in inj.apply(updates):
        pa.receive_update(ROOM, u)
        pa.flush()
    for u in updates:  # pb gets the clean stream
        pb.receive_update(ROOM, u)
    assert inj.fault_counts["corrupt"] > 0
    assert pa.engine.dead_letters.total > 0
    sync_repair(pa, pb)
    assert_identical(pa, pb)


def test_injector_deterministic():
    updates, _ = client_updates(seed=55, n_ops=20)
    cfg = dict(corrupt=0.3, truncate=0.2, duplicate=0.3, reorder=0.9, drop=0.2)
    out1 = ChaosInjector(ChaosConfig(seed=42, **cfg)).apply(updates)
    out2 = ChaosInjector(ChaosConfig(seed=42, **cfg)).apply(updates)
    out3 = ChaosInjector(ChaosConfig(seed=43, **cfg)).apply(updates)
    assert out1 == out2
    assert out1 != out3  # seed actually matters


def test_corruption_is_always_detectable():
    """The detectability contract: every corrupt/truncate product fails
    validate_update — a corruption that still decoded would be silent
    divergence (Byzantine), which the harness must never inject."""
    from yjs_tpu_torch.updates import InvalidUpdate, validate_update

    updates, _ = client_updates(seed=77, n_ops=30)
    inj = ChaosInjector(ChaosConfig(seed=5))
    for u in updates:
        for bad in (inj.corrupt(u), inj.truncate(u)):
            with pytest.raises(InvalidUpdate):
                validate_update(bad)


def test_chaos_config_from_env(monkeypatch):
    for k in ("CORRUPT", "TRUNCATE", "DUP", "REORDER", "DROP"):
        monkeypatch.delenv(f"YTPU_CHAOS_{k}", raising=False)
    assert not ChaosConfig.from_env().any_faults()
    monkeypatch.setenv("YTPU_CHAOS_SEED", "99")
    monkeypatch.setenv("YTPU_CHAOS_CORRUPT", "0.5")
    monkeypatch.setenv("YTPU_CHAOS_DUP", "2.5")  # clamped to 1.0
    monkeypatch.setenv("YTPU_CHAOS_DROP", "bogus")  # ignored -> 0
    cfg = ChaosConfig.from_env()
    assert cfg.seed == 99
    assert cfg.corrupt == 0.5
    assert cfg.duplicate == 1.0
    assert cfg.drop == 0.0
    assert cfg.any_faults()


def test_chaos_fault_counters_exported():
    from yjs_tpu_torch.obs import global_registry

    fam = global_registry().get("ytpu_chaos_faults_total")
    drop_child = fam.labels(fault="drop")
    before = drop_child.value
    inj = ChaosInjector(ChaosConfig(seed=1, drop=1.0))
    inj.apply([b"x", b"y", b"z"])
    assert drop_child.value == before + 3
