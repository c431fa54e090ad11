"""The cases of the JAX package's ``tests/test_engine_snapshot.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Engine-path snapshots: capture, snapshot-scoped delta rendering, and
createDocFromSnapshot for DEVICE-RESIDENT rooms — parity-pinned against
the CPU core's utils/snapshot.py + YText.to_delta (which are themselves
the reference twins of src/utils/Snapshot.js:27-202 and
src/types/YText.js:936-1030)."""

import random

import yjs_tpu_torch as Y
from torch_service import BatchEngine
from yjs_tpu_torch.utils.snapshot import (
    create_doc_from_snapshot,
    decode_snapshot,
    encode_snapshot,
    equal_snapshots,
    snapshot as cpu_snapshot,
)


def _mk_engine_and_doc(updates):
    """One device-resident room + one CPU oracle, fed the same updates."""
    eng = BatchEngine(1)
    d = Y.Doc(gc=False)
    for u in updates:
        eng.queue_update(0, u)
        Y.apply_update(d, u)
    eng.flush()
    return eng, d


def _edit_updates(seed=0, rounds=6, clients=2):
    """Two clients interleaving inserts/deletes/formats on 'text'."""
    rng = random.Random(seed)
    docs = [Y.Doc(gc=False) for _ in range(clients)]
    for i, d in enumerate(docs):
        d.client_id = 100 + i
    out = []
    svs = [None] * clients
    for _r in range(rounds):
        i = rng.randrange(clients)
        d = docs[i]
        t = d.get_text("text")
        n = len(t.to_string())
        op = rng.random()
        if op < 0.55 or n == 0:
            pos = rng.randint(0, n)
            t.insert(pos, rng.choice(["ab", "xyz", "\U0001F600", "Q"]))
        elif op < 0.8:
            pos = rng.randint(0, n - 1)
            t.delete(pos, min(rng.randint(1, 3), n - pos))
        else:
            pos = rng.randint(0, max(0, n - 2))
            t.format(pos, min(2, n - pos), {"bold": True})
        u = Y.encode_state_as_update(d, svs[i])
        svs[i] = Y.encode_state_vector(d)
        out.append(u)
        # cross-deliver so the two clients actually interleave
        for j, other in enumerate(docs):
            if j != i:
                Y.apply_update(other, u)
    return out


def test_engine_snapshot_capture_matches_cpu():
    for seed in range(4):
        updates = _edit_updates(seed=seed)
        eng, d = _mk_engine_and_doc(updates)
        es = eng.snapshot(0)
        cs = cpu_snapshot(d)
        assert equal_snapshots(es, cs), f"seed={seed}"
        # codec interop: engine snapshots ride the standard wire form
        assert equal_snapshots(decode_snapshot(encode_snapshot(es)), cs)


def test_engine_snapshot_scoped_delta_parity():
    for seed in range(6):
        updates = _edit_updates(seed=seed, rounds=8)
        k = len(updates) // 2
        # oracle doc built incrementally; snapshot mid-history
        eng = BatchEngine(1)
        d = Y.Doc(gc=False)
        for u in updates[:k]:
            eng.queue_update(0, u)
            Y.apply_update(d, u)
        eng.flush()
        snap_mid_e = eng.snapshot(0)
        snap_mid_c = cpu_snapshot(d)
        assert equal_snapshots(snap_mid_e, snap_mid_c)
        for u in updates[k:]:
            eng.queue_update(0, u)
            Y.apply_update(d, u)
        eng.flush()
        snap_end_c = cpu_snapshot(d)
        t = d.get_text("text")
        # point-in-time view
        assert eng.to_delta(0, snapshot=snap_mid_c) == t.to_delta(
            snap_mid_c
        ), f"seed={seed} point-in-time"
        # two-snapshot diff with ychange attribution
        assert eng.to_delta(
            0, snapshot=snap_end_c, prev_snapshot=snap_mid_c
        ) == t.to_delta(snap_end_c, snap_mid_c), f"seed={seed} diff"
        # custom compute_ychange passthrough
        cy = lambda kind, _id: {"type": kind, "user": _id.client}
        assert eng.to_delta(
            0, snapshot=snap_end_c, prev_snapshot=snap_mid_c,
            compute_ychange=cy,
        ) == t.to_delta(snap_end_c, snap_mid_c, cy), f"seed={seed} ychange"


def test_engine_create_doc_from_snapshot():
    for seed in range(3):
        updates = _edit_updates(seed=seed, rounds=8)
        k = len(updates) // 2
        eng = BatchEngine(1)
        d = Y.Doc(gc=False)
        for u in updates[:k]:
            eng.queue_update(0, u)
            Y.apply_update(d, u)
        eng.flush()
        snap = eng.snapshot(0)
        text_at_snap = d.get_text("text").to_string()
        for u in updates[k:]:
            eng.queue_update(0, u)
            Y.apply_update(d, u)
        eng.flush()
        rewound = eng.create_doc_from_snapshot(0, snap)
        # PARITY is the contract: the CPU reference path itself repairs
        # surrogate pairs split by post-snapshot edits to U+FFFD
        # (ContentString split rule), so compare against it — not
        # against the raw pre-edit text
        cpu_rewound = create_doc_from_snapshot(d, snap)
        assert (
            rewound.get_text("text").to_string()
            == cpu_rewound.get_text("text").to_string()
        ), f"seed={seed}"
        if "�" not in cpu_rewound.get_text("text").to_string():
            assert rewound.get_text("text").to_string() == text_at_snap


def test_engine_snapshot_survives_compaction():
    """Rows merged by engine compaction after the snapshot still render
    the point-in-time view exactly (element-level ds visibility makes
    merged runs transparent)."""
    for seed in range(3):
        updates = _edit_updates(seed=10 + seed, rounds=10)
        k = len(updates) // 2
        eng = BatchEngine(1, compact_min_rows=2)  # compact aggressively
        d = Y.Doc(gc=False)
        for u in updates[:k]:
            eng.queue_update(0, u)
            Y.apply_update(d, u)
        eng.flush()
        snap = cpu_snapshot(d)
        assert equal_snapshots(eng.snapshot(0), snap)
        for u in updates[k:]:
            eng.queue_update(0, u)
            Y.apply_update(d, u)
            eng.flush()  # per-update flushes -> compactions fire
        t = d.get_text("text")
        assert eng.text(0) == t.to_string()
        assert eng.to_delta(0, snapshot=snap) == t.to_delta(snap), (
            f"seed={seed}"
        )


def test_provider_snapshot_surface():
    from torch_service import TpuProvider

    prov = TpuProvider(n_docs=2)
    guid = "room-a"
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "hello world")
    prov.receive_update(guid, Y.encode_state_as_update(d))
    prov.flush()
    snap = prov.snapshot(guid)
    d.get_text("text").insert(5, " brave")
    prov.receive_update(guid, Y.encode_state_as_update(d))
    prov.flush()
    assert prov.text(guid) == "hello brave world"
    # point-in-time render from the still-device-resident room
    assert prov.to_delta(guid, snapshot=snap) == [{"insert": "hello world"}]
    rewound = prov.create_doc_from_snapshot(guid, snap)
    assert rewound.get_text("text").to_string() == "hello world"
    # the room itself was never demoted
    assert prov.engine.fallback == {}
