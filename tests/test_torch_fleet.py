"""The fleet suites on the port: ``FleetRouter`` over port providers.

The cases of the JAX package's ``tests/test_fleet.py`` (placement, the
routing table, the provider facade, live migration, drain, scale-out,
the rebalancer, mesh placement, metrics and sessions over the fleet),
``tests/test_fleet_chaos.py`` (a fleet killed mid-migration and
recovered from its WAL root) and ``tests/test_failover_chaos.py``
(primaries killed mid-flush, in the checkpoint window and under a
network storm) run here on ``yjs_tpu_torch.fleet.FleetRouter``, every
shard on the CPU (``device="cpu"``), under the ``"cpu"`` and the
``"auto"`` provider backend (on ``"auto"`` the plain ``apply_lanes``
carries every shard's flushes).  The oracle is the same: the port's CPU
``Doc`` fed the same updates, byte for byte.
"""

import random

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.fleet import FleetRouter as _FleetRouter
from yjs_tpu_torch.fleet import (
    FleetConfig,
    FleetFullError,
    HashRing,
    RoutingTable,
    stable_hash,
)
from yjs_tpu_torch.admission import AdmissionConfig
from yjs_tpu_torch.resilience import NetChaosConfig, NetworkFaultInjector
from yjs_tpu_torch.sync.session import SessionConfig
from yjs_tpu_torch.sync.transport import PipeNetwork
from yjs_tpu_torch.tiering import TierConfig
from yjs_tpu_torch.updates import (
    apply_update,
    encode_state_as_update,
    encode_state_vector,
)
from torch_service import (
    BACKENDS,
    FAST,
    SMALL,
    FleetRouter,
    TpuProvider,
    canonical,
    canonical_doc,
    convict,
    crash,
    edit,
    quiet_config,
    seeded_rooms,
    slot_owners,
    update_for,
)

pytestmark = pytest.mark.fleet


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


def drive(fleet, peer):
    def fn():
        fleet.flush()
        peer.flush()
        fleet.tick_sessions()
        peer.tick_sessions()

    return fn


# -- hash ring ---------------------------------------------------------------


def test_stable_hash_is_process_stable_and_64_bit():
    # blake2b, not hash(): the value below must never change across
    # processes or releases — routing tables depend on it
    assert stable_hash("room-0") == stable_hash("room-0")
    assert stable_hash("room-0") != stable_hash("room-1")
    for k in ("", "a", "room/x", "☃"):
        assert 0 <= stable_hash(k) < (1 << 64)


def test_ring_owner_deterministic_across_instances():
    a = HashRing(range(8), vnodes=32)
    b = HashRing(range(8), vnodes=32)
    guids = [f"doc-{i}" for i in range(500)]
    assert [a.owner(g) for g in guids] == [b.owner(g) for g in guids]
    # membership means every shard actually gets traffic
    assert len({a.owner(g) for g in guids}) == 8


def test_ring_minimal_movement_on_membership_change():
    before = HashRing(range(8), vnodes=64)
    guids = [f"doc-{i}" for i in range(2000)]
    owners = {g: before.owner(g) for g in guids}
    before.add(8)  # scale out 8 -> 9
    moved = sum(1 for g in guids if before.owner(g) != owners[g])
    # classic consistent hashing: ~1/9 of docs re-home, never a reshuffle
    assert 0 < moved < len(guids) * 0.25
    # every doc that moved, moved TO the new shard
    assert all(
        before.owner(g) == 8 for g in guids if before.owner(g) != owners[g]
    )


def test_bounded_load_sheds_off_hot_shard():
    ring = HashRing(range(4), vnodes=64)
    loads = {s: 0 for s in range(4)}
    caps = {s: 1000 for s in range(4)}
    placed = {}
    for i in range(400):
        g = f"doc-{i}"
        s, _shed = ring.place(g, loads.get, caps.get, 1.25)
        loads[s] += 1
        placed[g] = s
    # the ceiling held: no shard exceeds ceil(1.25 * total / N) by more
    # than the +1 headroom the formula grants per placement
    assert max(loads.values()) <= (1.25 * (400 + 1) / 4) + 1
    # and at least one doc was diverted off its natural owner
    assert any(ring.owner(g) != placed[g] for g in placed)


def test_place_fallback_and_fleet_full():
    ring = HashRing(range(2), vnodes=16)
    # both shards over the bound but one has a hard slot free: the
    # least-loaded one takes it rather than failing
    s, shed = ring.place("doc", {0: 10, 1: 9}.get, {0: 10, 1: 10}.get, 0.5)
    assert s == 1 and shed
    with pytest.raises(FleetFullError):
        ring.place("doc", {0: 10, 1: 10}.get, {0: 10, 1: 10}.get, 1.25)


def test_routing_table_versioned():
    t = RoutingTable()
    assert t.epoch == 0 and t.lookup("a") is None
    t.assign("a", 2)
    assert t.epoch == 0  # bare assign does not version
    t.assign("b", 2, bump=True)
    assert t.epoch == 1
    assert t.docs_on(2) == ["a", "b"]
    t.unassign("a", bump=True)
    assert t.epoch == 2 and t.lookup("a") is None
    snap = t.snapshot()
    assert snap["n_docs"] == 1 and snap["per_shard"] == {2: 1}


# -- fleet facade ------------------------------------------------------------


def test_fleet_admits_past_single_shard_capacity(backend):
    fleet = FleetRouter(3, 2, backend=backend)
    for i in range(5):  # one shard caps at 2; the fleet holds 6
        fleet.receive_update(f"doc-{i}", update_for(f"text {i}"))
    fleet.flush()
    for i in range(5):
        assert fleet.text(f"doc-{i}") == f"text {i}"
        owner = fleet.owner_of(f"doc-{i}")
        assert owner is not None
        assert fleet.shards[owner].has_doc(f"doc-{i}")
    assert fleet.doc_count == 5 and fleet.capacity == 6
    fleet.receive_update("doc-5", update_for("last slot"))
    with pytest.raises(FleetFullError):
        fleet.receive_update("doc-6", update_for("no room"))


def test_fleet_speaks_the_provider_surface(backend):
    fleet = FleetRouter(2, 2, backend=backend)
    fleet.receive_update("room", update_for("surface"))
    ref = TpuProvider(1, backend=backend)
    ref.receive_update("room", update_for("surface"))
    assert fleet.text("room") == ref.text("room") == "surface"
    assert fleet.state_vector("room") == ref.state_vector("room")
    assert Y.merge_updates([fleet.encode_state_as_update("room")]) == (
        Y.merge_updates([ref.encode_state_as_update("room")])
    )
    assert isinstance(fleet.sync_step1("room"), bytes)
    h = fleet.health()
    assert len(h["shards"]) == 2 and h["fleet"]["docs"] == 1
    snap = fleet.fleet_snapshot()
    assert snap["n_shards"] == snap["live_shards"] == 2
    assert snap["capacity"] == 4 and snap["migrations_active"] == 0
    row = snap["shards"][0]
    for key in ("shard", "docs", "capacity", "occupancy", "state",
                "dlq", "sessions", "migrating", "mig_in", "mig_out"):
        assert key in row


# -- live migration ----------------------------------------------------------


def test_migrate_doc_preserves_bytes_frees_slot_bumps_epoch(backend):
    fleet = FleetRouter(2, 2, backend=backend)
    fleet.receive_update("room", update_for("move me"))
    src = fleet.shard_of("room")
    dst = 1 - src
    before = Y.merge_updates([fleet.encode_state_as_update("room")])
    epoch0 = fleet.table.epoch
    fleet.migrate_doc("room", dst)
    assert fleet.owner_of("room") == dst
    assert fleet.table.epoch == epoch0 + 1
    assert not fleet.shards[src].has_doc("room")  # slot freed for reuse
    assert fleet.shards[dst].has_doc("room")
    assert fleet.text("room") == "move me"
    assert Y.merge_updates([fleet.encode_state_as_update("room")]) == before


def test_double_delivery_window_loses_no_inflight_update(backend):
    fleet = FleetRouter(2, 2, backend=backend)
    d = Y.Doc(gc=False)
    d.client_id = 7
    d.get_text("text").insert(0, "base")
    fleet.receive_update("room", encode_state_as_update(d))
    src = fleet.shard_of("room")
    dst = 1 - src
    fleet.begin_migration("room", dst)
    assert fleet.fleet_snapshot()["migrations_active"] == 1
    # an edit lands INSIDE the window: both shards must journal it
    sv = encode_state_vector(d)
    d.get_text("text").insert(0, "tail-")
    fleet.receive_update("room", encode_state_as_update(d, sv))
    fleet.complete_migration("room")
    assert fleet.owner_of("room") == dst
    assert fleet.text("room") == "tail-base"


def test_migration_misuse_is_typed(backend):
    fleet = FleetRouter(2, 2, backend=backend)
    fleet.receive_update("room", update_for("x"))
    src = fleet.shard_of("room")
    with pytest.raises(ValueError):
        fleet.migrate_doc("room", src)  # already lives there
    with pytest.raises(ValueError):
        fleet.migrate_doc("room", 99)  # not a shard
    with pytest.raises(RuntimeError):
        fleet.complete_migration("room")  # no window open
    fleet.begin_migration("room", 1 - src)
    with pytest.raises(RuntimeError):
        fleet.begin_migration("room", 1 - src)  # already migrating
    fleet.complete_migration("room")


def test_drain_shard_retires_and_excludes_from_placement(backend):
    fleet = FleetRouter(3, 4, backend=backend)
    for i in range(6):
        fleet.receive_update(f"doc-{i}", update_for(f"t{i}"))
    texts = {f"doc-{i}": f"t{i}" for i in range(6)}
    victim = fleet.shard_of("doc-0")
    on_victim = len(fleet.shards[victim].guids())
    moved = fleet.drain_shard(victim)
    assert moved == on_victim >= 1
    assert not fleet.shards[victim].guids()
    assert victim not in fleet.live_shards
    assert fleet.fleet_snapshot()["shards"][victim]["state"] == "retired"
    for g, t in texts.items():
        assert fleet.text(g) == t
        assert fleet.owner_of(g) != victim
    # future placements never propose the retired shard
    for i in range(6, 8):  # 2 live shards x 4 slots hold 8 docs total
        fleet.receive_update(f"doc-{i}", update_for("new"))
        assert fleet.owner_of(f"doc-{i}") != victim
    assert fleet.drain_shard(victim) == 0  # idempotent


def test_drain_fails_fast_when_rest_of_fleet_lacks_slots(backend):
    fleet = FleetRouter(2, 2, backend=backend)
    for i in range(4):  # full fleet: nowhere to move anything
        fleet.receive_update(f"doc-{i}", update_for(f"t{i}"))
    victim = fleet.shard_of("doc-0")
    snapshot_before = fleet.fleet_snapshot()
    with pytest.raises(FleetFullError, match="add_shard"):
        fleet.drain_shard(victim)
    # the veto left the fleet untouched — no half-drained wedge
    assert victim in fleet.live_shards
    assert fleet.fleet_snapshot() == snapshot_before


def test_add_shard_grows_capacity_and_joins_ring(backend):
    fleet = FleetRouter(2, 2, backend=backend)
    for i in range(4):
        fleet.receive_update(f"doc-{i}", update_for(f"t{i}"))
    with pytest.raises(FleetFullError):
        fleet.receive_update("doc-4", update_for("full"))
    epoch0 = fleet.table.epoch
    k = fleet.add_shard()
    assert k == 2 and fleet.capacity == 6
    assert fleet.table.epoch == epoch0 + 1
    fleet.receive_update("doc-4", update_for("fits now"))
    assert fleet.owner_of("doc-4") == k  # only shard with room
    assert fleet.text("doc-4") == "fits now"


# -- rebalancer --------------------------------------------------------------


def hot_fleet(backend, high=0.75, target=0.5, batch=8):
    cfg = FleetConfig(
        rebalance_high=high, rebalance_target=target, rebalance_batch=batch,
    )
    fleet = FleetRouter(2, 4, backend=backend, config=cfg)
    for i in range(4):
        fleet.receive_update(f"doc-{i}", update_for(f"t{i}"))
    # herd everything onto shard 0 so it sits at occupancy 1.0
    for i in range(4):
        if fleet.shard_of(f"doc-{i}") != 0:
            fleet.migrate_doc(f"doc-{i}", 0)
    assert fleet.shards[0].occupancy == 1.0
    return fleet


def test_rebalancer_sheds_hot_shard_to_target(backend):
    fleet = hot_fleet(backend)
    decisions = fleet.tick()
    moves = [d for d in decisions if d["action"] == "move"]
    assert moves and all(d["src"] == 0 for d in moves)
    # shed down to target occupancy (0.5 * 4 slots = 2 docs), texts kept
    assert len(fleet.shards[0].guids()) == 2
    for i in range(4):
        assert fleet.text(f"doc-{i}") == f"t{i}"
    # a balanced fleet's next tick is a no-op
    assert fleet.tick() == []


def test_rebalancer_moves_coldest_docs_first(backend):
    fleet = hot_fleet(backend)
    fleet.session("doc-0", "peer", quiet_config())  # doc-0 is now warm
    moves = [d for d in fleet.rebalancer.plan() if d["action"] == "move"]
    assert [d["guid"] for d in moves] == ["doc-1", "doc-2"]  # sessionless


def test_rebalancer_records_stuck_when_nowhere_to_move(backend):
    cfg = FleetConfig(
        rebalance_high=0.75, rebalance_target=0.5, rebalance_batch=4,
    )
    fleet = FleetRouter(2, 2, backend=backend, config=cfg)
    for i in range(4):  # both shards at 1.0: no destination qualifies
        fleet.receive_update(f"doc-{i}", update_for(f"t{i}"))
    decisions = fleet.tick()
    assert decisions and all(d["action"] == "stuck" for d in decisions)
    assert fleet.doc_count == 4  # nothing thrashed


# -- mesh placement ----------------------------------------------------------


def test_shard_meshes_partition_devices_contiguously(backend):
    from yjs_tpu_torch.parallel import doc_mesh, shard_meshes

    # the port's device list is the CUDA cards (the CPU backend has one
    # device): fewer devices than shards is the explicit-None mode, in
    # which every shard runs unmeshed on the fleet's device
    assert shard_meshes(4, backend="cpu") == [None] * 4
    (one,) = shard_meshes(1, backend="cpu")
    assert one is not None and one.devices.size == 1
    with pytest.raises(ValueError):
        shard_meshes(0)

    # a shard given a mesh runs on the mesh's devices (here two CPU
    # shards of its engine), whatever the fleet's device
    meshes = [doc_mesh(2, backend="cpu") for _ in range(2)]
    fleet = _FleetRouter(2, 4, backend=backend, meshes=meshes)
    for k, p in enumerate(fleet.shards):
        assert p.engine.mesh is meshes[k]
        assert p.engine.device.type == "cpu"
    for i in range(4):
        fleet.receive_update(f"doc-{i}", update_for(f"t{i}"))
    fleet.flush()
    assert [fleet.text(f"doc-{i}") for i in range(4)] == [
        f"t{i}" for i in range(4)
    ]
    k = fleet.add_shard(mesh=doc_mesh(2, backend="cpu"))
    assert fleet.shards[k].engine.mesh is not None


# -- observability -----------------------------------------------------------


def test_fleet_metric_families_registered_globally(backend):
    from yjs_tpu_torch.obs import global_registry

    FleetRouter(1, 1, backend=backend)
    names = set(global_registry().names())
    for fam in (
        "ytpu_fleet_shards",
        "ytpu_fleet_docs",
        "ytpu_fleet_shard_docs",
        "ytpu_fleet_shard_occupancy",
        "ytpu_fleet_routing_epoch",
        "ytpu_fleet_placements_total",
        "ytpu_fleet_migrations_total",
        "ytpu_fleet_migration_seconds",
        "ytpu_fleet_double_delivered_total",
        "ytpu_fleet_rebalance_decisions_total",
    ):
        assert fam in names, fam


def test_fleet_gauges_track_state(backend):
    from yjs_tpu_torch.obs import global_registry

    fleet = FleetRouter(2, 2, backend=backend)
    fleet.receive_update("room", update_for("x"))
    fleet._refresh_gauges()
    r = global_registry()
    assert r.get("ytpu_fleet_shards").value == 2
    assert r.get("ytpu_fleet_docs").value == 1
    assert r.get("ytpu_fleet_routing_epoch").value == fleet.table.epoch
    occ = {
        labels["shard"]: series.value
        for labels, series in r.get("ytpu_fleet_shard_occupancy").samples()
        if labels["shard"] in ("0", "1")
    }
    owner = str(fleet.shard_of("room"))
    assert occ[owner] == 0.5


def test_ytpu_top_renders_fleet_table(backend):
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "ytpu_top_fleet_test",
        pathlib.Path(__file__).resolve().parent.parent
        / "scripts" / "torch_ytpu_top.py",
    )
    top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(top)

    fleet = FleetRouter(3, 2, backend=backend)
    for i in range(4):
        fleet.receive_update(f"doc-{i}", update_for(f"t{i}"))
    fleet.session("doc-0", "peer", quiet_config())
    row = top.collect_row("fleet-a", fleet.metrics_snapshot(), None, 1.0)
    assert row["fleet"] and len(row["fleet"]) == 3
    frame = top.render([row], 1.0)
    assert "fleet:" in frame and "occup" in frame and "shard" in frame


# -- sessions over the fleet -------------------------------------------------


def test_fleet_sessions_fan_out_across_shards(backend):
    fleet = FleetRouter(2, 2, backend=backend)
    peer = TpuProvider(4, backend=backend)
    net = PipeNetwork()
    rooms = [f"doc-{i}" for i in range(3)]
    for g in rooms:
        tf, tp = net.pair(f"f-{g}", f"p-{g}")
        fleet.session(g, "peer", quiet_config()).connect(tf)
        peer.session(g, "fleet", quiet_config()).connect(tp)
    net.settle((drive(fleet, peer),))
    # the rooms span both shards yet one facade serves them all
    assert len({fleet.shard_of(g) for g in rooms}) == 2
    for g in rooms:
        peer.receive_update(g, update_for(f"from peer {g}"))
    net.settle((drive(fleet, peer),))
    for g in rooms:
        assert fleet.text(g) == f"from peer {g}"
    # and the reverse direction: fleet-side traffic reaches the peer
    fleet.receive_update(rooms[0], update_for("from fleet", client_id=5))
    net.settle((drive(fleet, peer),))
    assert "from fleet" in peer.text(rooms[0])
    rows = fleet.sessions_snapshot()
    assert len(rows) == 3
    assert all(row["shard"] == fleet.shard_of(row["guid"]) for row in rows)


def test_fleet_session_survives_live_migration(backend):
    fleet = FleetRouter(2, 2, backend=backend)
    peer = TpuProvider(1, backend=backend)
    net = PipeNetwork()
    tf, tp = net.pair()
    sf = fleet.session("room", "peer", quiet_config(antientropy=2))
    sp = peer.session("room", "fleet", quiet_config(antientropy=2))
    sf.connect(tf)
    sp.connect(tp)
    net.settle((drive(fleet, peer),))
    peer.receive_update("room", update_for("pre-move"))
    net.settle((drive(fleet, peer),))
    assert fleet.text("room") == "pre-move"
    src = fleet.shard_of("room")
    fleet.migrate_doc("room", 1 - src)
    # the session re-homed in place: no reconnect, epoch current, and
    # rehome() forced a digest so divergence heals immediately
    assert sf.routing_epoch == fleet.table.epoch
    assert not sf._closed and sf.state == "live"
    net.settle((drive(fleet, peer),), max_rounds=60, idle_rounds=3)
    peer.receive_update("room", update_for("post-move", client_id=3))
    net.settle((drive(fleet, peer),), max_rounds=60, idle_rounds=3)
    assert "post-move" in fleet.text("room")
    assert fleet.text("room") == peer.text("room")
    assert sf.n_full_resyncs == 1 and sp.n_full_resyncs == 1


def test_fleet_session_admission_is_atomic(backend):
    fleet = FleetRouter(1, 1, backend=backend)
    fleet.receive_update("a", update_for("occupies the only slot"))
    with pytest.raises(ValueError):  # ProviderFullError
        fleet.session("b", "peer", quiet_config())
    assert ("b", "peer") not in fleet._sessions  # veto left no entry
    fleet.shards[0].release_doc("a")
    sess = fleet.session("b", "peer", quiet_config())  # now admits
    assert fleet._sessions[("b", "peer")] is sess




@pytest.mark.chaos
@pytest.mark.durability
def test_kill_fleet_mid_migration_recovers_to_single_owner(backend, tmp_path):
    rooms = seeded_rooms(seed=6, n_rooms=8, n_ops=12)
    cfg = FleetConfig(
        rebalance_high=0.75, rebalance_target=0.5, rebalance_batch=4,
    )
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        config=cfg,
    )
    # churn: 8 rooms of seeded traffic — past any single shard's 4
    # slots, so admission only works because placement sharded
    for g, (_d, ups) in rooms.items():
        for u in ups:
            fleet.receive_update(g, u)
    fleet.flush()
    # a rebalance pass (shards that filled to the high watermark shed;
    # every move is itself an intent+release-journaled migration)
    fleet.tick()

    # open a migration window, then lose power with it OPEN and an
    # in-flight edit double-delivered but never released
    guid = "room-0"
    src = fleet.shard_of(guid)
    dst = next(
        k for k in fleet.live_shards
        if k != src and fleet._load(k) < fleet._capacity(k)
    )
    fleet.begin_migration(guid, dst)
    fleet.receive_update(guid, edit(rooms[guid][0], "tail!"))
    fleet.flush()
    crash(fleet)
    del fleet

    rec = FleetRouter.recover(
        tmp_path, docs_per_shard=4, backend=backend, wal_config=SMALL,
    )
    # the open intent resolved by completing the handoff (the
    # destination had journaled the doc's state)
    res = rec.last_recovery["resolution"]
    assert res["completed"] == 1 and res["deduped"] == 0
    assert rec.owner_of(guid) == dst

    # exactly one shard holds each doc, and the routing table agrees
    own = slot_owners(rec)
    assert sorted(own) == sorted(rooms)
    for g, holders in own.items():
        assert holders == [rec.owner_of(g)]

    # byte-identical reconvergence — including the in-window tail edit
    for g, (d, _ups) in rooms.items():
        assert rec.text(g) == str(d.get_text("text"))
        assert canonical(rec, g) == canonical_doc(d)

    # the recovered fleet is live: more traffic converges
    for g in ("room-0", "room-5"):
        rec.receive_update(g, edit(rooms[g][0], "after "))
        assert rec.text(g) == str(rooms[g][0].get_text("text"))


@pytest.mark.chaos
@pytest.mark.durability
def test_intent_only_crash_aborts_to_source(backend, tmp_path):
    """Crash between the intent append and the state transfer: the
    destination never admitted the doc, so recovery aborts the
    migration and the source keeps sole ownership."""
    fleet = FleetRouter(
        2, 2, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
    )
    d = Y.Doc(gc=False)
    d.client_id = 1
    d.get_text("text").insert(0, "stay")
    fleet.receive_update("room", encode_state_as_update(d))
    fleet.flush()
    src = fleet.shard_of("room")
    fleet.shards[src].journal_migration("room", 1 - src, fleet.table.epoch)
    crash(fleet)
    del fleet

    rec = FleetRouter.recover(
        tmp_path, docs_per_shard=2, backend=backend, wal_config=SMALL,
    )
    res = rec.last_recovery["resolution"]
    assert res["aborted"] == 1 and res["completed"] == 0
    assert rec.owner_of("room") == src
    assert slot_owners(rec)["room"] == [src]
    assert rec.text("room") == "stay"


@pytest.mark.chaos
@pytest.mark.durability
def test_release_marker_closes_the_window_durably(backend, tmp_path):
    """Crash AFTER complete_migration: the source's release record is
    the durable handoff marker, so recovery resurrects nothing on the
    source and resolves no intents."""
    fleet = FleetRouter(
        2, 2, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
    )
    d = Y.Doc(gc=False)
    d.client_id = 2
    d.get_text("text").insert(0, "moved")
    fleet.receive_update("room", encode_state_as_update(d))
    src = fleet.shard_of("room")
    fleet.migrate_doc("room", 1 - src)
    crash(fleet)
    del fleet

    rec = FleetRouter.recover(
        tmp_path, docs_per_shard=2, backend=backend, wal_config=SMALL,
    )
    res = rec.last_recovery["resolution"]
    assert res == {
        "completed": 0, "aborted": 0, "deduped": 0,
        "fenced": 0, "replicas_folded": 0, "replica_promoted": 0,
    }
    assert rec.owner_of("room") == 1 - src
    assert slot_owners(rec)["room"] == [1 - src]
    assert rec.text("room") == "moved"


@pytest.mark.chaos
@pytest.mark.durability
def test_checkpoint_then_crash_keeps_open_window_recoverable(backend, tmp_path):
    """Compaction drops the segment the intent lived in; the fleet
    checkpoint re-journals open intents, so a crash AFTER a checkpoint
    taken mid-window still resolves to exactly one owner."""
    fleet = FleetRouter(
        2, 2, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
    )
    d = Y.Doc(gc=False)
    d.client_id = 3
    d.get_text("text").insert(0, "compact me")
    fleet.receive_update("room", encode_state_as_update(d))
    src = fleet.shard_of("room")
    dst = 1 - src
    fleet.begin_migration("room", dst)
    fleet.checkpoint()
    fleet.receive_update("room", edit(d, "late "))  # still double-delivers
    fleet.flush()
    crash(fleet)
    del fleet

    rec = FleetRouter.recover(
        tmp_path, docs_per_shard=2, backend=backend, wal_config=SMALL,
    )
    assert rec.last_recovery["resolution"]["completed"] == 1
    assert rec.owner_of("room") == dst
    assert slot_owners(rec)["room"] == [dst]
    assert rec.text("room") == "late compact me"
    assert canonical(rec, "room") == canonical_doc(d)




# the full fault mix from the network-chaos acceptance matrix, and the
# same 20-seed spread
STORM = dict(drop=0.2, duplicate=0.2, delay=0.25, reorder=0.3,
             partition=0.04)


STORM_SEEDS = tuple(range(20))


MESH_CONFIG = dict(
    retry_base=4, retry_cap=16, retry_max=6, retry_jitter=0.25,
    antientropy=8, heartbeat=0, liveness=0, hello_timeout=0,
)


@pytest.mark.failover
@pytest.mark.chaos
def test_kill_primary_mid_flush_loses_nothing(backend, tmp_path):
    """The primary dies with acknowledged updates still sitting in its
    engine queue (never flushed) and in the replication outbox (never
    drained).  Acknowledged means durable: promotion must surface every
    one of them from the synchronous absorb / queued-outbox paths."""
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    rooms = seeded_rooms(seed=11, n_rooms=6, n_ops=10)
    for g, (_d, ups) in rooms.items():
        for u in ups:
            fleet.receive_update(g, u)
    fleet.flush()
    fleet.tick()  # replica copies seeded
    victim = fleet.owner_of("room-0")
    owned = [g for g in rooms if fleet.owner_of(g) == victim]
    assert owned
    # a fresh acked tail per owned doc: engine queue dirty, outbox
    # undrained — then the machine dies before any flush or tick
    for g in owned:
        fleet.receive_update(g, edit(rooms[g][0], "tail!"))
    fleet.kill_shard(victim)
    convict(fleet, victim)
    for g, (d, _ups) in rooms.items():
        assert fleet.owner_of(g) is not None
        assert canonical(fleet, g) == canonical_doc(d), g
    assert all(len(v) == 1 for v in slot_owners(fleet).values())
    # and the survivors keep taking traffic
    g = owned[0]
    fleet.receive_update(g, edit(rooms[g][0], "post-failover "))
    assert canonical(fleet, g) == canonical_doc(rooms[g][0])


@pytest.mark.failover
@pytest.mark.chaos
def test_kill_primary_during_checkpoint_window(backend, tmp_path):
    """WAL compaction folds only owned docs — a primary killed right
    inside the checkpoint window (replica history just compacted away,
    one more acked edit in flight) must still promote losslessly from
    the reseeded replica state plus the undrained outbox."""
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    rooms = seeded_rooms(seed=12, n_rooms=6, n_ops=10)
    for g, (_d, ups) in rooms.items():
        for u in ups:
            fleet.receive_update(g, u)
    fleet.flush()
    fleet.tick()
    fleet.checkpoint()  # compacts every WAL, reseeds every replica pair
    victim = fleet.owner_of("room-0")
    owned = [g for g in rooms if fleet.owner_of(g) == victim]
    # one acked edit lands between the checkpoint and the crash
    fleet.receive_update(
        "room-0", edit(rooms["room-0"][0], "in the window ")
    )
    fleet.kill_shard(victim)
    convict(fleet, victim)
    for g, (d, _ups) in rooms.items():
        assert canonical(fleet, g) == canonical_doc(d), g
    assert all(len(v) == 1 for v in slot_owners(fleet).values())
    assert "in the window" in fleet.text("room-0")
    # a re-crash after the failover replays to the same single owner
    for k, p in enumerate(fleet.shards):
        if not fleet._is_stub(k):
            p.wal.abandon()
    owners = {g: fleet.owner_of(g) for g in rooms}
    del fleet
    rec = FleetRouter.recover(tmp_path, backend=backend, wal_config=SMALL)
    for g, (d, _ups) in rooms.items():
        assert rec.owner_of(g) == owners[g]
        assert canonical(rec, g) == canonical_doc(d), g


# -- the 20-seed storm matrix ------------------------------------------------


def _storm_mesh(seed: int, tmp_path, backend):
    """Fleet + two peer providers in a full session mesh, every link
    faulted with the storm mix."""
    cfg = SessionConfig(seed=seed, **MESH_CONFIG)
    fleet = FleetRouter(
        3, 2, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    pa = TpuProvider(1, backend=backend)
    pb = TpuProvider(1, backend=backend)
    nets, sessions = [], []
    links = [
        (fleet, "fleet", pa, "A"),
        (fleet, "fleet", pb, "B"),
        (pa, "A", pb, "B"),
    ]
    for i, (x, xn, y, yn) in enumerate(links):
        inj = NetworkFaultInjector(
            NetChaosConfig(seed=(seed * 31 + i) & 0x7FFFFFFF, **STORM)
        )
        net = PipeNetwork(inj)
        tx, ty = net.pair(xn, yn)
        sx = x.session("room", yn, cfg)
        sy = y.session("room", xn, cfg)
        sx.connect(tx)
        sy.connect(ty)
        nets.append(net)
        sessions += [sx, sy]
    return fleet, pa, pb, nets, sessions


@pytest.mark.failover
@pytest.mark.chaos
@pytest.mark.parametrize("seed", STORM_SEEDS)
def test_storm_mesh_survives_primary_kill(backend, seed, tmp_path):
    fleet, pa, pb, nets, sessions = _storm_mesh(seed, tmp_path, backend)
    gen = random.Random(seed)
    # three uninterrupted reference editors, one per replica
    refs = {}
    for name, cid in (("fleet", 1), ("A", 2), ("B", 3)):
        d = Y.Doc(gc=False)
        d.client_id = cid
        refs[name] = d
    targets = {"fleet": fleet, "A": pa, "B": pb}
    all_updates = []

    def maybe_edit(name):
        if gen.random() >= 0.35:
            return
        d = refs[name]
        u = edit(d, gen.choice("abcdef "), gen.randrange(
            len(str(d.get_text("text"))) + 1
        ))
        # acked on return: the storm may not lose it, failover may not
        # lose it
        targets[name].receive_update("room", u)
        all_updates.append(u)

    def pump_all():
        for net in nets:
            net.pump()
        fleet.tick()
        for p in (pa, pb):
            p.flush()
            p.tick_sessions()

    edit_rounds, killed = 40, False
    stable, victim = 0, None
    for n in range(1500):
        if n < edit_rounds:
            for name in ("fleet", "A", "B"):
                maybe_edit(name)
        if n == 15:
            # the primary dies mid-storm with edits still streaming
            victim = fleet.owner_of("room")
            if victim is not None:
                fleet.kill_shard(victim)
                killed = True
        pump_all()
        if n >= edit_rounds:
            texts = {fleet.text("room"), pa.text("room"), pb.text("room")}
            if len(texts) == 1 and all(
                s.state == "live" for s in sessions
            ):
                stable += 1
                if stable >= 6:
                    break
            else:
                stable = 0
    assert killed and victim in fleet._down
    assert stable >= 6, "mesh never reached a live, converged fixpoint"
    # byte-identical across all three replicas
    assert fleet.text("room") == pa.text("room") == pb.text("room")
    # zero acknowledged-update loss: the merged reference stream IS the
    # converged state
    expected = Y.Doc(gc=False)
    apply_update(expected, Y.merge_updates(all_updates))
    assert fleet.text("room") == str(expected.get_text("text"))
    # recovery was retransmission + rehome, never a second full resync
    for s in sessions:
        assert s.n_full_resyncs == 1, (seed, s.peer, s.snapshot())


# -- fleets under admission and tiering ----------------------------------------
# (the fleet cases of tests/test_admission.py and tests/test_tiering.py)


def doc_update(client_id: int, text: str, doc=None):
    d = doc if doc is not None else Y.Doc(gc=False)
    if doc is None:
        d.client_id = client_id
    sv = encode_state_vector(d)
    d.get_text("text").insert(len(str(d.get_text("text"))), text)
    return d, encode_state_as_update(d, sv)


@pytest.mark.admission
@pytest.mark.tiering
def test_overcommitted_fleet_demotes_never_full():
    """Admission x tiering: an overcommitted fleet under admission
    pressure auto-demotes to make headroom instead of surfacing
    ProviderFullError, and stays byte-identical with the plan cache and
    replication at defaults (both on)."""
    fleet = FleetRouter(
        2, 2,
        tier_config=TierConfig(enabled=True),
        admission_config=AdmissionConfig(
            enabled=True, tenant_rate=64.0, tenant_burst=256,
            doc_rate=64.0, doc_burst=256, occupancy_high=0.5,
            headroom=1,
        ),
    )
    rng = random.Random(13)
    refs = {}
    guids = [f"tenant{i % 3}/room-{i}" for i in range(12)]
    for round_ in range(6):
        for g in guids:
            if rng.random() < 0.6:
                d = refs.get(g)
                if d is None:
                    d = Y.Doc(gc=False)
                    d.client_id = 100 + guids.index(g)
                    refs[g] = d
                _, u = doc_update(0, f"r{round_} ", d)
                fleet.receive_update(g, u)
        fleet.flush()
        fleet.tick()
    snap = fleet.admission.snapshot()
    # 12 docs through 4 slots: headroom maintenance had to demote
    assert not any(snap["full_events"].values())
    assert snap["demotions"] > 0
    for g, d in refs.items():
        assert fleet.text(g) == str(d.get_text("text")), g


@pytest.mark.admission
def test_fleet_shares_one_controller(backend):
    fleet = FleetRouter(
        3, 4, backend=backend,
        admission_config=AdmissionConfig(
            enabled=True, tenant_rate=0.0, tenant_burst=2,
            doc_rate=64.0, doc_burst=64, queue_max=64,
        ),
    )
    for prov in fleet.shards:
        assert prov.admission is fleet.admission
    # one tenant's bucket is fleet-wide: updates to docs landing on
    # different shards still share the 2-token budget
    d = {}
    for i in range(6):
        g = f"tenantX/doc-{i}"
        dd, u = doc_update(50 + i, "z")
        d[g] = dd
        fleet.receive_update(g, u)
    snap = fleet.admission.snapshot()
    assert snap["admitted"] == 2 and snap["queued"] == 4
    fleet.flush()
    assert fleet.admission.snapshot()["queue_depth"] == 0
    for g, dd in d.items():
        assert fleet.text(g) == str(dd.get_text("text"))


@pytest.mark.tiering
def test_fleet_overcommit_admits_past_slot_capacity(rng):
    f = FleetRouter(
        n_shards=2,
        docs_per_shard=2,
        tier_config=TierConfig(enabled=True, overcommit=16),
    )
    assert f.capacity == 2 * 2 * 16
    texts = {}
    for k in range(24):  # 6x the 4 physical slots, zero full errors
        g = f"room-{k:02d}"
        texts[g] = f"sharded {k}"
        f.receive_update(g, update_for(texts[g], client_id=k + 1))
    assert f.doc_count == 24
    for _ in range(40):
        g = rng.choice(sorted(texts))
        assert f.text(g) == texts[g]
    f.tick()  # tier maintenance runs fleet-wide without raising
    rows = f.fleet_snapshot()["shards"]
    assert sum(r["resident"] for r in rows) == 24
    assert all(r["docs"] <= 2 for r in rows)  # hot never exceeds slots


@pytest.mark.tiering
def test_rebalancer_sheds_cold_docs_before_hot_ones():
    # the shed order is real heat, not guid sort — make the LOWEST guid
    # the hottest doc; guid order would move it first, heat order must
    # keep it
    f = FleetRouter(
        n_shards=1,
        docs_per_shard=4,
        tier_config=TierConfig(enabled=True, overcommit=1),
    )
    guids = ["aa-hottest", "bb-mid", "cc-mid", "dd-coldest"]
    for k, g in enumerate(guids):
        f.receive_update(g, update_for(f"doc {k}", client_id=k + 1))
    for _ in range(6):
        f.text("aa-hottest")
    f.text("bb-mid")
    f.text("cc-mid")
    f.add_shard()  # empty destination; shard 0 is at 100% occupancy
    moves = [m["guid"] for m in f.rebalancer.plan()]
    assert moves  # over the high watermark: the planner does shed
    assert "dd-coldest" in moves


@pytest.mark.tiering
def test_migration_carries_heat_to_the_destination_shard():
    f = FleetRouter(
        n_shards=2, docs_per_shard=4, tier_config=TierConfig(enabled=True)
    )
    f.receive_update("mover", update_for("travels with heat"))
    for _ in range(5):
        f.text("mover")
    src = f.owner_of("mover")
    score = f.shards[src].tiers.heat_of("mover")
    assert score > 1.0
    dst = 1 - src
    f.migrate_doc("mover", dst)
    assert f.owner_of("mover") == dst
    # the destination inherits the source score (plus its own admission
    # touches) instead of restarting from a cold ~1.0
    assert f.shards[dst].tiers.heat_of("mover") >= score * 0.95


# (the fleet case of tests/test_flush_pipeline.py)


@pytest.mark.failover
@pytest.mark.chaos
@pytest.mark.parametrize("pipeline", [True, False])
def test_kill_primary_mid_pipelined_flush(pipeline, tmp_path, monkeypatch):
    """The primary dies right after a pipelined flush (copies and
    launches possibly still in flight) with a fresh acked tail never
    flushed.  Failover must surface every acked byte in both pipeline
    modes."""
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "1" if pipeline else "0")
    fleet = FleetRouter(
        3, 4, wal_dir=tmp_path, wal_config=SMALL, failover_config=FAST
    )
    rooms = seeded_rooms(seed=21, n_rooms=4, n_ops=8)
    for g, (_d, ups) in rooms.items():
        for u in ups:
            fleet.receive_update(g, u)
    fleet.flush()
    fleet.tick()  # replica copies seeded
    victim = fleet.owner_of("room-0")
    owned = [g for g in rooms if fleet.owner_of(g) == victim]
    assert owned
    for g in owned:  # acked but never flushed: the nastiest tail
        fleet.receive_update(g, edit(rooms[g][0], "tail!"))
    fleet.kill_shard(victim)
    convict(fleet, victim)
    for g, (d, _ups) in rooms.items():
        assert fleet.owner_of(g) is not None
        assert canonical(fleet, g) == canonical_doc(d), g
