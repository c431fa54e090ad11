"""The replication and black-box suites on the port.

The cases of the JAX package's ``tests/test_replication.py`` (replica
fan-out, the heartbeat detector, promotion under a fencing epoch, the
stale-primary fencing paths) and ``tests/test_blackbox_chaos.py`` (a
kill-primary run's flight-recorder dump sharing one episode trace, 20
storm seeds, tracing on against ``YTPU_OBS_DISABLED=1``, a merged fleet
trace validated by ``scripts/check_trace.py``) run here on
``yjs_tpu_torch.fleet.FleetRouter``, every shard on the CPU
(``device="cpu"``), under the ``"cpu"`` and ``"auto"`` provider
backends.
"""

import random
import sys
from pathlib import Path

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.fleet import (
    FailoverConfig,
    FailureDetector,
    ReplicationConfig,
)
from yjs_tpu_torch.obs.blackbox import reset_flight_recorder
from yjs_tpu_torch.sync.session import SessionConfig
from yjs_tpu_torch.sync.transport import PipeNetwork
from yjs_tpu_torch.updates import encode_state_as_update
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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

pytestmark = [pytest.mark.failover, pytest.mark.fleet]


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


# -- metric surface ----------------------------------------------------------


def test_repl_and_failover_metric_families_register(backend):
    fleet = FleetRouter(1, 1, backend=backend)
    names = set(fleet.metrics.registry.names())
    for n in (
        "ytpu_repl_records_total",
        "ytpu_repl_outbox_depth",
        "ytpu_repl_lag",
        "ytpu_repl_replica_docs",
        "ytpu_repl_backpressure_total",
        "ytpu_repl_reseeds_total",
        "ytpu_repl_stalls_total",
        "ytpu_failover_heartbeats_total",
        "ytpu_failover_shard_state",
        "ytpu_failover_suspects_total",
        "ytpu_failover_deaths_total",
        "ytpu_failover_promotions_total",
        "ytpu_failover_fenced_total",
        "ytpu_failover_seconds",
        "ytpu_failover_unavailable_ticks",
    ):
        assert n in names, n


# -- replication fan-out -----------------------------------------------------


def test_fanout_journals_replica_copies(backend, tmp_path):
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    for g, (_d, ups) in seeded_rooms(seed=3, n_rooms=6, n_ops=10).items():
        for u in ups:
            fleet.receive_update(g, u)
    fleet.flush()
    fleet.repl.repair_all()
    snap = fleet.repl.snapshot()
    # every accepted doc has exactly ``factor`` replica copies and the
    # outbox fully drained (lag zero once repaired)
    assert snap["factor"] == 1
    assert sum(snap["replica_docs"].values()) == snap["docs_tracked"] == 6
    assert all(v == 0 for v in snap["lag"].values())
    pairs = set(fleet.repl._applied) | fleet.repl._marked
    for g in [f"room-{j}" for j in range(6)]:
        holders = {s for (g2, s) in pairs if g2 == g}
        assert len(holders) == 1
        assert fleet.owner_of(g) not in holders


def test_outbox_backpressure_drains_inline_never_drops(backend, tmp_path):
    fleet = FleetRouter(
        2, 8, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        repl_config=ReplicationConfig(outbox_max=2, batch=1),
        failover_config=FAST,
    )
    d = Y.Doc(gc=False)
    d.client_id = 7
    for i in range(12):
        fleet.receive_update("room", edit(d, f"{i} "))
    fleet.flush()
    snap = fleet.metrics_snapshot()
    assert snap["counters"]["ytpu_repl_backpressure_total"].get("", 0) > 0
    # despite the tiny outbox nothing was dropped: the replica holds
    # the full history, so killing the primary loses no acked update
    owner = fleet.owner_of("room")
    fleet.kill_shard(owner)
    convict(fleet, owner)
    assert fleet.owner_of("room") != owner
    assert fleet.text("room") == str(d.get_text("text"))


# -- failure detector --------------------------------------------------------


def test_detector_timeline_is_tick_exact_without_jitter():
    det = FailureDetector(
        range(2), config=FailoverConfig(
            suspect_ticks=3, confirm_ticks=2, jitter_ticks=0,
        ),
    )
    timeline = []
    for _ in range(6):
        timeline += det.tick(lambda k: k != 1)
    # shard 1: suspect after exactly 3 misses, dead after 2 more
    assert timeline == [(1, "alive", "suspect"), (1, "suspect", "dead")]
    assert det.state_of(0) == "alive" and det.state_of(1) == "dead"


def test_detector_jitter_is_seed_deterministic():
    cfg = FailoverConfig(suspect_ticks=3, confirm_ticks=2,
                         jitter_ticks=2, seed=42)
    runs = []
    for _ in range(2):
        det = FailureDetector(range(4), config=cfg)
        events = []
        for _ in range(12):
            events += det.tick(lambda k: False)
        runs.append(events)
    assert runs[0] == runs[1]
    # jitter decorrelates: not every shard flips on the same tick —
    # group events by transition and check the per-shard orderings
    # aren't all identical positions
    death_order = [e[0] for e in runs[0] if e[2] == "dead"]
    assert sorted(death_order) == [0, 1, 2, 3]


def test_suspect_acquitted_by_good_probe():
    det = FailureDetector(
        range(1), config=FailoverConfig(
            suspect_ticks=2, confirm_ticks=2, jitter_ticks=0,
        ),
    )
    det.tick(lambda k: False)
    det.tick(lambda k: False)
    assert det.state_of(0) == "suspect"
    det.tick(lambda k: True)  # one good heartbeat clears the strike
    assert det.state_of(0) == "alive"
    det.tick(lambda k: False)
    assert det.state_of(0) == "alive"  # counter restarted from zero


# -- failover ----------------------------------------------------------------


def test_failover_promotes_replica_and_bumps_epoch(backend, tmp_path):
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    rooms = seeded_rooms(seed=8, n_rooms=6, n_ops=10)
    for g, (_d, ups) in rooms.items():
        for u in ups:
            fleet.receive_update(g, u)
    fleet.flush()
    fleet.tick()  # drain the replication outbox
    victim = fleet.owner_of("room-0")
    owned = [g for g in rooms if fleet.owner_of(g) == victim]
    epoch0 = fleet.table.epoch
    fleet.kill_shard(victim)
    convict(fleet, victim)
    assert fleet.table.epoch > epoch0
    roles = {r["shard"]: r["role"] for r in
             fleet.fleet_snapshot()["shards"]}
    assert roles[victim] == "dead"
    for g in owned:
        k = fleet.owner_of(g)
        assert k is not None and k != victim
        # byte-identical against the uninterrupted reference doc
        ref = Y.merge_updates([encode_state_as_update(rooms[g][0])])
        assert Y.merge_updates([fleet.encode_state_as_update(g)]) == ref
    # exactly one engine slot per doc after promotion
    owners = slot_owners(fleet)
    assert all(len(v) == 1 for g, v in owners.items() if g in rooms)
    snap = fleet.metrics_snapshot()
    assert snap["counters"]["ytpu_failover_deaths_total"].get("", 0) >= 1
    assert (
        snap["counters"]["ytpu_failover_promotions_total"]
        .get("outcome=promoted", 0) >= len(owned)
    )
    # and the recovered fleet keeps taking traffic on the moved doc
    fleet.receive_update("room-0", edit(rooms["room-0"][0], "after!"))
    assert "after" in fleet.text("room-0")


def test_unreplicated_update_survives_synchronous_absorb(backend, tmp_path):
    """An update accepted the instant before (or after) the primary
    dies is journaled synchronously on the replica set — acknowledged
    means durable, even with the outbox never drained."""
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    d = Y.Doc(gc=False)
    d.client_id = 5
    fleet.receive_update("room", edit(d, "base "))
    victim = fleet.owner_of("room")
    # kill with the outbox still holding the only copy: no tick has run
    fleet.kill_shard(victim)
    # the stub raises ShardDownError; receive_update absorbs onto the
    # replicas instead of losing the write
    fleet.receive_update("room", edit(d, "late ", pos=5))
    convict(fleet, victim)
    assert fleet.text("room") == str(d.get_text("text"))
    assert "late" in fleet.text("room")


def test_stale_primary_is_fenced_on_revival(backend, tmp_path):
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    d = Y.Doc(gc=False)
    d.client_id = 9
    fleet.receive_update("room", edit(d, "hello "))
    fleet.flush()
    fleet.tick()
    victim = fleet.owner_of("room")
    fleet.kill_shard(victim)
    convict(fleet, victim)
    survivor = fleet.owner_of("room")
    fleet.receive_update("room", edit(d, "world ", pos=6))
    fleet.flush()
    # the old machine comes back with its stale copy: it must be
    # fenced (its claim merged into the current owner), never a second
    # primary
    res = fleet.revive_shard(victim)
    assert "room" in res["fenced"]
    assert fleet.owner_of("room") == survivor
    owners = slot_owners(fleet)
    assert owners.get("room") == [survivor]
    assert fleet.text("room") == str(d.get_text("text"))
    snap = fleet.metrics_snapshot()
    assert snap["counters"]["ytpu_failover_fenced_total"].get("", 0) >= 1


def test_recover_resolves_primary_claims_by_epoch(backend, tmp_path):
    """Crash the whole fleet after a failover: WAL recovery must elect
    the highest-epoch primary claim and fold the stale one."""
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    d = Y.Doc(gc=False)
    d.client_id = 11
    fleet.receive_update("room", edit(d, "pre "))
    fleet.flush()
    fleet.tick()
    victim = fleet.owner_of("room")
    fleet.kill_shard(victim)
    convict(fleet, victim)
    survivor = fleet.owner_of("room")
    fleet.receive_update("room", edit(d, "post ", pos=4))
    fleet.flush()
    crash(fleet)
    del fleet
    rec = FleetRouter.recover(
        tmp_path, backend=backend, wal_config=SMALL,
    )
    # the victim's WAL still claims the doc at the old epoch; the
    # survivor's primary role marker carries the post-failover epoch
    assert rec.owner_of("room") == survivor
    owners = slot_owners(rec)
    assert owners.get("room") == [survivor]
    assert rec.text("room") == str(d.get_text("text"))
    res = rec.last_recovery["resolution"]
    assert res["fenced"] >= 1


def test_checkpoint_reseeds_replicas(backend, tmp_path):
    """WAL compaction folds only owned docs — the fleet checkpoint must
    re-seed every replica pair so promotion still has the full state."""
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    d = Y.Doc(gc=False)
    d.client_id = 13
    fleet.receive_update("room", edit(d, "kept across checkpoint"))
    fleet.flush()
    fleet.tick()
    fleet.checkpoint()
    snap = fleet.metrics_snapshot()
    assert snap["counters"]["ytpu_repl_reseeds_total"].get("", 0) >= 1
    victim = fleet.owner_of("room")
    fleet.kill_shard(victim)
    convict(fleet, victim)
    assert fleet.text("room") == "kept across checkpoint"


# -- placement never targets unhealthy shards ---------------------


def test_drain_and_rebalance_skip_suspect_shards(backend, tmp_path):
    fleet = FleetRouter(
        3, 8, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FailoverConfig(
            suspect_ticks=1, confirm_ticks=8, jitter_ticks=0,
        ),
    )
    for g, (_d, ups) in seeded_rooms(seed=4, n_rooms=6, n_ops=10).items():
        for u in ups:
            fleet.receive_update(g, u)
    fleet.flush()
    # one missed probe turns shard 2 suspect (but far from dead)
    fleet.detector.tick(lambda k: k != 2)
    assert fleet.detector.state_of(2) == "suspect"
    before = {g: fleet.owner_of(g) for g in slot_owners(fleet)}
    src = next(k for k in (0, 1) if any(v == k for v in before.values()))
    moved = fleet.drain_shard(src)
    assert moved == sum(1 for v in before.values() if v == src)
    # every migrated doc landed on the one healthy destination
    for g, k0 in before.items():
        if k0 == src:
            assert fleet.owner_of(g) not in (src, 2)
    assert all(d["dst"] != 2 for d in fleet.rebalancer.plan())


# -- sessions resume (not resync) across recovery ----------------


def _drive(*providers):
    def fn():
        for p in providers:
            p.flush()
        for p in providers:
            p.tick_sessions()

    return fn


def test_session_survives_failover_without_full_resync(backend, tmp_path):
    """The failover-path resume pin: the primary dies under a live
    session; rehome onto the promoted shard keeps the session live —
    no reconnect, no second full resync."""
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    peer = TpuProvider(1, backend=backend)
    net = PipeNetwork()
    tf, tp = net.pair()
    sf = fleet.session("room", "peer", quiet_config(antientropy=2))
    sp = peer.session("room", "fleet", quiet_config(antientropy=2))
    sf.connect(tf)
    sp.connect(tp)
    net.settle((_drive(fleet, peer),))
    peer.receive_update("room", update_for("pre-failover "))
    net.settle((_drive(fleet, peer),))
    assert fleet.text("room") == "pre-failover "
    fleet.flush()
    fleet.tick()
    victim = fleet.owner_of("room")
    fleet.kill_shard(victim)
    convict(fleet, victim)
    assert sf.routing_epoch == fleet.table.epoch
    assert not sf._closed and sf.state == "live"
    net.settle((_drive(fleet, peer),), max_rounds=80, idle_rounds=3)
    peer.receive_update("room", update_for("post-failover", client_id=3))
    net.settle((_drive(fleet, peer),), max_rounds=80, idle_rounds=3)
    assert "post-failover" in fleet.text("room")
    assert fleet.text("room") == peer.text("room")
    assert sf.n_full_resyncs == 1 and sp.n_full_resyncs == 1


def test_session_resumes_after_fleet_recovery(backend, tmp_path):
    """The recovery-path resume pin: a fleet killed and
    rebuilt from its WALs re-arms sessions with the journaled receive
    floor — the surviving peer RESUMES (``ytpu_net_resumes_total``
    increments, ``full_resyncs`` stays 1)."""
    cfg = quiet_config()
    fleet = FleetRouter(
        2, 4, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    peer = TpuProvider(2, backend=backend)
    net = PipeNetwork()
    tf, tp = net.pair()
    fleet.session("room", "peer", cfg).connect(tf)
    s2 = peer.session("room", "fleet", cfg)
    s2.connect(tp)
    net.settle((_drive(fleet, peer),))
    peer.receive_update("room", update_for("before crash"))
    net.settle((_drive(fleet, peer),))
    assert fleet.text("room") == "before crash"
    net.kill(tf, tp)
    crash(fleet)
    del fleet
    # the survivor keeps editing while the fleet is down
    peer.receive_update("room", update_for("offline edit / ", client_id=3))
    rec = FleetRouter.recover(tmp_path, backend=backend, wal_config=SMALL)
    sr = rec.session("room", "peer", cfg)  # armed with the WAL ack floor
    tf2, tp2 = net.pair()
    sr.connect(tf2)
    s2.attach(tp2)
    net.settle((_drive(rec, peer),))
    assert rec.text("room") == peer.text("room")
    assert "offline edit" in rec.text("room")
    assert s2.n_resumes == 1
    assert s2.n_full_resyncs == 1
    # the pin lands in the metric family too (survivor's registry)
    snap = peer.metrics_snapshot()
    assert snap["counters"]["ytpu_net_resumes_total"].get("", 0) >= 1


sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))


STORM_SEEDS = tuple(range(20))


def _resolvable(trace):
    return (
        isinstance(trace, str) and len(trace) == 32
        and int(trace, 16) >= 0
    )


# -- the headline acceptance criterion ---------------------------------------


@pytest.mark.tracing
@pytest.mark.chaos
def test_kill_primary_dumps_one_traced_episode(backend, tmp_path, monkeypatch):
    """Kill a primary under live sessions: the failover auto-dump must
    contain conviction + promotion + rehome + complete events all
    stamped with the SAME forced-sampled trace id, and the dump must
    land on disk when ``YTPU_BLACKBOX_DIR`` is set."""
    monkeypatch.setenv("YTPU_BLACKBOX_DIR", str(tmp_path / "bb"))
    rec = reset_flight_recorder()
    fleet = FleetRouter(
        3, 4, backend=backend, wal_dir=tmp_path / "wal", wal_config=SMALL,
        failover_config=FAST,
    )
    rooms = seeded_rooms(seed=21, n_rooms=4, n_ops=8)
    for g, (_d, ups) in rooms.items():
        for u in ups:
            fleet.receive_update(g, u)
    fleet.flush()
    fleet.tick()
    # a live peer session on room-0 so the failover has one to rehome
    cfg = SessionConfig(
        heartbeat=0, liveness=0, antientropy=0, hello_timeout=0,
        retry_base=4, retry_jitter=0.0, seed=1,
    )
    pa = TpuProvider(1, backend=backend)
    net = PipeNetwork()
    tx, ty = net.pair("fleet", "A")
    sx = fleet.session("room-0", "A", cfg)
    sy = pa.session("room-0", "fleet", cfg)
    sx.connect(tx)
    sy.connect(ty)
    net.settle((sx.tick, sy.tick))
    assert sx.state == "live"

    victim = fleet.owner_of("room-0")
    fleet.kill_shard(victim)
    convict(fleet, victim)

    dump = rec.last_dump
    assert dump is not None and dump["reason"] == "failover"
    fo = [e for e in dump["events"] if e["subsystem"] == "failover"]
    kinds = {e["event"] for e in fo}
    assert {"conviction", "promotion", "rehome", "complete"} <= kinds
    # ONE episode trace ties the whole story together
    traces = {e["trace"] for e in fo}
    assert len(traces) == 1
    (episode,) = traces
    assert _resolvable(episode)
    assert dump["context"]["trace"] == episode
    assert dump["context"]["shard"] == victim
    # the dump also shipped to disk
    files = sorted((tmp_path / "bb").glob("blackbox-failover-*.json"))
    assert files and files[-1].name.endswith("-0001.json")
    # the conviction names a rehomed peer for the session we attached
    rehomes = [e for e in fo if e["event"] == "rehome"]
    assert any(e["guid"] == "room-0" and e["kv"]["peer"] == "A"
               for e in rehomes)
    # forensics never cost correctness: every doc survived promotion
    for g, (d, _ups) in rooms.items():
        assert canonical(fleet, g) == canonical_doc(d), g


# -- 20-seed storm: every failure event is dumped, traced --------------------


@pytest.mark.tracing
@pytest.mark.chaos
@pytest.mark.parametrize("seed", STORM_SEEDS)
def test_storm_every_failure_event_dumped_with_trace(backend, seed, tmp_path):
    """Per seed: poison one room (dead letters + rollback), then kill
    the primary.  Every dead-letter / failover event recorded during
    the run must appear in an emitted dump, and every failover event
    must carry the episode's resolvable trace id."""
    rec = reset_flight_recorder()
    fleet = FleetRouter(
        3, 3, backend=backend, wal_dir=tmp_path, wal_config=SMALL,
        failover_config=FAST,
    )
    rooms = seeded_rooms(seed, n_rooms=3, n_ops=6)
    for g, (_d, ups) in rooms.items():
        for u in ups:
            fleet.receive_update(g, u)
    fleet.flush()
    fleet.tick()
    # dead-letter seam: a poison update rolls back and dead-letters on
    # the owner (and on any replica that mirrors it)
    gen = random.Random(seed)
    poison_room = f"room-{gen.randrange(3)}"
    fleet.receive_update(poison_room, b"\xff\xff\xff\xff\xff")
    fleet.flush()
    # failover seam
    victim = fleet.owner_of("room-0")
    fleet.kill_shard(victim)
    convict(fleet, victim)

    must_dump = [
        e for e in rec.snapshot()
        if (e["subsystem"], e["event"]) in (
            ("resilience", "dead_letter"),
            ("failover", "conviction"),
            ("failover", "promotion"),
            ("failover", "doc_lost"),
            ("failover", "rehome"),
        )
    ]
    assert any(e["event"] == "dead_letter" for e in must_dump), seed
    assert any(e["event"] == "conviction" for e in must_dump), seed
    dumped_ticks = {
        e["tick"] for d in rec.dumps for e in d["events"]
    }
    for e in must_dump:
        assert e["tick"] in dumped_ticks, (seed, e)
        if e["subsystem"] == "failover":
            assert _resolvable(e["trace"]), (seed, e)
    episode = {
        e["trace"] for e in must_dump if e["subsystem"] == "failover"
    }
    assert len(episode) == 1, seed
    # and the storm never cost convergence on the healthy rooms
    for g, (d, _ups) in rooms.items():
        if g != poison_room:
            assert canonical(fleet, g) == canonical_doc(d), (seed, g)


# -- tracing must be free: byte-identical on vs off --------------------------


@pytest.mark.tracing
@pytest.mark.chaos
def test_convergence_identical_tracing_on_vs_obs_disabled(backend, tmp_path, monkeypatch):
    """The full pipeline — ingest, flush, replication, failover — must
    produce byte-identical documents with everything sampled vs
    ``YTPU_OBS_DISABLED=1`` (the acceptance criterion that tracing is
    observation, never participation)."""

    def run(flag_env):
        for k, v in flag_env.items():
            monkeypatch.setenv(k, v)
        try:
            reset_flight_recorder()
            fleet = FleetRouter(
                3, 4, backend=backend,
                wal_dir=tmp_path / "-".join(sorted(flag_env)),
                wal_config=SMALL, failover_config=FAST,
            )
            rooms = seeded_rooms(seed=33, n_rooms=4, n_ops=8)
            for g, (_d, ups) in rooms.items():
                for u in ups:
                    fleet.receive_update(g, u)
            fleet.flush()
            fleet.tick()
            victim = fleet.owner_of("room-0")
            fleet.kill_shard(victim)
            convict(fleet, victim)
            for g, (d, _ups) in rooms.items():
                fleet.receive_update(g, edit(d, "after failover "))
            fleet.flush()
            out = {g: canonical(fleet, g) for g in rooms}
            refs = {g: canonical_doc(d) for g, (d, _u) in rooms.items()}
            return out, refs
        finally:
            for k in flag_env:
                monkeypatch.delenv(k)

    traced, refs_a = run({"YTPU_TRACE_SAMPLE": "1"})
    dark, refs_b = run({"YTPU_OBS_DISABLED": "1", "YTPU_BLACKBOX": "0"})
    assert traced == dark
    assert traced == refs_a == refs_b


# -- the merged trace validates under check_trace's invariants ----------------


@pytest.mark.tracing
@pytest.mark.chaos
def test_merged_fleet_trace_validates_green(backend, monkeypatch):
    """Everything-sampled 3-shard run, all shard tracers merged: every
    flow arrow resolves both ways and every sampled ingress chain
    reaches a convergence flow-finish (the same invariants CI enforces
    via ``check_trace --selftest``)."""
    import check_trace

    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "1")
    fleet = FleetRouter(3, 4, backend=backend)
    rooms = seeded_rooms(seed=44, n_rooms=4, n_ops=8)
    for _round in range(2):
        for g, (d, _ups) in sorted(rooms.items()):
            fleet.receive_update(g, edit(d, f"{g} r{_round} "))
        fleet.flush()
        fleet.tick()
    fleet.repl.repair_all()
    fleet.flush()

    events = []
    for p in fleet.shards:
        events.extend(p.engine.obs.tracer.trace_events())
    events.sort(key=lambda e: e.get("ts", 0.0))
    assert check_trace.validate_events(events) == []
    ingress = {
        (e.get("args") or {}).get("trace")
        for e in events
        if str(e.get("name", "")).startswith(check_trace.INGRESS_NAMES)
        and (e.get("args") or {}).get("trace")
    }
    assert ingress, "no sampled ingress spans in the merged trace"
    assert any(
        e.get("name") == "ytpu.repl.fanout" and e.get("ph") == "f"
        for e in events
    ), "no replication fan-out arrows in the merged trace"
