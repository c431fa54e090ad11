"""The geo replication suites on the port.

The cases of the JAX package's ``tests/test_geo.py`` (doc-space codecs,
the space session host, the WAN chaos profile, anti-entropy jitter,
``KIND_GEO`` journaling and recovery, the replicator's scheduler and
epochs) and ``tests/test_geo_chaos.py`` (three regions under a 20-seed
WAN storm, a clean mesh, a region killed and recovered) run here on
``yjs_tpu_torch.geo.GeoReplicator`` over port providers on the CPU
(``device="cpu"``), under the ``"cpu"`` and ``"auto"`` provider
backends.
"""

import json
import random

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.geo import (
    GeoConfig,
    GeoReplicator,
    SpaceSessionHost,
    decode_space_sv,
    decode_space_update,
    encode_space_sv,
    encode_space_update,
)
from yjs_tpu_torch.obs.blackbox import reset_flight_recorder
from yjs_tpu_torch.persistence import KIND_GEO
from yjs_tpu_torch.resilience import NetChaosConfig, NetworkFaultInjector
from yjs_tpu_torch.sync.session import (
    DocSessionHost,
    SessionConfig,
    SyncSession,
)
from yjs_tpu_torch.sync.transport import PipeNetwork
from yjs_tpu_torch.updates import encode_state_as_update
from torch_service import BACKENDS, TpuProvider

pytestmark = pytest.mark.geo


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


GEO_SESSION = dict(
    heartbeat=0, liveness=0, antientropy=8, hello_timeout=0,
    retry_base=4, retry_cap=16, retry_max=6, retry_jitter=0.25,
)


def _mk_update(text: str, client_id: int = 7) -> bytes:
    d = Y.Doc(gc=False)
    d.client_id = client_id
    d.get_text("text").insert(0, text)
    return encode_state_as_update(d)


def _mk_pair(backend, seed=1, n_docs=4, wal_a=None, wal_b=None, geo_kw=None):
    cfg = SessionConfig(seed=seed, **GEO_SESSION)
    a = TpuProvider(n_docs, backend=backend,
                    wal_dir=None if wal_a is None else str(wal_a))
    b = TpuProvider(n_docs, backend=backend,
                    wal_dir=None if wal_b is None else str(wal_b))
    net = PipeNetwork()
    ta, tb = net.pair("geo:A", "geo:B")
    kw = dict(geo_kw or {})
    ra = GeoReplicator(a, GeoConfig(region="A", seed=seed, **kw))
    rb = GeoReplicator(b, GeoConfig(region="B", seed=seed + 1, **kw))
    ra.add_peer("B", lambda: ta, session_config=cfg)
    rb.add_peer("A", lambda: tb, session_config=cfg)
    return a, b, ra, rb, net


def _run(net, provs, reps, rounds):
    for _ in range(rounds):
        for p in provs:
            p.flush()
        for r in reps:
            r.tick()
        net.pump()


# -- codecs -------------------------------------------------------------------


def test_space_sv_roundtrip():
    svs = {"room-a": {1: 5, 9: 2}, "room-b": {3: 1}, "empty": {}}
    assert decode_space_sv(encode_space_sv(svs)) == svs


def test_space_sv_tolerates_garbage():
    assert decode_space_sv(None) == {}
    assert decode_space_sv(b"") == {}
    assert decode_space_sv(b"\xff\xff\xff\xff") == {}


def test_space_update_roundtrip():
    parts = [("room-a", b"\x01\x02\x03"), ("room-b", b"")]
    assert decode_space_update(encode_space_update(parts)) == parts


def test_space_update_raises_on_malformed():
    with pytest.raises(Exception):
        decode_space_update(b"\x05only-one-entry")


# -- the space session host ---------------------------------------------------


def test_ahead_behind_space_granularity(backend):
    p = TpuProvider(4, backend=backend)
    p.receive_update("room-a", _mk_update("local", 11))
    p.flush()
    host = SpaceSessionHost(p)
    # peer has nothing: strictly ahead
    ahead, behind = host.ahead_behind(encode_space_sv({}))
    assert ahead and not behind
    # peer mirrors us exactly: neither
    mine = decode_space_sv(host.state_vector())
    ahead, behind = host.ahead_behind(encode_space_sv(mine))
    assert not ahead and not behind
    # peer holds a doc we never heard of: behind
    theirs = dict(mine)
    theirs["room-z"] = {42: 3}
    ahead, behind = host.ahead_behind(encode_space_sv(theirs))
    assert behind and not ahead


def test_diff_update_ships_only_missing_docs(backend):
    p = TpuProvider(4, backend=backend)
    p.receive_update("room-a", _mk_update("alpha", 11))
    p.receive_update("room-b", _mk_update("beta", 12))
    p.flush()
    host = SpaceSessionHost(p)
    mine = decode_space_sv(host.state_vector())
    # the peer already has room-a; only room-b should ship
    peer_sv = {"room-a": mine["room-a"]}
    parts = decode_space_update(
        host.diff_update(encode_space_sv(peer_sv))
    )
    assert [g for g, _ in parts] == ["room-b"]


def test_apply_update_routes_through_internal_ingress(backend):
    p = TpuProvider(4, backend=backend)
    host = SpaceSessionHost(p)
    payload = encode_space_update([("room-x", _mk_update("wan", 13))])
    host.apply_update(payload)
    p.flush()
    assert p.text("room-x") == "wan"
    assert "room-x" in host.docs()  # remote applies feed doc discovery


# -- WAN chaos profile --------------------------------------------------------


def _due(dst, n):
    return [(0, dst, bytes([i])) for i in range(n)]


class _FakeDst:
    def __init__(self, name):
        self.name = name


def test_oneway_partition_loses_one_direction_only():
    inj = NetworkFaultInjector(NetChaosConfig(seed=3, oneway=1.0))
    inj.register_link("geo:A", "geo:B")
    a, b = _FakeDst("geo:A"), _FakeDst("geo:B")
    lost = {"geo:A": 0, "geo:B": 0}
    passed = {"geo:A": 0, "geo:B": 0}
    for rnd in range(200):
        due = _due(a, 1) + _due(b, 1)
        deliver, defer = inj.filter_due(due, rnd)
        assert not defer
        for name in lost:
            got = sum(1 for e in deliver if e[1].name == name)
            (passed if got else lost)[name] += 1
    # windows opened (frames were lost) but never both directions in
    # the same round — the injector kills exactly one victim direction
    assert inj.fault_counts["net_oneway"] > 0
    for rnd in range(50):
        due = _due(a, 1) + _due(b, 1)
        deliver, _ = inj.filter_due(due, rnd)
        names = {e[1].name for e in deliver}
        assert names, "one-way partition must never drop BOTH directions"


def test_flap_windows_are_deterministic():
    inj = NetworkFaultInjector(NetChaosConfig(seed=3, flap_ticks=5))
    # 75% duty cycle: up for rounds 0..14, down for 15..19, repeating
    assert not inj._flap_down(0)
    assert not inj._flap_down(14)
    assert inj._flap_down(15)
    assert inj._flap_down(19)
    assert not inj._flap_down(20)
    dst = _FakeDst("geo:A")
    deliver, _ = inj.filter_due(_due(dst, 2), 15)
    assert deliver == []
    assert inj.fault_counts["net_flap"] == 2


def test_bandwidth_cap_defers_instead_of_losing():
    inj = NetworkFaultInjector(NetChaosConfig(seed=3, bw_frames=2))
    dst = _FakeDst("geo:A")
    due = _due(dst, 5)
    deliver, defer = inj.filter_due(due, 1)
    assert len(deliver) == 2 and len(defer) == 3
    assert deliver == due[:2]  # FIFO under the cap, not sampling
    assert inj.fault_counts["net_bw"] == 3


def test_rtt_floor_delays_every_frame():
    inj = NetworkFaultInjector(
        NetChaosConfig(seed=3, rtt_ticks=7, rtt_jitter_ticks=2)
    )
    for _ in range(50):
        for delay in inj.fates(b"frame"):
            assert delay is not None and 7 <= delay <= 9
    # a latency profile, not a counted fault
    assert inj.fault_counts["net_drop"] == 0


def test_wan_env_knobs(monkeypatch):
    monkeypatch.setenv("YTPU_CHAOS_NET_PARTITION_ONEWAY", "0.25")
    monkeypatch.setenv("YTPU_CHAOS_NET_FLAP_TICKS", "9")
    monkeypatch.setenv("YTPU_CHAOS_NET_RTT_TICKS", "15")
    monkeypatch.setenv("YTPU_CHAOS_NET_RTT_JITTER_TICKS", "4")
    monkeypatch.setenv("YTPU_CHAOS_NET_BW_FRAMES", "32")
    cfg = NetChaosConfig.from_env()
    assert cfg.oneway == 0.25
    assert cfg.flap_ticks == 9
    assert cfg.rtt_ticks == 15
    assert cfg.rtt_jitter_ticks == 4
    assert cfg.bw_frames == 32
    assert cfg.any_faults()


# -- anti-entropy jitter ------------------------------------------


def test_ae_jitter_spreads_digest_ticks():
    """Two sessions sharing a seed draw DIFFERENT digest jitter (the
    per-peer keyed stream), and the jitter never exceeds a quarter of
    the anti-entropy interval."""
    cfg = SessionConfig(seed=9, antientropy=16, heartbeat=0,
                        liveness=0, hello_timeout=0)
    docs = [Y.Doc(gc=False), Y.Doc(gc=False)]
    sessions = [
        SyncSession(DocSessionHost(d), cfg, peer=f"p{i}")
        for i, d in enumerate(docs)
    ]
    net = PipeNetwork()
    jitters = set()
    for s in sessions:
        t, _ = net.pair()
        s.connect(t)
        s._send_digest()
        assert 0 <= s._ae_jitter <= cfg.antientropy // 4
        jitters.add(s._ae_jitter)
    assert len(jitters) == 2  # distinct per-peer streams, distinct draws


def test_ae_jitter_stream_is_separate_from_backoff():
    """Drawing digest jitter must not perturb the retransmit backoff
    sequence — the two RNGs are independent keyed streams."""
    cfg = SessionConfig(seed=4, antientropy=16, heartbeat=0,
                        liveness=0, hello_timeout=0)
    a = SyncSession(DocSessionHost(Y.Doc(gc=False)), cfg, peer="a")
    b = SyncSession(DocSessionHost(Y.Doc(gc=False)), cfg, peer="b")
    b.sid = a.sid  # same identity -> same seeded backoff stream
    import random as _random

    b._rng = _random.Random((cfg.seed << 8) ^ b.sid)
    b._ae_rng = _random.Random(f"ae:{cfg.seed}:{a.peer}")
    for _ in range(5):
        b._ae_rng.random()  # extra jitter draws on one side only
    assert [a._backoff(i) for i in range(1, 6)] == [
        b._backoff(i) for i in range(1, 6)
    ]


# -- retry-cap force-sample seam ----------------------------------


def test_retry_cap_dead_letter_is_force_sampled():
    """A frame that exhausts its retry budget must land a blackbox
    event carrying a FORCED trace — loss evidence survives production
    sampling rates (the seam-force-sample lint rule pins the code
    shape; this pins the behavior)."""
    rec = reset_flight_recorder()
    cfg = SessionConfig(seed=2, retry_base=1, retry_cap=1, retry_max=2,
                        retry_jitter=0.0, heartbeat=0, liveness=0,
                        antientropy=0, hello_timeout=0)
    doc = Y.Doc(gc=False)
    sess = SyncSession(DocSessionHost(doc), cfg, peer="wan")
    net = PipeNetwork()
    ta, tb = net.pair()
    sess.connect(ta)
    peer = SyncSession(DocSessionHost(Y.Doc(gc=False)), cfg, peer="rev")
    peer.connect(tb)
    for _ in range(6):
        net.pump()
        sess.tick()
        peer.tick()
    assert sess.state == "live"
    # black-hole the wire: sends still "succeed" (no transport loss,
    # so the session keeps retrying) but every frame — data and acks —
    # is dropped, burning the retry budget
    net.injector = NetworkFaultInjector(NetChaosConfig(seed=1, drop=1.0))
    doc.get_text("text").insert(0, "doomed")
    sess.send_update(encode_state_as_update(doc))
    for _ in range(40):
        net.pump()
        sess.tick()
        peer.tick()
        if sess.n_dead_lettered:
            break
    assert sess.n_dead_lettered >= 1
    events = [
        e for e in rec.snapshot()
        if e.get("event") == "retry_cap_dead_letter"
    ]
    assert events, "retry-cap exhaustion must land a blackbox event"
    evt = events[-1]
    assert evt["subsystem"] == "session"
    assert evt["severity"] == "warning"
    assert evt.get("trace"), "the dead-letter trace must be force-sampled"
    assert evt["kv"]["attempts"] >= cfg.retry_max


# -- KIND_GEO journaling + recovery -------------------------------------------


def test_kind_geo_roundtrips_through_recovery(backend, tmp_path):
    p = TpuProvider(2, backend=backend, wal_dir=str(tmp_path))
    p.journal_geo_link("region-b", sid=12, seq=34, epoch=2)
    p.journal_geo_link("region-b", sid=12, seq=99, epoch=3)  # LAST wins
    p.journal_geo_link("region-c", sid=7, seq=1, epoch=3)
    del p
    pr = TpuProvider.recover(str(tmp_path), backend=backend)
    assert pr.last_recovery["geo_links"] == 2
    assert pr._recovered_geo["region-b"] == {
        "sid": 12, "seq": 99, "epoch": 3,
    }
    assert pr._recovered_geo["region-c"] == {
        "sid": 7, "seq": 1, "epoch": 3,
    }


def test_recovered_replicator_bumps_fencing_epoch(backend, tmp_path):
    p = TpuProvider(2, backend=backend, wal_dir=str(tmp_path))
    p.journal_geo_link("B", sid=5, seq=17, epoch=4)
    del p
    pr = TpuProvider.recover(str(tmp_path), backend=backend)
    rep = GeoReplicator(pr, GeoConfig(region="A", seed=1))
    # the restart is a new fencing era: max journaled epoch + 1
    assert rep.epoch == 5
    link = rep.add_peer("B", lambda: None)
    # the journaled floor armed the session's resume hint
    assert link.session._resume_hint == (5, 17)


def test_checkpoint_rejournals_geo_floors(backend, tmp_path):
    a, b, ra, rb, net = _mk_pair(backend, wal_a=tmp_path / "a")
    a.receive_update("room", _mk_update("floor me"))
    _run(net, (a, b), (ra, rb), 40)
    assert ra.links["B"].floor["seq"] >= 1
    a.checkpoint()
    del a, ra
    pr = TpuProvider.recover(str(tmp_path / "a"), backend=backend)
    assert pr._recovered_geo["B"]["seq"] >= 1


# -- replicator behavior ------------------------------------------------------


def test_two_region_convergence_and_floors(backend):
    a, b, ra, rb, net = _mk_pair(backend)
    a.receive_update("room-1", _mk_update("hello from A", 11))
    b.receive_update("room-2", _mk_update("hello from B", 12))
    _run(net, (a, b), (ra, rb), 50)
    assert a.text("room-1") == b.text("room-1") == "hello from A"
    assert a.text("room-2") == b.text("room-2") == "hello from B"
    for rep, peer in ((ra, "B"), (rb, "A")):
        link = rep.links[peer]
        assert link.session.state == "live"
        assert link.session.n_full_resyncs == 1
        assert link.floor["seq"] >= 1
        assert rep.detector.state_of(peer) == "alive"


def test_budget_scheduler_defers_oldest_first(backend):
    """A tiny link budget forces one doc per tick, oldest dirty doc
    first; deferred docs are counted and eventually ship."""
    geo_kw = dict(link_budget_bps=800, tick_ms=10)  # 1 B/tick accrual
    a, b, ra, rb, net = _mk_pair(backend, n_docs=8, geo_kw=geo_kw)
    _run(net, (a, b), (ra, rb), 12)  # settle handshake
    before = ra.metrics.deferrals.value
    for i in range(4):
        a.receive_update(f"room-{i}", _mk_update(f"doc {i}", 20 + i))
        a.flush()
        ra.tick()  # each doc dirties on its own tick: distinct ages
    _run(net, (a, b), (ra, rb), 250)
    assert ra.metrics.deferrals.value > before
    for i in range(4):
        assert b.text(f"room-{i}") == f"doc {i}"


def test_coalesced_updates_counted(backend):
    a, b, ra, rb, net = _mk_pair(backend, geo_kw=dict(link_budget_bps=80))
    _run(net, (a, b), (ra, rb), 12)
    before = ra.metrics.coalesced.value
    # many updates to ONE doc between scheduler ticks: later marks
    # absorb into the already-dirty entry instead of shipping their
    # own frames (the coalesce path)
    for i in range(6):
        a.receive_update("room", _mk_update(f"edit {i} ", 30 + i))
        a.flush()
    assert ra.metrics.coalesced.value > before
    _run(net, (a, b), (ra, rb), 400)
    assert a.text("room") == b.text("room")


def test_link_reconnect_backoff_and_revival(backend):
    a, b, ra, rb, net = _mk_pair(backend)
    _run(net, (a, b), (ra, rb), 20)
    la, lb = ra.links["B"], rb.links["A"]
    assert la.session.state == "live"
    # sever the WAN; connect_fn returns None while it is down
    down = {"down": True}
    ta2 = {}

    def connect_a():
        if down["down"]:
            return None
        return ta2["t"]

    def connect_b():
        if down["down"]:
            return None
        return ta2["u"]

    la.connect_fn = connect_a
    lb.connect_fn = connect_b
    net.kill(la.session.transport, lb.session.transport)
    assert la.session.state == "reconnecting"
    for _ in range(30):
        ra.tick()
        rb.tick()
    # the detector convicted the dead link
    assert ra.detector.state_of("B") in ("suspect", "dead")
    n_attempts_window = la._reconnect_attempts
    assert n_attempts_window >= 1  # backoff is retrying
    # WAN heals
    down["down"] = False
    ta2["t"], ta2["u"] = net.pair("geo:A", "geo:B")
    a.receive_update("post-heal", _mk_update("after the partition"))
    _run(net, (a, b), (ra, rb), 120)
    assert la.session.state == "live"
    assert b.text("post-heal") == "after the partition"
    assert ra.detector.state_of("B") == "alive"
    assert la.n_reconnects == 1
    # resumed, not full-resynced: seq spaces carried across the outage
    assert la.session.n_full_resyncs == 1


def test_epoch_poll_rehomes_links(backend):
    """An upstream routing-epoch bump (fleet/cluster failover) advances
    the region fencing epoch and rehomes every link."""

    class _Table:
        epoch = 3

    a, b, ra, rb, net = _mk_pair(backend)
    _run(net, (a, b), (ra, rb), 20)
    a.table = _Table()  # facade grows a routing table mid-flight
    ra.tick()  # baseline observation: no rehome
    e0 = ra.epoch
    a.table.epoch = 4
    ra.tick()
    assert ra.epoch == e0 + 1
    assert ra.links["B"].floor["epoch"] == ra.epoch
    assert ra.links["B"].session.routing_epoch == ra.epoch
    # push entry point dedups against the poll
    ra.notify_epoch(4)
    assert ra.epoch == e0 + 1


def test_snapshot_shape_for_statusz(backend):
    a, b, ra, rb, net = _mk_pair(backend)
    _run(net, (a, b), (ra, rb), 20)
    snap = a.statusz()["geo"]
    assert snap["region"] == "A"
    assert len(snap["links"]) == 1
    row = snap["links"][0]
    for key in ("link", "state", "detector", "outbox", "dirty_docs",
                "lag_bytes", "lag_seconds", "reconnects", "resumes",
                "full_resyncs", "dead_letters", "floor"):
        assert key in row
    # and the metrics snapshot used by ytpu_top carries the same block
    assert a.metrics_snapshot()["geo"]["region"] == "A"


def test_geo_config_env_knobs(monkeypatch):
    monkeypatch.setenv("YTPU_GEO_REGION", "eu-west")
    monkeypatch.setenv("YTPU_GEO_LINK_BUDGET_BPS", "125000")
    monkeypatch.setenv("YTPU_GEO_TICK_MS", "20")
    monkeypatch.setenv("YTPU_GEO_RECONNECT_BASE", "8")
    monkeypatch.setenv("YTPU_GEO_RECONNECT_CAP", "128")
    monkeypatch.setenv("YTPU_GEO_RECONNECT_JITTER", "0.5")
    cfg = GeoConfig()
    assert cfg.region == "eu-west"
    assert cfg.link_budget_bps == 125000
    assert cfg.tick_ms == 20
    assert cfg.reconnect_base == 8
    assert cfg.reconnect_cap == 128
    assert cfg.reconnect_jitter == 0.5
    assert cfg.budget_per_tick() == 2500


def test_geo_json_payload_shape(backend, tmp_path):
    """The KIND_GEO payload is the documented JSON contract: an empty
    guid (link state is region-scoped, not per-doc) and a
    ``{peer, sid, seq, epoch}`` JSON body."""
    from yjs_tpu_torch.persistence.recovery import iter_file_events, scan_wal

    p = TpuProvider(2, backend=backend, wal_dir=str(tmp_path))
    p.journal_geo_link("B", sid=1, seq=2, epoch=3)
    p.close(checkpoint=False)
    _, segs = scan_wal(str(tmp_path))
    recs = [
        val for _, path in segs
        for kind, val, *_ in iter_file_events(path, final=False)
        if kind == "record" and val.kind == KIND_GEO
    ]
    assert recs, "journal_geo_link must land a KIND_GEO record"
    assert recs[-1].guid == ""
    info = json.loads(recs[-1].payload.decode("utf-8"))
    assert info == {"peer": "B", "sid": 1, "seq": 2, "epoch": 3}


CORPUS_SEEDS = tuple(range(20))


# the full WAN storm: every classic fault plus the geo-profile faults
# (asymmetric one-way partitions and deterministic link flapping)
WAN_STORM = dict(
    drop=0.15, duplicate=0.15, delay=0.2, reorder=0.25, partition=0.03,
    oneway=0.03, flap_ticks=11,
)


REGIONS = ("A", "B", "C")


ROOMS = ("room-0", "room-1", "room-2")


class GeoMesh:
    """Three regions in a full WAN mesh, each link its own faulted
    PipeNetwork; tracks every accepted token for the acked-loss
    oracle."""

    PAIRS = (("A", "B"), ("A", "C"), ("B", "C"))

    def __init__(self, backend, seed: int, faults: dict, wal_dirs=None):
        self.seed = seed
        self.session_cfg = SessionConfig(seed=seed, **GEO_SESSION)
        self.provs: dict[str, TpuProvider] = {}
        self.reps: dict[str, GeoReplicator] = {}
        self.nets: dict[tuple[str, str], PipeNetwork] = {}
        # (src, dst) -> {"t": transport | None}; links reconnect
        # through these, so tests heal a WAN cut by swapping the holder
        self.holders: dict[tuple[str, str], dict] = {}
        self.accepted: dict[str, set] = {r: set() for r in ROOMS}
        self._gen = random.Random(seed)
        self._n_edits = 0
        for i, r in enumerate(REGIONS):
            wal = None if wal_dirs is None else str(wal_dirs[r])
            self.provs[r] = TpuProvider(8, backend=backend, wal_dir=wal)
            self.reps[r] = GeoReplicator(
                self.provs[r],
                GeoConfig(region=r, seed=seed * 7 + i,
                          reconnect_cap=8),
            )
        for i, (x, y) in enumerate(self.PAIRS):
            inj = (
                NetworkFaultInjector(NetChaosConfig(
                    seed=(seed * 31 + i) & 0x7FFFFFFF, **faults,
                ))
                if faults
                else None
            )
            self.nets[(x, y)] = PipeNetwork(inj)
            self.connect(x, y)

    def connect(self, x: str, y: str) -> None:
        tx, ty = self.nets[(x, y)].pair(f"geo:{x}", f"geo:{y}")
        hx = self.holders.setdefault((x, y), {"t": None})
        hy = self.holders.setdefault((y, x), {"t": None})
        hx["t"], hy["t"] = tx, ty
        for region, peer, h in ((x, y, hx), (y, x, hy)):
            if peer not in self.reps[region].links:
                self.reps[region].add_peer(
                    peer, (lambda hh: (lambda: hh["t"]))(h),
                    session_config=self.session_cfg,
                )

    def maybe_edit(self, region: str) -> None:
        if self._gen.random() >= 0.3:
            return
        self._n_edits += 1
        token = f"[{region}{self._n_edits}]"
        room = ROOMS[self._gen.randrange(len(ROOMS))]
        client = 1000 * (REGIONS.index(region) + 1) + self._n_edits
        if self.provs[region].receive_update(
            room, _mk_update(token, client)
        ):
            # the ingress ACCEPTED this update: it may never be lost
            self.accepted[room].add(token)

    def step(self, editing: bool = False) -> None:
        for r in REGIONS:
            if editing:
                self.maybe_edit(r)
        for p in self.provs.values():
            p.flush()
        for rep in self.reps.values():
            rep.tick()
        for net in self.nets.values():
            net.pump()

    def converged(self) -> bool:
        for room in ROOMS:
            texts = set()
            svs = []
            for p in self.provs.values():
                texts.add(p.text(room) if room in p.guids() else "")
                svs.append(
                    p.state_vector(room) if room in p.guids() else {}
                )
            if len(texts) != 1:
                return False
            if any(sv != svs[0] for sv in svs[1:]):
                return False
        return True

    def all_live(self) -> bool:
        """Every geo link finished its handshake.  Convergence alone is
        not stability: texts can agree transitively (A<->C, C<->B)
        while one link is still in backoff — and the backoff rng is
        sid-keyed, so how long that takes depends on how many sessions
        the process created before this test."""
        return all(
            link.session.state == "live"
            for rep in self.reps.values()
            for link in rep.links.values()
        )

    def run(self, edit_rounds=50, max_rounds=2500, quiet=12) -> int:
        stable = 0
        for n in range(max_rounds):
            self.step(editing=n < edit_rounds)
            if n >= edit_rounds:
                if self.converged() and self.all_live():
                    stable += 1
                    if stable >= quiet:
                        return n
                else:
                    stable = 0
        return max_rounds

    def assert_identical_and_lossless(self) -> None:
        for room in ROOMS:
            texts = {
                p.text(room) if room in p.guids() else ""
                for p in self.provs.values()
            }
            assert len(texts) == 1, f"{room} diverged: {texts}"
            final = next(iter(texts))
            missing = [
                t for t in self.accepted[room] if t not in final
            ]
            assert not missing, (
                f"acked updates lost in {room}: {missing}"
            )

    def assert_no_full_resyncs(self) -> None:
        for r, rep in self.reps.items():
            for peer, link in rep.links.items():
                s = link.session
                assert s.n_full_resyncs == 1, (r, peer, s.snapshot())
                assert s.n_resumes == 0, (r, peer, s.snapshot())


@pytest.mark.chaos
@pytest.mark.parametrize("seed", CORPUS_SEEDS)
def test_three_region_wan_storm_converges(backend, seed):
    mesh = GeoMesh(backend, seed, WAN_STORM)
    rounds = mesh.run()
    assert rounds < 2500, "geo mesh never reached a stable fixpoint"
    mesh.assert_identical_and_lossless()
    mesh.assert_no_full_resyncs()


@pytest.mark.chaos
def test_clean_geo_mesh_has_no_recovery_traffic(backend):
    mesh = GeoMesh(backend, 5, {})
    mesh.run(edit_rounds=40, max_rounds=800)
    mesh.assert_identical_and_lossless()
    mesh.assert_no_full_resyncs()
    for rep in mesh.reps.values():
        for link in rep.links.values():
            assert link.n_dead_letters == 0
            assert link.session.n_retransmits == 0


@pytest.mark.chaos
def test_region_kill9_recovers_and_resumes(backend, tmp_path):
    """The acceptance case: kill -9 one region mid-storm under the
    full WAN fault mix, recover it from its journaled WAL, heal the
    partition — byte-identical convergence, zero acked loss, and the
    surviving regions RESUME their links from the journaled ack floor
    instead of full-resyncing (``full_resyncs`` stays 1 per link,
    ``resumes >= 1`` toward the recovered region)."""
    seed = 11
    wal_dirs = {r: tmp_path / r for r in REGIONS}
    mesh = GeoMesh(backend, seed, WAN_STORM, wal_dirs=wal_dirs)
    # storm phase: edits stream while every link is faulted
    for n in range(60):
        mesh.step(editing=True)
    # settle enough that A has acked SOMETHING from each peer — the
    # journaled recv floors are what arm the resume hints after
    # recovery — without requiring convergence
    for n in range(400):
        mesh.step()
        if all(
            mesh.reps["A"].links[p].floor["seq"] >= 1
            for p in ("B", "C")
        ):
            break
    assert all(
        mesh.reps["A"].links[p].floor["seq"] >= 1 for p in ("B", "C")
    ), "storm never let A ack anything; no floor to resume from"
    old_epoch = mesh.reps["A"].epoch

    # kill -9: region A vanishes — no close, no checkpoint; its WAN
    # transports die with the process and the survivors' connect_fn
    # holders go empty (the WAN route to A is down)
    for x, y in (("A", "B"), ("A", "C")):
        net = mesh.nets[(x, y)]
        ha, hs = mesh.holders[(x, y)], mesh.holders[(y, x)]
        net.kill(*(h["t"] for h in (ha, hs) if h["t"] is not None))
        ha["t"] = hs["t"] = None
    del mesh.provs["A"], mesh.reps["A"]

    # the survivors keep editing into the outage; their A-links sit in
    # reconnect backoff against the empty holders
    for n in range(40):
        mesh.maybe_edit("B")
        mesh.maybe_edit("C")
        for r in ("B", "C"):
            mesh.provs[r].flush()
            mesh.reps[r].tick()
        for net in mesh.nets.values():
            net.pump()
    for r in ("B", "C"):
        assert mesh.reps[r].links["A"].session.state == "reconnecting"
        assert mesh.reps[r].detector.state_of("A") in ("suspect", "dead")

    # recover A from its WAL: journaled KIND_GEO floors arm resume
    # hints, and the new fencing epoch is past every journaled one
    pa = TpuProvider.recover(str(wal_dirs["A"]), backend=backend)
    assert pa.last_recovery["geo_links"] >= 1
    ra = GeoReplicator(
        pa, GeoConfig(region="A", seed=seed * 7, reconnect_cap=8),
    )
    assert ra.epoch > old_epoch
    mesh.provs["A"] = pa
    mesh.reps["A"] = ra
    survivors_before = {
        r: {
            "resumes": mesh.reps[r].links["A"].session.n_resumes,
            "resyncs": mesh.reps[r].links["A"].session.n_full_resyncs,
        }
        for r in ("B", "C")
    }
    # heal the WAN: fresh faulted pipes land in the connect_fn holders;
    # the recovered replicator arms resume hints from the journaled
    # floors and the survivors' links pick the route up from backoff
    mesh.connect("A", "B")
    mesh.connect("A", "C")

    rounds = mesh.run(edit_rounds=0)
    assert rounds < 2500, "mesh never converged after recovery"
    mesh.assert_identical_and_lossless()
    for r in ("B", "C"):
        s = mesh.reps[r].links["A"].session
        before = survivors_before[r]
        assert s.n_full_resyncs == before["resyncs"] == 1, (
            r, s.snapshot(),
        )
        assert s.n_resumes == before["resumes"] + 1, (r, s.snapshot())
    # B<->C never went down: still on their original handshake
    assert mesh.reps["B"].links["C"].session.n_full_resyncs == 1
    assert mesh.reps["C"].links["B"].session.n_full_resyncs == 1
