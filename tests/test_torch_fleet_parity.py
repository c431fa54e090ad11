"""The port's fleet and geo replicator held to the JAX package's.

The same seeded update bytes go through a JAX ``FleetRouter`` and a port
``FleetRouter(device="cpu")``; after a flush, a live migration, a drain,
a kill with its failover, a revive and a recovery the two must agree
exactly: placements (``shard_of``/``owner_of``), the routing epoch,
every room's encoded state, text and state vector, and the counts of
``fleet_snapshot()``.  The JAX side runs with ``YTPU_FLUSH_PIPELINE=0``
(ROADMAP reference caveat R1).  Both provider backends run, ``"auto"``
(the engines' apply lanes) and ``"cpu"``.  The port also recovers a WAL
root that a JAX fleet wrote, to the states the JAX fleet recovers, and a
pair of port ``GeoReplicator`` regions converges as the JAX pair does.
Without ``device=`` a port fleet wants the card, and on the CPU a
``device="cpu"`` fleet lives through kill, failover, revive and recover
without touching CUDA.
"""

import itertools
import random
import shutil

import pytest
import torch

import yjs_tpu
import yjs_tpu.fleet
import yjs_tpu.geo
import yjs_tpu.persistence
import yjs_tpu.provider
import yjs_tpu.sync.session
import yjs_tpu.sync.transport
import yjs_tpu_torch
import yjs_tpu_torch.fleet
import yjs_tpu_torch.geo
import yjs_tpu_torch.persistence
import yjs_tpu_torch.provider
import yjs_tpu_torch.sync.session
import yjs_tpu_torch.sync.transport
from yjs_tpu_torch.ops import kernels
from yjs_tpu_torch.persistence import WalConfig

pytestmark = pytest.mark.fleet

SMALL = dict(segment_bytes=256, fsync="never")
FAST = dict(suspect_ticks=2, confirm_ticks=1, jitter_ticks=0)
N_ROOMS = 24


class Side:
    """One package's fleet and what the comparison reads from it."""

    def __init__(self, pkg, **device):
        self.pkg = pkg
        self.fleet_mod = getattr(pkg, "fleet")
        self.device = device

    def fleet(self, n_shards, docs_per_shard, backend, wal_dir):
        f = self.fleet_mod
        return f.FleetRouter(
            n_shards, docs_per_shard, backend=backend, wal_dir=str(wal_dir),
            wal_config=self.pkg.persistence.WalConfig(**SMALL),
            failover_config=f.FailoverConfig(**FAST), **self.device,
        )

    def recover(self, root, backend):
        return self.fleet_mod.FleetRouter.recover(
            str(root), backend=backend,
            wal_config=self.pkg.persistence.WalConfig(**SMALL),
            **self.device,
        )


JAX = Side(yjs_tpu)
PORT = Side(yjs_tpu_torch, device="cpu")


@pytest.fixture(params=["auto", "cpu"])
def backend(request, monkeypatch):
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")
    # session ids seed retransmit backoff: both packages count from 1
    for pkg in (yjs_tpu, yjs_tpu_torch):
        monkeypatch.setattr(pkg.sync.session, "_SID", itertools.count(1))
    return request.param


def seeded_updates(seed, n_rooms=N_ROOMS, n_ops=10):
    """room -> incremental update stream of one seeded editor (made by
    the JAX package's core; the wire bytes are the same in both)."""
    Y = yjs_tpu
    out = {}
    for j in range(n_rooms):
        gen = random.Random(seed * 1000 + j)
        d = Y.Doc(gc=False)
        d.client_id = 100 + j
        ups = []
        d.on("update", lambda u, origin, doc: ups.append(bytes(u)))
        t = d.get_text("text")
        for _ in range(n_ops):
            if len(t) and gen.random() < 0.3:
                t.delete(gen.randrange(len(t)), 1)
            else:
                t.insert(gen.randrange(len(t) + 1), gen.choice("abcdef "))
        out[f"room-{j:02d}"] = ups
    return out


def tail_update(client_id, text):
    d = yjs_tpu.Doc(gc=False)
    d.client_id = client_id
    d.get_text("text").insert(0, text)
    return yjs_tpu.encode_state_as_update(d)


SNAP_KEYS = ("epoch", "n_shards", "live_shards", "docs", "capacity",
             "migrations_active")


def observe(fleet, rooms):
    """Everything the parity holds equal, from one fleet."""
    fleet.flush()
    snap = fleet.fleet_snapshot()
    return {
        "epoch": fleet.table.epoch,
        "live": list(fleet.live_shards),
        "shard_of": {g: fleet.shard_of(g) for g in rooms},
        "owner_of": {g: fleet.owner_of(g) for g in rooms},
        "state": {g: fleet.encode_state_as_update(g) for g in rooms},
        "text": {g: fleet.text(g) for g in rooms},
        "sv": {g: fleet.state_vector(g) for g in rooms},
        "snapshot": {k: snap[k] for k in SNAP_KEYS},
        "rows": snap["shards"],
    }


def assert_same(a, b, what):
    for key in a:
        assert a[key] == b[key], (what, key)


def convict(fleet, shard, budget=16):
    for _ in range(budget):
        fleet.tick()
        if shard in fleet._down:
            return
    raise AssertionError(f"shard {shard} never convicted")


def test_fleet_lifecycle_matches_jax(backend, tmp_path):
    updates = seeded_updates(seed=5)
    rooms = sorted(updates)
    fleets = {
        s: s.fleet(4, 16, backend, tmp_path / name)
        for s, name in ((JAX, "jax"), (PORT, "port"))
    }

    def both(fn, what):
        obs = [fn(f) for f in fleets.values()]
        a, b = (observe(f, rooms) for f in fleets.values())
        assert_same(a, b, what)
        assert obs[0] == obs[1], what
        return a

    def ingest(f):
        for g in rooms:
            for u in updates[g]:
                f.receive_update(g, u)
        f.flush()
        return f.tick()

    seen = both(ingest, "flush")
    assert sum(bool(s) for s in seen["text"].values()) > N_ROOMS // 2

    def migrate(f):
        for j, g in enumerate(rooms[:4]):
            f.migrate_doc(g, (f.owner_of(g) + 1 + j % 3) % 4)

    both(migrate, "migration")
    drained = fleets[PORT].owner_of(rooms[5])
    both(lambda f: f.drain_shard(drained), "drain")
    both(lambda f: f.tick(), "rebalancer tick")

    victim = fleets[PORT].owner_of(rooms[0])

    def kill(f):
        for j, g in enumerate(rooms):
            if f.owner_of(g) == victim:  # an acked tail never flushed
                f.receive_update(g, tail_update(5000 + j, "tail!"))
        f.kill_shard(victim)
        convict(f, victim)

    both(kill, "kill and failover")
    both(lambda f: f.revive_shard(victim), "revive")

    for f in fleets.values():
        f.checkpoint()
        f.receive_update(rooms[1], tail_update(7000, "after checkpoint"))
        for k, p in enumerate(f.shards):
            if not f._is_stub(k):
                p.wal.abandon()
    recs = {s: s.recover(tmp_path / name, backend)
            for s, name in ((JAX, "jax"), (PORT, "port"))}
    a, b = (observe(f, rooms) for f in recs.values())
    assert_same(a, b, "recover")
    assert "after checkpoint" in a["text"][rooms[1]]
    assert (recs[JAX].last_recovery["resolution"]
            == recs[PORT].last_recovery["resolution"])


def test_port_recovers_a_jax_wal_root(backend, tmp_path):
    """The WAL root is the cross-package carry of a fleet: a JAX fleet
    crashes mid-migration with replicas seeded, and the port recovers
    its root to the states, owners and resolution the JAX package's own
    recovery gives."""
    updates = seeded_updates(seed=9)
    rooms = sorted(updates)
    root = tmp_path / "jax"
    f = JAX.fleet(3, 16, backend, root)
    for g in rooms:
        for u in updates[g]:
            f.receive_update(g, u)
    f.flush()
    f.tick()
    g = rooms[2]
    f.begin_migration(g, (f.owner_of(g) + 1) % 3)
    f.receive_update(g, tail_update(6000, "in the window"))
    f.flush()
    for p in f.shards:
        p.wal.abandon()
    shutil.copytree(root, tmp_path / "copy")
    jax_rec = JAX.recover(root, backend)
    port_rec = PORT.recover(tmp_path / "copy", backend)
    a, b = observe(jax_rec, rooms), observe(port_rec, rooms)
    assert_same(a, b, "recover of a JAX root")
    assert "in the window" in b["text"][g]
    assert (jax_rec.last_recovery["resolution"]
            == port_rec.last_recovery["resolution"])
    assert port_rec.last_recovery["resolution"]["completed"] == 1


GEO_SESSION = dict(
    heartbeat=0, liveness=0, antientropy=8, hello_timeout=0,
    retry_base=4, retry_cap=16, retry_max=6, retry_jitter=0.25,
)


def geo_pair(pkg, backend, **device):
    cfg = pkg.sync.session.SessionConfig(seed=1, **GEO_SESSION)
    a = pkg.provider.TpuProvider(8, backend=backend, **device)
    b = pkg.provider.TpuProvider(8, backend=backend, **device)
    net = pkg.sync.transport.PipeNetwork()
    ta, tb = net.pair("geo:A", "geo:B")
    ra = pkg.geo.GeoReplicator(a, pkg.geo.GeoConfig(region="A", seed=1))
    rb = pkg.geo.GeoReplicator(b, pkg.geo.GeoConfig(region="B", seed=2))
    ra.add_peer("B", lambda: ta, session_config=cfg)
    rb.add_peer("A", lambda: tb, session_config=cfg)
    return (a, b), (ra, rb), net


def test_geo_pair_matches_jax(backend):
    updates = seeded_updates(seed=13, n_rooms=6)
    rooms = sorted(updates)
    runs = {}
    for name, pkg, device in (("jax", yjs_tpu, {}),
                              ("port", yjs_tpu_torch, {"device": "cpu"})):
        provs, reps, net = geo_pair(pkg, backend, **device)
        for j, g in enumerate(rooms):
            for u in updates[g]:
                provs[0].receive_update(g, u)
            provs[1].receive_update(g, tail_update(8000 + j, f"[B{j}]"))
        log = []
        for _ in range(60):
            for p in provs:
                p.flush()
            for r in reps:
                r.tick()
            net.pump()
            log.append(tuple(
                (r.links[peer].shipped_bytes, r.links[peer].session.state)
                for r, peer in zip(reps, ("B", "A"))
            ))
        runs[name] = {
            "log": log,
            "state": [[p.encode_state_as_update(g) for g in rooms]
                      for p in provs],
            "sv": [[p.state_vector(g) for g in rooms] for p in provs],
            "epoch": [r.epoch for r in reps],
            "resyncs": [r.links[peer].session.n_full_resyncs
                        for r, peer in zip(reps, ("B", "A"))],
        }
    assert runs["jax"] == runs["port"]
    port = runs["port"]
    assert port["state"][0] == port["state"][1]
    assert port["resyncs"] == [1, 1]


def test_fleet_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default fleet runs there")
    with pytest.raises(kernels.KernelError):
        yjs_tpu_torch.fleet.FleetRouter(2, 2)
    with pytest.raises(kernels.KernelError):
        yjs_tpu_torch.fleet.FleetRouter(2, 2, backend="cpu")


def test_cpu_fleet_lifecycle_never_touches_cuda(tmp_path, monkeypatch):
    """kill -> fail_over -> revive -> recover on a ``device="cpu"`` fleet:
    CUDA is never initialised and every device the kernels resolve is
    the CPU."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("the CPU fleet initialised CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    resolved = []
    real = kernels.resolve_device

    def spy(device=None, *args, **kwargs):
        dev = real(device, *args, **kwargs)
        resolved.append(dev.type)
        return dev

    monkeypatch.setattr(kernels, "resolve_device", spy)
    F = yjs_tpu_torch.fleet
    wal = WalConfig(**SMALL)
    fleet = F.FleetRouter(
        3, 4, wal_dir=str(tmp_path), wal_config=wal, device="cpu",
        failover_config=F.FailoverConfig(**FAST),
    )
    updates = seeded_updates(seed=3, n_rooms=8)
    for g, ups in updates.items():
        for u in ups:
            fleet.receive_update(g, u)
    fleet.flush()
    fleet.tick()
    victim = fleet.owner_of("room-00")
    fleet.kill_shard(victim)
    res = fleet.fail_over(victim)
    assert "room-00" in res["promoted"]
    fleet.revive_shard(victim)
    assert fleet.shards[victim].engine.device.type == "cpu"
    texts = {g: fleet.text(g) for g in updates}
    fleet.checkpoint()
    fleet.close(checkpoint=False)
    rec = F.FleetRouter.recover(str(tmp_path), wal_config=wal, device="cpu")
    assert {g: rec.text(g) for g in updates} == texts
    assert all(p.engine.device.type == "cpu" for p in rec.shards)
    assert resolved and set(resolved) == {"cpu"}
