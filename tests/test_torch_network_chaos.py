"""The cases of the JAX package's ``tests/test_network_chaos.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Network-chaos property suite: three peers in a full
session mesh, every link independently faulted (drop / duplicate /
delay / reorder / partition at the transport seam), edits streaming
WHILE the faults fire.  The contract under any mix and any seed:

- all three replicas end byte-identically (text + state vector, and
  each peer's full state is a strict no-op on the others);
- nobody falls back to a full resync after the initial handshake —
  recovery is retransmission + anti-entropy, never "send everything"
  (``n_full_resyncs == 1`` and ``n_resumes == 0`` per session, the
  acceptance shape);
- loss shows up in the loss counters (retransmits / repairs), not in
  the document.

Everything is tick-driven and seeded — a failure replays exactly.  The
``network`` marker deselects the suite with ``-m 'not network'``.
"""

import random

import pytest

import yjs_tpu_torch as Y
from torch_service import TpuProvider
from yjs_tpu_torch.resilience import NetChaosConfig, NetworkFaultInjector
from yjs_tpu_torch.sync.session import DocSessionHost, SessionConfig, SyncSession
from yjs_tpu_torch.sync.transport import PipeNetwork
from yjs_tpu_torch.updates import (
    apply_update,
    decode_state_vector,
    encode_state_as_update,
    encode_state_vector,
)

pytestmark = pytest.mark.network


@pytest.fixture(autouse=True)
def _pin_sid_counter(monkeypatch):
    # session sids draw from a module-global counter, and each
    # session's retransmit-backoff rng is seeded with (seed ^ sid) —
    # so the storm's jitter sequences silently depend on how many
    # sessions every EARLIER test in the suite created.  Pin the
    # counter per test so a failure replays identically in any order.
    import itertools

    from yjs_tpu_torch.sync import session as session_mod

    monkeypatch.setattr(session_mod, "_SID", itertools.count(1))

# the chaos-suite corpus (test_chaos.py) plus a fresh spread — the
# acceptance matrix runs the full storm over 20 seeds
CORPUS_SEEDS = (101, 202, 55, 77)
STORM_SEEDS = tuple(range(20))

FAULT_MIXES = [
    ("drop", dict(drop=0.25)),
    ("dup", dict(duplicate=0.35)),
    ("delay", dict(delay=0.5)),
    ("reorder", dict(reorder=0.6)),
    ("partition", dict(partition=0.08)),
]
STORM = dict(drop=0.2, duplicate=0.2, delay=0.25, reorder=0.3,
             partition=0.04)

# retransmission must out-run the worst fault window, and anti-entropy
# must close any dead-letter hole well inside the round budget
MESH_CONFIG = dict(
    retry_base=4, retry_cap=16, retry_max=6, retry_jitter=0.25,
    antientropy=8, heartbeat=0, liveness=0, hello_timeout=0,
)


class MeshPeer:
    """One replica: a Doc plus one session per neighbor.  Local edits
    fan out to every session; applied remote updates gossip onward to
    the OTHER neighbors (the origin guard stops echo; redundant applies
    are no-ops and fire no update event, so gossip cannot loop)."""

    def __init__(self, name: str, client_id: int, seed: int):
        self.name = name
        self.doc = Y.Doc(gc=False)
        self.doc.client_id = client_id
        self.sessions: dict[str, SyncSession] = {}
        self._gen = random.Random((seed << 4) ^ client_id)
        self.doc.on("update", self._relay)

    def link(self, other: str, cfg: SessionConfig) -> SyncSession:
        s = SyncSession(DocSessionHost(self.doc), cfg, peer=other)
        self.sessions[other] = s
        return s

    def _relay(self, update, origin, doc):
        for s in self.sessions.values():
            if origin is not s.host:
                s.send_update(bytes(update))

    def maybe_edit(self) -> None:
        if self._gen.random() >= 0.25:
            return
        t = self.doc.get_text("text")
        if len(t) and self._gen.random() < 0.3:
            t.delete(self._gen.randrange(len(t)), 1)
        else:
            t.insert(
                self._gen.randrange(len(t) + 1),
                self._gen.choice("abcdef "),
            )

    @property
    def text(self) -> str:
        return str(self.doc.get_text("text"))

    @property
    def sv(self) -> dict:
        return dict(decode_state_vector(encode_state_vector(self.doc)))


def build_mesh(seed: int, faults: dict):
    cfg = SessionConfig(seed=seed, **MESH_CONFIG)
    peers = [
        MeshPeer("A", 1, seed), MeshPeer("B", 2, seed),
        MeshPeer("C", 3, seed),
    ]
    nets = []
    for i, (pa, pb) in enumerate(
        [(peers[0], peers[1]), (peers[0], peers[2]),
         (peers[1], peers[2])]
    ):
        inj = (
            NetworkFaultInjector(
                NetChaosConfig(seed=(seed * 31 + i) & 0x7FFFFFFF,
                               **faults)
            )
            if faults
            else None
        )
        net = PipeNetwork(inj)
        ta, tb = net.pair(pa.name, pb.name)
        pa.link(pb.name, cfg).connect(ta)
        pb.link(pa.name, cfg).connect(tb)
        nets.append(net)
    return peers, nets


def run_mesh(peers, nets, edit_rounds=120, max_rounds=2500, quiet=6):
    """Drive the whole mesh tick-by-tick: edits stream during the
    first ``edit_rounds`` while faults fire, then the loop runs until
    text AND state vector agree across all three replicas for
    ``quiet`` consecutive rounds (sv catches undelivered inserts, text
    catches undelivered deletes — together a stable fixpoint)."""
    sessions = [s for p in peers for s in p.sessions.values()]
    stable = 0
    for n in range(max_rounds):
        if n < edit_rounds:
            for p in peers:
                p.maybe_edit()
        for net in nets:
            net.pump()
        for s in sessions:
            s.tick()
        if n >= edit_rounds:
            if (
                len({p.text for p in peers}) == 1
                and peers[0].sv == peers[1].sv == peers[2].sv
            ):
                stable += 1
                if stable >= quiet:
                    return n
            else:
                stable = 0
    return max_rounds


def assert_mesh_identical(peers):
    texts = {p.text for p in peers}
    assert len(texts) == 1, f"diverged: {[p.text for p in peers]}"
    assert peers[0].sv == peers[1].sv == peers[2].sv
    # byte-level: each replica's full state is a strict no-op elsewhere
    for src in peers:
        full = encode_state_as_update(src.doc)
        for dst in peers:
            if dst is src:
                continue
            before = dst.text
            apply_update(dst.doc, full)
            assert dst.text == before


def assert_no_full_resyncs(peers):
    """The acceptance: after the initial handshake, recovery
    is always delta-shaped — no session ever restarts from scratch."""
    for p in peers:
        for s in p.sessions.values():
            assert s.n_full_resyncs == 1, (p.name, s.peer, s.snapshot())
            assert s.n_resumes == 0, (p.name, s.peer, s.snapshot())


@pytest.mark.parametrize("seed", STORM_SEEDS)
def test_three_peer_storm_converges(seed):
    peers, nets = build_mesh(seed, STORM)
    rounds = run_mesh(peers, nets)
    assert rounds < 2500, "mesh never reached a stable fixpoint"
    assert_mesh_identical(peers)
    assert_no_full_resyncs(peers)
    assert any(p.text for p in peers) or True  # content is seed-driven


@pytest.mark.parametrize("name,faults", FAULT_MIXES,
                         ids=[m[0] for m in FAULT_MIXES])
@pytest.mark.parametrize("seed", CORPUS_SEEDS)
def test_three_peer_single_fault_mix_converges(seed, name, faults):
    peers, nets = build_mesh(seed, faults)
    rounds = run_mesh(peers, nets)
    assert rounds < 2500, f"{name} mesh never stabilized"
    assert_mesh_identical(peers)
    assert_no_full_resyncs(peers)
    if name == "drop":
        # loss must surface in the loss counters, not the document
        total_rtx = sum(
            s.n_retransmits for p in peers
            for s in p.sessions.values()
        )
        total_repairs = sum(
            s.n_repairs for p in peers for s in p.sessions.values()
        )
        assert total_rtx + total_repairs >= 1


def test_clean_mesh_has_no_recovery_traffic():
    peers, nets = build_mesh(7, {})
    run_mesh(peers, nets, edit_rounds=60, max_rounds=800)
    assert_mesh_identical(peers)
    assert_no_full_resyncs(peers)
    for p in peers:
        for s in p.sessions.values():
            assert s.n_dead_lettered == 0
            assert s.n_retransmits == 0  # acks beat every backoff
            # (n_repairs may be nonzero even on a clean wire: a digest
            # can race an in-flight update — the repair is idempotent)


# -- provider-level regression pins ------------------------------------------


def _quiet_cfg():
    return SessionConfig(
        heartbeat=0, liveness=0, antientropy=0, hello_timeout=0,
        retry_base=4, retry_jitter=0.0, seed=1,
    )


def _drive(*providers):
    def fn():
        for p in providers:
            p.flush()
        for p in providers:
            p.tick_sessions()

    return fn


def test_reconnect_mid_flush_replays_pending_delta():
    """Regression pin: an update received but NOT yet flushed when the
    transport dies must still reach the peer after reconnect — the
    session host flushes the room before computing the catch-up diff,
    so the delta includes pending engine state."""
    pa = TpuProvider(2, backend="cpu")
    pb = TpuProvider(2, backend="cpu")
    net = PipeNetwork()
    ta, tb = net.pair()
    sa = pa.session("room", "pb", _quiet_cfg())
    sb = pb.session("room", "pa", _quiet_cfg())
    sa.connect(ta)
    sb.connect(tb)
    net.settle((_drive(pa, pb),))
    assert sa.state == sb.state == "live"
    # land an update in the engine queue and kill the wire BEFORE any
    # flush can broadcast it
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "pending at disconnect")
    pa.receive_update("room", encode_state_as_update(d))
    net.kill(ta, tb)
    assert sa.state == sb.state == "reconnecting"
    ta2, tb2 = net.pair()
    sa.attach(ta2)
    sb.attach(tb2)
    net.settle((_drive(pa, pb),))
    assert pb.text("room") == "pending at disconnect"
    # and it was a resume, not a second full resync
    assert sa.n_resumes == 1 and sa.n_full_resyncs == 1
    assert sb.n_resumes == 1 and sb.n_full_resyncs == 1


def test_killed_provider_catches_up_via_delta_replay(tmp_path):
    """Acceptance: a peer killed and recovered from its WAL catches up
    through delta replay — the surviving side resumes (resumes > 0)
    and never re-runs a full resync (full_resyncs stays 1)."""
    cfg = _quiet_cfg()
    p1 = TpuProvider(2, backend="cpu", wal_dir=str(tmp_path))
    p2 = TpuProvider(2, backend="cpu")
    net = PipeNetwork()
    t1, t2 = net.pair()
    p1.session("doc", "p2", cfg).connect(t1)
    s2 = p2.session("doc", "p1", cfg)
    s2.connect(t2)
    net.settle((_drive(p1, p2),))
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "before crash")
    p2.receive_update("doc", encode_state_as_update(d))
    net.settle((_drive(p1, p2),))
    assert p1.text("doc") == "before crash"
    net.kill(t1, t2)
    del p1  # crash: no close, no checkpoint
    # the survivor keeps editing while the peer is down
    d2 = Y.Doc(gc=False)
    d2.get_text("text").insert(0, "offline edit / ")
    p2.receive_update("doc", encode_state_as_update(d2))
    pr = TpuProvider.recover(str(tmp_path), backend="cpu")
    assert pr.last_recovery["session_acks"] >= 1
    sr = pr.session("doc", "p2", cfg)  # armed with the WAL ack floor
    t1b, t2b = net.pair()
    sr.connect(t1b)
    s2.attach(t2b)
    net.settle((_drive(pr, p2),))
    assert pr.text("doc") == p2.text("doc")
    assert "offline edit" in pr.text("doc")
    assert s2.n_resumes == 1
    assert s2.n_full_resyncs == 1
