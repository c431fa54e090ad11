"""The port's session layer and operator scripts held to the JAX package's.

Session parity: a JAX provider pair (``YTPU_FLUSH_PIPELINE=0``, ROADMAP
reference caveat R1) and a port pair on ``device="cpu"`` each join
their rooms by session pairs over a ``PipeNetwork`` behind a
``NetworkFaultInjector`` with the same seeded ``NetChaosConfig`` (drop,
duplicate, reorder, delay, and one partition that heals).  The same
edits land on the same side in the same rounds and the same tick
schedule drives both; after the second round one side is killed without
a checkpoint, recovered from its WAL and re-attached.  Every transport
must carry the same frames in the same order in both packages, and the
rooms' final state vectors and full diffs must be equal.  Both provider
backends run: ``"auto"`` (the engines' apply lanes) and ``"cpu"``.

Render parity: the same fleet snapshot directory, the same cluster
snapshot drop and the same snapshot file go through the JAX package's
``scripts/ytpu_top.py`` / ``scripts/ytpu_stats.py`` and the port's
``scripts/torch_ytpu_top.py`` / ``scripts/torch_ytpu_stats.py``; the
text must be equal once the clock in each frame's header is masked.
"""

import contextlib
import io
import itertools
import json
import random
import re

import pytest

import yjs_tpu
import yjs_tpu.provider
import yjs_tpu.resilience
import yjs_tpu.sync.session
import yjs_tpu.sync.transport
import yjs_tpu_torch
import yjs_tpu_torch.provider
import yjs_tpu_torch.resilience
import yjs_tpu_torch.sync.session
import yjs_tpu_torch.sync.transport
from torch_service import load_script

pytestmark = pytest.mark.network

N_ROOMS = 6
ROUNDS = 4
TICKS_A_ROUND = 24
KILL_AFTER_ROUND = 2
PARTITION_ROUND = 1
SETTLE_TICKS = 200


class Side:
    """One package's provider pair, its network and the frames it saw."""

    def __init__(self, pkg, backend, seed, root, **device):
        self.pkg = pkg
        self.backend = backend
        self.device = device
        self.root = root
        self.cfg = pkg.sync.session.SessionConfig(
            seed=seed, retry_base=2, retry_cap=8, retry_max=6,
            retry_jitter=0.25, antientropy=8, heartbeat=0, liveness=0,
            hello_timeout=0,
        )
        self.injector = pkg.resilience.NetworkFaultInjector(
            pkg.resilience.NetChaosConfig(
                seed=seed, drop=0.05, duplicate=0.02, reorder=0.05,
                delay=0.05,
            )
        )
        self.net = pkg.sync.transport.PipeNetwork(self.injector)
        self.frames: list[tuple[str, bytes]] = []
        enqueue = self.net._enqueue

        def spy(src, dst, frame):
            self.frames.append((src.name, bytes(frame)))
            enqueue(src, dst, frame)

        self.net._enqueue = spy
        self.a = self.provider("a")
        self.b = self.provider("b")
        self.links: dict[str, tuple] = {}
        for r in range(N_ROOMS):
            self.link(f"room-{r}")

    def provider(self, name):
        return self.pkg.provider.TpuProvider(
            N_ROOMS, backend=self.backend, wal_dir=str(self.root / name),
            **self.device,
        )

    def link(self, room):
        ta, tb = self.net.pair(f"A:{room}", f"B:{room}")
        self.a.session(room, "B", self.cfg).connect(ta)
        self.b.session(room, "A", self.cfg).connect(tb)
        self.links[room] = (ta, tb)

    def tick(self):
        self.net.pump()
        self.a.flush()
        self.b.flush()
        self.a.tick_sessions()
        self.b.tick_sessions()

    def kill_and_recover_b(self):
        """``b`` dies without a checkpoint; its WAL rebuilds it and its
        sessions re-attach, armed with the journaled ack floors."""
        for ta, tb in self.links.values():
            self.net.kill(ta, tb)
        self.b.wal.abandon()
        self.b = self.pkg.provider.TpuProvider.recover(
            str(self.root / "b"), backend=self.backend, **self.device
        )
        for room in list(self.links):
            ta, tb = self.net.pair(f"A:{room}", f"B:{room}")
            self.a.session(room, "B", self.cfg).attach(ta)
            self.b.session(room, "A", self.cfg).connect(tb)
            self.links[room] = (ta, tb)

    def states(self):
        out = {}
        for room in self.links:
            for name, p in (("a", self.a), ("b", self.b)):
                out[(room, name)] = (
                    p.state_vector(room), p.encode_state_as_update(room),
                    p.text(room),
                )
        return out


def editor_updates(seed):
    """room -> eight incremental updates by two seeded editors (made by
    the JAX package's core; the wire bytes are the same in both)."""
    Y = yjs_tpu
    out = {}
    for r in range(N_ROOMS):
        gen = random.Random(seed * 1000 + r)
        ups = []
        for client in (100 + r, 200 + r):
            d = Y.Doc(gc=False)
            d.client_id = client
            d.on("update", lambda u, origin, doc: ups.append(bytes(u)))
            t = d.get_text("text")
            for _ in range(4):
                t.insert(gen.randrange(len(t) + 1), gen.choice(["ab", "xyz "]))
        out[f"room-{r}"] = ups
    return out


def drive(side, updates):
    """The schedule: round k deals each room's k-th pair of updates to
    A and to B, then ticks; one partition opens in round 1 and heals;
    ``b`` is killed and recovered after round 2; then settle."""
    for _ in range(4):  # the handshake
        side.tick()
    for k in range(ROUNDS):
        for room, ups in updates.items():
            side.a.receive_update(room, ups[k])
            side.b.receive_update(room, ups[ROUNDS + k])
        for t in range(TICKS_A_ROUND):
            if k == PARTITION_ROUND and t == 2:
                side.injector._partition_left = 3
            side.tick()
        if k + 1 == KILL_AFTER_ROUND:
            side.kill_and_recover_b()
    for _ in range(SETTLE_TICKS):
        side.tick()
        if not side.net.in_flight and all(
            s.outbox_depth == 0 for p in (side.a, side.b)
            for s in p._sessions.values()
        ):
            break


@pytest.fixture(params=["auto", "cpu"])
def backend(request, monkeypatch):
    monkeypatch.setenv("YTPU_FLUSH_PIPELINE", "0")
    return request.param


@pytest.mark.parametrize("seed", [3, 11])
def test_session_pairs_carry_the_same_frames(backend, seed, tmp_path,
                                             monkeypatch):
    updates = editor_updates(seed)
    sides = {}
    for label, pkg, device in (("jax", yjs_tpu, {}),
                               ("port", yjs_tpu_torch, {"device": "cpu"})):
        # session ids seed the retransmit backoff: both count from 1
        monkeypatch.setattr(pkg.sync.session, "_SID", itertools.count(1))
        root = tmp_path / label
        root.mkdir()
        side = Side(pkg, backend, seed, root, **device)
        drive(side, updates)
        sides[label] = side
    jax_side, port = sides["jax"], sides["port"]
    assert jax_side.injector.fault_counts == port.injector.fault_counts
    assert port.injector.fault_counts["net_partition"] >= 1
    assert port.injector.fault_counts["net_drop"] >= 1
    assert len(port.frames) == len(jax_side.frames)
    for n, (got, want) in enumerate(zip(port.frames, jax_side.frames)):
        assert got == want, f"frame {n} differs: {got[0]} vs {want[0]}"
    want_states = jax_side.states()
    got_states = port.states()
    assert got_states == want_states
    merge = yjs_tpu_torch.merge_updates
    for room in port.links:
        sv_a, diff_a, text_a = got_states[(room, "a")]
        sv_b, diff_b, text_b = got_states[(room, "b")]
        # the pair converged: the same state as a map, the same text and
        # the same full diff in canonical form
        assert (sv_b, text_b) == (sv_a, text_a), room
        assert merge([diff_b]) == merge([diff_a]), room
        assert len(sv_a) == 2, f"{room}: an editor's updates never arrived"
    # the survivor resumed through delta replay: one full resync a session
    for p in (port.a, port.b):
        for s in p._sessions.values():
            assert s.n_full_resyncs == 1, s.snapshot()


# -- the operator scripts ---------------------------------------------------------


def _clock_masked(text: str) -> str:
    return re.sub(r"\b\d\d:\d\d:\d\d\b", "HH:MM:SS", text)


def _run_main(script, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = script.main(argv)
    assert rc in (0, None)
    return out.getvalue()


@pytest.fixture(scope="module")
def scripts():
    return {
        "top": (load_script("ytpu_top"), load_script("torch_ytpu_top")),
        "stats": (load_script("ytpu_stats"), load_script("torch_ytpu_stats")),
    }


@pytest.fixture(scope="module")
def shard_snapshots():
    """Three shards' metrics snapshots from port providers that flushed,
    ran sessions and dead-lettered a frame (written by the port; both
    dashboards read the same JSON)."""
    from torch_service import TpuProvider
    from yjs_tpu_torch.sync.transport import PipeNetwork

    snaps = []
    for k in range(3):
        p = TpuProvider(4, backend="auto")
        q = TpuProvider(4, backend="auto")
        net = PipeNetwork()
        for r in range(2):
            ta, tb = net.pair()
            p.session(f"room-{r}", "peer").connect(ta)
            q.session(f"room-{r}", "host").connect(tb)
            d = yjs_tpu_torch.Doc(gc=False)
            d.get_text("text").insert(0, f"shard {k} room {r}")
            p.receive_update(f"room-{r}", yjs_tpu_torch.encode_state_as_update(d))
        net.settle(((lambda: (p.flush(), q.flush(), p.tick_sessions(),
                              q.tick_sessions())),))
        p.handle_sync_message("room-1", b"\x02\xff\xff\xff")
        snaps.append(p.metrics_snapshot())
    return snaps


def test_ytpu_top_directory_renders_the_same_text(scripts, shard_snapshots,
                                                  tmp_path):
    for k, snap in enumerate(shard_snapshots):
        (tmp_path / f"shard-{k}.json").write_text(json.dumps(snap))
    jax_top, port_top = scripts["top"]
    argv = [str(tmp_path), "--once", "--plain"]
    want = _clock_masked(_run_main(jax_top, argv))
    got = _clock_masked(_run_main(port_top, argv))
    assert "FLEET" in got and "shard-2" in got
    assert got == want


def test_ytpu_top_cluster_drop_renders_the_same_text(scripts, shard_snapshots,
                                                     tmp_path):
    for k, snap in enumerate(shard_snapshots):
        (tmp_path / f"shard-{k}.json").write_text(json.dumps(snap))
    report = {
        "kind": "cluster", "epoch": 3,
        "shards": [
            {"shard": 0, "state": "live", "pid": 101, "port": 9101,
             "restarts": 0, "outcome": "fresh", "records_applied": 0},
            {"shard": 1, "state": "live", "pid": 102, "port": 9102,
             "restarts": 1, "outcome": "recovered", "records_applied": 9},
            {"shard": 2, "state": "lost", "pid": 103, "port": 9103,
             "restarts": 3, "outcome": "failover", "records_applied": 4},
        ],
        "events": [{"shard": 2, "outcome": "failover", "epoch": 3,
                    "unavailable_s": 2.5,
                    "resolution": {"completed": 1, "aborted": 0,
                                   "fenced": 2}}],
        "outcomes": {"recovered": 1, "failover": 1},
    }
    (tmp_path / "cluster.json").write_text(json.dumps(report))
    jax_top, port_top = scripts["top"]
    argv = ["--cluster", str(tmp_path), "--once", "--plain"]
    want = _clock_masked(_run_main(jax_top, argv))
    got = _clock_masked(_run_main(port_top, argv))
    assert "failover" in got and "shard-2" in got
    assert got == want


def test_ytpu_stats_renders_the_same_text(scripts, shard_snapshots, tmp_path):
    jax_stats, port_stats = scripts["stats"]
    one = tmp_path / "one.json"
    one.write_text(json.dumps(shard_snapshots[0]))
    want = _run_main(jax_stats, [str(one)])
    got = _run_main(port_stats, [str(one)])
    assert "network (sessions)" in got and "resilience" in got
    assert got == want
    merged = tmp_path / "dir"
    merged.mkdir()
    for k, snap in enumerate(shard_snapshots):
        (merged / f"shard-{k}.json").write_text(json.dumps(snap))
    want = _run_main(jax_stats, ["--merge", str(merged)])
    got = _run_main(port_stats, ["--merge", str(merged)])
    assert "federation" in got
    assert got == want


# -- the smoke's session corpus ---------------------------------------------------


def test_smoke_trace_pieces_rebuild_the_trace():
    """``chip_smoke.py``'s ``[session]`` phase deals each fixture trace
    as four updates: applied in any order they rebuild the trace, and
    its oracle helpers flag a room whose state differs."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_session", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    Y = yjs_tpu_torch
    for trace in smoke.load_traces()[:2]:
        pieces = smoke._trace_pieces(trace)
        assert len(pieces) == smoke.N_SESSION_ROUNDS
        want = Y.Doc(gc=False)
        Y.apply_update(want, trace)
        for order in ([0, 1, 2, 3], [3, 1, 0, 2]):
            got = Y.Doc(gc=False)
            for k in order:
                Y.apply_update(got, pieces[k])
            assert str(got.get_text("text")) == str(want.get_text("text"))
            assert Y.merge_updates([Y.encode_state_as_update(got)]) == (
                Y.merge_updates([Y.encode_state_as_update(want)]))
        text, sv, canon = smoke._trace_oracle([trace])
        assert text == str(want.get_text("text"))
        assert sv == Y.decode_state_vector(Y.encode_state_vector(want))
        state = Y.encode_state_as_update(want)
        assert smoke._canonical_check_job((canon, [("r", state)])) == []
        other = smoke._trace_oracle([trace, pieces[0]])[2]
        assert other == canon  # a piece adds nothing to the whole trace
        edited = Y.Doc(gc=False)
        Y.apply_update(edited, state)
        edited.get_text("text").insert(0, "x")
        assert smoke._canonical_check_job(
            (canon, [("r", Y.encode_state_as_update(edited))])) == ["r"]
