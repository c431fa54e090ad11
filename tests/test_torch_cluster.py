"""The PyTorch port's process cluster under kill -9, failover and hangs
(the supervision cases of ``tests/test_cluster.py``).

Real OS shard processes (``python -m yjs_tpu_torch.cluster.shard
--device cpu``) under the port's :class:`Supervisor`, fronted by its
y-websocket gateway, with live session peers (port ``Doc``s behind
``scripts/torch_ytpu_cluster.py``'s :class:`SessionClient`) attached
over real sockets.  The contract is the reference's: ``kill -9`` of the
owner shard mid-flush → the supervisor restarts it through
``recover()`` (or fails over past the restart budget), every surviving
peer reconverges byte-identically with at most one full resync, and no
acked update is lost.  The kill case runs under both provider
backends, as does the failover case in ``test_torch_cluster_facade.py``:
under ``"auto"`` every flush and the restarted child's replay run the
engine's apply lane in the child.  Every child a supervisor starts or
restarts must report ``cpu`` on its ready line.
"""

import os
import signal
import time

import pytest
from torch_service import (
    BACKENDS,
    Supervisor,
    live_devices,
    load_script,
    one_thread_a_child,
    wait_outcome,
)

import yjs_tpu_torch as Y
from yjs_tpu_torch.cluster import (
    ClusterConfig,
    Gateway,
    GatewayConfig,
    RpcBusy,
    RpcError,
)

pytestmark = pytest.mark.cluster

# tight supervision so one kill costs ~a second of test wall time, not
# the production defaults' five
FAST = dict(heartbeat_s=0.15, restart_backoff_s=0.05, busy_retry_ticks=4)


@pytest.fixture(autouse=True)
def _one_thread_a_child(monkeypatch):
    one_thread_a_child(monkeypatch)


LAUNCHER = load_script("torch_ytpu_cluster")


def _connect(gw_port: int, room: str, client_id: int):
    doc = Y.Doc(gc=False)
    doc.client_id = client_id
    conn = LAUNCHER.SessionClient(
        gw_port, room, f"peer-{client_id}", doc=doc
    )
    return doc, conn


def _texts(pairs):
    out = []
    for doc, conn in pairs:
        with conn.lock:
            out.append(doc.get_text("text").to_string())
    return out


def _wait_equal(pairs, deadline_s: float = 60.0, require=()):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        texts = _texts(pairs)
        if (
            len(set(texts)) == 1
            and texts[0] != ""
            and all(tok in texts[0] for tok in require)
        ):
            return texts[0]
        time.sleep(0.05)
    raise AssertionError(f"no convergence: {_texts(pairs)!r}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_kill9_owner_mid_flush_reconverges_with_zero_acked_loss(
    tmp_path, backend
):
    """The reference's acceptance scenario end to end, on port shards."""
    snap_dir = str(tmp_path / "snap")
    sup = Supervisor(
        3, str(tmp_path / "wal"), docs_per_shard=8, backend=backend,
        config=ClusterConfig(
            restart_max=2, snapshot_dir=snap_dir, snapshot_s=0.5, **FAST
        ),
    ).start()
    gw = Gateway(sup, config=GatewayConfig(port=0)).start()
    pairs = []
    try:
        assert live_devices(sup.recovery_report()) == {"cpu"}
        room = "accept-room"
        a = _connect(gw.port, room, 1)
        b = _connect(gw.port, room, 2)
        pairs = [a, b]
        with a[1].lock:
            a[0].get_text("text").insert(0, "[A0]")
        with b[1].lock:
            b[0].get_text("text").insert(0, "[B0]")
        _wait_equal(pairs, require=("[A0]", "[B0]"))

        owner = sup.owner_of(room)
        pid = sup._shards[owner].pid
        assert pid is not None

        # an edit right before the kill: its frame is acked only once
        # the shard durably holds it, so either it lands in the WAL and
        # survives the replay, or it stays unacked in the session
        # outbox and retransmits after the restart — never lost
        with a[1].lock:
            a[0].get_text("text").insert(0, "[A-preckill]")
        os.kill(pid, signal.SIGKILL)

        # edits DURING the outage from both sides: the gateway answers
        # BUSY (shard mid-restart) and the sessions hold + retransmit
        with a[1].lock:
            a[0].get_text("text").insert(0, "[A-outage]")
        with b[1].lock:
            b[0].get_text("text").insert(0, "[B-outage]")

        report = wait_outcome(sup, "recovered")
        ev = report["events"][0]
        assert ev["shard"] == owner
        assert ev["outcome"] == "recovered"
        assert ev["unavailable_s"] > 0
        assert report["epoch"] >= 1
        assert "records_applied" in (ev.get("recovery") or {})
        # the restarted child took the device it was given
        assert report["shards"][owner]["device"] == "cpu"
        assert report["shards"][owner]["pid"] != pid

        final = _wait_equal(
            pairs,
            require=("[A0]", "[B0]", "[A-preckill]",
                     "[A-outage]", "[B-outage]"),
        )
        with a[1].lock:
            sv_a = Y.decode_state_vector(Y.encode_state_vector(a[0]))
        with b[1].lock:
            sv_b = Y.decode_state_vector(Y.encode_state_vector(b[0]))
        assert sv_a == sv_b

        deadline = time.time() + 30
        cluster_text = None
        while time.time() < deadline:
            try:
                cluster_text = sup.text(room)
                if cluster_text == final:
                    break
            except (RpcBusy, RpcError):
                pass
            time.sleep(0.1)
        assert cluster_text == final

        for doc, conn in pairs:
            with conn.lock:
                snap = conn.session.snapshot()
            assert snap["full_resyncs"] <= 1, snap
        deadline = time.time() + 30
        while time.time() < deadline:
            depths = []
            for doc, conn in pairs:
                with conn.lock:
                    depths.append(conn.session.snapshot()["outbox_depth"])
            if depths == [0, 0]:
                break
            time.sleep(0.1)
        assert depths == [0, 0], f"undrained outboxes: {depths}"

        deadline = time.time() + 15
        while time.time() < deadline:
            if os.path.exists(os.path.join(snap_dir, "cluster.json")):
                break
            time.sleep(0.1)
        assert os.path.exists(os.path.join(snap_dir, "cluster.json"))
        assert any(
            name.startswith("shard-") and name.endswith(".json")
            for name in os.listdir(snap_dir)
        )
    finally:
        for doc, conn in pairs:
            conn.close()
        gw.close()
        sup.close()


def test_hung_shard_convicted_by_heartbeat_probe(tmp_path):
    """A SIGSTOPped shard is invisible to ``proc.poll()`` and
    ``client.alive`` — only the monitor's heartbeat probe can convict
    it.  Two unanswered probes must force a restart-through-recover."""
    sup = Supervisor(
        2, str(tmp_path / "wal"), docs_per_shard=8, backend="cpu",
        config=ClusterConfig(probe_timeout_s=0.5, **FAST),
    ).start()
    hung_pid = None
    try:
        room = "hang-room"
        doc = Y.Doc(gc=False)
        doc.client_id = 11
        doc.get_text("text").insert(0, "before the hang")
        assert sup.receive_update(room, Y.encode_state_as_update(doc))
        sup.flush(room)

        owner = sup.owner_of(room)
        hung_pid = sup._shards[owner].pid
        os.kill(hung_pid, signal.SIGSTOP)

        report = wait_outcome(sup, "recovered")
        ev = report["events"][0]
        assert ev["shard"] == owner
        assert ev["outcome"] == "recovered"
        deadline = time.time() + 30
        text = None
        while time.time() < deadline:
            try:
                text = sup.text(room)
                break
            except (RpcBusy, RpcError):
                time.sleep(0.1)
        assert text == "before the hang"
        assert sup._shards[owner].pid != hung_pid
        assert sup._shards[owner].device == "cpu"
    finally:
        if hung_pid is not None:
            try:
                os.kill(hung_pid, signal.SIGKILL)
            except OSError:
                pass
        sup.close()


def test_library_and_launcher_defaults_put_rooms_on_the_engine(
    tmp_path, monkeypatch
):
    """``Supervisor``, ``ShardServer``, the shard child's ``--backend``
    and the launcher's ``--backend`` all default to ``"auto"``, the
    provider's own default (the JAX cluster defaults to ``"cpu"``), and
    ``device=None`` stays the CUDA device."""
    import inspect

    import yjs_tpu_torch.cluster as cluster_pkg
    from yjs_tpu_torch.cluster import Supervisor as PortSupervisor
    from yjs_tpu_torch.cluster import shard as shard_mod

    for cls in (PortSupervisor, shard_mod.ShardServer):
        params = inspect.signature(cls.__init__).parameters
        assert params["backend"].default == "auto", cls
        assert params["device"].default is None, cls
    assert PortSupervisor(1, str(tmp_path / "wal")).device == "cuda"

    seen = {}

    class Stop(Exception):
        pass

    def capture(*args, **kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(shard_mod, "ShardServer", capture)
    with pytest.raises(Stop):
        shard_mod.main(["--id", "0", "--wal-dir", str(tmp_path / "s")])
    assert seen["backend"] == "auto" and seen["device"] is None

    seen.clear()
    monkeypatch.setattr(cluster_pkg, "Supervisor", capture)
    with pytest.raises(Stop):
        LAUNCHER.main(["--shards", "1", "--wal-root", str(tmp_path / "l")])
    assert seen["backend"] == "auto" and seen["device"] is None
