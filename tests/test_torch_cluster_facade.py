"""The PyTorch port's process cluster: failover, its facade, spawn
and launcher (the remaining cases of ``tests/test_cluster.py``), and the
port's own rule that no kernel failure hides.

Every shard child runs ``python -m yjs_tpu_torch.cluster.shard --device
cpu`` (``tests/torch_service.py``).  The failover case runs under both
provider backends.  The launcher cases run
``scripts/torch_ytpu_cluster.py``; the ``ytpu_top`` case renders a port
cluster's snapshot directory with the port's dashboard
(``scripts/torch_ytpu_top.py``).  A :class:`KernelError` in a shard
(its tick loop or an RPC call) stops it: the error reaches the caller
and the process exits non-zero; a child asked for the CUDA device on a
host without one fails its spawn instead of coming up on the CPU.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
from torch_service import (
    BACKENDS,
    FleetRouter,
    ShardServer,
    Supervisor,
    live_devices,
    load_script,
    one_thread_a_child,
    wait_outcome,
)

import yjs_tpu_torch as Y
from yjs_tpu_torch.cluster import (
    ClusterConfig,
    RpcBusy,
    RpcError,
)
from yjs_tpu_torch.cluster import Supervisor as PortSupervisor
from yjs_tpu_torch.cluster.rpc import RpcClient
from yjs_tpu_torch.ops.kernels import KernelError

pytestmark = pytest.mark.cluster

ROOT = Path(__file__).resolve().parent.parent

FAST = dict(heartbeat_s=0.15, restart_backoff_s=0.05, busy_retry_ticks=4)


@pytest.fixture(autouse=True)
def _one_thread_a_child(monkeypatch):
    one_thread_a_child(monkeypatch)


@pytest.mark.parametrize("backend", BACKENDS)
def test_failover_promotes_replica_past_restart_budget(tmp_path, backend):
    """With a zero restart budget a SIGKILL is a permanent loss: the
    ring successor's journal-only replica records materialize via a
    recover-restart and the room rehomes — text survives the shard."""
    sup = Supervisor(
        3, str(tmp_path / "wal"), docs_per_shard=8, backend=backend,
        config=ClusterConfig(restart_max=0, **FAST),
    ).start()
    try:
        room = "failover-room"
        doc = Y.Doc(gc=False)
        doc.client_id = 9
        doc.get_text("text").insert(0, "survives the shard")
        assert sup.receive_update(room, Y.encode_state_as_update(doc))
        sup.flush(room)
        assert sup.text(room) == "survives the shard"

        owner = sup.owner_of(room)
        replica = sup.replica_of(room)
        assert replica is not None and replica != owner
        before = sup._shards[replica].pid
        os.kill(sup._shards[owner].pid, signal.SIGKILL)

        report = wait_outcome(sup, "failover")
        ev = report["events"][0]
        assert ev["outcome"] == "failover"
        assert ev["shard"] == owner
        assert ev["promoted"] >= 1
        assert report["shards"][owner]["state"] == "lost"
        assert report["epoch"] >= 1
        # the successor's recover-restart is a new child on the device
        # the supervisor was given
        assert report["shards"][replica]["pid"] != before
        assert report["shards"][replica]["device"] == "cpu"
        assert live_devices(report) == {"cpu"}

        new_owner = sup.owner_of(room)
        assert new_owner != owner
        deadline = time.time() + 30
        text = None
        while time.time() < deadline:
            try:
                text = sup.text(room)
                break
            except (RpcBusy, RpcError):
                time.sleep(0.1)
        assert text == "survives the shard"

        doc.get_text("text").insert(0, "and keeps going: ")
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                assert sup.receive_update(
                    room, Y.encode_state_as_update(doc)
                )
                break
            except (RpcBusy, RpcError):
                time.sleep(0.1)
        assert sup.text(room) == "and keeps going: survives the shard"
    finally:
        sup.close()




def test_spawn_ready_timeout_kills_silent_child(tmp_path):
    """A child that starts but never prints its ready line must fail
    the spawn at ``spawn_timeout_s`` and must not leak the process."""
    sup = Supervisor(
        1, str(tmp_path / "wal"), backend="cpu",
        config=ClusterConfig(spawn_timeout_s=0.5, **FAST),
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        stdout=subprocess.PIPE, text=True,
    )
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        sup._read_ready(proc)
    assert time.monotonic() - t0 < 10.0
    assert proc.poll() is not None  # killed, not leaked

    proc = subprocess.Popen(
        [sys.executable, "-c", "raise SystemExit(3)"],
        stdout=subprocess.PIPE, text=True,
    )
    with pytest.raises(RuntimeError, match="exited before ready"):
        sup._read_ready(proc)


def test_supervisor_facade_and_federated_metrics(tmp_path):
    """The FleetRouter-shaped facade over RPC: sv/diff/text round-trip,
    and the federated snapshot carries every shard's families plus the
    supervisor's own cluster gauges."""
    sup = Supervisor(
        2, str(tmp_path / "wal"), docs_per_shard=8, backend="cpu",
        config=ClusterConfig(**FAST),
    ).start()
    try:
        doc = Y.Doc(gc=False)
        doc.client_id = 5
        doc.get_text("text").insert(0, "facade")
        assert sup.receive_update("room-f", Y.encode_state_as_update(doc))
        assert sup.text("room-f") == "facade"

        sv = sup.state_vector_bytes("room-f")
        assert sv and sv != b"\x00"
        diff = sup.diff_update("room-f", b"\x00")
        probe = Y.Doc()
        Y.apply_update(probe, diff)
        assert probe.get_text("text").to_string() == "facade"
        assert len(sup.diff_update("room-f", sv)) < len(diff)

        snap = sup.metrics_snapshot()
        assert snap["federation"]["sources"], snap["federation"]
        names = set(snap["counters"]) | set(snap["gauges"])
        assert any(n.startswith("ytpu_cluster_") for n in names), names
        assert any(n.startswith("ytpu_") and "cluster" not in n
                   for n in names), names
    finally:
        sup.close()


def test_fleet_recovery_report_matches_supervisor_shape(tmp_path):
    """The port's in-process fleet reports recovery outcomes in the
    shape its supervisor emits, so one renderer serves both."""
    wal = str(tmp_path / "fleet")
    fleet = FleetRouter(
        n_shards=2, docs_per_shard=8, backend="cpu", wal_dir=wal
    )
    doc = Y.Doc(gc=False)
    doc.client_id = 3
    doc.get_text("text").insert(0, "fleet doc")
    fleet.receive_update("room-r", Y.encode_state_as_update(doc))
    fleet.flush()
    fresh = fleet.recovery_report()
    assert fresh["kind"] == "fleet"
    assert fresh["outcomes"] == {"recovered": 0, "failover": 0}
    assert all(r["outcome"] == "fresh" for r in fresh["shards"])
    fleet.close()

    recovered = FleetRouter.recover(wal, docs_per_shard=8, backend="cpu")
    report = recovered.recovery_report()
    try:
        assert report["kind"] == "fleet"
        assert report["outcomes"]["recovered"] >= 1
        for key in ("epoch", "shards", "events", "outcomes", "resolution"):
            assert key in report
        for kind in ("completed", "aborted", "fenced"):
            assert kind in report["resolution"]
        row = report["shards"][0]
        for key in ("shard", "state", "pid", "port", "restarts",
                    "outcome", "records_applied"):
            assert key in row
        assert any(
            r["records_applied"] >= 1 for r in report["shards"]
        ), report["shards"]
    finally:
        recovered.close()


def test_ytpu_top_cluster_mode_renders_supervision_panel(tmp_path):
    """``ytpu_top --cluster`` renders a supervision report, and the
    snapshot directory a port cluster dumps."""
    top = load_script("torch_ytpu_top")
    report = {
        "kind": "cluster",
        "epoch": 2,
        "shards": [
            {"shard": 0, "state": "live", "pid": 41, "port": 9001,
             "restarts": 0, "outcome": "fresh", "records_applied": 0},
            {"shard": 1, "state": "lost", "pid": 42, "port": 9002,
             "restarts": 3, "outcome": "recovered",
             "records_applied": 17},
        ],
        "events": [{"shard": 1, "outcome": "failover", "epoch": 2,
                    "unavailable_s": 1.25,
                    "resolution": {"completed": 0, "aborted": 0,
                                   "fenced": 1}}],
        "outcomes": {"recovered": 0, "failover": 1},
        "resolution": {"completed": 0, "aborted": 0, "fenced": 1},
    }
    synth = tmp_path / "synth"
    synth.mkdir()
    (synth / "cluster.json").write_text(json.dumps(report))
    (synth / "shard-000.json").write_text(
        json.dumps({"counters": {}, "gauges": {}, "histograms": {}})
    )
    out = io.StringIO()
    top.run_plain(
        top.ClusterDirSource(str(synth)),
        interval=0.01, iterations=1, out=out,
    )
    frame = out.getvalue()
    assert "cluster epoch 2" in frame
    assert "failover" in frame and "recovered" in frame
    assert "unavailable=1.25s" in frame
    assert "CLUSTER" in frame and "shard-000" in frame
    lines = [ln for ln in frame.splitlines() if ln.startswith("cluster")]
    assert lines, frame
    empty = tmp_path / "empty"
    empty.mkdir()
    src = top.ClusterDirSource(str(empty))
    assert "no cluster.json" in src.header()

    # a port cluster's own dump: one shard file per child plus the report
    sup = Supervisor(
        2, str(tmp_path / "wal"), docs_per_shard=4, backend="auto",
        config=ClusterConfig(**FAST),
    ).start()
    try:
        doc = Y.Doc(gc=False)
        doc.get_text("text").insert(0, "dashboard")
        assert sup.receive_update("room-t", Y.encode_state_as_update(doc))
        sup.flush("room-t")
        snap = sup.dump_snapshots(path=str(tmp_path / "snap"))
    finally:
        sup.close()
    names = sorted(os.listdir(snap))
    assert names == ["cluster.json", "shard-000.json", "shard-001.json"]
    out = io.StringIO()
    top.run_plain(
        top.ClusterDirSource(snap), interval=0.01, iterations=1, out=out,
    )
    frame = out.getvalue()
    assert "cluster epoch 0" in frame
    assert "CLUSTER" in frame
    assert "shard-000" in frame and "shard-001" in frame


def test_cluster_launcher_parses_compose_shaped_config():
    """``scripts/torch_ytpu_cluster.py --config`` speaks the compose
    shape, as the JAX launcher does."""
    launcher = load_script("torch_ytpu_cluster")
    got = launcher.parse_compose({
        "services": {
            "shard": {
                "deploy": {"replicas": 5},
                "environment": {"YTPU_CLUSTER_HEARTBEAT_S": "0.15"},
            },
            "gateway": {
                "ports": ["8765:8765"],
                "environment": ["YTPU_GATEWAY_TICK_S=0.01"],
            },
        }
    })
    assert got["shards"] == 5
    assert got["gateway_port"] == 8765
    assert got["env"] == {
        "YTPU_CLUSTER_HEARTBEAT_S": "0.15",
        "YTPU_GATEWAY_TICK_S": "0.01",
    }
    assert launcher.parse_compose({"services": {"redis": {}}}) == {
        "shards": None, "gateway_port": None, "env": {},
    }


def test_cluster_launcher_smoke_round_trips_an_edit(tmp_path):
    """Launch 1 port shard on the CPU + gateway from a compose-shaped
    config file, push one edit through the session dialect, verify it
    server-side, exit 0."""
    cfg = tmp_path / "cluster.json"
    cfg.write_text(json.dumps({
        "services": {
            "shard": {
                "deploy": {"replicas": 1},
                "environment": {"YTPU_CLUSTER_HEARTBEAT_S": "0.15"},
            },
            "gateway": {"ports": ["0:0"]},
        }
    }))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_ytpu_cluster.py"),
         "--config", str(cfg), "--smoke", "--device", "cpu",
         "--backend", "auto", "--wal-root", str(tmp_path / "wal")],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "smoke: OK" in proc.stdout
    assert "1 shard(s) up" in proc.stdout
    assert "device=cpu" in proc.stdout


# -- no kernel failure hides --------------------------------------------------


def _raise_kernel_error(*args, **kwargs):
    raise KernelError("apply_lanes: launch failed (test)")


def test_tick_loop_kernel_error_stops_the_shard(tmp_path):
    """A KernelError in the tick loop is not a failed tick to retry:
    the loop ends, and ``run_forever`` hands the error to its caller
    (``main`` then exits non-zero)."""
    shard = ShardServer(0, str(tmp_path / "wal"), n_docs=4, tick_s=0.01,
                        backend="auto")
    try:
        shard.provider.flush_tick = _raise_kernel_error
        done = threading.Event()
        caught = []

        def serve():
            try:
                shard.run_forever()
            except KernelError as e:
                caught.append(e)
            done.set()

        threading.Thread(target=serve, daemon=True).start()
        assert done.wait(30), "run_forever kept serving after a KernelError"
        assert caught and "launch failed" in str(caught[0])
        assert shard.fault is caught[0]
        shard._ticker.join(timeout=5)
        assert not shard._ticker.is_alive()
    finally:
        shard.close(checkpoint=False)


def test_tick_loop_other_errors_still_retry(tmp_path):
    """Any other tick failure stays what the reference makes it: the
    next round retries, and the shard keeps serving."""
    shard = ShardServer(0, str(tmp_path / "wal"), n_docs=4, tick_s=0.01,
                        backend="auto")
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        raise ValueError("a passing fault")

    try:
        shard.provider.flush_tick = flaky
        deadline = time.time() + 30
        while len(calls) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert len(calls) >= 3
        assert shard._ticker.is_alive()
        assert shard.fault is None
    finally:
        shard.close(checkpoint=False)


def test_rpc_kernel_error_reaches_the_caller_and_stops_the_shard(tmp_path):
    """A KernelError raised under an RPC call answers the caller with an
    error and stops the shard: it is not retried as BUSY by the shard."""
    shard = ShardServer(0, str(tmp_path / "wal"), n_docs=4,
                        backend="auto")
    client = RpcClient("127.0.0.1", shard.port, timeout=30)
    try:
        shard.provider.flush = _raise_kernel_error
        with pytest.raises(RpcError, match="launch failed") as info:
            client.call("flush", {})
        assert not isinstance(info.value, RpcBusy)
        with pytest.raises(KernelError):
            shard.run_forever()
    finally:
        client.close()
        shard.close(checkpoint=False)


def test_launches_rpc_reads_and_resets_the_wrapper_counts(tmp_path):
    """The ``launches`` call returns the kernel wrappers' counts of the
    shard's process; a CPU shard launches nothing."""
    from yjs_tpu_torch.ops import kernels

    shard = ShardServer(0, str(tmp_path / "wal"), n_docs=4,
                        backend="auto")
    try:
        doc = Y.Doc(gc=False)
        doc.get_text("text").insert(0, "counted")
        shard.handle_rpc_request("update", {
            "guid": "room-c",
            "update": __import__("base64").b64encode(
                Y.encode_state_as_update(doc)).decode("ascii"),
        }, None)
        shard.handle_rpc_request("flush", {}, None)
        got = shard.handle_rpc_request("launches", {"reset": True}, None)
        assert set(got["launches"]) == set(kernels.launches)
        assert all(v == 0 for v in got["launches"].values())
        kernels.launches["apply_lanes"] += 2
        got = shard.handle_rpc_request("launches", {"reset": True}, None)
        assert got["launches"]["apply_lanes"] == 2
        assert kernels.launches["apply_lanes"] == 0
    finally:
        shard.close(checkpoint=False)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_child_without_cuda_fails_its_spawn(tmp_path, device):
    """A child asked for the CUDA device (``--device cuda``, the
    default) on a host without CUDA exits before its ready line: the
    spawn fails, nothing comes up on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("holds a host without CUDA to refusing a CUDA child")
    sup = PortSupervisor(
        1, str(tmp_path / "wal"), docs_per_shard=4, backend="auto",
        device=device, config=ClusterConfig(spawn_timeout_s=120.0, **FAST),
    )
    assert sup.device == "cuda"
    with pytest.raises(RuntimeError, match=r"exited before ready \(rc=1\)"):
        sup.start()
    try:
        assert sup._shards[0].state == "starting"
        assert sup._shards[0].pid == 0
    finally:
        sup.close()
