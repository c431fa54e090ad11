"""The shard and cluster cases of ``tests/test_admin.py`` on the
PyTorch port: the admin plane of the port's shard servers and
supervisor (the shard fencing-epoch readiness machine, mid-recovery
readiness, SIGSTOP liveness, stale scrape rows, HTTP-vs-file federation
byte equivalence).  Every shard runs on the CPU
(``tests/torch_service.py``)."""

from __future__ import annotations

import json
import os
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
from torch_service import (
    ShardServer,
    Supervisor,
    TpuProvider,
    one_thread_a_child,
)

from yjs_tpu_torch.cluster import ClusterConfig, Gateway, GatewayConfig
from yjs_tpu_torch.core import Doc
from yjs_tpu_torch.obs.federate import federate_snapshots, read_snapshot_dir
from yjs_tpu_torch.updates import encode_state_as_update

pytestmark = pytest.mark.admin


@pytest.fixture(autouse=True)
def _one_thread_a_child(monkeypatch):
    one_thread_a_child(monkeypatch)


def _get(url: str, timeout: float = 10.0):
    """GET -> (status, body bytes); 4xx/5xx don't raise."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _edit(prov, room: str, text: str) -> None:
    d = Doc(gc=False)
    d.get_text("text").insert(0, text)
    prov.receive_update(room, encode_state_as_update(d))


FAST = dict(heartbeat_s=0.1, restart_backoff_s=0.05, spawn_timeout_s=120.0)


def test_shard_fencing_epoch_readiness(tmp_path):
    """The fenced-corpse state machine, driven through the real RPC
    dispatch seam: witnessing a fleet epoch ahead of the routing epoch
    flips /readyz 503; the supervisor's epoch push restores it."""
    shard = ShardServer(7, str(tmp_path / "wal7"), n_docs=4,
                        backend="cpu")
    try:
        base = shard.admin.url
        assert _get(base + "/readyz")[0] == 200

        # a fence: demoted to replica at epoch 5 (we think we're at 0)
        shard.handle_rpc_request(
            "journal_repl_role",
            {"guid": "roomf", "role": "replica", "epoch": 5,
             "primary": 1},
            None,
        )
        code, body = _get(base + "/readyz")
        assert code == 503
        checks = json.loads(body)["checks"]
        assert checks["epoch_current"] is False
        assert checks["epoch_seen"] == 5
        assert checks["recovery_complete"] is True  # ONLY the fence

        # statusz keeps serving (and shows the lag) while not ready
        code, body = _get(base + "/statusz")
        assert code == 200
        status = json.loads(body)
        assert status["epoch_seen"] == 5
        assert status["routing_epoch"] == 0

        # the supervisor's post-resolution push: current again
        shard.handle_rpc_request("epoch", {"epoch": 6}, None)
        code, body = _get(base + "/readyz")
        assert code == 200
        assert json.loads(body)["checks"]["routing_epoch"] == 6
    finally:
        shard.close()


def test_shard_recovered_wal_history_does_not_fence(tmp_path):
    """Replayed repl_role WAL records must NOT raise _epoch_seen: only
    live control frames fence, else every recovered shard would boot
    not-ready with no supervisor around to push an epoch."""
    wal = str(tmp_path / "wal0")
    shard = ShardServer(0, wal, n_docs=4, backend="cpu")
    shard.handle_rpc_request(
        "journal_repl_role",
        {"guid": "roomr", "role": "replica", "epoch": 9, "primary": 1},
        None,
    )
    shard.close()

    shard = ShardServer(0, wal, n_docs=4, backend="cpu")
    try:
        assert shard.recovery["outcome"] == "recovered"
        assert shard._epoch_seen == 0  # history replayed, not witnessed
        assert _get(shard.admin.url + "/readyz")[0] == 200
    finally:
        shard.close()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.cluster
def test_cluster_admin_everywhere_and_federation_equivalence(tmp_path):
    """Every process serves the plane, and HTTP-scrape federation is
    byte-equivalent with the file-drop mode over the SAME payloads."""

    sup = Supervisor(
        3, str(tmp_path / "wal"), docs_per_shard=4, backend="cpu",
        config=ClusterConfig(snapshot_dir="", **FAST),
    ).start()
    gw = Gateway(sup, config=GatewayConfig(port=0)).start()
    try:
        urls = sup.admin_urls()
        assert set(urls) == {
            "supervisor", "shard-000", "shard-001", "shard-002"
        }
        urls["gateway"] = gw.admin.url
        for name, base in urls.items():
            assert _get(base + "/healthz")[0] == 200, name
            assert _get(base + "/readyz")[0] == 200, name
            code, body = _get(base + "/statusz")
            assert code == 200, name
            status = json.loads(body)
            expect = name.split("-")[0] if name.startswith("shard") else name
            assert status["role"] == expect
            code, body = _get(base + "/metrics")
            assert code == 200 and b"ytpu_" in body, name

        srcs = sup.scrape_sources()
        assert [s["label"] for s in srcs] == [
            "shard-000", "shard-001", "shard-002"
        ]
        assert not any(s["stale"] for s in srcs)
        out = sup.dump_snapshots(path=str(tmp_path / "snap"), sources=srcs)
        file_srcs = [
            s for s in read_snapshot_dir(out) if s["label"] != "cluster"
        ]
        via_http = json.dumps(federate_snapshots(srcs), sort_keys=True)
        via_file = json.dumps(
            federate_snapshots(file_srcs), sort_keys=True
        )
        assert via_http == via_file
    finally:
        gw.close()
        sup.close()


@pytest.mark.cluster
def test_cluster_kill_shard_mid_scrape_yields_stale_row(tmp_path):
    """SIGKILL a shard, scrape immediately: its row is stale-marked,
    the others merge, federation never raises."""
    sup = Supervisor(
        2, str(tmp_path / "wal"), docs_per_shard=4, backend="cpu",
        config=ClusterConfig(
            snapshot_dir="", restart_max=0, probe_timeout_s=60.0,
            scrape_timeout_s=1.0, **FAST,
        ),
    ).start()
    try:
        victim = sup._shards[0].pid
        os.kill(victim, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            srcs = sup.scrape_sources()
            if srcs[0]["stale"]:
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"killed shard never went stale: {srcs}")
        assert srcs[0]["label"] == "shard-000"
        assert srcs[1]["stale"] is False
        fed = federate_snapshots(srcs)
        assert fed["federation"]["stale"] == ["shard-000"]
    finally:
        sup.close()


@pytest.mark.cluster
def test_cluster_healthz_flips_on_sigstop(tmp_path):
    """/healthz is pure liveness: a SIGSTOPped (hung) shard times the
    probe out; SIGCONT restores it.  probe_timeout_s is generous so
    the supervisor doesn't restart the shard under the test."""
    sup = Supervisor(
        1, str(tmp_path / "wal"), docs_per_shard=4, backend="cpu",
        config=ClusterConfig(
            snapshot_dir="", probe_timeout_s=600.0, **FAST
        ),
    ).start()
    pid = sup._shards[0].pid
    stopped = False
    try:
        base = sup.admin_urls()["shard-000"]
        assert _get(base + "/healthz")[0] == 200

        os.kill(pid, signal.SIGSTOP)
        stopped = True
        with pytest.raises(OSError):
            urllib.request.urlopen(base + "/healthz", timeout=1.0)

        os.kill(pid, signal.SIGCONT)
        stopped = False
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                if _get(base + "/healthz", timeout=2.0)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        else:
            pytest.fail("healthz never recovered after SIGCONT")
    finally:
        if stopped:
            os.kill(pid, signal.SIGCONT)
        sup.close()


@pytest.mark.cluster
def test_readyz_flips_during_wal_recovery(tmp_path, monkeypatch):
    """A shard replaying a big WAL answers /healthz 200 and /readyz
    503 (recovery_complete false) until replay completes, then 200 —
    the plane comes up BEFORE the provider.  The port replays these 400
    records faster than a probe can land, so the replay waits at its
    start until the probe has seen the window."""
    import yjs_tpu_torch.persistence as persistence

    seen_503 = threading.Event()
    replay = persistence.replay_wal

    def held_replay(*args, **kwargs):
        seen_503.wait(60)
        return replay(*args, **kwargs)

    monkeypatch.setattr(persistence, "replay_wal", held_replay)
    wal = str(tmp_path / "wal")
    prov = TpuProvider(8, wal_dir=wal)
    for i in range(400):
        _edit(prov, f"room{i % 8}", f"record {i} " * 8)
    prov.flush()
    prov.close()

    admin_port = _free_port()
    built: dict = {}

    def build():
        built["shard"] = ShardServer(
            0, wal, n_docs=8, admin_port=admin_port, backend="cpu"
        )

    t = threading.Thread(target=build, daemon=True)
    base = f"http://127.0.0.1:{admin_port}"
    codes: list[int] = []
    t.start()
    try:
        deadline = time.monotonic() + 120
        while t.is_alive() and time.monotonic() < deadline:
            try:
                codes.append(_get(base + "/readyz", timeout=2.0)[0])
            except OSError:
                pass  # socket not bound yet
            if 503 in codes:
                seen_503.set()
        t.join(timeout=120)
        assert "shard" in built, "shard construction failed"
        # during replay the plane answered, and answered NOT READY
        assert 503 in codes, f"never saw 503 during recovery: {codes}"
        assert _get(base + "/readyz")[0] == 200
        assert built["shard"].recovery["outcome"] == "recovered"
    finally:
        sh = built.get("shard")
        if sh is not None:
            sh.close()


@pytest.mark.cluster
def test_cluster_fencing_flips_readyz_over_real_sockets(tmp_path):
    """The fence window end-to-end: a live shard witnessing a fleet
    epoch ahead of its routing epoch (the frame a real failover sends
    to a stale primary) goes 503 until the supervisor's broadcast."""
    sup = Supervisor(
        2, str(tmp_path / "wal"), docs_per_shard=4, backend="cpu",
        config=ClusterConfig(snapshot_dir="", **FAST),
    ).start()
    try:
        base = sup.admin_urls()["shard-000"]
        assert _get(base + "/readyz")[0] == 200
        # the fence frame, over the real RPC socket
        sup._call(0, "journal_repl_role", {
            "guid": "roomf", "role": "replica", "epoch": 3,
            "primary": 1,
        })
        code, body = _get(base + "/readyz")
        assert code == 503
        assert json.loads(body)["checks"]["epoch_current"] is False
        # the supervisor's post-resolution push restores readiness
        sup._broadcast_epoch(4)
        assert _get(base + "/readyz")[0] == 200
    finally:
        sup.close()
