"""The cases of the JAX package's ``tests/test_admin.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Per-process introspection plane tests.

Covers the AdminServer endpoint surface over a live provider, the
liveness/readiness split (including the shard fencing-epoch state
machine), the inflight bound, the env opt-in for library objects, the
HTTP/file scrape hardening against mid-death races, and the
concurrent-scrape hammer against a flushing provider.

The shard and cluster cases are carried in
``tests/test_torch_admin_cluster.py``; the bench-regression gate's case
tests ``scripts/check_bench.py``, a tool of the JAX package's
benchmark, and is not carried.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import urllib.error
import urllib.request

import pytest

from yjs_tpu_torch.core import Doc
from yjs_tpu_torch.obs.admin import AdminConfig, AdminServer, maybe_start_admin
from yjs_tpu_torch.obs.federate import (
    federate_snapshots,
    read_snapshot_dir,
    scrape_endpoints,
)
from torch_service import TpuProvider
from yjs_tpu_torch.updates import encode_state_as_update

pytestmark = pytest.mark.admin


def _get(url: str, timeout: float = 10.0):
    """GET -> (status, body bytes); 4xx/5xx don't raise."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _edit(prov: TpuProvider, room: str, text: str) -> None:
    d = Doc(gc=False)
    d.get_text("text").insert(0, text)
    prov.receive_update(room, encode_state_as_update(d))


@pytest.fixture
def prov_admin():
    prov = TpuProvider(8)
    admin = AdminServer(prov, role="provider").start()
    try:
        yield prov, admin
    finally:
        admin.close()
        prov.close()


# -- endpoint surface ---------------------------------------------------------


def test_all_endpoints_answer_over_live_provider(prov_admin):
    prov, admin = prov_admin
    _edit(prov, "room0", "hello admin")
    prov.flush()
    base = admin.url
    assert base.startswith("http://127.0.0.1:")

    code, body = _get(base + "/healthz")
    assert (code, body) == (200, b"ok\n")

    code, body = _get(base + "/metrics")
    assert code == 200
    text = body.decode()
    assert "ytpu_engine_flushes_total" in text

    code, body = _get(base + "/metrics.json")
    assert code == 200
    snap = json.loads(body)
    assert set(snap) >= {"counters", "gauges", "histograms"}

    code, body = _get(base + "/readyz")
    assert code == 200
    verdict = json.loads(body)
    assert verdict["ready"] is True
    assert verdict["checks"]["recovery_complete"] is True

    code, body = _get(base + "/statusz")
    assert code == 200
    status = json.loads(body)
    assert status["role"] == "provider"
    assert status["pid"] == os.getpid()
    assert status["docs"] == 1
    assert "residue_fraction" in status
    assert "plan_cache_hit_rate" in status
    assert status["admission"]["level_name"] in (
        "normal", "shed-bg", "coalesce", "rej-write"
    )

    code, body = _get(base + "/debug/blackbox")
    assert code == 200
    bb = json.loads(body)
    assert "stats" in bb and "events" in bb

    code, body = _get(base + "/debug/prof")
    assert code == 200
    prof = json.loads(body)
    assert "device_memory" in prof

    code, body = _get(base + "/debug/trace?n=3")
    assert code == 200
    tr = json.loads(body)
    assert len(tr["events"]) <= 3
    assert tr["total"] >= len(tr["events"])

    code, body = _get(base + "/nope")
    assert code == 404


def test_metrics_exposition_well_formed(prov_admin):
    import re

    prov, admin = prov_admin
    _edit(prov, "roomx", "expo")
    prov.flush()
    code, body = _get(admin.url + "/metrics")
    assert code == 200
    line_re = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})?"
        r" [-+]?([0-9.eE+-]+|NaN|Inf)( [0-9]+)?$"
    )
    for ln in body.decode().splitlines():
        if ln and not ln.startswith("#"):
            assert line_re.match(ln), f"malformed exposition line: {ln!r}"


def test_request_counter_and_busy_shed():
    """max_inflight=1 with a blocked handler: the second request is
    shed with 503 'admin busy' instead of queueing behind the stall."""
    from yjs_tpu_torch.obs.admin import admin_metrics

    hold = threading.Event()
    entered = threading.Event()

    class SlowTarget:
        def statusz(self):
            entered.set()
            hold.wait(10)
            return {"slow": True}

    admin = AdminServer(
        SlowTarget(), role="slow",
        config=AdminConfig(max_inflight=1),
    ).start()
    try:
        t = threading.Thread(
            target=lambda: _get(admin.url + "/statusz"), daemon=True
        )
        t.start()
        assert entered.wait(5)
        before = admin_metrics().requests.labels(
            endpoint="/healthz", code=503
        ).value
        code, body = _get(admin.url + "/healthz")
        assert code == 503
        assert json.loads(body)["error"] == "admin busy"
        after = admin_metrics().requests.labels(
            endpoint="/healthz", code=503
        ).value
        assert after == before + 1
        hold.set()
        t.join(timeout=5)
        # the gate released: the plane serves again
        assert _get(admin.url + "/healthz")[0] == 200
    finally:
        hold.set()
        admin.close()


def test_target_exception_renders_500_and_plane_survives():
    class BadTarget:
        def statusz(self):
            raise RuntimeError("target on fire")

    admin = AdminServer(BadTarget(), role="bad").start()
    try:
        code, body = _get(admin.url + "/statusz")
        assert code == 500
        err = json.loads(body)
        assert err["error"] == "RuntimeError"
        # liveness untouched by the target bug
        assert _get(admin.url + "/healthz")[0] == 200
    finally:
        admin.close()


# -- lifecycle / opt-in -------------------------------------------------------


def test_maybe_start_admin_env_optin(monkeypatch):
    monkeypatch.delenv("YTPU_ADMIN_PORT", raising=False)
    prov = TpuProvider(2)
    try:
        assert prov.admin is None  # no env: libraries stay silent
        assert maybe_start_admin(prov, "provider") is None
    finally:
        prov.close()

    monkeypatch.setenv("YTPU_ADMIN_PORT", "0")
    prov = TpuProvider(2)
    try:
        assert prov.admin is not None
        assert _get(prov.admin.url + "/healthz")[0] == 200
    finally:
        prov.close()
    # close() shut the plane down with the provider
    assert prov.admin is None or prov.admin._httpd is None

    monkeypatch.setenv("YTPU_ADMIN_DISABLED", "1")
    prov = TpuProvider(2)
    try:
        assert prov.admin is None
    finally:
        prov.close()


def test_maybe_start_admin_port_collision_yields_none():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    taken = sock.getsockname()[1]
    try:
        admin = maybe_start_admin(
            object(), "provider", config=AdminConfig(port=taken)
        )
        assert admin is None
    finally:
        sock.close()


def test_disabled_config_makes_start_a_noop():
    admin = AdminServer(None, config=AdminConfig(disabled=True)).start()
    assert admin.port == 0
    assert admin.url == ""
    admin.close()  # no-op, no raise


def test_fleet_router_owns_one_plane(monkeypatch):
    monkeypatch.setenv("YTPU_ADMIN_PORT", "0")
    from torch_service import FleetRouter

    fleet = FleetRouter(n_shards=2, docs_per_shard=4)
    try:
        # per-provider auto-planes were folded into the fleet's one
        assert all(p.admin is None for p in fleet.shards)
        assert fleet.admin is not None
        code, body = _get(fleet.admin.url + "/statusz")
        assert code == 200
        status = json.loads(body)
        assert status["role"] == "fleet"
        assert status["n_shards"] == 2
        assert _get(fleet.admin.url + "/readyz")[0] == 200
    finally:
        fleet.close()


# -- readiness semantics ------------------------------------------------------


def test_provider_readyz_flips_on_recovering_and_brownout(prov_admin):
    prov, admin = prov_admin
    assert _get(admin.url + "/readyz")[0] == 200

    prov.recovering = True
    code, body = _get(admin.url + "/readyz")
    assert code == 503
    assert json.loads(body)["checks"]["recovery_complete"] is False
    prov.recovering = False
    assert _get(admin.url + "/readyz")[0] == 200

    prov.admission.brownout.level = 3  # reject-writes
    code, body = _get(admin.url + "/readyz")
    assert code == 503
    assert json.loads(body)["checks"]["accepting_writes"] is False
    prov.admission.brownout.level = 0
    assert _get(admin.url + "/readyz")[0] == 200


# -- scrape hardening ---------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_scrape_endpoints_dead_target_is_stale_not_error(prov_admin):
    from yjs_tpu_torch.obs.federate import fed_metrics

    prov, admin = prov_admin
    prov.flush()
    dead = f"127.0.0.1:{_free_port()}"
    before = fed_metrics().scrape_errors.labels(mode="http").value
    sources = scrape_endpoints([admin.url, dead], timeout_s=1.0)
    assert len(sources) == 2
    live, gone = sources
    assert live["stale"] is False
    assert live["snapshot"].get("counters")
    assert gone["stale"] is True
    assert gone["snapshot"] == {}
    assert gone["label"] == dead
    after = fed_metrics().scrape_errors.labels(mode="http").value
    assert after == before + 1
    # federation renders the blank row and names the stale source
    fed = federate_snapshots(sources)
    assert fed["federation"]["stale"] == [dead]


def test_scrape_endpoints_truncated_body_is_stale():
    """An endpoint that promises a Content-Length then dies mid-body
    (the shard was SIGKILLed mid-scrape) must yield a stale entry."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def truncating_server():
        conn, _ = srv.accept()
        conn.recv(4096)
        conn.sendall(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: 100000\r\n\r\n"
            b'{"counters": {'
        )
        conn.close()  # mid-body: the promised bytes never arrive

    t = threading.Thread(target=truncating_server, daemon=True)
    t.start()
    try:
        sources = scrape_endpoints(
            [f"127.0.0.1:{port}"], timeout_s=5.0
        )
        assert sources[0]["stale"] is True
        assert sources[0]["snapshot"] == {}
    finally:
        srv.close()
        t.join(timeout=5)


def test_read_snapshot_dir_file_deleted_mid_listing(tmp_path, monkeypatch):
    """A shard dying between listdir and open contributes a stale
    blank source, never an exception."""
    from yjs_tpu_torch.obs import federate as fed_mod

    good = tmp_path / "shard-000.json"
    good.write_text(json.dumps({"counters": {"c": {"": 1}}}))
    doomed = tmp_path / "shard-001.json"
    doomed.write_text("{}")

    real_listdir = os.listdir

    def racing_listdir(path):
        names = real_listdir(path)
        if doomed.exists():
            doomed.unlink()  # dies right after the listing
        return names

    monkeypatch.setattr(fed_mod.os, "listdir", racing_listdir)
    before = fed_mod.fed_metrics().scrape_errors.labels(mode="file").value
    sources = read_snapshot_dir(str(tmp_path))
    assert [s["label"] for s in sources] == ["shard-000", "shard-001"]
    assert sources[0]["stale"] is False
    assert sources[1]["stale"] is True
    after = fed_mod.fed_metrics().scrape_errors.labels(mode="file").value
    assert after == before + 1


def test_read_snapshot_dir_mid_write_torn_json(tmp_path):
    (tmp_path / "shard-000.json").write_text('{"counters": {"tor')
    sources = read_snapshot_dir(str(tmp_path))
    assert sources[0]["stale"] is True
    assert sources[0]["snapshot"] == {}
    # federation over the torn dir still renders
    fed = federate_snapshots(sources)
    assert fed["federation"]["stale"] == ["shard-000"]


# -- concurrency --------------------------------------------------------------


def test_concurrent_scrape_hammer_against_flushing_provider():
    """N scraper threads x every endpoint while the provider flushes:
    no torn exposition, no deadlock, every response well-formed."""
    prov = TpuProvider(8)
    admin = AdminServer(
        prov, role="provider", config=AdminConfig(max_inflight=16)
    ).start()
    stop = threading.Event()
    failures: list[str] = []

    def flusher():
        n = 0
        while not stop.is_set():
            n += 1
            _edit(prov, f"room{n % 8}", f"edit {n} ")
            prov.flush()

    endpoints = (
        "/metrics", "/metrics.json", "/healthz", "/readyz",
        "/statusz", "/debug/blackbox", "/debug/prof", "/debug/trace",
    )

    def scraper(k: int):
        for i in range(12):
            ep = endpoints[(k + i) % len(endpoints)]
            try:
                code, body = _get(admin.url + ep, timeout=30)
            except Exception as e:
                failures.append(f"{ep}: {type(e).__name__}: {e}")
                continue
            if code == 503 and ep not in ("/readyz",):
                continue  # inflight shed under the hammer is legal
            if code != 200:
                failures.append(f"{ep}: HTTP {code}")
            elif ep == "/metrics":
                import re

                line_re = re.compile(
                    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})?"
                    r" [-+]?([0-9.eE+-]+|NaN|Inf)$"
                )
                for ln in body.decode("utf-8").splitlines():
                    if ln and not ln.startswith("#") \
                            and not line_re.match(ln):
                        failures.append(f"{ep}: torn line {ln!r}")
                        break
            elif ep != "/healthz":
                try:
                    json.loads(body)
                except ValueError:
                    failures.append(f"{ep}: torn JSON")

    ft = threading.Thread(target=flusher, daemon=True)
    ft.start()
    threads = [
        threading.Thread(target=scraper, args=(k,)) for k in range(8)
    ]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "scraper deadlocked"
    finally:
        stop.set()
        ft.join(timeout=30)
        admin.close()
        prov.close()
    assert not failures, failures
