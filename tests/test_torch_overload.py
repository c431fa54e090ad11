"""The overload harness and the capacity ramp on the port.

The cases of the JAX package's ``tests/test_overload.py`` (the seeded
load generator against an admission-controlled, replicated fleet: zero
acked loss, an unpaged interactive SLO, bounded brownout recovery,
delta-resume failover under brownout) and the ramp cases of
``tests/test_cost.py`` (``ramp_capacity`` records every stage in the
TSDB and reads its knee back) run here on ``yjs_tpu_torch.loadgen`` and
``yjs_tpu_torch.obs.capacity`` over port fleets and providers on the CPU
(``device="cpu"``).
"""

import pytest

from yjs_tpu_torch.admission import AdmissionConfig
from yjs_tpu_torch.fleet import FailoverConfig
from yjs_tpu_torch.loadgen import LoadGen, LoadGenConfig
from yjs_tpu_torch.obs.capacity import CapacityConfig, ramp_capacity, read_knee
from yjs_tpu_torch.obs.tsdb import Tsdb, TsdbConfig
from yjs_tpu_torch.persistence import WalConfig
from torch_service import BACKENDS, FleetRouter, TpuProvider

pytestmark = pytest.mark.loadgen


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


def overloaded_fleet(backend, **adm_kw):
    base = dict(
        enabled=True, tenant_rate=1.0, tenant_burst=4,
        doc_rate=1.0, doc_burst=4, queue_max=64, drain_batch=32,
        down_ticks=4,
    )
    base.update(adm_kw)
    return FleetRouter(
        2, 32, backend=backend,
        admission_config=AdmissionConfig(**base),
    )


def run_harness(fleet, seed=42, ticks=120, **lg_kw):
    lg = LoadGen(fleet, LoadGenConfig(seed=seed, n_clients=12, **lg_kw))
    lg.run(ticks)
    lg.drain()
    return lg


def test_seed_determinism(backend):
    reports = []
    for _ in range(2):
        lg = run_harness(overloaded_fleet(backend), seed=42, ticks=60)
        reports.append(lg.report())
    # byte-identical replay: same seed, same schedule, same outcome
    assert reports[0] == reports[1]


def test_seed_changes_schedule(backend):
    a = run_harness(overloaded_fleet(backend), seed=42, ticks=60).report()
    b = run_harness(overloaded_fleet(backend), seed=43, ticks=60).report()
    assert a["edits"] != b["edits"] or a["admission"] != b["admission"]


def test_2x_overload_invariants(backend, request):
    request.node.loadgen_seed = 42
    fleet = overloaded_fleet(backend)
    lg = run_harness(fleet, seed=42, ticks=120)
    rep = lg.report()
    assert rep["overload_factor"] >= 2.0
    assert rep["shed_fraction"] > 0.05  # the surplus really shed
    # the harness contracts: no acked loss (byte-identical rooms), the
    # interactive SLO never paged, brownout back at normal
    lg.assert_invariants()
    # every session paid exactly its one initial full resync
    assert all(v <= 1 for v in rep["session_full_resyncs"])


def test_brownout_engages_and_recovers(backend, request):
    request.node.loadgen_seed = 7
    fleet = overloaded_fleet(
        backend, tenant_rate=0.5, tenant_burst=2, doc_rate=0.5, doc_burst=2,
        queue_max=16, drain_batch=4, up_ticks=2, down_ticks=6,
    )
    lg = run_harness(fleet, seed=7, ticks=120, flush_every=8)
    rep = lg.report()
    # ~4x offered: the controller must actually climb...
    assert rep["overload_factor"] >= 2.0
    assert rep["max_level"] >= 1
    assert rep["transitions"]
    # ...journal/meter each step (levels only move one step at a time,
    # and every transition carries a typed reason)
    names = ("normal", "shed-background", "coalesce", "reject-writes")
    order = {n: i for i, n in enumerate(names)}
    for t in rep["transitions"]:
        assert abs(order[t["to"]] - order[t["from"]]) == 1
        assert t["reason"]
    # ...and return to normal within a bounded window once load stops
    assert rep["recovery_ticks"] <= 200
    lg.assert_invariants()


@pytest.mark.chaos
def test_kill_primary_during_brownout(backend, request, tmp_path):
    """Acceptance: a primary dies while the fleet is browned out; the
    survivors fail over via delta resume (full_resyncs stays at the one
    initial handshake each) and the drained fleet is byte-identical."""
    request.node.loadgen_seed = 7
    fleet = FleetRouter(
        3, 32, backend=backend, wal_dir=tmp_path,
        wal_config=WalConfig(fsync="never"),
        failover_config=FailoverConfig(
            suspect_ticks=2, confirm_ticks=1, jitter_ticks=0,
        ),
        admission_config=AdmissionConfig(
            enabled=True, tenant_rate=0.5, tenant_burst=2,
            doc_rate=0.5, doc_burst=2, queue_max=16, drain_batch=4,
            up_ticks=2, down_ticks=6,
        ),
    )
    lg = LoadGen(fleet, LoadGenConfig(seed=7, n_clients=12, flush_every=8))
    state = {"killed": None, "revived": False}

    def on_tick(lg_):
        adm = fleet.admission
        if state["killed"] is None and adm.level >= 1 and lg_.tick >= 24:
            # the brownout is live: kill the primary of the first
            # session room mid-traffic
            guid = next(
                c.guid for c in lg_.clients if hasattr(c, "session")
            )
            victim = fleet.owner_of(guid)
            if victim is not None:
                fleet.kill_shard(victim)
                state["killed"] = victim
        elif (
            state["killed"] is not None
            and not state["revived"]
            and state["killed"] in fleet._down
        ):
            fleet.revive_shard(state["killed"])
            state["revived"] = True

    lg.run(120, on_tick=on_tick)
    assert state["killed"] is not None, "brownout never engaged"
    assert state["revived"]
    lg.drain()
    rep = lg.report()
    assert rep["max_level"] >= 1
    lg.assert_invariants()
    # delta-resume failover: each surviving session's only full resync
    # is its initial handshake
    assert rep["session_full_resyncs"]
    assert all(v == 1 for v in rep["session_full_resyncs"])


# -- the capacity ramp (tests/test_cost.py) ------------------------------------


def _store() -> Tsdb:
    return Tsdb(TsdbConfig(
        interval_s=1.0, retention_raw_s=10 * 24 * 3600.0,
        retention_1m_s=20 * 24 * 3600.0,
        retention_10m_s=30 * 24 * 3600.0, directory=None,
    ))


@pytest.mark.cost
def test_ramp_capacity_records_stages_and_reads_knee_from_tsdb():
    st = _store()
    cfg = CapacityConfig(
        start_sessions=2, max_sessions=4, growth=2.0,
        ticks_per_stage=4, flush_every=2, slo_target_ms=60_000.0,
        seed=0,
    )
    result = ramp_capacity(
        lambda n: TpuProvider(n + 4), config=cfg, store=st, now=5000.0,
    )
    assert [s["sessions"] for s in result["stages"]] == [2, 4]
    assert all(s["ok"] for s in result["stages"])
    assert result["ceiling_hit"] is True
    assert result["sessions_at_slo"] == 4
    # the figure is, by construction, a TSDB query over the ramp
    assert read_knee(st, *result["window"]) == 4
    pts = st.query("ytpu_capacity_sessions", start=4999.0, end=5010.0,
                   tier="raw")
    assert [v for _, v in pts] == [2.0, 4.0]


@pytest.mark.cost
def test_ramp_capacity_stops_at_degraded_stage():
    st = _store()
    # an impossible visibility budget: every stage degrades, so the
    # ramp must stop after the first stage and publish a zero knee
    cfg = CapacityConfig(
        start_sessions=2, max_sessions=8, growth=2.0,
        ticks_per_stage=4, flush_every=2, p99_limit_ticks=-1,
        slo_target_ms=60_000.0,
    )
    result = ramp_capacity(
        lambda n: TpuProvider(n + 4), config=cfg, store=st, now=9000.0,
    )
    assert result["ceiling_hit"] is False
    assert len(result["stages"]) == 1  # degraded on the very first
    assert result["stages"][0]["ok"] is False
    assert result["sessions_at_slo"] == 0
    assert read_knee(st, *result["window"]) == 0
    # the degraded stage is still in the history (ok recorded as 0)
    assert st.query("ytpu_capacity_ok", start=8999.0, end=9010.0,
                    tier="raw") == [(9000.0, 0.0)]
