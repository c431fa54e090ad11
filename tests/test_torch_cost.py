"""The cases of the JAX package's ``tests/test_cost.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Cost-attribution ledger + capacity-model tests.

Covers flush-seam attribution (device/host seconds split across docs
proportional to staged bytes), the bounded top-K doc map under a
10k-doc churn storm (with exact conservation through the sampled
tail), tenant-label folding at the cardinality cap, the geo-link
shipped/deferred accounting seam, provider wiring, byte-identical
engine output with the whole telemetry plane disabled vs enabled, and
the TSDB-derived sessions-per-device capacity knee.  The two
``ramp_capacity`` cases are carried in ``tests/test_torch_overload.py``.
"""

from __future__ import annotations

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.obs import MetricsRegistry
from yjs_tpu_torch.obs.capacity import (
    CapacityConfig,
    read_knee,
    sessions_per_device,
)
from yjs_tpu_torch.obs.cost import DIMS, CostLedger, cost_enabled
from yjs_tpu_torch.obs.expo import registry_snapshot
from yjs_tpu_torch.obs.tsdb import Tsdb, TsdbConfig
from torch_service import TpuProvider
from yjs_tpu_torch.updates import encode_state_as_update

pytestmark = pytest.mark.cost

FLUSH = {
    "t_dispatch_s": 0.8,
    "t_compact_s": 0.05, "t_plan_s": 0.05,
    "t_pack_s": 0.05, "t_emit_s": 0.05,
}


def _ledger(**kw) -> CostLedger:
    kw.setdefault("max_docs", 32)
    kw.setdefault("max_tenants", 8)
    kw.setdefault("tail_sample", 1)
    return CostLedger(MetricsRegistry(), **kw)


def _store() -> Tsdb:
    return Tsdb(TsdbConfig(
        interval_s=1.0, retention_raw_s=10 * 24 * 3600.0,
        retention_1m_s=20 * 24 * 3600.0,
        retention_10m_s=30 * 24 * 3600.0, directory=None,
    ))


# -- flush-seam attribution ---------------------------------------------------


def test_on_flush_splits_time_proportional_to_staged_bytes():
    led = _ledger()
    led.staged("acme/doc-a", 300)
    led.staged("acme/doc-a", 0)     # zero-byte stage is harmless
    led.staged("beta/doc-b", 100)
    led.on_flush(dict(FLUSH))
    snap = led.snapshot()
    top = {d["guid"]: d for d in snap["top"]}
    assert top["acme/doc-a"]["device_s"] == pytest.approx(0.6)
    assert top["beta/doc-b"]["device_s"] == pytest.approx(0.2)
    assert top["acme/doc-a"]["host_s"] == pytest.approx(0.15)
    assert top["beta/doc-b"]["host_s"] == pytest.approx(0.05)
    assert top["acme/doc-a"]["tenant"] == "acme"
    assert snap["tenants"]["acme"]["device_s"] == pytest.approx(0.6)
    # conservation: the whole flush is attributed, nothing minted
    t = led.totals()
    assert t["device_s"] == pytest.approx(0.8)
    assert t["host_s"] == pytest.approx(0.2)


def test_on_flush_resets_staging_between_flushes():
    led = _ledger()
    led.staged("t/d", 64)
    led.on_flush(dict(FLUSH))
    led.on_flush(dict(FLUSH))  # nothing staged since: must be a no-op
    assert led.totals()["device_s"] == pytest.approx(0.8)
    led.on_flush(None)         # idle-flush seam passes None
    assert led.totals()["device_s"] == pytest.approx(0.8)


def test_hooks_land_in_their_own_dimensions():
    led = _ledger()
    led.wal_bytes("t/d", 100)
    led.repl_bytes("t/d", 250)
    led.session_frame("t/d")
    led.session_frame("t/d", n=3)
    t = led.totals()
    assert set(t) == set(DIMS)
    assert t["wal_bytes"] == 100.0
    assert t["repl_bytes"] == 250.0
    assert t["session_frames"] == 4.0
    assert t["device_s"] == t["host_s"] == 0.0


def test_geo_bytes_exports_per_peer_kind_labels():
    reg = MetricsRegistry()
    led = CostLedger(reg, max_docs=8, max_tenants=4, tail_sample=1)
    led.geo_bytes("euw", 1000, kind="shipped")
    led.geo_bytes("euw", 200, kind="deferred")
    led.geo_bytes("apne", 50)  # kind defaults to shipped
    snap = registry_snapshot(reg)
    geo = snap["counters"]["ytpu_cost_geo_link_bytes_total"]
    assert geo["peer=euw,kind=shipped"] == 1000
    assert geo["peer=euw,kind=deferred"] == 200
    assert geo["peer=apne,kind=shipped"] == 50
    # link bytes are per-peer, not per-doc: the doc ledger is untouched
    assert led.totals()["geo_bytes"] == 0.0


def test_exported_tenant_families_follow_attribution():
    reg = MetricsRegistry()
    led = CostLedger(reg, max_docs=8, max_tenants=4, tail_sample=1)
    led.wal_bytes("acme/doc-1", 500)
    led.wal_bytes("acme/doc-2", 300)
    led.wal_bytes("beta/doc-9", 100)
    wal = registry_snapshot(reg)["counters"]["ytpu_cost_wal_bytes_total"]
    assert wal["tenant=acme"] == 800
    assert wal["tenant=beta"] == 100


# -- bounded top-K under churn ------------------------------------------------


def test_topk_bound_and_conservation_under_10k_doc_churn(rng):
    led = _ledger(max_docs=32, max_tenants=8, tail_sample=1)
    fed_wal = 0
    heavy = "tenant0/doc-heavy"
    # the heavy doc earns device time first, so compaction must keep it
    led.staged(heavy, 1000)
    led.on_flush(dict(FLUSH))
    for i in range(10_000):
        nbytes = rng.randrange(1, 64)
        led.wal_bytes(f"tenant{i % 20}/doc-{i}", nbytes)
        fed_wal += nbytes
        assert len(led._docs) <= 2 * led.max_docs  # hard bound, always
    snap = led.snapshot(top=40)
    assert snap["tracked_docs"] <= 2 * led.max_docs
    assert snap["folded_docs"] > 9_000
    # conservation at tail_sample=1: tracked + tail == everything fed
    t = led.totals()
    assert t["wal_bytes"] == pytest.approx(float(fed_wal))
    assert t["device_s"] == pytest.approx(0.8)
    # the heaviest doc (by device+host burn) survived every compaction
    assert any(d["guid"] == heavy for d in snap["top"])
    # tenant label cardinality stays bounded: 8 exact + __other__
    assert len(snap["tenants"]) <= led.max_tenants + 1


def test_folded_doc_contributions_keep_flowing_into_tail():
    led = _ledger(max_docs=4, tail_sample=1)
    for i in range(20):  # force compactions; 8-doc hard cap
        led.wal_bytes(f"t/d{i:02d}", 10)
    folded = [g for g in (f"t/d{i:02d}" for i in range(20))
              if g not in led._docs]
    assert folded
    before = led.totals()["wal_bytes"]
    led.wal_bytes(folded[0], 7)  # a folded doc writes again
    assert led.totals()["wal_bytes"] == pytest.approx(before + 7)
    assert folded[0] not in led._docs  # stays in the sampled tail


def test_sampled_tail_counts_one_in_n_scaled():
    led = _ledger(max_docs=4, tail_sample=4)
    for i in range(20):
        led.wal_bytes(f"t/d{i:02d}", 10)
    folded = next(g for g in (f"t/d{i:02d}" for i in range(20))
                  if g not in led._docs)
    before = led.totals()["wal_bytes"]
    for _ in range(8):  # 8 events at 1-in-4: 2 samples x 10 x 4 = 80
        led.wal_bytes(folded, 10)
    assert led.totals()["wal_bytes"] == pytest.approx(before + 80)


def test_tenant_fold_to_other_at_cap():
    led = _ledger(max_docs=64, max_tenants=4)
    for i in range(10):
        led.wal_bytes(f"tenant{i}/doc", 100)
    snap = led.snapshot()
    assert len(snap["tenants"]) == 5
    assert "__other__" in snap["tenants"]
    assert snap["tenants"]["__other__"]["wal_bytes"] == 600.0
    # per-tenant rows + overflow row still conserve the fed total
    assert sum(t["wal_bytes"] for t in snap["tenants"].values()) \
        == 1000.0


def test_disabled_ledger_is_inert(monkeypatch):
    monkeypatch.setenv("YTPU_COST_DISABLED", "1")
    assert not cost_enabled()
    led = _ledger()
    led.staged("t/d", 100)
    led.wal_bytes("t/d", 100)
    led.session_frame("t/d")
    led.geo_bytes("euw", 100)
    led.on_flush(dict(FLUSH))
    snap = led.snapshot()
    assert snap["disabled"] is True
    assert snap["top"] == [] and snap["tenants"] == {}
    assert all(v == 0.0 for v in led.totals().values())


# -- geo-link shipped/deferred accounting seam --------------------------------


def test_geo_link_shipment_accounting_marks_late_bytes():
    from yjs_tpu_torch.geo.replicator import GeoLink

    led = _ledger()

    class _FakeLink:
        region = "euw"
        shipped_bytes = 0
        deferred_bytes = 0
        _deferred = {"t/doc-late"}

        def _ledger(self):
            return led

    link = _FakeLink()
    payload = b"x" * 120
    parts = [("t/doc-now", b"a" * 40), ("t/doc-late", b"b" * 60)]
    GeoLink._account_shipment(link, payload, parts)
    assert link.shipped_bytes == 120
    assert link.deferred_bytes == 60   # only the budget-held doc
    assert link._deferred == set()     # cleared once shipped
    # second shipment with no deferred docs adds only shipped bytes
    GeoLink._account_shipment(link, b"y" * 10, [("t/doc-now", b"c")])
    assert link.shipped_bytes == 130
    assert link.deferred_bytes == 60


def test_geo_link_accounting_survives_missing_ledger():
    from yjs_tpu_torch.geo.replicator import GeoLink

    class _FakeLink:
        region = "use"
        shipped_bytes = 0
        deferred_bytes = 0
        _deferred: set = set()

        def _ledger(self):
            return None  # supervisor facade: no per-shard ledger

    link = _FakeLink()
    GeoLink._account_shipment(link, b"z" * 30, [("t/d", b"z" * 30)])
    assert link.shipped_bytes == 30  # per-link counters still advance


# -- provider wiring ----------------------------------------------------------


def _edit(prov: TpuProvider, room: str, text: str) -> None:
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, text)
    prov.receive_update(room, encode_state_as_update(d))


def test_provider_attributes_flush_costs_per_tenant(tmp_path):
    from yjs_tpu_torch.persistence import WalConfig

    prov = TpuProvider(8, wal_dir=tmp_path,
                       wal_config=WalConfig(fsync="never"))
    try:
        _edit(prov, "acme/room-0", "hello cost ledger")
        _edit(prov, "beta/room-1", "hi")
        prov.flush()
        snap = prov.metrics_snapshot()["cost"]
        assert snap["tracked_docs"] == 2
        tenants = snap["tenants"]
        assert set(tenants) == {"acme", "beta"}
        assert tenants["acme"]["wal_bytes"] > 0
        # the flush's device+host seconds were split across both docs
        t = prov.cost.totals()
        assert t["device_s"] > 0.0 or t["host_s"] > 0.0
        assert tenants["acme"]["device_s"] + tenants["beta"]["device_s"] \
            == pytest.approx(t["device_s"])
    finally:
        prov.close()


def test_byte_identical_engine_output_telemetry_on_vs_off(monkeypatch,
                                                          rng):
    """Acceptance bar: YTPU_TSDB_DISABLED=1 + YTPU_COST_DISABLED=1 vs
    enabled produce byte-identical engine output for the same trace —
    the telemetry plane observes, never steers."""
    # one fixed trace (pinned client ids) fed to BOTH runs
    trace = []
    for j in range(6):
        d = Y.Doc(gc=False)
        d.client_id = 1000 + j
        d.get_text("text").insert(
            0, "".join(rng.choice("abcdef ") for _ in range(12))
        )
        trace.append(
            (f"t{j % 2}/room-{j % 3}", encode_state_as_update(d))
        )

    def run(disabled: bool) -> dict:
        if disabled:
            monkeypatch.setenv("YTPU_TSDB_DISABLED", "1")
            monkeypatch.setenv("YTPU_COST_DISABLED", "1")
        else:
            monkeypatch.delenv("YTPU_TSDB_DISABLED", raising=False)
            monkeypatch.delenv("YTPU_COST_DISABLED", raising=False)
        prov = TpuProvider(8)
        try:
            for j, (guid, update) in enumerate(trace):
                prov.receive_update(guid, update)
                if j % 2:
                    prov.flush()
            prov.flush()
            return {
                g: prov.encode_state_as_update(g)
                for g, _ in trace
            }
        finally:
            prov.close()

    on = run(disabled=False)
    off = run(disabled=True)
    assert on == off
    assert any(len(v) > 0 for v in on.values())


# -- capacity model -----------------------------------------------------------


def test_read_knee_from_recorded_ramp_history():
    st = _store()
    t = 1000.0
    for n, ok in ((8, 1.0), (16, 1.0), (32, 0.0)):
        st.record("ytpu_capacity_sessions", float(n), now=t)
        st.record("ytpu_capacity_ok", ok, now=t)
        st.record("ytpu_capacity_p99_ticks", 2.0, now=t)
        t += 1.0
    assert read_knee(st, 999.0, t) == 16
    # a window that misses the ramp reads zero, never a stale figure
    assert read_knee(st, 0.0, 500.0) == 0


def test_sessions_per_device_divides_by_visible_devices():
    import torch

    # the port divides by the visible CUDA devices (1 when there is none)
    n_dev = max(1, torch.cuda.device_count())
    out = sessions_per_device({"sessions_at_slo": 4 * n_dev,
                               "ceiling_hit": True})
    assert out["n_devices"] == n_dev
    assert out["sessions_per_device"] == pytest.approx(4.0)
    assert out["ceiling_hit"] is True
    assert sessions_per_device({})["sessions_per_device"] == 0.0


def test_capacity_config_stage_plan_is_geometric():
    c = CapacityConfig(start_sessions=8, max_sessions=100, growth=2.0)
    assert c.stages() == [8, 16, 32, 64, 100]
    assert CapacityConfig(start_sessions=5, max_sessions=5).stages() \
        == [5]
    assert c.p99_limit_ticks == 4 * c.flush_every


