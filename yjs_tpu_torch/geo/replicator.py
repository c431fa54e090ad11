"""Geo-distributed active-active replication.

N independent regions — each a full single-site deployment (provider,
fleet, or process cluster) — join into one document space over
inter-region links that ride the existing type-121 session machinery:

- :class:`GeoSession` subclasses :class:`~yjs_tpu_torch.sync.session.
  SyncSession`, inheriting seq/ack, retransmit backoff, resume-vs-full-
  resync handshakes, BUSY backpressure, and the anti-entropy loop
  unchanged; only the digest comparison is overridden (composite space
  state vectors are not one doc's vector) plus a convergence-latency
  stamp on the outbox.
- :class:`GeoLink` owns one remote region: a budgeted delta scheduler
  (the generalization of the lagging-peer single-pending-delta path —
  per-link byte budget from ``YTPU_GEO_LINK_BUDGET_BPS``, oldest-doc-
  first under pressure), exponential-backoff reconnect with seeded
  jitter, and the journaled ack floor (``KIND_GEO``) that lets a
  kill -9'd region RESUME its links instead of full-resyncing.
- :class:`GeoReplicator` is the per-region driver: peers with every
  other region per doc-space, bridges the facade's update stream into
  per-link dirty sets, runs the alive→suspect→dead
  :class:`~yjs_tpu_torch.fleet.failover.FailureDetector` over link health,
  and extends the routing-epoch event stream with region-level fencing
  epochs (a recovering region bumps its epoch; every link re-digests).

Knobs (``YTPU_GEO_*``): ``YTPU_GEO_REGION``,
``YTPU_GEO_LINK_BUDGET_BPS`` (0 = unlimited),
``YTPU_GEO_TICK_MS``, ``YTPU_GEO_RECONNECT_BASE``,
``YTPU_GEO_RECONNECT_CAP``, ``YTPU_GEO_RECONNECT_JITTER``.
Metrics: the ``ytpu_geo_*`` families (README "Geo replication").
"""

from __future__ import annotations

import inspect
import os
import random

from ..fleet.failover import (
    ALIVE,
    DEAD,
    SUSPECT,
    FailoverConfig,
    FailureDetector,
)
from ..lib0 import decoding
from ..lib0.encoding import Encoder
from ..obs import dist as obs_dist
from ..obs import global_registry
from ..obs.blackbox import flight_recorder
from ..sync import protocol
from ..sync.session import (
    LIVE,
    RECONNECTING,
    SessionConfig,
    SyncSession,
    _EMPTY_UPDATE_LEN,
)
from ..updates import decode_state_vector
from .space import (
    SpaceSessionHost,
    decode_space_update,
    encode_space_update,
    encode_sv_dict,
)

__all__ = [
    "GeoConfig",
    "GeoLink",
    "GeoMetrics",
    "GeoReplicator",
    "GeoSession",
]


def _env_int(name: str, default: int, lo: int = 0) -> int:
    try:
        return max(lo, int(os.environ.get(name, default)))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return max(0.0, float(os.environ.get(name, default)))
    except (TypeError, ValueError):
        return default


class GeoConfig:
    """Resolved geo knobs (constructor args beat ``YTPU_GEO_*`` env
    beats defaults).  Ticks are replicator ticks; ``tick_ms`` converts
    them to wall time for the byte budget and the lag gauges."""

    __slots__ = ("region", "seed", "link_budget_bps", "tick_ms",
                 "reconnect_base", "reconnect_cap", "reconnect_jitter")

    def __init__(
        self,
        region: str | None = None,
        seed: int | None = None,
        link_budget_bps: int | None = None,
        tick_ms: int | None = None,
        reconnect_base: int | None = None,
        reconnect_cap: int | None = None,
        reconnect_jitter: float | None = None,
    ):
        self.region = (
            region if region is not None
            else os.environ.get("YTPU_GEO_REGION", "local")
        )
        self.seed = (
            seed if seed is not None else _env_int("YTPU_GEO_SEED", 0)
        )
        # bytes/second each link may ship; 0 = unlimited.  The per-tick
        # allowance is bps * tick_ms / 1000, accumulated while idle (up
        # to 4 ticks' worth) so a quiet link can burst one batch.
        self.link_budget_bps = (
            link_budget_bps if link_budget_bps is not None
            else _env_int("YTPU_GEO_LINK_BUDGET_BPS", 0)
        )
        self.tick_ms = max(
            1,
            tick_ms if tick_ms is not None
            else _env_int("YTPU_GEO_TICK_MS", 10, lo=1),
        )
        self.reconnect_base = max(
            1,
            reconnect_base if reconnect_base is not None
            else _env_int("YTPU_GEO_RECONNECT_BASE", 2, lo=1),
        )
        self.reconnect_cap = max(
            self.reconnect_base,
            reconnect_cap if reconnect_cap is not None
            else _env_int("YTPU_GEO_RECONNECT_CAP", 64, lo=1),
        )
        self.reconnect_jitter = (
            reconnect_jitter if reconnect_jitter is not None
            else _env_float("YTPU_GEO_RECONNECT_JITTER", 0.25)
        )

    def budget_per_tick(self) -> int:
        """Byte allowance one link accrues per tick (0 = unlimited)."""
        if not self.link_budget_bps:
            return 0
        return max(1, self.link_budget_bps * self.tick_ms // 1000)


class GeoMetrics:
    """The ``ytpu_geo_*`` instrument bundle (process-global registry by
    default, same dedup contract as the other metric bundles)."""

    def __init__(self, registry=None):
        r = registry if registry is not None else global_registry()
        self.registry = r
        self.links = r.gauge(
            "ytpu_geo_links",
            "Inter-region links by health state "
            "(alive / suspect / dead)",
            labelnames=("state",),
        )
        self.lag_bytes = r.gauge(
            "ytpu_geo_link_lag_bytes",
            "Unacked + unscheduled bytes queued toward one remote "
            "region (outbox inner frames plus pending dirty-doc diffs "
            "are not counted until scheduled)",
            labelnames=("link",),
        )
        self.lag_seconds = r.gauge(
            "ytpu_geo_link_lag_seconds",
            "Age of the oldest unshipped dirty doc or unacked frame on "
            "one link, in tick_ms-derived seconds",
            labelnames=("link",),
        )
        self.reconnects = r.counter(
            "ytpu_geo_reconnects_total",
            "Link transport reattachments after loss, per link",
            labelnames=("link",),
        )
        self.coalesced = r.counter(
            "ytpu_geo_coalesced_updates_total",
            "Local updates absorbed into an already-dirty doc's pending "
            "delta instead of shipping their own frame (the coalesce "
            "ratio's numerator; delta frames are the denominator)",
        )
        self.delta_frames = r.counter(
            "ytpu_geo_delta_frames_total",
            "Composite delta batches shipped across all links",
        )
        self.delta_bytes = r.counter(
            "ytpu_geo_delta_bytes_total",
            "Composite delta payload bytes shipped across all links",
        )
        self.deferrals = r.counter(
            "ytpu_geo_budget_deferrals_total",
            "Dirty docs deferred to a later tick because the link's "
            "byte budget was exhausted (oldest-doc-first under "
            "pressure)",
        )
        self.convergence = r.histogram(
            "ytpu_geo_convergence_seconds",
            "Cross-region convergence lag: local enqueue of a delta "
            "frame to the remote ack confirming integrate, in "
            "tick_ms-derived seconds",
            unit="s",
        )
        self.epoch = r.gauge(
            "ytpu_geo_epoch",
            "This region's fencing epoch (bumps on crash recovery and "
            "on upstream routing-epoch changes)",
        )
        self.dead_letters = r.counter(
            "ytpu_geo_dead_letters_total",
            "Frames a WAN link gave up on (retry cap / unparseable); "
            "anti-entropy owns the repair",
        )


class GeoSession(SyncSession):
    """A :class:`SyncSession` whose host is a doc SPACE.

    Everything rides the parent unchanged except the two seams that
    parse host bytes as one doc's state vector: the anti-entropy digest
    comparison (composite vectors compare per doc via
    ``host.ahead_behind``) and a convergence-latency stamp on outbox
    entries so the ack that confirms remote integrate observes the
    cross-region lag histogram."""

    def __init__(self, host, config=None, metrics=None, peer="geo",
                 geo_metrics=None, tick_ms: int = 10):
        super().__init__(host, config=config, metrics=metrics, peer=peer)
        self._geo_metrics = geo_metrics
        self._tick_ms = max(1, int(tick_ms))

    # -- convergence stamps --------------------------------------------------

    def _queue_data(self, inner, trace=None):
        super()._queue_data(inner, trace)
        if self._outbox:
            self._outbox[-1]["geo_t"] = self._tick

    def _drop_acked(self, cum: int) -> None:
        gm = self._geo_metrics
        if gm is not None and self._outbox:
            for e in self._outbox:
                if e["seq"] <= cum and "geo_t" in e:
                    gm.convergence.observe(
                        (self._tick - e["geo_t"]) * self._tick_ms / 1000.0
                    )
        super()._drop_acked(cum)

    # -- composite digest ----------------------------------------------------

    def _on_digest(self, dec) -> None:
        peer_sv = decoding.read_var_uint8_array(dec)
        self._peer_sv = peer_sv
        pol = self.policy
        if pol is not None and getattr(pol, "antientropy_paused", False):
            return
        ahead, behind = self.host.ahead_behind(bytes(peer_sv))
        if ahead:
            diff = self.host.diff_update(bytes(peer_sv))
            if len(diff) > _EMPTY_UPDATE_LEN:
                self.n_repairs += 1
                self.metrics.repairs.inc()
                inner = Encoder()
                protocol.write_update(inner, diff)
                self._queue_data(inner.to_bytes())
        if behind and self._tick - self._last_digest >= 2:
            self._send_digest()


class GeoLink:
    """One remote region: a :class:`GeoSession` plus the budgeted delta
    scheduler, reconnect backoff, and the journaled ack floor."""

    def __init__(self, replicator: "GeoReplicator", region: str,
                 connect_fn, session_config: SessionConfig | None = None):
        self.replicator = replicator
        self.region = str(region)
        self.connect_fn = connect_fn
        cfg = replicator.config
        self.host = SpaceSessionHost(replicator.facade, link=self)
        self.session = GeoSession(
            self.host,
            config=session_config,
            peer=f"geo:{self.region}",
            geo_metrics=replicator.metrics,
            tick_ms=cfg.tick_ms,
        )
        # oldest-doc-first dirty queue: guid -> first-dirty tick
        # (python dicts preserve insertion order; re-dirtying an
        # already-queued doc keeps its ORIGINAL position and age)
        self._dirty: dict[str, int] = {}
        # per-doc local sv at last scheduled send: the diff target that
        # makes scheduled batches incremental between digests
        self._sent_sv: dict[str, dict[int, int]] = {}
        self._budget = 0
        # cost telemetry: docs the byte budget held back —
        # their bytes count as kind="deferred" when they finally ship
        self._deferred: set[str] = set()
        self.shipped_bytes = 0
        self.deferred_bytes = 0
        # reconnect backoff, seeded per link (the FailureDetector
        # keyed-stream pattern) so N links never stampede a reconnect
        self._rng = random.Random(
            f"geo:{cfg.seed}:{cfg.region}:{self.region}"
        )
        self._reconnect_attempts = 0
        self._next_reconnect = 0
        self.n_reconnects = 0
        self.n_dead_letters = 0
        # the journaled floor: peer session id + cumulative recv seq
        # at this region's fencing epoch
        self.floor = {"sid": 0, "seq": 0, "epoch": replicator.epoch}

    # -- callbacks from the host/session -------------------------------------

    def on_recv_floor(self, sid: int, seq: int) -> None:
        self.floor = {
            "sid": int(sid), "seq": int(seq),
            "epoch": self.replicator.epoch,
        }
        self.replicator._journal_floor(self.region, self.floor)

    def note_dead_letter(self, reason: str) -> None:
        self.n_dead_letters += 1
        self.replicator.metrics.dead_letters.inc()

    def note_remote_apply(self, guid: str, update: bytes) -> None:
        """A doc arrived FROM this link: close the cross-region flow
        arrow the origin region opened for these bytes."""
        tracer = self.replicator._tracer()
        if tracer is None:
            return
        ctx = obs_dist.mint_for_update(update, salt=b"geo")
        if ctx.sampled:
            tracer.flow_end(
                "ytpu.geo", obs_dist.flow_id_for((ctx.trace_hex, "wan")),
                guid=guid, link=self.region,
            )

    # -- local update intake --------------------------------------------------

    def mark_dirty(self, guid: str, tick: int) -> None:
        if guid in self._dirty:
            # absorbed into the doc's pending delta: the coalesce path
            self.replicator.metrics.coalesced.inc()
            return
        self._dirty[guid] = tick
        self.host.track(guid)

    # -- the clock ------------------------------------------------------------

    def tick(self, now: int) -> None:
        sess = self.session
        sess.tick()
        if sess.state == RECONNECTING:
            self._maybe_reconnect(now)
            return
        self._pump_dirty(now)

    def _maybe_reconnect(self, now: int) -> None:
        if now < self._next_reconnect:
            return
        cfg = self.replicator.config
        self._reconnect_attempts += 1
        base = min(
            cfg.reconnect_cap,
            cfg.reconnect_base * (1 << min(self._reconnect_attempts, 16)),
        )
        jitter = 1.0 + cfg.reconnect_jitter * self._rng.random()
        self._next_reconnect = now + max(1, int(base * jitter))
        transport = None
        try:
            transport = self.connect_fn()
        except Exception:
            transport = None
        if transport is None:
            return
        self.session.attach(transport)
        self._reconnect_attempts = 0
        self.n_reconnects += 1
        self.replicator.metrics.reconnects.labels(
            link=self.region
        ).inc()
        # the partition may have eaten our incremental bookkeeping:
        # fall back to handshake-sv diff targets on the next schedule
        self._sent_sv.clear()

    def _pump_dirty(self, now: int) -> None:
        """The budgeted delta scheduler: oldest-doc-first composite
        batches, capped by the per-tick byte allowance."""
        cfg = self.replicator.config
        per_tick = cfg.budget_per_tick()
        if per_tick:
            self._budget = min(self._budget + per_tick, 4 * per_tick)
        sess = self.session
        if not self._dirty or sess.state != LIVE:
            return
        if sess._pending_delta or self._tick_busy(sess):
            # the session-level coalesced delta (BUSY window, lagging
            # recovery) supersedes scheduling; docs stay dirty
            return
        metrics = self.replicator.metrics
        parts: list[tuple[str, bytes]] = []
        spent = 0
        for guid in list(self._dirty):
            if per_tick and parts and spent >= self._budget:
                # budget exhausted: everything younger waits its turn
                metrics.deferrals.inc()
                self._deferred.update(self._dirty)
                break
            try:
                sv = self._doc_sv(guid)
                target = self._sent_sv.get(guid)
                upd = self.host._doc_diff(
                    guid, encode_sv_dict(target) if target else None
                )
            except Exception:
                # the doc vanished mid-schedule (demotion race): the
                # anti-entropy digest re-discovers it if it returns
                self._dirty.pop(guid, None)
                continue
            self._dirty.pop(guid, None)
            if len(upd) <= _EMPTY_UPDATE_LEN:
                continue
            parts.append((guid, upd))
            spent += len(upd)
            if sv is not None:
                self._sent_sv[guid] = sv
        if not parts:
            return
        payload = encode_space_update(parts)
        if per_tick:
            self._budget = max(0, self._budget - len(payload))
        metrics.delta_frames.inc()
        metrics.delta_bytes.inc(len(payload))
        self._account_shipment(payload, parts)
        self._send_payload(payload)

    def _tick_busy(self, sess) -> bool:
        return sess._tick < sess._busy_until

    def _ledger(self):
        """The cost ledger behind the region facade, when one exists
        (a provider facade carries its own; a fleet facade is probed
        through its first shard — per-link totals, not per-shard)."""
        facade = self.replicator.facade
        cost = getattr(facade, "cost", None)
        if cost is not None:
            return cost
        shards = getattr(facade, "shards", None)
        if shards:
            try:
                return getattr(shards[0], "cost", None)
            except Exception:
                return None
        return None

    def _account_shipment(self, payload: bytes,
                          parts: list[tuple[str, bytes]]) -> None:
        """Per-link WAN byte telemetry: every
        payload counts as shipped; parts whose doc the budget deferred
        earlier additionally count as deferred, now that they left."""
        cost = self._ledger()
        self.shipped_bytes += len(payload)
        if cost is not None:
            cost.geo_bytes(self.region, len(payload), kind="shipped")
        late = 0
        for guid, upd in parts:
            if guid in self._deferred:
                self._deferred.discard(guid)
                late += len(upd)
        if late:
            self.deferred_bytes += late
            if cost is not None:
                cost.geo_bytes(self.region, late, kind="deferred")

    def _doc_sv(self, guid: str) -> dict[int, int] | None:
        try:
            return decode_state_vector(self.host._doc_sv_bytes(guid))
        except Exception:
            return None

    def _send_payload(self, payload: bytes) -> None:
        """Ship one composite payload and open the cross-region flow
        arrow (closed by the remote's ``note_remote_apply``)."""
        tracer = self.replicator._tracer()
        ctx = None
        # the arrow is minted per PART (per doc update) so one trace
        # spans origin region -> WAN hop -> remote integrate -> visible
        if tracer is not None:
            for guid, upd in decode_space_update(payload):
                c = obs_dist.mint_for_update(upd, salt=b"geo")
                if c.sampled:
                    tracer.flow_start(
                        "ytpu.geo",
                        obs_dist.flow_id_for((c.trace_hex, "wan")),
                        guid=guid, link=self.region,
                    )
                    if ctx is None:
                        ctx = c
        with obs_dist.use_context(ctx):
            self.session.send_update(payload)

    # -- introspection --------------------------------------------------------

    def lag_bytes(self) -> int:
        return sum(len(e["inner"]) for e in self.session._outbox)

    def lag_ticks(self, now: int) -> int:
        oldest = None
        if self._dirty:
            oldest = next(iter(self._dirty.values()))
        for e in self.session._outbox:
            t = e.get("geo_t")
            if t is not None and (oldest is None or t < oldest):
                oldest = t
        return 0 if oldest is None else max(0, now - oldest)

    def snapshot(self, now: int, det_state: str) -> dict:
        sess = self.session
        return {
            "link": self.region,
            "state": sess.state,
            "detector": det_state,
            "outbox": len(sess._outbox),
            "dirty_docs": len(self._dirty),
            "lag_bytes": self.lag_bytes(),
            "lag_seconds": round(
                self.lag_ticks(now)
                * self.replicator.config.tick_ms / 1000.0, 3,
            ),
            "reconnects": self.n_reconnects,
            "resumes": sess.n_resumes,
            "full_resyncs": sess.n_full_resyncs,
            "dead_letters": self.n_dead_letters,
            "shipped_bytes": self.shipped_bytes,
            "deferred_bytes": self.deferred_bytes,
            "floor": dict(self.floor),
        }


class GeoReplicator:
    """Per-region driver joining one region facade into the geo mesh.

    ``facade`` is anything with the region surface (see
    :class:`SpaceSessionHost`); ``connect_fn`` per peer returns a fresh
    :class:`~yjs_tpu_torch.sync.transport.Transport` toward that region, or
    ``None`` while the WAN is down (the reconnect backoff retries).
    """

    def __init__(self, facade, config: GeoConfig | None = None,
                 metrics: GeoMetrics | None = None,
                 detector_config: FailoverConfig | None = None):
        self.facade = facade
        self.config = config if config is not None else GeoConfig()
        self.metrics = metrics if metrics is not None else GeoMetrics()
        self.region = self.config.region
        self.links: dict[str, GeoLink] = {}
        self.now = 0
        # link-health: the shard failure detector, keyed by region name.  A link
        # "answers the probe" while its transport is attached; detached
        # (reconnecting) links miss until suspect -> dead, and a
        # successful reattach revives them.
        self.detector = FailureDetector(
            (),
            detector_config
            if detector_config is not None
            else FailoverConfig(seed=self.config.seed),
        )
        # region fencing epoch: resumes from the max journaled link
        # epoch + 1 after a crash (the restart is a new fencing era —
        # remote regions see the bump in statusz and the epoch gauge)
        self._recovered: dict[str, dict] = dict(
            getattr(facade, "_recovered_geo", None) or {}
        )
        self.epoch = (
            max(
                (int(f.get("epoch", 0)) for f in self._recovered.values()),
                default=-1,
            )
            + 1
        )
        self.metrics.epoch.set(self.epoch)
        # upstream routing epoch last folded into the fencing
        # epoch; None until the first tick observes a baseline so
        # startup never fires a spurious region-wide rehome
        self._upstream_seen: int | None = None
        self._bridge_installed = False
        # advertise on the facade so statusz/ytpu_top find the rows
        try:
            facade.geo = self
        except Exception:
            pass

    # -- wiring ----------------------------------------------------------------

    def _tracer(self):
        eng = getattr(self.facade, "engine", None)
        obs = getattr(eng, "obs", None)
        return getattr(obs, "tracer", None)

    def _install_bridge(self) -> None:
        if self._bridge_installed:
            return
        self._bridge_installed = True
        reg = getattr(self.facade, "on_update", None)
        if inspect.ismethod(reg):
            reg(self._on_local_update)
            return
        # attribute-style seam (the cluster supervisor): chain any
        # previously-installed gateway callback
        prev = reg if callable(reg) else None

        def chained(guid, update, _prev=prev):
            if _prev is not None:
                _prev(guid, update)
            self._on_local_update(guid, update)

        try:
            self.facade.on_update = chained
        except Exception:
            pass

    def add_peer(self, region: str, connect_fn,
                 session_config: SessionConfig | None = None) -> GeoLink:
        """Join one remote region: builds the link + session, arms the
        journaled resume floor, and connects if the WAN is up."""
        region = str(region)
        if region in self.links:
            return self.links[region]
        self._install_bridge()
        link = GeoLink(self, region, connect_fn,
                       session_config=session_config)
        hint = self._recovered.get(region)
        if hint is not None:
            link.session.set_resume_hint(hint["sid"], hint["seq"])
            link.floor = {
                "sid": hint["sid"], "seq": hint["seq"],
                "epoch": self.epoch,
            }
        self.links[region] = link
        self.detector.add(region)
        transport = None
        try:
            transport = connect_fn()
        except Exception:
            transport = None
        if transport is not None:
            link.session.connect(transport)
        return link

    def remove_peer(self, region: str) -> None:
        link = self.links.pop(str(region), None)
        if link is not None:
            link.session.close()
        self.detector.remove(str(region))

    # -- local update intake ----------------------------------------------------

    def _on_local_update(self, guid: str, update: bytes) -> None:
        """The facade's flush-emitted update stream: every doc that
        changed (locally-authored or transit traffic from another
        region — the CRDT merge dedups the echo) dirties every link."""
        for link in self.links.values():
            link.mark_dirty(guid, self.now)

    # -- fencing epochs ----------------------------------------------------------

    def notify_epoch(self, epoch: int) -> None:
        """The routing-epoch event stream reaches the WAN: an upstream
        routing-epoch bump (failover, shard restart) advances this
        region's FENCING epoch — a separate monotonic counter, since
        routing epochs are local to each region — and makes every live
        link offer a digest immediately, so cross-region divergence
        from the local handoff window heals now instead of an
        anti-entropy interval later.  Facades with an ``epoch`` surface
        (cluster supervisor, fleet routing table) are also polled each
        :meth:`tick`; this push entry point exists for event-driven
        callers (``Supervisor.on_epoch``)."""
        epoch = int(epoch)
        if self._upstream_seen is not None and epoch <= self._upstream_seen:
            return
        self._upstream_seen = epoch
        self._advance_epoch()

    def _advance_epoch(self) -> None:
        self.epoch += 1
        self.metrics.epoch.set(self.epoch)
        flight_recorder().record(
            "geo", "epoch_advanced", region=self.region, epoch=self.epoch,
        )
        for link in self.links.values():
            link.floor["epoch"] = self.epoch
            link.session.rehome(self.epoch)
            self._journal_floor(link.region, link.floor)

    def _upstream_epoch(self) -> int | None:
        ep = getattr(self.facade, "epoch", None)  # cluster supervisor
        if isinstance(ep, int):
            return ep
        table = getattr(self.facade, "table", None)  # fleet router
        ep = getattr(table, "epoch", None)
        return ep if isinstance(ep, int) else None

    # -- durability ---------------------------------------------------------------

    def _journal_floor(self, region: str, floor: dict) -> None:
        fn = getattr(self.facade, "journal_geo_link", None)
        if fn is not None:
            fn(region, floor["sid"], floor["seq"], floor["epoch"])

    def link_floors(self) -> dict[str, dict]:
        """Live floors for checkpoint re-journaling (see
        ``TpuProvider._journal_geo_floors``)."""
        return {
            r: dict(link.floor)
            for r, link in self.links.items()
            if link.floor.get("sid")
        }

    # -- the clock ----------------------------------------------------------------

    def tick(self) -> None:
        """One unit of geo time: session clocks, reconnect backoff, the
        delta scheduler, link-health probes, and gauge refresh."""
        self.now += 1
        # fold upstream routing-epoch movement into the fencing epoch
        # (event-driven facades also push through notify_epoch; the
        # seen-tracking dedups the two paths)
        up = self._upstream_epoch()
        if up is not None:
            if self._upstream_seen is None:
                self._upstream_seen = up  # baseline, no rehome
            elif up > self._upstream_seen:
                self._upstream_seen = up
                self._advance_epoch()
        for region in sorted(self.links):
            self.links[region].tick(self.now)
        # DEAD links are skipped by the probe round (the detector stops
        # probing the confirmed-dead), so a reattached link must be
        # revived explicitly before the round or it stays dead forever
        for region, link in self.links.items():
            if (
                self._link_attached(link)
                and self.detector.state_of(region) != ALIVE
            ):
                self.detector.revive(region)

        def probe(region):
            link = self.links.get(region)
            return link is not None and self._link_attached(link)

        self.detector.tick(probe)
        self._refresh_gauges()

    @staticmethod
    def _link_attached(link: GeoLink) -> bool:
        sess = link.session
        return (
            sess.transport is not None
            and sess.state != RECONNECTING
            and not sess._closed
        )

    def _refresh_gauges(self) -> None:
        m = self.metrics
        counts = {ALIVE: 0, SUSPECT: 0, DEAD: 0}
        for region, link in self.links.items():
            st = self.detector.state_of(region)
            counts[st] = counts.get(st, 0) + 1
            m.lag_bytes.labels(link=region).set(link.lag_bytes())
            m.lag_seconds.labels(link=region).set(
                link.lag_ticks(self.now) * self.config.tick_ms / 1000.0
            )
        for st, n in counts.items():
            m.links.labels(state=st).set(n)

    # -- introspection -------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/statusz`` "geo" row and the ytpu_top feed."""
        return {
            "region": self.region,
            "epoch": self.epoch,
            "tick": self.now,
            "links": [
                self.links[r].snapshot(
                    self.now, self.detector.state_of(r)
                )
                for r in sorted(self.links)
            ],
        }

    def close(self) -> None:
        for link in self.links.values():
            link.session.close()
