"""Failure detection and automatic failover for the shard fleet.

PRs 3/5/6 made shard crashes *recoverable* — WAL replay, session resume,
single-owner migration — but every path still needed an operator to run
``FleetRouter.recover()`` while the dead shard's docs sat offline.  This
module is the *survivability* half of replication: a tick-deterministic
heartbeat failure detector (suspect → confirmed-dead with jittered,
per-shard thresholds and an injectable clock, the same determinism
discipline as ``SyncSession.tick`` and the resilience health tracker)
and a failover coordinator that promotes the freshest replica under a
monotonic fencing epoch.

Fencing rules (the split-brain contract):

- the :class:`~yjs_tpu_torch.fleet.hashring.RoutingTable` epoch is the fencing
  token — every failover bumps it exactly once, and the promoted shard
  journals a ``KIND_REPL`` primary marker carrying that epoch;
- a revived stale primary is *fenced out*: the routing table no longer
  points at it, the fleet's update bridge suppresses emissions from
  non-owners, and ``FleetRouter.revive_shard`` merge-releases any doc
  the corpse still holds into the current owner (CRDT-idempotent, so a
  late tail the dead shard accepted before the kill is recovered, never
  double-applied);
- post-crash, recovery compares journaled primary-marker epochs — the
  highest epoch wins ownership and lower claims are merged + released
  (``recovery-fenced``), so re-crashing after a failover still converges
  to exactly one owner.

Knobs: ``YTPU_FAILOVER_SUSPECT_TICKS``, ``YTPU_FAILOVER_CONFIRM_TICKS``,
``YTPU_FAILOVER_JITTER_TICKS``, ``YTPU_FAILOVER_SEED``.  Metrics: the
``ytpu_failover_*`` families (README "Replication & failover").
"""

from __future__ import annotations

import random
import time

from ..obs import global_registry
from ..obs import dist as obs_dist
from ..obs.blackbox import flight_recorder
from .hashring import _env_int

__all__ = [
    "DeadShard",
    "FailoverConfig",
    "FailoverCoordinator",
    "FailoverMetrics",
    "FailureDetector",
    "ShardDownError",
]

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

_STATE_CODE = {ALIVE: 0, SUSPECT: 1, DEAD: 2}


class ShardDownError(RuntimeError):
    """Raised by any call into a shard whose machine is gone (the
    chaos harness installs a :class:`DeadShard` stub).  The router
    treats it as a failure-detector signal and reroutes to replicas."""


class DeadShard:
    """Stub installed by ``FleetRouter.kill_shard``: the machine is
    gone, so EVERY attribute access raises :class:`ShardDownError` —
    exactly the behavior a network peer would observe.  Only the shard
    id survives (it names the corpse in error messages)."""

    def __init__(self, shard_id: int):
        object.__setattr__(self, "shard_id", shard_id)

    def __getattr__(self, name: str):
        raise ShardDownError(
            f"shard {object.__getattribute__(self, 'shard_id')} is down"
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DeadShard({object.__getattribute__(self, 'shard_id')})"


class FailoverConfig:
    """Resolved failure-detector knobs (constructor args beat
    ``YTPU_FAILOVER_*`` env beats defaults)."""

    __slots__ = ("suspect_ticks", "confirm_ticks", "jitter_ticks", "seed")

    def __init__(
        self,
        suspect_ticks: int | None = None,
        confirm_ticks: int | None = None,
        jitter_ticks: int | None = None,
        seed: int | None = None,
    ):
        def pick(v, env, default):
            return v if v is not None else _env_int(env, default)

        # consecutive missed heartbeats before a shard turns suspect
        self.suspect_ticks = max(
            1, pick(suspect_ticks, "YTPU_FAILOVER_SUSPECT_TICKS", 3)
        )
        # additional misses before suspect is confirmed dead
        self.confirm_ticks = max(
            1, pick(confirm_ticks, "YTPU_FAILOVER_CONFIRM_TICKS", 2)
        )
        # per-shard deterministic jitter added to both thresholds so a
        # correlated blip doesn't stampede every shard into failover on
        # the same tick (seeded, so chaos tests replay exactly)
        self.jitter_ticks = max(
            0, pick(jitter_ticks, "YTPU_FAILOVER_JITTER_TICKS", 1)
        )
        self.seed = pick(seed, "YTPU_FAILOVER_SEED", 0)


class FailoverMetrics:
    """The ``ytpu_failover_*`` instrument bundle (process-global
    registry by default, same dedup contract as FleetMetrics)."""

    def __init__(self, registry=None):
        r = registry if registry is not None else global_registry()
        self.registry = r
        self.heartbeats = r.counter(
            "ytpu_failover_heartbeats_total",
            "Failure-detector heartbeat probes, by outcome (ok / miss)",
            labelnames=("outcome",),
        )
        self.shard_state = r.gauge(
            "ytpu_failover_shard_state",
            "Failure-detector verdict per shard "
            "(0 = alive, 1 = suspect, 2 = dead)",
            labelnames=("shard",),
        )
        self.suspects = r.counter(
            "ytpu_failover_suspects_total",
            "alive->suspect transitions declared by the failure detector",
        )
        self.deaths = r.counter(
            "ytpu_failover_deaths_total",
            "suspect->dead confirmations (each triggers one failover)",
        )
        self.promotions = r.counter(
            "ytpu_failover_promotions_total",
            "Per-doc failover resolutions, by outcome (promoted = a "
            "replica took ownership; lost = no replica held the doc)",
            labelnames=("outcome",),
        )
        self.fenced = r.counter(
            "ytpu_failover_fenced_total",
            "Docs a revived stale primary still held that were fenced "
            "out (merge-released into the current owner)",
        )
        self.seconds = r.histogram(
            "ytpu_failover_seconds",
            "Wall time of one shard failover (promotion + catch-up + "
            "session rehome)",
            unit="s",
        )
        self.unavailable_ticks = r.histogram(
            "ytpu_failover_unavailable_ticks",
            "Detector ticks from a dead shard's first missed heartbeat "
            "to failover completion (the availability gap writes ride "
            "out on replicas)",
        )


class FailureDetector:
    """Tick-deterministic heartbeat failure detector.

    Time is the injectable tick counter — ``tick(probe)`` advances it —
    so every suspect/confirm timeline is replayable.  Per shard, the
    suspect and confirm thresholds carry a deterministic jitter drawn
    from ``seed`` (distinct shards never share an exact timeout).
    Demand-driven evidence (``report_down`` from a failed request) and
    probe evidence share one miss counter, capped at one miss per tick
    so a request storm cannot fast-forward the clock.
    """

    def __init__(self, shards=(), config: FailoverConfig | None = None,
                 metrics: FailoverMetrics | None = None):
        self.config = config if config is not None else FailoverConfig()
        self.metrics = metrics
        self.now = 0
        self._state: dict[int, str] = {}
        self._misses: dict[int, int] = {}
        self._first_miss: dict[int, int] = {}
        self._miss_tick: dict[int, int] = {}
        self._thresholds: dict[int, tuple[int, int]] = {}
        for k in shards:
            self.add(int(k))

    def add(self, shard: int) -> None:
        if shard in self._state:
            return
        cfg = self.config
        rng = random.Random(f"failover:{cfg.seed}:{shard}")
        j1 = rng.randrange(cfg.jitter_ticks + 1)
        j2 = rng.randrange(cfg.jitter_ticks + 1)
        suspect_at = cfg.suspect_ticks + j1
        dead_at = suspect_at + cfg.confirm_ticks + j2
        self._thresholds[shard] = (suspect_at, dead_at)
        self._state[shard] = ALIVE
        self._misses[shard] = 0
        self._set_gauge(shard)

    def remove(self, shard: int) -> None:
        for d in (self._state, self._misses, self._first_miss,
                  self._miss_tick, self._thresholds):
            d.pop(shard, None)

    def state_of(self, shard: int) -> str:
        return self._state.get(shard, ALIVE)

    def healthy(self, shard: int) -> bool:
        return self._state.get(shard, ALIVE) == ALIVE

    def suspects(self) -> list[int]:
        return sorted(k for k, s in self._state.items() if s == SUSPECT)

    def dead(self) -> list[int]:
        return sorted(k for k, s in self._state.items() if s == DEAD)

    def first_miss_tick(self, shard: int) -> int | None:
        return self._first_miss.get(shard)

    def _set_gauge(self, shard: int) -> None:
        if self.metrics is not None:
            self.metrics.shard_state.labels(shard=str(shard)).set(
                _STATE_CODE[self._state.get(shard, ALIVE)]
            )

    def _miss(self, shard: int) -> str | None:
        """Record one miss (at most one per tick); returns the new
        state when the miss caused a transition."""
        if self._state.get(shard, ALIVE) == DEAD:
            return None
        if self._miss_tick.get(shard) == self.now:
            return None
        self._miss_tick[shard] = self.now
        self._misses[shard] = self._misses.get(shard, 0) + 1
        self._first_miss.setdefault(shard, self.now)
        suspect_at, dead_at = self._thresholds.get(
            shard,
            (self.config.suspect_ticks,
             self.config.suspect_ticks + self.config.confirm_ticks),
        )
        state = self._state.get(shard, ALIVE)
        if state == ALIVE and self._misses[shard] >= suspect_at:
            self._state[shard] = SUSPECT
            if self.metrics is not None:
                self.metrics.suspects.inc()
            self._set_gauge(shard)
            return SUSPECT
        if state == SUSPECT and self._misses[shard] >= dead_at:
            self._state[shard] = DEAD
            if self.metrics is not None:
                self.metrics.deaths.inc()
            self._set_gauge(shard)
            return DEAD
        return None

    def report_down(self, shard: int) -> str | None:
        """Demand-driven evidence: a request into the shard raised
        :class:`ShardDownError`.  Counts as this tick's miss."""
        return self._miss(shard)

    def force_dead(self, shard: int) -> None:
        """Operator override: skip the suspect window (used by explicit
        ``FleetRouter.fail_over`` calls, never by the tick loop)."""
        if self._state.get(shard) == DEAD:
            return
        self._state[shard] = DEAD
        self._first_miss.setdefault(shard, self.now)
        if self.metrics is not None:
            self.metrics.deaths.inc()
        self._set_gauge(shard)

    def revive(self, shard: int) -> None:
        self._state[shard] = ALIVE
        self._misses[shard] = 0
        self._first_miss.pop(shard, None)
        self._miss_tick.pop(shard, None)
        self._set_gauge(shard)

    def tick(self, probe) -> list[tuple[int, str, str]]:
        """Advance the clock one tick and probe every non-dead shard.
        ``probe(shard)`` returns True when the shard answered.  Returns
        the transitions ``[(shard, old_state, new_state), ...]`` this
        tick caused, in shard order."""
        self.now += 1
        transitions: list[tuple[int, str, str]] = []
        for k in sorted(self._state):
            state = self._state[k]
            if state == DEAD:
                continue
            ok = False
            try:
                ok = bool(probe(k))
            except ShardDownError:
                ok = False
            if self.metrics is not None:
                self.metrics.heartbeats.labels(
                    outcome="ok" if ok else "miss"
                ).inc()
            if ok:
                self._misses[k] = 0
                self._first_miss.pop(k, None)
                if state == SUSPECT:
                    # a suspect that answers again was a blip, not a
                    # death: back to alive, counters reset
                    self._state[k] = ALIVE
                    self._set_gauge(k)
                    transitions.append((k, SUSPECT, ALIVE))
                continue
            new = self._miss(k)
            if new is not None:
                transitions.append((k, state, new))
        return transitions


class FailoverCoordinator:
    """Promotes replicas when the detector confirms a shard dead.

    Bound to one FleetRouter; the promotion path reuses the seams the
    fleet already has — ``RoutingTable`` epochs for fencing,
    ``SyncSession.rehome`` for live-session repair, and the replication
    manager's journaled copies for WAL-assisted catch-up."""

    def __init__(self, fleet, metrics: FailoverMetrics | None = None):
        self.fleet = fleet
        self.metrics = (
            metrics if metrics is not None
            else FailoverMetrics(fleet.metrics.registry)
        )

    def fail_over(self, shard: int, reason: str = "heartbeat") -> dict:
        """Resolve every doc the dead shard owned onto its freshest
        replica, fence the corpse out of routing, and re-home live
        sessions.  One epoch bump covers the whole failover (the
        fencing token); per-doc primary markers journal that epoch so
        post-crash recovery keeps the promotion."""
        fleet = self.fleet
        m = self.metrics
        t0 = time.perf_counter()
        det = fleet.detector
        det.force_dead(shard)

        # ONE forced-sampled episode trace ties the conviction, every
        # promotion, and every session rehome together in the black-box
        # dump (and in any Perfetto trace a promoted shard exports).
        # Minted from the fencing state, so a replayed chaos run with
        # the same seed produces the same trace id.
        ctx = obs_dist.mint_for_update(
            f"failover:{shard}:{fleet.table.epoch}:{det.now}".encode(),
            salt=b"failover",
        ).force("failover")
        bb = flight_recorder()
        bb.record(
            "failover", "conviction", severity="error", shard=shard,
            trace=ctx.trace_hex, reason=reason, detector_tick=det.now,
        )

        # resolve migrations the corpse was part of FIRST: the window's
        # double delivery makes the counterpart shard the freshest copy
        # by construction
        mig_promotions: list[str] = []
        for guid, mig in sorted(list(fleet._migrating.items())):
            if mig["src"] == shard:
                del fleet._migrating[guid]
                if mig["dst"] not in fleet._down and not fleet._is_stub(
                    mig["dst"]
                ):
                    # the seeded destination takes over mid-window
                    fleet.table.assign(guid, mig["dst"])
                    mig_promotions.append(guid)
                else:
                    fleet.table.unassign(guid)
            elif mig["dst"] == shard:
                # destination died mid-window: abort to the source (its
                # journaled intent resolves the same way post-crash)
                del fleet._migrating[guid]

        promoted: list[tuple[str, int]] = []
        lost: list[str] = []
        for guid in fleet.table.docs_on(shard):
            new_owner = fleet.repl.promote(guid, exclude={shard})
            if new_owner is None:
                # no replica ever saw the doc (factor 0, or it died
                # before any fan-out): the doc is offline until the
                # corpse's WAL is recovered or the shard revives
                fleet.table.unassign(guid)
                lost.append(guid)
                m.promotions.labels(outcome="lost").inc()
                bb.record(
                    "failover", "doc_lost", severity="warning",
                    guid=guid, shard=shard, trace=ctx.trace_hex,
                )
                continue
            fleet.table.assign(guid, new_owner)
            promoted.append((guid, new_owner))
            m.promotions.labels(outcome="promoted").inc()
            bb.record(
                "failover", "promotion", guid=guid, shard=new_owner,
                trace=ctx.trace_hex, src=shard,
            )

        # fence the corpse out of placement and replication
        fleet.ring.remove(shard)
        fleet._down.add(shard)
        fleet.repl.drop_shard(shard)

        # ONE monotonic fencing-epoch bump for the whole failover
        epoch = fleet.table.bump()
        fleet.metrics.epoch.set(epoch)
        for guid in mig_promotions:
            owner = fleet.table.lookup(guid)
            promoted.append((guid, owner))
            m.promotions.labels(outcome="promoted").inc()
            bb.record(
                "failover", "promotion", guid=guid, shard=owner,
                trace=ctx.trace_hex, src=shard, via="migration",
            )
        for guid, owner in promoted:
            fleet.shards[owner].journal_repl_role(guid, "primary", epoch)
            fleet.repl.rejournal_acks(guid, owner)
            fleet.shards[owner].engine.obs.tracer.instant(
                "ytpu.failover.promote", guid=guid, shard=owner,
                trace=ctx.trace_hex, epoch=epoch,
            )
        # live sessions resume against the new primary: rehome forces
        # an immediate anti-entropy digest; seq spaces survive, so the
        # repair is a targeted diff, never a full resync.  The episode
        # context stays installed so frames and replication records
        # emitted by the repair carry the failover's trace id.
        affected = {g for g, _o in promoted} | set(lost)
        with obs_dist.use_context(ctx):
            for (g, peer), sess in sorted(fleet._sessions.items()):
                if g in affected:
                    sess.rehome(epoch)
                    bb.record(
                        "failover", "rehome", guid=g, shard=shard,
                        trace=ctx.trace_hex, peer=peer, epoch=epoch,
                    )
            fleet.repl.repair_all()

        first_miss = det.first_miss_tick(shard)
        gap = det.now - first_miss if first_miss is not None else 0
        m.unavailable_ticks.observe(gap)
        m.seconds.observe(time.perf_counter() - t0)
        fleet._refresh_gauges()
        bb.record(
            "failover", "complete", shard=shard, trace=ctx.trace_hex,
            epoch=epoch, promoted=len(promoted), lost=len(lost),
            unavailable_ticks=gap,
        )
        bb.dump(
            "failover", shard=shard, cause=reason, epoch=epoch,
            trace=ctx.trace_hex,
        )
        return {
            "shard": shard,
            "reason": reason,
            "epoch": epoch,
            "promoted": sorted(g for g, _o in promoted),
            "lost": sorted(lost),
            "unavailable_ticks": gap,
        }
