"""Churn rebalancer: migrate docs off shards approaching full.

The bounded-load ring keeps FIRST-TOUCH placement even, but live fleets
skew afterwards: docs are released, shards are added, one tenant's rooms
all go hot.  The rebalancer is the corrective loop — each
``FleetRouter.tick()`` it reads per-shard occupancy (the same gauge
``ytpu_prof_slot_occupancy``/``ytpu_fleet_shard_occupancy`` exposes) and
migrates docs from any shard above the high watermark down toward the
target, bounded per tick so rebalancing spreads its cost instead of
stampeding the fleet.

Policy, deterministic end to end (chaos tests replay it exactly):

- a shard triggers when ``occupancy >= YTPU_FLEET_REBALANCE_HIGH``
  (default 0.85 — close enough to ``ProviderFullError`` to matter, far
  enough to finish moving before admission fails);
- it sheds down to ``YTPU_FLEET_REBALANCE_TARGET`` (default 0.6),
  coldest docs first: sessionless rooms before sessioned ones
  (migrating a room nobody is attached to is free, migrating a live
  room costs a digest round), then ascending REAL heat score from the
  shard's :class:`~yjs_tpu_torch.tiering.HeatTracker` — the room least
  likely to be touched again moves first.  With tiering disabled every
  score is 0.0 and the order degrades to the old deterministic
  guid sort;
- at most ``YTPU_FLEET_REBALANCE_BATCH`` migrations per tick (default
  4) across the whole fleet;
- destinations are the least-loaded live shards with free slots; a
  fleet with nowhere to put a doc records a ``stuck`` decision (the
  operator's cue to ``add_shard``) rather than thrashing.
"""

from __future__ import annotations


class Rebalancer:
    """Occupancy-driven migration planner bound to one FleetRouter."""

    def __init__(self, fleet):
        self.fleet = fleet

    def _pick_destination(self, src: int) -> int | None:
        """Least-loaded live shard with a free slot (ties break to the
        lowest id — determinism beats spread at this scale)."""
        fleet = self.fleet
        best = None
        best_load = None
        for k in fleet.live_shards:
            if k == src:
                continue
            # never rebalance ONTO a shard the failure detector holds
            # suspect (or dead but unconvicted): a migration into a
            # dying shard is data movement toward the cliff edge
            if not fleet.shard_healthy(k):
                continue
            load = fleet._load(k)
            if load >= fleet._capacity(k):
                continue
            # a destination at/above the high watermark would trigger
            # itself next tick: moving load there is churn, not balance
            if fleet._capacity(k) and (
                (load + 1) / fleet._capacity(k)
                > fleet.config.rebalance_high
            ):
                continue
            if best_load is None or load < best_load:
                best, best_load = k, load
        return best

    def plan(self) -> list[dict]:
        """The moves one tick would make (dry run, same determinism)."""
        fleet = self.fleet
        cfg = fleet.config
        sessioned = {g for (g, _p) in fleet._sessions}
        moves: list[dict] = []
        budget = cfg.rebalance_batch
        for src in fleet.live_shards:
            if budget <= 0:
                break
            # a suspect/dead source has nothing safely readable to
            # migrate; failover, not rebalancing, resolves it
            if not fleet.shard_healthy(src):
                continue
            cap = fleet._capacity(src)
            if not cap or fleet._load(src) / cap < cfg.rebalance_high:
                continue
            target_docs = int(cfg.rebalance_target * cap)
            excess = fleet._load(src) - target_docs
            tm = fleet.shards[src].tiers
            candidates = sorted(
                fleet.shards[src].guids(),
                key=lambda g: (g in sessioned, tm.heat_of(g), g),
            )
            for guid in candidates[:max(0, excess)]:
                if budget <= 0:
                    break
                if guid in fleet._migrating:
                    continue
                dst = self._pick_destination(src)
                if dst is None:
                    moves.append(
                        {"action": "stuck", "guid": guid, "src": src}
                    )
                    budget -= 1
                    break
                moves.append(
                    {"action": "move", "guid": guid,
                     "src": src, "dst": dst}
                )
                budget -= 1
        return moves

    def tick(self) -> list[dict]:
        """Plan and execute one rebalance pass; returns the decisions
        (executed moves carry ``action="move"``)."""
        fleet = self.fleet
        decisions = self.plan()
        for d in decisions:
            fleet.metrics.rebalance.labels(action=d["action"]).inc()
            if d["action"] == "move":
                fleet.migrate_doc(d["guid"], d["dst"], reason="rebalance")
        return decisions
