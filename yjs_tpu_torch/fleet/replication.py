"""Shard replication: journaled doc copies that survive a primary's
death.

Every update the fleet accepts is fanned out to R replica shards
(``YTPU_REPL_FACTOR``, default 1) chosen by walking the consistent-hash
ring past the owner — the same successor order placement would pick, so
replica locations are deterministic and rebalance-stable.  Replication
is **journal-only**: a replica appends the fanned-out records
(``KIND_UPDATE`` / ``KIND_ACK`` / ``KIND_DLQ``, under a ``KIND_REPL``
role marker) to its OWN write-ahead log without admitting the doc into
an engine slot.  That keeps slot accounting, bounded-load placement,
and the rebalancer's occupancy math untouched by replication — a
replica costs disk, not device memory — and makes promotion exactly the
recovery path the WAL already guarantees: scan the replica's journal,
integrate the doc's records, flush.

Delivery is asynchronous through a bounded per-shard outbox drained on
every fleet tick.  Overflow never drops: the outbox applies
backpressure by draining inline (``ytpu_repl_backpressure_total``).
Zero-acknowledged-loss has one more hole to plug — a primary that dies
*before the first drain* — so the freshness oracle counts queued outbox
entries as recoverable state, and ``FleetRouter.receive_update``
falls back to :meth:`ReplicationManager.absorb` (synchronous journal on
a replica) when the primary's machine is already gone, refusing the
update entirely if no replica can journal it.  An acknowledged update
is therefore always on at least one surviving WAL.

Checkpoint interplay: WAL compaction folds only docs the shard OWNS, so
a replica's journaled copies would vanish with their segments.
``FleetRouter.checkpoint`` therefore calls
:meth:`rejournal_after_checkpoint`, which reseeds every replica pair
with the live owner's full state (one record, counted by
``ytpu_repl_reseeds_total``) — the same move migration's seed step
makes, and idempotent for the same CRDT reason.

Knobs: ``YTPU_REPL_FACTOR``, ``YTPU_REPL_OUTBOX_MAX``,
``YTPU_REPL_BATCH``.  Metrics: the ``ytpu_repl_*`` families.
"""

from __future__ import annotations

import base64
import json
from collections import deque

from ..obs import global_registry
from ..obs.blackbox import flight_recorder
from ..obs.dist import current_context, flow_id_for
from ..persistence import KIND_DLQ, KIND_UPDATE
from ..persistence.recovery import iter_file_events, scan_wal
from ..provider import ProviderFullError
from .failover import ShardDownError
from .hashring import _env_int

__all__ = ["ReplicationConfig", "ReplicationManager", "ReplicationMetrics"]

# cap on dead letters mirrored per doc (matches the engine's own DLQ
# bounding philosophy: newest evidence wins)
_LETTER_CAP = 32


class ReplicationConfig:
    """Resolved replication knobs (constructor args beat ``YTPU_REPL_*``
    env beats defaults)."""

    __slots__ = ("factor", "outbox_max", "batch")

    def __init__(
        self,
        factor: int | None = None,
        outbox_max: int | None = None,
        batch: int | None = None,
    ):
        def pick(v, env, default):
            return v if v is not None else _env_int(env, default)

        # replicas per doc; 0 disables fan-out (failover then only
        # recovers docs inside a migration window)
        self.factor = max(0, pick(factor, "YTPU_REPL_FACTOR", 1))
        # queued records per replica shard before backpressure drains
        # inline (never drops)
        self.outbox_max = max(1, pick(outbox_max, "YTPU_REPL_OUTBOX_MAX", 256))
        # records applied per replica per drain pass
        self.batch = max(1, pick(batch, "YTPU_REPL_BATCH", 64))


class ReplicationMetrics:
    """The ``ytpu_repl_*`` instrument bundle."""

    def __init__(self, registry=None):
        r = registry if registry is not None else global_registry()
        self.registry = r
        self.records = r.counter(
            "ytpu_repl_records_total",
            "Records journaled onto replica WALs, by kind (update / ack "
            "/ dlq / seed = full-state reseed after checkpoint or "
            "absorb)",
            labelnames=("kind",),
        )
        self.outbox_depth = r.gauge(
            "ytpu_repl_outbox_depth",
            "Replication records queued toward one replica shard",
            labelnames=("shard",),
        )
        self.lag = r.gauge(
            "ytpu_repl_lag",
            "Accepted-but-not-yet-journaled updates across all docs "
            "replicated to one shard (0 = replica WALs are current)",
            labelnames=("shard",),
        )
        self.replica_docs = r.gauge(
            "ytpu_repl_replica_docs",
            "Docs one shard holds journaled replica copies of",
            labelnames=("shard",),
        )
        self.backpressure = r.counter(
            "ytpu_repl_backpressure_total",
            "Outbox-overflow events resolved by draining inline "
            "(replication never drops on overflow)",
        )
        self.reseeds = r.counter(
            "ytpu_repl_reseeds_total",
            "Full-state replica reseeds (post-checkpoint re-journal, "
            "or first copy on a new replica)",
        )
        self.stalls = r.counter(
            "ytpu_repl_stalls_total",
            "Drain passes skipped or aborted per replica, by reason "
            "(suspect / down / error)",
            labelnames=("reason",),
        )


class ReplicationManager:
    """Fan-out, lag tracking, and WAL-assisted promotion for one fleet.

    All state is host-side bookkeeping over the shards' own WALs; the
    durable truth is always the journals themselves (recovery rebuilds
    roles from ``KIND_REPL`` markers with no help from this object)."""

    def __init__(self, fleet, config: ReplicationConfig | None = None,
                 metrics: ReplicationMetrics | None = None):
        self.fleet = fleet
        self.config = config if config is not None else ReplicationConfig()
        self.metrics = (
            metrics if metrics is not None
            else ReplicationMetrics(fleet.metrics.registry)
        )
        # per-doc primary-accepted sequence high watermark
        self._hwm: dict[str, int] = {}
        # (guid, shard) -> highest seq journaled on that replica
        self._applied: dict[tuple[str, int], int] = {}
        # (guid, shard) pairs whose replica role marker is journaled
        self._marked: set[tuple[str, int]] = set()
        # shard -> queued fan-out entries (kind, guid, data)
        self._outbox: dict[int, deque] = {}
        # in-memory mirror for WAL-less shards: (guid, shard) -> entries
        self._mem: dict[tuple[str, int], list] = {}
        # last heat observed on the owner (travels with promotion)
        self._heat: dict[str, float] = {}
        # mirrored dead letters per doc, newest-last, bounded
        self._letters: dict[str, list[dict]] = {}

    # -- placement -----------------------------------------------------------

    def replicas_of(self, guid: str, exclude=()) -> list[int]:
        """The R replica shards for a doc: ring successors past the
        owner, skipping unhealthy/retired shards.  Deterministic, so
        the freshness oracle and recovery agree on where copies live."""
        if self.config.factor <= 0:
            return []
        fleet = self.fleet
        owner = fleet.owner_of(guid)
        bad = set(exclude) | fleet._unhealthy()
        out: list[int] = []
        for k in fleet.ring.walk(guid):
            if k == owner or k in bad or k in out:
                continue
            out.append(k)
            if len(out) >= self.config.factor:
                break
        return out

    # -- fan-out enqueue -----------------------------------------------------

    def _push(self, dst: int, entry: tuple) -> None:
        q = self._outbox.setdefault(dst, deque())
        q.append(entry)
        if len(q) > self.config.outbox_max:
            # bounded outbox, unbounded durability: overflow drains
            # inline instead of dropping
            self.metrics.backpressure.inc()
            self._drain_one(dst, budget=len(q))
        self.metrics.outbox_depth.labels(shard=str(dst)).set(
            len(self._outbox.get(dst, ()))
        )

    def enqueue_update(self, guid: str, update: bytes, v2: bool = False
                       ) -> None:
        """Fan one accepted update out to the doc's replicas
        (asynchronous: queued now, journaled on the next drain)."""
        targets = self.replicas_of(guid)
        seq = self._hwm.get(guid, 0) + 1
        self._hwm[guid] = seq
        if not targets:
            return
        ctx = current_context()
        trace_hex = (
            ctx.trace_hex if ctx is not None and ctx.sampled else None
        )
        owner = self.fleet.owner_of(guid)
        if owner is not None:
            try:
                shard = self.fleet.shards[owner]
                self._heat[guid] = shard.tiers.heat_of(guid)
                # cost attribution: fan-out bytes land on the
                # owner's ledger — the doc that wrote is the doc that pays
                # for every replica copy
                shard.cost.repl_bytes(guid, len(update) * len(targets))
            except ShardDownError:
                pass
        for dst in targets:
            if trace_hex is not None and owner is not None:
                # flow arrow: opened on the primary's tracer here, closed
                # on the replica's tracer when the record is journaled
                # (the id is hash-derived, so the two halves match even
                # when the tracers export separately and merge later)
                try:
                    self.fleet.shards[owner].engine.obs.tracer.flow_start(
                        "ytpu.repl.fanout",
                        flow_id_for((trace_hex, "repl", guid, seq, dst)),
                        guid=guid, dst=dst, trace=trace_hex,
                    )
                except ShardDownError:
                    pass
            self._push(
                dst,
                ("update", guid, (seq, bytes(update), bool(v2), trace_hex)),
            )

    def enqueue_ack(self, guid: str, peer: str, sid: int, seq: int) -> None:
        """Fan a session receive-floor ack out to the replicas, so a
        promoted replica's WAL lets surviving sessions RESUME instead
        of full-resyncing."""
        for dst in self.replicas_of(guid):
            self._push(dst, ("ack", guid, (str(peer), int(sid), int(seq))))

    def enqueue_dlq(self, guid: str, update: bytes, v2: bool, reason: str
                    ) -> None:
        """Mirror one dead letter to the replicas (quarantined evidence
        must survive the primary that quarantined it)."""
        letter = {
            "guid": guid,
            "v2": bool(v2),
            "reason": str(reason),
            "update": base64.b64encode(bytes(update)).decode("ascii"),
        }
        kept = self._letters.setdefault(guid, [])
        kept.append(dict(letter))
        del kept[:-_LETTER_CAP]
        targets = self.replicas_of(guid)
        ctx = current_context()
        if ctx is not None:
            ctx.force("dlq_mirror")
        flight_recorder().record(
            "replication", "dlq_mirror", severity="warning", guid=guid,
            trace=ctx.trace_hex if ctx is not None else None,
            reason=str(reason), replicas=len(targets),
        )
        for dst in targets:
            self._push(dst, ("dlq", guid, (letter,)))

    def absorb(self, guid: str, update: bytes, v2: bool = False) -> bool:
        """Synchronous last-resort journal: the primary's machine is
        already gone, so the update is journaled directly on the doc's
        replicas (no outbox).  Returns False — caller must refuse the
        update — when not a single replica could journal it; True means
        the bytes are durable somewhere and failover will carry them."""
        owner = self.fleet.owner_of(guid)
        exclude = {owner} if owner is not None else set()
        seq = self._hwm.get(guid, 0) + 1
        ctx = current_context()
        if ctx is not None:
            ctx.force("absorb")
        trace_hex = (
            ctx.trace_hex if ctx is not None and ctx.sampled else None
        )
        count = 0
        for dst in self.replicas_of(guid, exclude=exclude):
            try:
                self._apply(dst, ("update", guid,
                                  (seq, bytes(update), bool(v2),
                                   trace_hex)))
            except ShardDownError:
                self.fleet.detector.report_down(dst)
                continue
            count += 1
        flight_recorder().record(
            "replication", "absorb",
            severity="warning" if count else "error", guid=guid,
            trace=ctx.trace_hex if ctx is not None else None,
            replicas=count,
        )
        if count == 0:
            return False
        self._hwm[guid] = seq
        return True

    # -- drain ---------------------------------------------------------------

    def _apply(self, dst: int, entry: tuple) -> None:
        """Journal one fan-out entry on the replica shard's WAL.
        Raises :class:`ShardDownError` when the shard is gone (caller
        reports to the detector and keeps the queue)."""
        kind, guid, data = entry
        prov = self.fleet.shards[dst]
        if (guid, dst) not in self._marked:
            prov.journal_repl_role(
                guid, "replica", self.fleet.table.epoch,
                primary=self.fleet.owner_of(guid),
            )
            self._marked.add((guid, dst))
        if kind == "update":
            seq, payload, v2 = data[:3]
            trace_hex = data[3] if len(data) > 3 else None
            if not prov.journal_replica_record(
                KIND_UPDATE, guid, payload, v2=v2
            ):
                # WAL-less shard: keep an in-memory mirror so promotion
                # still has the bytes (durability is only as good as
                # the process, same as the primary's own slots)
                self._mem.setdefault((guid, dst), []).append(
                    (seq, payload, v2)
                )
            key = (guid, dst)
            if seq > self._applied.get(key, 0):
                self._applied[key] = seq
            if trace_hex is not None:
                prov.engine.obs.tracer.flow_end(
                    "ytpu.repl.fanout",
                    flow_id_for((trace_hex, "repl", guid, seq, dst)),
                    guid=guid, shard=dst, trace=trace_hex,
                )
            self.metrics.records.labels(kind="update").inc()
        elif kind == "ack":
            peer, sid, seq = data
            self._applied.setdefault((guid, dst), 0)
            prov.journal_session_ack(guid, peer, sid, seq)
            self.metrics.records.labels(kind="ack").inc()
        elif kind == "dlq":
            (letter,) = data
            self._applied.setdefault((guid, dst), 0)
            prov.journal_replica_record(
                KIND_DLQ, guid,
                json.dumps(
                    {"schema": 1, "letters": [letter]},
                    separators=(",", ":"),
                ).encode("utf-8"),
            )
            self.metrics.records.labels(kind="dlq").inc()

    def _drain_one(self, dst: int, budget: int | None = None) -> int:
        q = self._outbox.get(dst)
        if not q:
            return 0
        fleet = self.fleet
        if dst in fleet._down or fleet._is_stub(dst):
            self.metrics.stalls.labels(reason="down").inc()
            return 0
        n = len(q) if budget is None else min(budget, len(q))
        done = 0
        for _ in range(n):
            entry = q[0]
            try:
                self._apply(dst, entry)
            except ShardDownError:
                fleet.detector.report_down(dst)
                self.metrics.stalls.labels(reason="error").inc()
                break
            q.popleft()
            done += 1
        self.metrics.outbox_depth.labels(shard=str(dst)).set(len(q))
        return done

    def drain(self, full: bool = False) -> int:
        """One replication pass: apply up to ``batch`` queued records
        per replica (all of them when ``full``).  Suspect shards are
        skipped — their queues hold until the detector acquits or
        convicts them."""
        det = self.fleet.detector
        total = 0
        for dst in sorted(self._outbox):
            if not self._outbox[dst]:
                continue
            state = det.state_of(dst)
            if state == "suspect":
                self.metrics.stalls.labels(reason="suspect").inc()
                continue
            total += self._drain_one(
                dst, budget=None if full else self.config.batch
            )
        self._refresh_gauges()
        return total

    def repair_all(self) -> int:
        """Drain every outbox to empty (post-failover catch-up)."""
        return self.drain(full=True)

    def flush_for(self, guid: str, dst: int) -> None:
        """Apply every queued entry for one (doc, replica) pair NOW —
        promotion must not leave accepted updates stranded in the
        outbox."""
        q = self._outbox.get(dst)
        if not q:
            return
        keep = deque()
        for entry in q:
            if entry[1] == guid:
                self._apply(dst, entry)
            else:
                keep.append(entry)
        self._outbox[dst] = keep
        self.metrics.outbox_depth.labels(shard=str(dst)).set(len(keep))

    # -- freshness + promotion ----------------------------------------------

    def _candidates(self, guid: str, exclude=()) -> list[tuple[int, int]]:
        """``(score, shard)`` per surviving replica, freshest first
        (score ties break to the LOWEST shard id, so every node in a
        partitioned fleet elects the same winner).  Queued outbox
        entries count: promotion flushes them before materializing."""
        fleet = self.fleet
        bad = set(exclude) | fleet._down | fleet._retired
        scores: dict[int, int] = {}
        for (g, s), seq in self._applied.items():
            if g == guid and s not in bad and not fleet._is_stub(s):
                scores[s] = max(scores.get(s, 0), seq)
        for g, s in self._marked | set(self._mem):
            if g == guid and s not in bad and not fleet._is_stub(s):
                scores.setdefault(s, 0)
        for s, q in self._outbox.items():
            if s in bad or fleet._is_stub(s):
                continue
            for kind, g, data in q:
                if g != guid:
                    continue
                seq = data[0] if kind == "update" else 0
                scores[s] = max(scores.get(s, 0), seq)
        return sorted(
            ((seq, s) for s, seq in scores.items()),
            key=lambda t: (-t[0], t[1]),
        )

    def freshest(self, guid: str, exclude=()) -> int | None:
        cands = self._candidates(guid, exclude)
        return cands[0][1] if cands else None

    def promote(self, guid: str, exclude=()) -> int | None:
        """Make the freshest surviving replica the doc's primary:
        flush its queued fan-out, admit the doc, integrate the copy
        from its own WAL (WAL-assisted catch-up), carry heat and dead
        letters over.  Tries the next-freshest on admission overflow.
        Returns the promoted shard, or None when no replica holds the
        doc.  The CALLER owns routing: table assignment, the fencing
        epoch bump, and the primary role marker."""
        for _score, cand in self._candidates(guid, exclude):
            prov = self.fleet.shards[cand]
            try:
                self.flush_for(guid, cand)
                self._materialize(prov, guid)
            except ShardDownError:
                self.fleet.detector.report_down(cand)
                continue
            except ProviderFullError:
                continue
            prov.tiers.adopt_heat(guid, self._heat.get(guid, 0.0))
            doc = prov.doc_id(guid)
            for e in self._letters.get(guid, ()):
                prov.engine._dead_letter(
                    doc, base64.b64decode(e.get("update", "")),
                    bool(e.get("v2")), e.get("reason", "replicated"),
                )
            # the promoted shard is no longer a replica of the doc
            self._applied.pop((guid, cand), None)
            self._marked.discard((guid, cand))
            self._mem.pop((guid, cand), None)
            return cand
        return None

    def _materialize(self, prov, guid: str) -> int:
        """Integrate a replica's journaled copy of one doc into its
        engine.  Reads the shard's OWN WAL tail (appends flush to the
        OS on every record, so live segments are readable in-process);
        WAL-less shards integrate from the in-memory mirror."""
        doc = prov.doc_id(guid)
        eng = prov.engine
        applied = 0
        if prov.wal is not None:
            _ckpt, segs = scan_wal(prov.wal.dir)
            for _idx, path in segs:
                for ev in iter_file_events(path, final=False):
                    if ev[0] != "record":
                        continue
                    rec = ev[1]
                    if rec.guid != guid or rec.kind != KIND_UPDATE:
                        continue
                    if eng.queue_update(doc, rec.payload, v2=rec.v2):
                        applied += 1
        for _seq, payload, v2 in sorted(
            self._mem.get((guid, prov.shard_id), ())
        ):
            if eng.queue_update(doc, payload, v2=v2):
                applied += 1
        if applied:
            prov._dirty = True
            prov.flush()
        return applied

    # -- durability interplay ------------------------------------------------

    def rejournal_after_checkpoint(self) -> int:
        """Reseed every replica pair after WAL compaction: checkpoints
        fold only OWNED docs, so the replica's journaled copy must be
        re-established — one full-state record from the live owner
        (idempotent), plus role marker, mirrored letters, and current
        session ack floors."""
        fleet = self.fleet
        pairs = sorted(set(self._applied) | self._marked)
        reseeded = 0
        for guid, dst in pairs:
            owner = fleet.owner_of(guid)
            if owner is None or owner in fleet._down:
                continue
            try:
                src = fleet.shards[owner]
                src.flush()
                state = src.encode_state_as_update(guid)
                prov = fleet.shards[dst]
                prov.journal_repl_role(
                    guid, "replica", fleet.table.epoch, primary=owner
                )
                if prov.journal_replica_record(KIND_UPDATE, guid, state):
                    self._applied[(guid, dst)] = self._hwm.get(guid, 0)
                self._marked.add((guid, dst))
                for e in self._letters.get(guid, ()):
                    prov.journal_replica_record(
                        KIND_DLQ, guid,
                        json.dumps(
                            {"schema": 1, "letters": [e]},
                            separators=(",", ":"),
                        ).encode("utf-8"),
                    )
            except ShardDownError:
                fleet.detector.report_down(dst)
                continue
            self.metrics.reseeds.inc()
            self.metrics.records.labels(kind="seed").inc()
            reseeded += 1
            self.rejournal_acks(guid, dst)
        return reseeded

    def rejournal_acks(self, guid: str, dst: int) -> None:
        """Journal every live session's receive floor for a doc onto
        one shard's WAL — the promoted/reseeded owner must know the
        floors or post-crash recovery forces full resyncs."""
        fleet = self.fleet
        prov = fleet.shards[dst]
        for (g, peer), sess in sorted(fleet._sessions.items()):
            if g != guid:
                continue
            sid, seq = sess.ack_floor
            prov.journal_session_ack(guid, peer, sid, seq)

    # -- lifecycle + introspection -------------------------------------------

    def drop_shard(self, shard: int) -> None:
        """Forget a dead shard's queues and copies (its journal is
        gone with the machine; revival re-enters through fencing)."""
        self._outbox.pop(shard, None)
        for key in [k for k in self._applied if k[1] == shard]:
            del self._applied[key]
        self._marked = {p for p in self._marked if p[1] != shard}
        for key in [k for k in self._mem if k[1] == shard]:
            del self._mem[key]
        lab = str(shard)
        self.metrics.outbox_depth.labels(shard=lab).set(0)
        self.metrics.lag.labels(shard=lab).set(0)
        self.metrics.replica_docs.labels(shard=lab).set(0)

    def owner_changed(self, guid: str, new_owner: int) -> None:
        """A doc's ownership moved onto ``new_owner`` (migration
        complete / failover promotion): it is no longer a replica of
        the doc it now serves."""
        self._applied.pop((guid, new_owner), None)
        self._marked.discard((guid, new_owner))
        self._mem.pop((guid, new_owner), None)
        q = self._outbox.get(new_owner)
        if q:
            self._outbox[new_owner] = deque(
                e for e in q if e[1] != guid
            )

    def forget_doc(self, guid: str) -> None:
        """Drop all replication state for a doc (released/lost)."""
        self._hwm.pop(guid, None)
        self._heat.pop(guid, None)
        self._letters.pop(guid, None)
        for key in [k for k in self._applied if k[0] == guid]:
            del self._applied[key]
        self._marked = {p for p in self._marked if p[0] != guid}
        for key in [k for k in self._mem if k[0] == guid]:
            del self._mem[key]
        for q in self._outbox.values():
            stale = [e for e in q if e[1] == guid]
            for e in stale:
                q.remove(e)

    def copies_on(self, shard: int) -> list[str]:
        return sorted(
            {g for (g, s) in (set(self._applied) | self._marked)
             if s == shard}
        )

    def lag(self, shard: int) -> int:
        """Accepted-minus-journaled updates across every doc this
        shard replicates (queued outbox entries keep it honest)."""
        total = 0
        for (g, s), seq in self._applied.items():
            if s == shard:
                total += max(0, self._hwm.get(g, 0) - seq)
        seen = {g for (g, s) in self._applied if s == shard}
        for kind, g, data in self._outbox.get(shard, ()):
            if kind == "update" and g not in seen:
                total += 1
        return total

    def _refresh_gauges(self) -> None:
        shards = set(self._outbox) | {s for (_g, s) in self._applied}
        shards |= {s for (_g, s) in self._marked}
        for s in shards:
            lab = str(s)
            self.metrics.outbox_depth.labels(shard=lab).set(
                len(self._outbox.get(s, ()))
            )
            self.metrics.lag.labels(shard=lab).set(self.lag(s))
            self.metrics.replica_docs.labels(shard=lab).set(
                len(self.copies_on(s))
            )

    def snapshot(self) -> dict:
        """JSON-able replication state (ytpu_stats / bench feeds)."""
        self._refresh_gauges()
        return {
            "factor": self.config.factor,
            "docs_tracked": len(self._hwm),
            "outbox": {
                str(s): len(q) for s, q in sorted(self._outbox.items()) if q
            },
            "lag": {
                str(s): self.lag(s)
                for s in sorted(
                    {x for (_g, x) in set(self._applied) | self._marked}
                )
            },
            "replica_docs": {
                str(s): len(self.copies_on(s))
                for s in sorted(
                    {x for (_g, x) in set(self._applied) | self._marked}
                )
            },
        }
