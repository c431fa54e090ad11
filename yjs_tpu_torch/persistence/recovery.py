"""Crash recovery: replay a WAL directory into a live provider.

Semantics:

- the newest checkpoint's per-doc snapshots are applied first, then the
  tail segments it does not cover, in order — snapshot-then-tail;
- a torn write (short or checksum-failing record) on the FINAL segment
  truncates the log at the first bad byte: that is the crash frontier,
  everything before it is intact by CRC;
- a corrupt record in the MIDDLE of the log (a sealed segment or the
  checkpoint file — at-rest damage, not a crash artifact) is routed
  through ``validate_update`` into the dead-letter queue and the reader
  resynchronizes on the next record magic — recovery never aborts;
- replay is idempotent by the CRDT merge contract: applying a snapshot
  plus an overlapping tail, or replaying the same log twice, converges
  to the same state (pinned by tests/test_persistence.py).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

from .records import (
    KIND_ACK,
    KIND_ADM,
    KIND_DLQ,
    KIND_GEO,
    KIND_MIGRATE,
    KIND_RELEASE,
    KIND_REPL,
    KIND_SNAPSHOT,
    KIND_TIER,
    KIND_UPDATE,
    SEG_HEADER,
    SNAP_HEADER,
    decode_tier_payload,
    resync,
    try_decode_at,
)
from .wal import list_checkpoints, list_segments

# cap on the bytes of an unparseable region preserved in a dead letter
_SLICE_CAP = 1 << 16


def iter_file_events(path, final: bool):
    """Decode one segment/checkpoint file into a stream of events:
    ``("record", WalRecord)``, ``("corrupt", payload_bytes, note)``, or
    ``("torn", offset)``.  ``final=True`` applies the torn-write rule:
    the first anomaly ends the stream (truncation point = its offset);
    sealed files instead surface anomalies as corrupt events and keep
    reading from the next record magic."""
    data = Path(path).read_bytes()
    if not data:
        return
    if data[:8] not in (SEG_HEADER, SNAP_HEADER):
        if final:
            yield ("torn", 0)
        else:
            yield ("corrupt", data[:_SLICE_CAP], "bad segment header")
        return
    pos = 8
    n = len(data)
    while pos < n:
        status, val, end = try_decode_at(data, pos)
        if status == "ok":
            yield ("record", val)
            pos = end
            continue
        if final:
            yield ("torn", pos)
            return
        if status == "bad_crc":
            yield ("corrupt", val, "crc mismatch")
            pos = end
            continue
        # bad_header / short inside a sealed file: scan forward for the
        # next record magic; the skipped region is preserved (capped)
        nxt = resync(data, pos + 1)
        yield ("corrupt", data[pos : min(nxt, pos + _SLICE_CAP)],
               "unparseable bytes")
        pos = nxt


def scan_wal(path):
    """(newest checkpoint | None, uncovered tail segments) of a dir."""
    path = Path(path)
    if not path.is_dir():
        return None, []
    ckpts = list_checkpoints(path)
    ckpt = ckpts[-1] if ckpts else None
    upto = ckpt[0] if ckpt else 0
    segs = [(i, p) for i, p in list_segments(path) if i >= upto]
    return ckpt, segs


def count_guids(path, exclude_from: int | None = None) -> int:
    """Distinct doc guids named anywhere in the log — the default fleet
    size for ``TpuProvider.recover`` when the caller gives none."""
    ckpt, segs = scan_wal(path)
    if exclude_from is not None:
        segs = [(i, p) for i, p in segs if i < exclude_from]
    guids: set[str] = set()
    sources = ([ckpt[1]] if ckpt else []) + [p for _, p in segs]
    for j, p in enumerate(sources):
        for ev in iter_file_events(p, final=(j == len(sources) - 1)):
            if ev[0] == "record" and ev[1].kind not in (
                KIND_DLQ, KIND_ADM, KIND_GEO
            ):
                # KIND_ADM/KIND_GEO records are fleet/region-scoped
                # (empty guid) and must not inflate the recovered fleet
                # size
                guids.add(ev[1].guid)
    return len(guids)


def replay_wal(
    provider,
    path,
    exclude_from: int | None = None,
    truncate_torn: bool = True,
) -> dict:
    """Replay a WAL directory into ``provider`` and flush.

    ``exclude_from`` skips segments at or past that index (the
    provider's own live appends during self-recovery);
    ``truncate_torn=False`` reads without modifying files (the
    idempotence property tests re-read prefixes non-destructively).
    Returns the recovery stats dict (also stored by
    ``TpuProvider.recover`` as ``last_recovery``)."""
    from ..updates import validate_update

    t0 = time.perf_counter()
    m = provider._wal_metrics
    eng = provider.engine
    stats = {
        "checkpoint": None,
        "segments": 0,
        "snapshots_applied": 0,
        "records_applied": 0,
        "dead_lettered": 0,
        "overflowed": 0,
        "dlq_restored": 0,
        "released": 0,
        "session_acks": 0,
        "migration_intents": 0,
        "migrations_pending": {},
        "repl_markers": 0,
        "repl_roles": {},
        "adm_transitions": 0,
        "adm_level": None,
        "geo_links": 0,
        "geo_floors": {},
        "tier_records": 0,
        "tier_placements": {},
        "corrupt_records": 0,
        "torn_truncations": 0,
        "duration_s": 0.0,
        "outcome": "empty",
    }
    ckpt, segs = scan_wal(path)
    if exclude_from is not None:
        segs = [(i, p) for i, p in segs if i < exclude_from]
    sources: list[tuple[Path, bool]] = []
    if ckpt is not None:
        stats["checkpoint"] = str(ckpt[1])
        sources.append((ckpt[1], False))
    sources += [(p, j == len(segs) - 1) for j, (_i, p) in enumerate(segs)]
    stats["segments"] = len(segs)

    def doc_of(guid: str) -> int:
        from ..provider import ProviderFullError

        try:
            return provider.doc_id(guid)
        except ProviderFullError:
            return -1

    saw_records = False
    # KIND_TIER placement markers: the LAST marker for a guid
    # stands — a "hot" promotion marker or a release clears it.  State
    # replay and placement are separate: tier-record updates apply like
    # snapshots as they stream by, and placement happens once, after
    # the final flush, via TierManager.place_recovered.
    tier_markers: dict[str, dict] = {}
    for fpath, final in sources:
        for ev in iter_file_events(fpath, final=final):
            if ev[0] == "torn":
                stats["torn_truncations"] += 1
                m.torn.inc()
                if truncate_torn:
                    off = ev[1]
                    os.truncate(
                        fpath, 0 if off <= len(SEG_HEADER) else off
                    )
                continue
            if ev[0] == "corrupt":
                payload, note = ev[1] or b"", ev[2]
                # the recovery contract: mid-log corruption is routed
                # through validate_update into the DLQ, never applied
                # and never fatal.  Bytes whose CRC failed are refused
                # even if they happen to still decode — an unverifiable
                # update is a Byzantine input.
                try:
                    validate_update(payload)
                except Exception as ve:
                    reason = f"wal-corrupt: {note} ({type(ve).__name__})"
                else:
                    reason = f"wal-corrupt: {note} (decodes; refused)"
                eng._dead_letter(-1, payload, False, reason)
                stats["corrupt_records"] += 1
                stats["dead_lettered"] += 1
                m.corrupt.inc()
                m.replayed.labels(disposition="dead_lettered").inc()
                continue
            rec = ev[1]
            saw_records = True
            if rec.kind in (KIND_UPDATE, KIND_SNAPSHOT):
                doc = doc_of(rec.guid)
                if doc < 0:
                    # the provider is full: the doc's durably-journaled
                    # state must NOT vanish.  The record rides the DLQ
                    # with its guid in the reason so an operator (or a
                    # fleet rebalancer) can re-route it to a shard with
                    # room.
                    eng._dead_letter(
                        doc, rec.payload, rec.v2,
                        f"wal-overflow: no free slot for {rec.guid!r}",
                    )
                    stats["overflowed"] += 1
                    stats["dead_lettered"] += 1
                    m.overflow.inc()
                    m.replayed.labels(disposition="overflow").inc()
                    continue
                try:
                    validate_update(rec.payload, rec.v2)
                except Exception as ve:
                    eng._dead_letter(
                        doc, rec.payload, rec.v2,
                        f"wal-invalid: {type(ve).__name__}: {ve}",
                    )
                    stats["dead_lettered"] += 1
                    m.replayed.labels(disposition="dead_lettered").inc()
                    continue
                if eng.queue_update(doc, rec.payload, v2=rec.v2):
                    # mark dirty NOW, not after the loop: a tiered
                    # provider's mid-replay auto-eviction flushes
                    # before exporting, and a gated no-op flush would
                    # leave every slot ineligible (queued updates)
                    provider._dirty = True
                    key = (
                        "snapshots_applied"
                        if rec.kind == KIND_SNAPSHOT
                        else "records_applied"
                    )
                    stats[key] += 1
                    m.replayed.labels(
                        disposition="snapshot"
                        if rec.kind == KIND_SNAPSHOT
                        else "applied"
                    ).inc()
                else:
                    # queue_update already dead-lettered (quarantine)
                    stats["dead_lettered"] += 1
                    m.replayed.labels(disposition="dead_lettered").inc()
            elif rec.kind == KIND_DLQ:
                try:
                    state = json.loads(rec.payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    state = None
                if isinstance(state, dict):
                    stats["dlq_restored"] += provider._restore_dlq(state)
                    m.replayed.labels(disposition="dlq_restored").inc()
            elif rec.kind == KIND_RELEASE:
                provider._apply_release_record(rec.guid)
                # a release after a migration intent marks the handoff
                # complete: the doc left this shard on purpose
                stats["migrations_pending"].pop(rec.guid, None)
                stats["repl_roles"].pop(rec.guid, None)
                tier_markers.pop(rec.guid, None)
                stats["released"] += 1
                m.replayed.labels(disposition="released").inc()
            elif rec.kind == KIND_TIER:
                try:
                    meta, update = decode_tier_payload(rec.payload)
                except ValueError as ve:
                    eng._dead_letter(
                        -1, rec.payload, False,
                        f"wal-tier-invalid: {ve} ({rec.guid!r})",
                    )
                    stats["dead_lettered"] += 1
                    m.replayed.labels(disposition="dead_lettered").inc()
                    continue
                stats["tier_records"] += 1
                m.replayed.labels(disposition="tier").inc()
                if meta["tier"] == "hot":
                    # promotion marker: the earlier demote no longer
                    # stands (the doc's state lives in later records)
                    tier_markers.pop(rec.guid, None)
                    continue
                # demote marker: its payload is the doc's full state at
                # demotion time — replay it like a snapshot, placement
                # comes after the final flush
                if update:
                    doc = doc_of(rec.guid)
                    if doc < 0:
                        eng._dead_letter(
                            doc, update, False,
                            f"wal-overflow: no free slot for "
                            f"{rec.guid!r}",
                        )
                        stats["overflowed"] += 1
                        stats["dead_lettered"] += 1
                        m.overflow.inc()
                        m.replayed.labels(disposition="overflow").inc()
                        continue
                    try:
                        validate_update(update)
                    except Exception as ve:
                        eng._dead_letter(
                            doc, update, False,
                            f"wal-invalid: {type(ve).__name__}: {ve}",
                        )
                        stats["dead_lettered"] += 1
                        m.replayed.labels(
                            disposition="dead_lettered"
                        ).inc()
                        continue
                    if eng.queue_update(doc, update):
                        provider._dirty = True
                        stats["snapshots_applied"] += 1
                    else:
                        stats["dead_lettered"] += 1
                        m.replayed.labels(
                            disposition="dead_lettered"
                        ).inc()
                        continue
                tier_markers[rec.guid] = meta
            elif rec.kind == KIND_MIGRATE:
                # migration intent: journaled by the source
                # shard before any state reached the destination.  An
                # intent with no later release means the crash landed
                # mid-migration; FleetRouter.recover resolves ownership
                # (destination owns iff its own WAL admitted the doc).
                try:
                    intent = json.loads(rec.payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    intent = None
                if isinstance(intent, dict) and "dst" in intent:
                    try:
                        stats["migrations_pending"][rec.guid] = {
                            "dst": int(intent["dst"]),
                            "epoch": int(intent.get("epoch", 0)),
                        }
                    except (TypeError, ValueError):
                        pass
                    else:
                        stats["migration_intents"] += 1
                        m.replayed.labels(disposition="migrate").inc()
            elif rec.kind == KIND_REPL:
                # replication role marker: "this WAL holds the
                # doc as a replica copy" or "this shard won ownership at
                # fencing epoch N".  The LAST marker stands (a promotion
                # overwrites the replica claim); a release clears it.
                # FleetRouter.recover reads the surfaced roles to keep
                # replica journals from looking like split-brain owners
                # and to fence stale-primary claims behind newer epochs.
                try:
                    info = json.loads(rec.payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    info = None
                if isinstance(info, dict) and info.get("role") in (
                    "replica", "primary"
                ):
                    try:
                        stats["repl_roles"][rec.guid] = {
                            "role": str(info["role"]),
                            "epoch": int(info.get("epoch", 0)),
                        }
                    except (TypeError, ValueError):
                        pass
                    else:
                        stats["repl_markers"] += 1
                        m.replayed.labels(disposition="repl").inc()
            elif rec.kind == KIND_ADM:
                # brownout transition marker: forensic record
                # of when/why service degraded.  Surfaced in stats only;
                # the live brownout level always restarts at "normal"
                # (post-crash load may look nothing like pre-crash).
                try:
                    info = json.loads(rec.payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    info = None
                if isinstance(info, dict) and "level" in info:
                    stats["adm_transitions"] += 1
                    stats["adm_level"] = str(info["level"])
                    m.replayed.labels(disposition="adm").inc()
            elif rec.kind == KIND_GEO:
                # geo link floor: "our WAN session with
                # region <peer> holds <sid> up to <seq> at fencing
                # epoch <epoch>".  The LAST record per peer stands;
                # the rebuilt region's GeoReplicator HELLOs each link
                # with these floors so a kill -9'd region RESUMES its
                # WAN retransmission windows instead of full-resyncing
                # the whole doc space across every link.
                try:
                    info = json.loads(rec.payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    info = None
                hints = getattr(provider, "_recovered_geo", None)
                if isinstance(info, dict) and hints is not None:
                    try:
                        floor = {
                            "sid": int(info["sid"]),
                            "seq": int(info["seq"]),
                            "epoch": int(info.get("epoch", 0)),
                        }
                        peer = str(info["peer"])
                    except (KeyError, TypeError, ValueError):
                        pass
                    else:
                        hints[peer] = floor
                        stats["geo_floors"][peer] = floor
                        stats["geo_links"] = len(hints)
                        m.replayed.labels(disposition="geo").inc()
            elif rec.kind == KIND_ACK:
                # session ack floor: the journaled "we hold
                # peer session <sid> up to <seq>" fact.  Later records
                # win (floors only advance); the rebuilt provider's
                # sessions HELLO with these so the surviving peer
                # resumes retransmission instead of a full resync.
                try:
                    ack = json.loads(rec.payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    ack = None
                hints = getattr(provider, "_recovered_acks", None)
                if isinstance(ack, dict) and hints is not None:
                    try:
                        hints[(rec.guid, str(ack["peer"]))] = (
                            int(ack["sid"]), int(ack["seq"])
                        )
                    except (KeyError, TypeError, ValueError):
                        pass
                    else:
                        stats["session_acks"] += 1
                        m.replayed.labels(disposition="ack").inc()
    if stats["snapshots_applied"] or stats["records_applied"]:
        # queue_update was called below the provider's dirty-tracking
        # seam; without this, device-backed engines would leave the
        # replayed records queued-but-uningested until unrelated new
        # traffic happened to trigger a flush
        provider._dirty = True
    provider.flush()
    if tier_markers:
        tiers = getattr(provider, "tiers", None)
        if tiers is not None and tiers.enabled:
            stats["tier_placements"] = tiers.place_recovered(tier_markers)
        else:
            # tiering off on the recovering provider: every doc stays
            # hot, but the letters that rode the demote markers must
            # not vanish
            import base64

            for guid, meta in sorted(tier_markers.items()):
                doc = provider._guids.get(guid, -1)
                for d in meta.get("letters") or []:
                    eng._dead_letter(
                        doc,
                        base64.b64decode(d.get("update", "")),
                        bool(d.get("v2")),
                        str(d.get("reason", "tiered")),
                    )
    dt = time.perf_counter() - t0
    stats["duration_s"] = round(dt, 6)
    if stats["corrupt_records"]:
        stats["outcome"] = "corrupt_records"
    elif stats["torn_truncations"]:
        stats["outcome"] = "torn_tail"
    elif saw_records:
        stats["outcome"] = "clean"
    m.recoveries.labels(outcome=stats["outcome"]).inc()
    m.replay_seconds.observe(dt)
    return stats
