"""TierManager: the heat-driven hot/warm/cold doc lifecycle.

Every provider owns exactly one manager.  Three tiers:

- **hot** — the doc holds an engine slot: packed columns on device,
  mirror on host, updates integrate batched like always;
- **warm** — the doc's host mirror is detached (struct-of-arrays
  columns + interned payloads, no engine references) and the slot is
  freed.  Promotion scatters the columns straight back into a slot —
  ``Engine.hydrate_doc_columns`` — with NO decode round-trip;
- **cold** — the doc is folded into a durable ``KIND_TIER`` WAL record
  (full ``encode_state_as_update`` bytes + meta) and only a
  ``(segment, offset, length)`` locator is kept in memory (a compressed
  blob when the provider has no WAL).  Promotion replays the encoded
  state through the normal decode path, exactly like the
  snapshot-then-tail recovery.

Demotion journals BEFORE the slot is freed, so a crash mid-demotion
recovers the doc in exactly one tier: the tier record lost → the
journaled updates still replay it hot; the record present → recovery
places it demoted (unless later records show it was touched again).
Dead letters attributed to the slot ride the tier record the same way
(they must not be misattributed to the slot's next tenant and must not
vanish).

The whole subsystem is **opt-in** (``TierConfig(enabled=True)`` or
``YTPU_TIER_ENABLED=1``): with it off, the manager is inert bookkeeping
— ``doc_id()`` keeps raising ``ProviderFullError`` and every existing
contract holds bit-for-bit.  Metrics (the ``ytpu_tier_*`` families)
register unconditionally so exposition and the schema checker see them
either way.
"""

from __future__ import annotations

import base64
import os
import time
import zlib

from ..obs import TierMetrics
from ..persistence.records import (
    KIND_TIER,
    decode_tier_payload,
    encode_tier_payload,
    try_decode_at,
)
from .heat import HeatTracker

HOT = "hot"
WARM = "warm"
COLD = "cold"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class TierConfig:
    """Tiering policy knobs (env-derived defaults, constructor wins).

    - ``YTPU_TIER_ENABLED`` — master switch (default off: the provider
      keeps its hard-capped ``ProviderFullError`` contract);
    - ``YTPU_TIER_HALF_LIFE_S`` — heat half-life in seconds (300);
    - ``YTPU_TIER_WARM_MAX`` — max docs held warm before the coldest
      spill to the cold tier (0 = unbounded);
    - ``YTPU_TIER_SESSION_WEIGHT`` — extra touch weight a session
      admission adds (8.0 — an attached peer outweighs stray reads);
    - ``YTPU_TIER_OVERCOMMIT`` — virtual-capacity multiplier the fleet
      router advertises per tiered shard (64);
    - ``YTPU_TIER_GC_MIN_ROWS`` / ``YTPU_TIER_GC_DELETED_RATIO`` — a
      hot doc qualifies for a forced tombstone/GC compaction pass once
      it holds at least MIN_ROWS packed rows of which at least
      DELETED_RATIO are deleted content (512 / 0.5);
    - ``YTPU_TIER_GC_MAX_DOCS`` — GC'd docs per ``tick`` pass (8).
    """

    __slots__ = (
        "enabled", "half_life_s", "warm_max", "session_weight",
        "overcommit", "gc_min_rows", "gc_deleted_ratio", "gc_max_docs",
    )

    def __init__(
        self,
        enabled: bool | None = None,
        half_life_s: float | None = None,
        warm_max: int | None = None,
        session_weight: float | None = None,
        overcommit: int | None = None,
        gc_min_rows: int | None = None,
        gc_deleted_ratio: float | None = None,
        gc_max_docs: int | None = None,
    ):
        if enabled is None:
            enabled = os.environ.get("YTPU_TIER_ENABLED", "0") in (
                "1", "true", "yes",
            )
        self.enabled = bool(enabled)
        if half_life_s is None:
            half_life_s = _env_float("YTPU_TIER_HALF_LIFE_S", 300.0)
        self.half_life_s = max(1e-6, float(half_life_s))
        if warm_max is None:
            warm_max = _env_int("YTPU_TIER_WARM_MAX", 0)
        self.warm_max = max(0, int(warm_max))
        if session_weight is None:
            session_weight = _env_float("YTPU_TIER_SESSION_WEIGHT", 8.0)
        self.session_weight = max(0.0, float(session_weight))
        if overcommit is None:
            overcommit = _env_int("YTPU_TIER_OVERCOMMIT", 64)
        self.overcommit = max(1, int(overcommit))
        if gc_min_rows is None:
            gc_min_rows = _env_int("YTPU_TIER_GC_MIN_ROWS", 512)
        self.gc_min_rows = max(1, int(gc_min_rows))
        if gc_deleted_ratio is None:
            gc_deleted_ratio = _env_float("YTPU_TIER_GC_DELETED_RATIO", 0.5)
        self.gc_deleted_ratio = min(1.0, max(0.0, float(gc_deleted_ratio)))
        if gc_max_docs is None:
            gc_max_docs = _env_int("YTPU_TIER_GC_MAX_DOCS", 8)
        self.gc_max_docs = max(0, int(gc_max_docs))

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class _WarmEntry:
    __slots__ = ("mirror", "letters", "log", "nbytes")

    def __init__(self, mirror, letters: list, log: list):
        self.mirror = mirror
        self.letters = letters
        # the slot's replay journal (engine ``_update_log`` invariant:
        # replays to the doc's full state) — restored on promotion so a
        # later CPU-demotion rollback still has history to rebuild from
        self.log = log
        self.nbytes = mirror.host_nbytes() + sum(
            len(u) for u, _v2 in log
        )


class _ColdEntry:
    __slots__ = ("ref", "blob", "letters", "nbytes")

    def __init__(self, ref, blob, letters: list):
        self.ref = ref  # (segment path, offset, length) WAL locator
        self.blob = blob  # zlib'd state (no-WAL providers / checkpoints)
        self.letters = letters
        self.nbytes = ref[2] if ref is not None else len(blob)


def _dump_letters(letters) -> list[dict]:
    """DeadLetter objects → the JSON-able shape tier records carry."""
    return [
        {
            "v2": bool(e.v2),
            "reason": e.reason,
            "update": base64.b64encode(e.update).decode("ascii"),
        }
        for e in letters
    ]


def _restore_letters(dumped: list, doc: int, dlq) -> None:
    for d in dumped:
        dlq.append(
            doc,
            base64.b64decode(d.get("update", "")),
            bool(d.get("v2")),
            str(d.get("reason", "tiered")),
        )


class TierManager:
    """Hot/warm/cold lifecycle bound to one :class:`TpuProvider`."""

    def __init__(self, provider, config: TierConfig | None = None):
        self.provider = provider
        self.config = config if config is not None else TierConfig()
        self.heat = HeatTracker(self.config.half_life_s)
        self.metrics = TierMetrics(provider.engine.obs.registry)
        self.warm: dict[str, _WarmEntry] = {}
        self.cold: dict[str, _ColdEntry] = {}
        self._warm_bytes = 0
        self._cold_bytes = 0

    # -- policy inputs -------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def touch(self, guid: str, weight: float = 1.0) -> None:
        """One access through any provider seam; free when disabled."""
        if self.config.enabled:
            self.heat.touch(guid, weight)

    def heat_of(self, guid: str) -> float:
        """Decayed heat score; 0.0 when tiering is off or never touched
        — callers sorting by heat degrade to their old order."""
        return self.heat.score(guid)

    def tier_of(self, guid: str) -> str | None:
        if guid in self.provider._guids:
            return HOT
        if guid in self.warm:
            return WARM
        if guid in self.cold:
            return COLD
        return None

    def resident_count(self) -> int:
        return len(self.provider._guids) + len(self.warm) + len(self.cold)

    def resident_guids(self) -> list[str]:
        return sorted(
            set(self.provider._guids) | set(self.warm) | set(self.cold)
        )

    # -- demotion ------------------------------------------------------------

    def demote(self, guid: str, tier: str = WARM) -> bool:
        """Move a doc down to ``tier`` (``"warm"`` or ``"cold"``).

        Hot docs are flushed, their final state journaled as a
        ``KIND_TIER`` record (with the slot's dead letters riding
        along), the mirror detached, and the slot freed — journal
        BEFORE free, so a crash in between recovers the doc in exactly
        one tier.  Docs pinned to their slot (CPU fallback, registered
        observers, quarantine-parked updates) raise.  Returns False
        only for a warm→cold fold blocked by parked causal deps."""
        if tier not in (WARM, COLD):
            raise ValueError(f"unknown destination tier {tier!r}")
        prov = self.provider
        if guid not in prov._guids:
            if tier == COLD and guid in self.warm:
                return self._warm_to_cold(guid)
            if self.tier_of(guid) == tier:
                return True
            raise KeyError(f"unknown doc {guid!r}")
        t0 = time.perf_counter()
        eng = prov.engine
        i = prov._guids[guid]
        if i in eng.fallback:
            raise ValueError(
                f"{guid!r} is CPU-served; its fallback doc is bound to "
                "the slot and cannot be tiered"
            )
        if i in eng._event_listeners:
            raise ValueError(
                f"{guid!r} has observers bound to its slot; "
                "unobserve before demoting"
            )
        prov.flush()
        if eng.mirrors[i]._incoming:
            raise RuntimeError(
                f"{guid!r} still holds un-integrated updates after a "
                "flush (quarantine backoff); not demotable until "
                "re-admitted"
            )
        mirror = eng.export_doc_columns(i)
        # fold the slot's replay journal when the doc is causally whole
        # (the engine's own >64-entry fold idiom); keep it raw when
        # structs are parked — encoded state would drop them
        if mirror.has_pending():
            log = list(eng._update_log[i])
        else:
            log = [(mirror.encode_state_as_update(), False)]
        letters = _dump_letters(eng.dead_letters.take(doc=i))
        score = self.heat.score(guid)
        if prov.wal is not None:
            prov.wal.append(
                KIND_TIER,
                guid,
                encode_tier_payload(
                    WARM, score, mirror.encode_state_as_update(), letters
                ),
            )
        eng.reset_doc(i)
        del prov._guids[guid]
        del prov._guid_of[i]
        prov._free.append(i)
        self.warm[guid] = e = _WarmEntry(mirror, letters, log)
        self._warm_bytes += e.nbytes
        self.metrics.transition(HOT, WARM)
        self.metrics.demoted(WARM, time.perf_counter() - t0)
        ok = True
        if tier == COLD:
            ok = self._warm_to_cold(guid)
        else:
            self._enforce_warm_bound()
        self._refresh_gauges()
        return ok

    def _warm_to_cold(self, guid: str) -> bool:
        """Fold a warm mirror into a durable cold record.  Refuses (and
        keeps the doc warm) when the mirror parks causally-unready
        updates — encoded state would silently drop them."""
        e = self.warm[guid]
        if e.mirror.has_pending():
            return False
        t0 = time.perf_counter()
        del self.warm[guid]
        self._warm_bytes -= e.nbytes
        update = e.mirror.encode_state_as_update()
        prov = self.provider
        if prov.wal is not None:
            ref = prov.wal.append(
                KIND_TIER,
                guid,
                encode_tier_payload(
                    COLD, self.heat.score(guid), update, e.letters
                ),
            )
            ce = _ColdEntry(ref, None, e.letters)
        else:
            ce = _ColdEntry(None, zlib.compress(update), e.letters)
        self.cold[guid] = ce
        self._cold_bytes += ce.nbytes
        self.metrics.transition(WARM, COLD)
        self.metrics.demoted(COLD, time.perf_counter() - t0)
        self._refresh_gauges()
        return True

    def _enforce_warm_bound(self) -> None:
        cap = self.config.warm_max
        if not cap:
            return
        while len(self.warm) > cap:
            for guid in self.heat.coldest(self.warm):
                if self._warm_to_cold(guid):
                    break
            else:
                return  # every warm doc has parked deps: stop spilling

    # -- promotion -----------------------------------------------------------

    def promote(self, guid: str) -> int:
        """Bring a demoted doc back into a device slot; returns it.

        Warm: the detached mirror hydrates straight into the slot (no
        decode).  Cold: the journaled state replays through the normal
        decode path.  Either way the doc's dead letters return to the
        slot, and a ``KIND_TIER`` "hot" marker is journaled so recovery
        knows the demote marker no longer stands.

        Pipeline note: hydration only STAGES host rows; the
        device scatter is deferred to the next flush, where it rides
        the engine's single ``_dispatch`` seam as a donated
        ``scatter_rows`` stage.  The staged host copy belongs to the
        engine, so the warm mirror released here never aliases a
        donated device buffer."""
        src = self.tier_of(guid)
        if src not in (WARM, COLD):
            raise KeyError(f"{guid!r} is not demoted (tier={src})")
        t0 = time.perf_counter()
        prov = self.provider
        i = self._alloc_slot(guid)
        # re-resolve: make_room inside _alloc_slot can spill THIS doc
        # warm→cold while we were looking
        if guid in self.warm:
            src = WARM
            e: _WarmEntry | _ColdEntry = self.warm.pop(guid)
            self._warm_bytes -= e.nbytes
            prov.engine.hydrate_doc_columns(i, e.mirror)
            prov.engine._update_log[i] = list(e.log)
        else:
            src = COLD
            e = self.cold.pop(guid)
            self._cold_bytes -= e.nbytes
            prov.engine.queue_update(i, self._cold_update(guid, e))
            prov._dirty = True
            # materialize now: callers flush-then-doc_id (text, sync
            # step answers), so the replay must not stay queued past
            # the promotion — and promote latency should honestly
            # include the decode+integrate cost warm promotion skips
            prov.flush()
        _restore_letters(e.letters, i, prov.engine.dead_letters)
        if prov.wal is not None:
            prov.wal.append(
                KIND_TIER,
                guid,
                encode_tier_payload(HOT, self.heat.score(guid), b""),
            )
        self.metrics.transition(src, HOT)
        self.metrics.promoted(src, time.perf_counter() - t0)
        self._refresh_gauges()
        return i

    def _alloc_slot(self, guid: str) -> int:
        """A free slot for ``guid``, evicting the coldest eligible hot
        doc when the provider is full; registers the slot maps."""
        prov = self.provider
        if prov._free:
            i = prov._free.pop()
        elif prov._next < prov.engine.n_docs:
            i = prov._next
            prov._next += 1
        else:
            if not self.make_room():
                from ..provider import ProviderFullError

                raise ProviderFullError(
                    f"provider is full ({prov.engine.n_docs} docs) and "
                    f"no hot doc is evictable (all pinned by fallback/"
                    f"observers/quarantine); cannot admit {guid!r}"
                )
            i = prov._free.pop()
        prov._guids[guid] = i
        prov._guid_of[i] = guid
        return i

    def make_room(self) -> bool:
        """Demote the coldest eligible hot doc to warm (the auto-evict
        behind ``doc_id``); False when nothing is evictable."""
        prov = self.provider
        eng = prov.engine
        prov.flush()
        sessioned = {g for (g, _p) in getattr(prov, "_sessions", {})}
        eligible = [
            g
            for g, i in prov._guids.items()
            if i not in eng.fallback
            and i not in eng._event_listeners
            and not eng.mirrors[i]._incoming
        ]
        if not eligible:
            return False
        now = self.heat._clock()
        eligible.sort(
            key=lambda g: (g in sessioned, self.heat.score(g, now), g)
        )
        self.demote(eligible[0], WARM)
        self.metrics.evicted()
        return True

    def _cold_update(self, guid: str, e: _ColdEntry) -> bytes:
        if e.blob is not None:
            return zlib.decompress(e.blob)
        path, offset, length = e.ref
        with open(path, "rb") as f:
            f.seek(offset)
            buf = f.read(length)
        status, rec, _end = try_decode_at(buf, 0)
        if status != "ok" or rec.kind != KIND_TIER:
            raise RuntimeError(
                f"cold record for {guid!r} unreadable at "
                f"{path}:{offset} ({status})"
            )
        _meta, update = decode_tier_payload(rec.payload)
        return update

    # -- release / checkpoint / recovery ------------------------------------

    def release(self, guid: str):
        """Drop a DEMOTED doc for good: returns ``(final_state_bytes,
        letters)`` or None when the guid holds no demoted entry."""
        if guid in self.warm:
            e: _WarmEntry | _ColdEntry = self.warm.pop(guid)
            self._warm_bytes -= e.nbytes
            update = e.mirror.encode_state_as_update()
        elif guid in self.cold:
            e = self.cold.pop(guid)
            self._cold_bytes -= e.nbytes
            update = self._cold_update(guid, e)
        else:
            return None
        self.heat.forget(guid)
        self._refresh_gauges()
        return update, e.letters

    def forget(self, guid: str) -> None:
        """Heat bookkeeping for a doc released from the hot tier."""
        self.heat.forget(guid)

    def adopt_heat(self, guid: str, score: float) -> None:
        """Carry a migrated/recovered doc's heat across providers."""
        if self.config.enabled and score > 0.0:
            self.heat.set(guid, score)

    def demoted_snapshots(self) -> list[tuple[str, bytes]]:
        """(guid, full-state bytes) for every demoted doc — they join
        the hot docs in the provider checkpoint so compaction covers
        all tiers.  Cold locators are materialized into blobs here,
        BEFORE ``wal.checkpoint`` deletes the segments they point at;
        :meth:`rejournal` re-anchors them afterwards."""
        out = []
        for guid in sorted(self.warm):
            out.append(
                (guid, self.warm[guid].mirror.encode_state_as_update())
            )
        for guid in sorted(self.cold):
            e = self.cold[guid]
            update = self._cold_update(guid, e)
            if e.blob is None:
                e.blob = zlib.compress(update)
            out.append((guid, update))
        return out

    def rejournal(self) -> None:
        """Re-append every demote marker after a checkpoint (the
        ack-floor idiom): compaction deleted the segments the markers —
        and the cold locators — lived in."""
        wal = self.provider.wal
        if wal is None:
            return
        for guid in sorted(self.warm):
            e = self.warm[guid]
            wal.append(
                KIND_TIER,
                guid,
                encode_tier_payload(
                    WARM,
                    self.heat.score(guid),
                    e.mirror.encode_state_as_update(),
                    e.letters,
                ),
            )
        for guid in sorted(self.cold):
            ce = self.cold[guid]
            update = self._cold_update(guid, ce)
            ref = wal.append(
                KIND_TIER,
                guid,
                encode_tier_payload(
                    COLD, self.heat.score(guid), update, ce.letters
                ),
            )
            self._cold_bytes += ref[2] - ce.nbytes
            ce.ref = ref
            ce.nbytes = ref[2]
            ce.blob = None

    def place_recovered(self, markers: dict) -> dict:
        """Post-replay tier placement: demote each doc whose LAST WAL
        record is a standing demote marker (recovery replayed its state
        hot first).  Returns ``{guid: tier}`` for the docs placed."""
        placed: dict[str, str] = {}
        prov = self.provider
        for guid in sorted(markers):
            meta = markers[guid]
            tier = meta.get("tier")
            if tier not in (WARM, COLD):
                continue
            if guid not in prov._guids:
                continue
            self.heat.set(guid, float(meta.get("heat", 0.0)))
            # the recorded letters return to the slot first, so the
            # demote scoops them together with anything replay itself
            # dead-lettered there
            _restore_letters(
                meta.get("letters") or [],
                prov._guids[guid],
                prov.engine.dead_letters,
            )
            try:
                self.demote(guid, tier)
            except (ValueError, RuntimeError):
                continue  # pinned (fallback/observers): stays hot
            # a cold request can legitimately settle warm (parked deps)
            placed[guid] = self.tier_of(guid) or tier
        return placed

    # -- GC / maintenance ----------------------------------------------------

    def gc_pass(self, max_docs: int | None = None) -> dict:
        """Forced tombstone/GC compaction over qualifying hot docs (≥
        ``gc_min_rows`` rows, ≥ ``gc_deleted_ratio`` deleted) — the
        long-lived-hot-doc bound the amortized doubling pass misses."""
        out = {"docs": 0, "rows_reclaimed": 0, "bytes_reclaimed": 0}
        if not self.config.enabled:
            return out
        prov = self.provider
        eng = prov.engine
        prov.flush()
        cfg = self.config
        cand = []
        for guid in sorted(prov._guids):
            i = prov._guids[guid]
            if i in eng.fallback or eng.mirrors[i]._incoming:
                continue
            m = eng.mirrors[i]
            if m.n_rows < cfg.gc_min_rows:
                continue
            if m.deleted_ratio() < cfg.gc_deleted_ratio:
                continue
            cand.append(i)
        limit = cfg.gc_max_docs if max_docs is None else max_docs
        if limit:
            cand = cand[:limit]
        if not cand:
            return out
        before = sum(eng.mirrors[i].host_nbytes() for i in cand)
        stats = eng.compact_docs(cand, gc=True)
        after = sum(eng.mirrors[i].host_nbytes() for i in cand)
        out["docs"] = len(stats)
        out["rows_reclaimed"] = max(
            0, sum(s["rows_before"] - s["rows_after"] for s in stats)
        )
        out["bytes_reclaimed"] = max(0, before - after)
        self.metrics.gc(out["rows_reclaimed"], out["bytes_reclaimed"])
        return out

    def tick(self) -> dict:
        """One background maintenance pass: warm-bound spill + GC."""
        if not self.config.enabled:
            return {"docs": 0, "rows_reclaimed": 0, "bytes_reclaimed": 0}
        self._enforce_warm_bound()
        out = self.gc_pass()
        self._refresh_gauges()
        return out

    # -- exposition ----------------------------------------------------------

    def _refresh_gauges(self) -> None:
        self.metrics.occupancy(
            {
                HOT: len(self.provider._guids),
                WARM: len(self.warm),
                COLD: len(self.cold),
            },
            {
                HOT: 0,
                WARM: max(0, self._warm_bytes),
                COLD: max(0, self._cold_bytes),
            },
        )

    def snapshot(self) -> dict:
        """JSON-able tier state (rides ``provider.metrics_snapshot``)."""
        self._refresh_gauges()
        hot = len(self.provider._guids)
        return {
            "enabled": self.config.enabled,
            "hot": hot,
            "warm": len(self.warm),
            "cold": len(self.cold),
            "resident": hot + len(self.warm) + len(self.cold),
            "capacity": self.provider.engine.n_docs,
            "warm_bytes": max(0, self._warm_bytes),
            "cold_bytes": max(0, self._cold_bytes),
            "config": self.config.as_dict(),
        }
