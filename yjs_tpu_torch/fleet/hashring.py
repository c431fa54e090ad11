"""Consistent-hash doc→shard placement with bounded loads.

The ring is the classic Karger construction: every shard projects
``vnodes`` virtual points onto a 64-bit keyspace and a doc lands on the
first point clockwise of its own hash.  Two properties make it the
right router for a provider fleet:

- **determinism** — placement is a pure function of (guid, shard set,
  vnodes), so any process that knows the membership computes the same
  answer; no coordination service required;
- **minimal movement** — adding or removing a shard re-homes only the
  docs whose arc changed (~1/N of the fleet), which is exactly the
  churn bill a drain or scale-out should pay.

Plain consistent hashing still tolerates ~O(log N / log log N) skew, and
a skewed shard is not a cosmetic problem here: a full shard raises
``ProviderFullError``.  So placement uses the *bounded-load* variant
(Mirrokni et al., "Consistent Hashing with Bounded Loads"): a shard may
hold at most ``ceil(c · (docs+1) / N)`` docs (``c`` = load factor,
``YTPU_FLEET_LOAD_FACTOR``, default 1.25); a doc whose natural owner is
at the bound walks clockwise to the next shard under it — the hot shard
*sheds*, and placement degrades gracefully toward round-robin as the
fleet fills instead of tipping one shard over.

:class:`RoutingTable` is the *versioned* record of where every admitted
doc actually lives.  The ring proposes, the table remembers: migrations
and bounded-load shedding mean a doc's home can differ from its natural
ring owner, and the ``epoch`` counter (bumped on every membership or
ownership change) is what sessions carry so a peer can tell a stale
route from a current one.
"""

from __future__ import annotations

import bisect
import hashlib
import math
import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def stable_hash(key: str) -> int:
    """64-bit stable hash of a string key.

    blake2b, not ``hash()``: placement must agree across processes and
    Python's string hash is salted per-process (PYTHONHASHSEED).
    """
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """The consistent-hash ring over integer shard ids."""

    def __init__(self, shards=(), vnodes: int | None = None):
        self.vnodes = (
            vnodes
            if vnodes is not None
            else _env_int("YTPU_FLEET_VNODES", 64)
        )
        if self.vnodes < 1:
            raise ValueError(f"vnodes must be positive, got {self.vnodes}")
        self._shards: set[int] = set()
        self._points: list[tuple[int, int]] = []  # sorted (hash, shard)
        self._hashes: list[int] = []  # parallel keys for bisect
        for s in shards:
            self.add(int(s))

    def __contains__(self, shard: int) -> bool:
        return shard in self._shards

    def __len__(self) -> int:
        return len(self._shards)

    @property
    def shards(self) -> list[int]:
        return sorted(self._shards)

    def add(self, shard: int) -> None:
        if shard in self._shards:
            return
        self._shards.add(shard)
        for v in range(self.vnodes):
            h = stable_hash(f"shard-{shard}#{v}")
            bisect.insort(self._points, (h, shard))
        self._hashes = [h for h, _ in self._points]

    def remove(self, shard: int) -> None:
        if shard not in self._shards:
            return
        self._shards.discard(shard)
        self._points = [(h, s) for h, s in self._points if s != shard]
        self._hashes = [h for h, _ in self._points]

    def walk(self, guid: str):
        """Shards in ring order starting at the guid's point, each
        yielded once — the preference list bounded-load placement
        walks."""
        if not self._points:
            return
        i = bisect.bisect_right(self._hashes, stable_hash(guid))
        n = len(self._points)
        seen: set[int] = set()
        for k in range(n):
            s = self._points[(i + k) % n][1]
            if s not in seen:
                seen.add(s)
                yield s

    def owner(self, guid: str) -> int:
        """The natural (unbounded) ring owner."""
        for s in self.walk(guid):
            return s
        raise ValueError("empty ring")

    def place(
        self,
        guid: str,
        load,
        capacity,
        load_factor: float | None = None,
        exclude=(),
    ) -> tuple[int, bool]:
        """Bounded-load placement: ``(shard, shed)``.

        ``load(shard)`` / ``capacity(shard)`` are callables (the fleet
        passes live occupancy; the bench passes plain arrays).  The doc
        goes to the first shard in ring order that is under BOTH its
        hard capacity and the bounded-load ceiling
        ``ceil(c · (total+1) / N)``; ``shed`` is True when that was not
        the natural owner (the hot shard shed).  If every shard is at
        the ceiling the least-loaded shard with a free slot takes it;
        with no free slot anywhere the fleet is genuinely full and
        ``FleetFullError`` is raised.
        """
        c = (
            load_factor
            if load_factor is not None
            else _env_float("YTPU_FLEET_LOAD_FACTOR", 1.25)
        )
        live = [s for s in self._shards if s not in exclude]
        if not live:
            raise FleetFullError("no live shards in the ring")
        total = sum(load(s) for s in live)
        bound = math.ceil(c * (total + 1) / len(live))
        first = None
        for s in self.walk(guid):
            if s in exclude:
                continue
            if first is None:
                first = s
            if load(s) < min(capacity(s), bound):
                return s, (s != first)
        fallback = [s for s in live if load(s) < capacity(s)]
        if not fallback:
            raise FleetFullError(
                f"fleet is full ({total} docs across {len(live)} shards); "
                f"no shard has a free slot for {guid!r}"
            )
        return min(fallback, key=lambda s: (load(s), s)), True


class FleetFullError(ValueError):
    """Every live shard is at hard capacity — the fleet-level analogue
    of :class:`yjs_tpu_torch.provider.ProviderFullError` (both subclass
    ``ValueError``, so a caller's existing full-handling catches
    either).  Defined here, import-light, so the 100k-doc placement
    bench can drive the ring without touching the provider stack."""


class RoutingTable:
    """Versioned doc→shard assignment map.

    ``epoch`` increments on every ownership or membership change; it is
    the number sessions carry (``SyncSession.rehome``) so "which shard
    owns this doc" is always answerable as of a specific version, and a
    crash-recovered fleet can prove its view is newer than a peer's.
    """

    def __init__(self):
        self.epoch = 0
        self.assignments: dict[str, int] = {}

    def lookup(self, guid: str) -> int | None:
        return self.assignments.get(guid)

    def assign(self, guid: str, shard: int, bump: bool = False) -> None:
        self.assignments[guid] = shard
        if bump:
            self.epoch += 1

    def unassign(self, guid: str, bump: bool = False) -> None:
        self.assignments.pop(guid, None)
        if bump:
            self.epoch += 1

    def bump(self) -> int:
        self.epoch += 1
        return self.epoch

    def docs_on(self, shard: int) -> list[str]:
        return sorted(
            g for g, s in self.assignments.items() if s == shard
        )

    def snapshot(self) -> dict:
        per_shard: dict[int, int] = {}
        for s in self.assignments.values():
            per_shard[s] = per_shard.get(s, 0) + 1
        return {
            "epoch": self.epoch,
            "n_docs": len(self.assignments),
            "per_shard": per_shard,
        }
