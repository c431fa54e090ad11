"""Per-doc heat: exponentially-decayed touch counters.

Every provider seam that means "someone cares about this doc right now"
— ``doc_id`` resolution, update receive, session admission — feeds a
weighted touch.  Heat decays continuously with a configurable half-life,
so "touched 50 times an hour ago" loses to "touched twice just now"
once the half-life has passed.  The score is the tiering policy's only
input: demotion victims are the coldest eligible docs, the fleet
rebalancer sheds the coldest rooms first, and a migrated or recovered
doc carries its heat along so it lands in the tier it deserves.

The tracker is pure host-side bookkeeping — a dict of
``guid -> (heat, last_touch_ts)`` — and decays lazily at read time
(``0.5 ** (dt / half_life)``), so an idle fleet pays nothing.  The
clock is injectable for deterministic tests.
"""

from __future__ import annotations

import time
from collections.abc import Iterable


class HeatTracker:
    """Decayed per-guid touch counters with an injectable clock."""

    __slots__ = ("half_life_s", "_clock", "_h")

    def __init__(self, half_life_s: float = 300.0, clock=None):
        self.half_life_s = max(1e-6, float(half_life_s))
        self._clock = clock if clock is not None else time.monotonic
        self._h: dict[str, tuple[float, float]] = {}

    def __len__(self) -> int:
        return len(self._h)

    def __contains__(self, guid: str) -> bool:
        return guid in self._h

    def touch(self, guid: str, weight: float = 1.0) -> float:
        """Fold one access of ``weight`` into the doc's decayed score."""
        now = self._clock()
        prev = self._h.get(guid)
        if prev is None:
            heat = float(weight)
        else:
            h, ts = prev
            heat = h * 0.5 ** ((now - ts) / self.half_life_s) + weight
        self._h[guid] = (heat, now)
        return heat

    def score(self, guid: str, now: float | None = None) -> float:
        """Current decayed heat; 0.0 for a never-touched doc."""
        rec = self._h.get(guid)
        if rec is None:
            return 0.0
        h, ts = rec
        if now is None:
            now = self._clock()
        return h * 0.5 ** (max(0.0, now - ts) / self.half_life_s)

    def set(self, guid: str, heat: float) -> None:
        """Adopt an externally-carried score (migration / recovery)."""
        self._h[guid] = (max(0.0, float(heat)), self._clock())

    def forget(self, guid: str) -> None:
        self._h.pop(guid, None)

    def coldest(self, guids: Iterable[str]) -> list[str]:
        """``guids`` ordered coldest-first (score, then guid — the tie
        break keeps eviction deterministic for never-touched docs)."""
        now = self._clock()
        return sorted(guids, key=lambda g: (self.score(g, now), g))
