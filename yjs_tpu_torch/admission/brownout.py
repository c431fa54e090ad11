"""Adaptive brownout controller: deterministic, hysteresis-gated
degradation levels.

Levels (each one strictly widens the previous level's shedding):

====  ================  ====================================================
 0    normal            full service
 1    shed-background   anti-entropy digests and digest repair paused,
                        flush tick widened (advisory ``flush_interval_scale``)
 2    coalesce          lagging-style delta coalescing forced on all peers
 3    reject-writes     new writes refused with retry-after; reads and
                        sync-step1 still served
====  ================  ====================================================

Transitions move ONE level at a time and are gated by consecutive-streak
hysteresis: the overload signal must point above the current level for
``up_ticks`` consecutive ticks to escalate, and below it for
``down_ticks`` consecutive ticks to recover — so a borderline signal
cannot flap the fleet between levels.  Every transition is pushed through
``on_transition`` (the admission controller journals it to each attached
provider's WAL and bumps ``ytpu_adm_transitions_total``) and kept in a
bounded in-memory ring for snapshots.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

__all__ = [
    "NORMAL",
    "SHED_BACKGROUND",
    "COALESCE",
    "REJECT_WRITES",
    "LEVEL_NAMES",
    "BrownoutController",
]

NORMAL = 0
SHED_BACKGROUND = 1
COALESCE = 2
REJECT_WRITES = 3

LEVEL_NAMES = ("normal", "shed-background", "coalesce", "reject-writes")

# advisory flush-cadence multiplier per level: hosts that own their flush
# cadence (loadgen, external tickers) widen the tick by this factor
FLUSH_SCALE = (1.0, 2.0, 4.0, 4.0)


class BrownoutController:
    """Hysteresis-gated level ladder driven by ``observe(target)``.

    ``observe`` is called once per controller tick with the *target*
    level the raw overload signals currently point at; the controller
    steps its actual level toward the target at most one rung per call,
    after the streak thresholds are met.
    """

    def __init__(
        self,
        up_ticks: int = 2,
        down_ticks: int = 8,
        on_transition: Optional[Callable[[int, int, str, int], None]] = None,
        history: int = 64,
    ) -> None:
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.on_transition = on_transition
        self.level = NORMAL
        self.ticks_at_level = 0
        self.n_transitions = 0
        self.transitions: deque = deque(maxlen=max(1, int(history)))
        self._tick = 0
        self._up_streak = 0
        self._down_streak = 0

    @property
    def level_name(self) -> str:
        return LEVEL_NAMES[self.level]

    def observe(self, target: int, reason: str = "") -> int:
        """Advance one tick with the signal-derived target level."""
        target = max(NORMAL, min(REJECT_WRITES, int(target)))
        self._tick += 1
        self.ticks_at_level += 1
        if target > self.level:
            self._down_streak = 0
            self._up_streak += 1
            if self._up_streak >= self.up_ticks:
                self._step(self.level + 1, reason or "overload")
        elif target < self.level:
            self._up_streak = 0
            self._down_streak += 1
            if self._down_streak >= self.down_ticks:
                self._step(self.level - 1, reason or "recovered")
        else:
            self._up_streak = 0
            self._down_streak = 0
        return self.level

    def _step(self, new_level: int, reason: str) -> None:
        old = self.level
        self.level = new_level
        self.ticks_at_level = 0
        self._up_streak = 0
        self._down_streak = 0
        self.n_transitions += 1
        self.transitions.append(
            {
                "tick": self._tick,
                "from": LEVEL_NAMES[old],
                "to": LEVEL_NAMES[new_level],
                "reason": reason,
            }
        )
        if self.on_transition is not None:
            self.on_transition(old, new_level, reason, self._tick)

    def force(self, level: int, reason: str = "forced") -> None:
        """Jump directly to a level (recovery/testing); still journaled."""
        level = max(NORMAL, min(REJECT_WRITES, int(level)))
        if level != self.level:
            self._step(level, reason)

    def snapshot(self) -> dict:
        return {
            "level": self.level,
            "level_name": self.level_name,
            "ticks_at_level": self.ticks_at_level,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            "n_transitions": self.n_transitions,
            "transitions": list(self.transitions),
        }
