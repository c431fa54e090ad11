"""Bounded flush-history ring: the last N per-flush metric dicts.

Supersedes the overwrite-only ``last_flush_metrics`` — the engine now
appends every flush's metrics dict here, and ``last_flush_metrics``
remains as a compatibility view of the newest entry (the SAME dict
object, not a copy; ``snapshot()`` returns copies for export).
"""

from __future__ import annotations

import os
import threading
from collections import deque

DEFAULT_HISTORY = 128


def history_len_from_env() -> int:
    """Ring capacity: ``YTPU_OBS_HISTORY`` (default 128, min 1)."""
    try:
        return max(1, int(os.environ.get("YTPU_OBS_HISTORY", DEFAULT_HISTORY)))
    except ValueError:
        return DEFAULT_HISTORY


class FlushHistory:
    """FIFO ring of per-flush metric dicts (oldest evicted first).

    ``append`` and ``snapshot`` are lock-guarded: exposition scrapes run
    from other threads while a flush appends, and deque iteration raises
    on concurrent mutation (a torn scrape, not just a stale one)."""

    __slots__ = ("_ring", "total", "_lock")

    def __init__(self, maxlen: int | None = None):
        if maxlen is None:
            maxlen = history_len_from_env()
        self._ring: deque = deque(maxlen=maxlen)
        # flushes ever recorded (monotonic; ring length caps at maxlen)
        self.total = 0
        self._lock = threading.Lock()

    @property
    def maxlen(self) -> int:
        # the deque binding is final and .maxlen is immutable
        return self._ring.maxlen  # ytpu-lint: disable=lock-discipline -- reads an immutable attribute of a never-rebound deque

    @property
    def latest(self) -> dict | None:
        """The newest entry itself — the ``last_flush_metrics`` alias."""
        with self._lock:
            return self._ring[-1] if self._ring else None

    def append(self, metrics: dict) -> None:
        with self._lock:
            self._ring.append(metrics)
            self.total += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def __iter__(self):
        # iterate a point-in-time copy: deque iteration raises if a
        # concurrent flush appends mid-walk (a torn scrape)
        with self._lock:
            return iter(tuple(self._ring))

    def __getitem__(self, i):
        with self._lock:
            return self._ring[i]

    def snapshot(self) -> list[dict]:
        """Oldest-to-newest copies, safe to serialize or mutate."""
        with self._lock:
            return [dict(m) for m in self._ring]
