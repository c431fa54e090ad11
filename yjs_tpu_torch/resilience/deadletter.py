"""Bounded dead-letter queue for rejected update bytes.

Every update the engine refuses to integrate — malformed bytes, CPU-apply
failures, traffic for a quarantined doc — lands here with its reason and
timestamp instead of being dropped, so operators can inspect what was
rejected and :meth:`~yjs_tpu.ops.engine.BatchEngine.replay_dead_letters`
it after a fix.  Capacity is bounded (``YTPU_DLQ_MAX``, default 1024
letters): at capacity the OLDEST letter is dropped and counted, so a
poison storm can never grow host memory without bound.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque


class DeadLetter:
    """One rejected update: the exact bytes plus rejection context."""

    __slots__ = ("seq", "doc", "update", "v2", "reason", "ts")

    def __init__(self, seq: int, doc: int, update: bytes, v2: bool,
                 reason: str, ts: float):
        self.seq = seq
        self.doc = doc
        self.update = update
        self.v2 = v2
        self.reason = reason
        self.ts = ts

    def as_dict(self) -> dict:
        """JSON-able view (bytes reported as a length, not inlined)."""
        return {
            "seq": self.seq,
            "doc": self.doc,
            "bytes": len(self.update),
            "v2": self.v2,
            "reason": self.reason,
            "ts": self.ts,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"DeadLetter(seq={self.seq}, doc={self.doc}, "
            f"bytes={len(self.update)}, reason={self.reason!r})"
        )


class DeadLetterQueue:
    """FIFO ring of :class:`DeadLetter` with O(1) bounded append.

    ``total``/``dropped`` counters are kept here (independent of the obs
    registry) so the queue stays fully observable under
    ``YTPU_OBS_DISABLED=1``.
    """

    def __init__(self, maxlen: int | None = None):
        if maxlen is None:
            try:
                maxlen = int(os.environ.get("YTPU_DLQ_MAX", "1024"))
            except ValueError:
                maxlen = 1024
        self.maxlen = max(1, maxlen)
        self._q: deque[DeadLetter] = deque()
        self._seq = itertools.count()
        self.total = 0
        self.dropped = 0

    def append(self, doc: int, update: bytes, v2: bool, reason: str) -> DeadLetter:
        entry = DeadLetter(
            next(self._seq), doc, bytes(update), bool(v2), reason, time.time()
        )
        self._q.append(entry)
        self.total += 1
        if len(self._q) > self.maxlen:
            self._q.popleft()
            self.dropped += 1
        return entry

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(list(self._q))

    def list(self, doc: int | None = None) -> list[DeadLetter]:
        """Letters oldest-first, optionally restricted to one doc."""
        if doc is None:
            return list(self._q)
        return [e for e in self._q if e.doc == doc]

    def take(
        self, doc: int | None = None, seqs=None, limit: int | None = None
    ) -> list[DeadLetter]:
        """Remove and return matching letters (oldest-first).

        ``doc`` restricts to one doc; ``seqs`` (an iterable of letter
        seq ids) restricts to specific letters.  Both None = drain all.
        ``limit`` caps how many matches are taken — excess matches stay
        queued (oldest taken first), so one replay invocation cannot
        stall a flush tick on an arbitrarily deep queue.
        """
        seq_set = None if seqs is None else set(seqs)
        taken: list[DeadLetter] = []
        kept: deque[DeadLetter] = deque()
        for e in self._q:
            if (
                (doc is None or e.doc == doc)
                and (seq_set is None or e.seq in seq_set)
                and (limit is None or len(taken) < limit)
            ):
                taken.append(e)
            else:
                kept.append(e)
        self._q = kept
        return taken

    def count_matching(self, doc: int | None = None, seqs=None) -> int:
        """Letters a ``take`` with the same filters would match."""
        seq_set = None if seqs is None else set(seqs)
        return sum(
            1
            for e in self._q
            if (doc is None or e.doc == doc)
            and (seq_set is None or e.seq in seq_set)
        )

    def snapshot(self, letters: bool = False) -> dict:
        """JSON-able summary for exposition/bench artifacts.

        ``letters=True`` additionally inlines every queued letter with
        its update bytes (base64) — the checkpoint-grade dump
        :meth:`restore` rebuilds from, so ``replay_dead_letters`` keeps
        working across a crash.  The default stays the small
        summary: exposition must not ship payload bytes."""
        out = {
            "depth": len(self._q),
            "capacity": self.maxlen,
            "total": self.total,
            "dropped": self.dropped,
            "reasons": self._reason_counts(),
        }
        if letters:
            import base64

            out["schema"] = 1
            out["letters"] = [
                {
                    "doc": e.doc,
                    "v2": e.v2,
                    "reason": e.reason,
                    "ts": e.ts,
                    "update": base64.b64encode(e.update).decode("ascii"),
                }
                for e in self._q
            ]
        return out

    def restore(self, state: dict) -> int:
        """Re-enqueue the letters of a :meth:`snapshot(letters=True)`
        dump (crash recovery).  Restored letters keep their original
        doc/bytes/v2/reason/timestamp but get fresh seq ids (seqs are a
        process-local handle, not a durable identity); ``total`` counts
        them again in this process's ledger.  Returns the number of
        letters restored (0 for a summary-only snapshot)."""
        import base64

        restored = 0
        for e in state.get("letters") or []:
            try:
                update = base64.b64decode(e["update"])
                doc = int(e.get("doc", -1))
            except (KeyError, TypeError, ValueError):
                continue
            entry = DeadLetter(
                next(self._seq),
                doc,
                update,
                bool(e.get("v2")),
                str(e.get("reason", "restored")),
                float(e.get("ts") or time.time()),
            )
            self._q.append(entry)
            self.total += 1
            restored += 1
            if len(self._q) > self.maxlen:
                self._q.popleft()
                self.dropped += 1
        return restored

    def _reason_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self._q:
            # group by the reason's stable prefix (before any exception
            # detail) so the summary stays small under poison storms
            key = e.reason.split(":", 1)[0]
            out[key] = out.get(key, 0) + 1
        return out
