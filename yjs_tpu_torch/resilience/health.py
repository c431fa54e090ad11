"""Per-doc health state machine: healthy → degraded → quarantined.

Drives admission control for the engine's update path.  Failures
(validation, integration, CPU-apply) push a doc toward quarantine;
while quarantined its traffic is diverted to the dead-letter queue so
repeated poison cannot re-enter the flush pipeline.  Backoff is counted
in FLUSH TICKS, not wall time, so recovery behavior is deterministic
under test (the engine bumps the tick once per flush).

State transitions:

- ``healthy``: the default; healthy docs carry NO tracker state (the
  hot path pays one empty-dict check per admission).
- ``degraded``: at least one recent failure (below the quarantine
  threshold), or a quarantined doc on re-admission probation.
  ``YTPU_RESILIENCE_RECOVERY`` consecutive successes return it to
  healthy (and free its record).
- ``quarantined``: ``YTPU_RESILIENCE_THRESHOLD`` consecutive failures.
  Inadmissible until ``base * 2**(n_quarantines-1)`` flush ticks pass
  (capped at ``YTPU_RESILIENCE_BACKOFF_CAP``) — each repeat quarantine
  doubles the sentence, the classic exponential-backoff re-admission.
"""

from __future__ import annotations

import os

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"


def _env_int(name: str, default: int, lo: int = 1, hi: int = 1 << 30) -> int:
    try:
        return max(lo, min(hi, int(os.environ.get(name, default))))
    except ValueError:
        return default


class DocHealth:
    """Mutable health record of one tracked (non-healthy) doc."""

    __slots__ = (
        "doc",
        "state",
        "consecutive_failures",
        "total_failures",
        "successes",
        "n_quarantines",
        "quarantined_until",
        "last_reason",
    )

    def __init__(self, doc: int):
        self.doc = doc
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.total_failures = 0
        self.successes = 0
        self.n_quarantines = 0
        self.quarantined_until = 0
        self.last_reason: str | None = None

    def as_dict(self) -> dict:
        return {
            "doc": self.doc,
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "total_failures": self.total_failures,
            "n_quarantines": self.n_quarantines,
            "quarantined_until": self.quarantined_until,
            "last_reason": self.last_reason,
        }


class HealthTracker:
    """Admission control + failure accounting over a doc fleet.

    ``obs`` (a :class:`yjs_tpu.obs.EngineObs`, optional) receives gauge
    updates (degraded/quarantined doc counts) and re-admission counts;
    the tracker itself stays import-light and fully functional when obs
    is disabled.
    """

    def __init__(
        self,
        threshold: int | None = None,
        backoff_base: int | None = None,
        backoff_cap: int | None = None,
        recovery: int | None = None,
        obs=None,
    ):
        self.threshold = (
            threshold
            if threshold is not None
            else _env_int("YTPU_RESILIENCE_THRESHOLD", 3)
        )
        self.backoff_base = (
            backoff_base
            if backoff_base is not None
            else _env_int("YTPU_RESILIENCE_BACKOFF", 4)
        )
        self.backoff_cap = (
            backoff_cap
            if backoff_cap is not None
            else _env_int("YTPU_RESILIENCE_BACKOFF_CAP", 256)
        )
        self.recovery = (
            recovery
            if recovery is not None
            else _env_int("YTPU_RESILIENCE_RECOVERY", 2)
        )
        self._obs = obs
        self._tick = 0
        # ONLY non-healthy docs have records: admission for a healthy
        # fleet is one falsy-dict check, no per-doc state
        self._docs: dict[int, DocHealth] = {}

    # -- clock ---------------------------------------------------------------

    @property
    def tick_count(self) -> int:
        return self._tick

    def tick(self) -> None:
        """One engine flush happened (the backoff clock)."""
        self._tick += 1

    # -- queries -------------------------------------------------------------

    @property
    def tracked(self) -> bool:
        """True when ANY doc is non-healthy (hot-path early-out)."""
        return bool(self._docs)

    def state(self, doc: int) -> str:
        h = self._docs.get(doc)
        return HEALTHY if h is None else h.state

    def record(self, doc: int) -> dict:
        h = self._docs.get(doc)
        if h is None:
            return DocHealth(doc).as_dict()
        return h.as_dict()

    def records(self) -> list[dict]:
        """Health records of every tracked (non-healthy) doc."""
        return [h.as_dict() for h in self._docs.values()]

    def reset(self, doc: int | None = None) -> None:
        """Operator override: forget health records (one doc, or all)
        — the doc(s) return to healthy with no backoff memory."""
        if doc is None:
            self._docs.clear()
        else:
            self._docs.pop(doc, None)
        self._push_gauges()

    def summary(self) -> dict:
        states = [h.state for h in self._docs.values()]
        return {
            "degraded": states.count(DEGRADED),
            "quarantined": states.count(QUARANTINED),
            "tick": self._tick,
        }

    # -- transitions ---------------------------------------------------------

    def admissible(self, doc: int) -> bool:
        """May this doc's traffic enter the engine right now?

        Quarantined docs become admissible again once their backoff
        expires — re-admission is lazy (checked here, at the moment
        traffic arrives) and lands the doc in ``degraded`` probation, so
        one more failure re-quarantines it with a doubled sentence.
        """
        h = self._docs.get(doc)
        if h is None or h.state != QUARANTINED:
            return True
        if self._tick < h.quarantined_until:
            return False
        h.state = DEGRADED
        h.consecutive_failures = 0
        h.successes = 0
        if self._obs is not None:
            self._obs.readmitted()
        self._push_gauges()
        return True

    def record_failure(self, doc: int, reason: str) -> str:
        """One failure for ``doc``; returns the resulting state."""
        h = self._docs.get(doc)
        if h is None:
            h = self._docs[doc] = DocHealth(doc)
        h.consecutive_failures += 1
        h.total_failures += 1
        h.successes = 0
        h.last_reason = reason
        if h.consecutive_failures >= self.threshold:
            h.state = QUARANTINED
            h.n_quarantines += 1
            backoff = min(
                self.backoff_cap,
                self.backoff_base * (1 << (h.n_quarantines - 1)),
            )
            h.quarantined_until = self._tick + backoff
            from ..obs.blackbox import flight_recorder
            from ..obs.dist import current_context

            ctx = current_context()
            if ctx is not None:
                ctx = ctx.force("quarantine")
            bb = flight_recorder()
            bb.record(
                "resilience", "quarantine", severity="error",
                trace=ctx.trace_hex if ctx is not None else None,
                doc=doc, reason=reason, backoff_ticks=backoff,
                n_quarantines=h.n_quarantines,
            )
            bb.dump("quarantine", doc=doc, cause=reason)
        else:
            h.state = DEGRADED
        self._push_gauges()
        return h.state

    def record_success(self, doc: int) -> None:
        """One successful apply/flush for a TRACKED doc (no-op for
        healthy docs — call under a ``tracked`` guard on hot paths)."""
        h = self._docs.get(doc)
        if h is None or h.state == QUARANTINED:
            return
        h.consecutive_failures = 0
        h.successes += 1
        if h.successes >= self.recovery:
            del self._docs[doc]  # back to healthy: record freed
        self._push_gauges()

    def _push_gauges(self) -> None:
        if self._obs is not None:
            s = self.summary()
            self._obs.health_gauges(s["degraded"], s["quarantined"])
