"""Token buckets and weighted-fair queuing for the admission seam.

Two small deterministic primitives used by the fleet-wide admission
controller:

- ``TokenBucket`` — tick-based rate limiter with lazy refill (no per-tick
  sweep over idle buckets; refill is computed from the tick delta at the
  moment of use, so 100k mostly-idle doc buckets cost nothing).
- ``WeightedFairQueue`` — classic virtual-finish-time WFQ over tenants.
  Deterministic: ties broken by arrival sequence number, never by dict
  order or object identity, so a seeded overload run drains in exactly
  the same order every time.

``AdmissionRejected`` is the typed veto outcome: callers either handle it
(session paths convert it into a BUSY frame) or it propagates to the
client that offered the update — it is never silently dropped.
"""

from __future__ import annotations

import heapq
from typing import Any

__all__ = ["AdmissionRejected", "TokenBucket", "WeightedFairQueue"]


class AdmissionRejected(RuntimeError):
    """An inbound update was refused by admission control.

    Carries enough structure for callers to respond cooperatively:
    ``reason`` is one of ``"rate-limit"``/``"queue-full"``/
    ``"reject-writes"`` and ``retry_after`` is the suggested backoff in
    ticks (rides the wire inside the BUSY envelope frame).
    """

    def __init__(
        self, guid: str, tenant: str, reason: str, retry_after: int
    ) -> None:
        super().__init__(
            f"admission rejected update for {guid!r} "
            f"(tenant {tenant!r}): {reason}; retry after "
            f"{int(retry_after)} ticks"
        )
        self.guid = guid
        self.tenant = tenant
        self.reason = reason
        self.retry_after = int(retry_after)


class TokenBucket:
    """Tick-based token bucket with lazy refill.

    ``refill_to(tick)`` advances the bucket to the given tick, adding
    ``rate`` tokens per elapsed tick up to ``burst``.  Callers refill
    before ``peek``/``take`` so idle buckets need no per-tick sweep.
    """

    __slots__ = ("rate", "burst", "tokens", "tick")

    def __init__(self, rate: float, burst: float, tick: int = 0) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.tick = int(tick)

    def refill_to(self, tick: int) -> None:
        if tick > self.tick:
            self.tokens = min(
                self.burst, self.tokens + self.rate * (tick - self.tick)
            )
            self.tick = tick

    def peek(self, cost: float = 1.0) -> bool:
        return self.tokens >= cost

    def take(self, cost: float = 1.0) -> bool:
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def snapshot(self) -> dict:
        return {
            "rate": self.rate,
            "burst": self.burst,
            "tokens": self.tokens,
            "tick": self.tick,
        }


class WeightedFairQueue:
    """Virtual-finish-time weighted-fair queue over tenants.

    Each pushed item is stamped with a virtual finish time
    ``max(vtime, tenant_last_finish) + cost / weight``; pops return the
    smallest finish time, with the (finish, arrival-seq) pair as a total
    order so equal-weight tenants interleave round-robin
    deterministically.  A heavier weight drains proportionally faster; an
    abusive tenant flooding the queue only delays its own backlog.
    """

    __slots__ = ("_heap", "_seq", "_vtime", "_tenant_finish", "_depths")

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, str, Any]] = []
        self._seq = 0
        self._vtime = 0.0
        self._tenant_finish: dict[str, float] = {}
        self._depths: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._heap)

    def push(
        self, tenant: str, item: Any, cost: float = 1.0, weight: float = 1.0
    ) -> None:
        start = max(self._vtime, self._tenant_finish.get(tenant, 0.0))
        finish = start + cost / max(1e-9, float(weight))
        self._tenant_finish[tenant] = finish
        self._seq += 1
        heapq.heappush(self._heap, (finish, self._seq, tenant, item))
        self._depths[tenant] = self._depths.get(tenant, 0) + 1

    def pop(self) -> tuple[str, Any]:
        finish, _seq, tenant, item = heapq.heappop(self._heap)
        self._vtime = max(self._vtime, finish)
        n = self._depths.get(tenant, 1) - 1
        if n <= 0:
            self._depths.pop(tenant, None)
            self._tenant_finish.pop(tenant, None)
        else:
            self._depths[tenant] = n
        return tenant, item

    def drain(self) -> list[tuple[str, Any]]:
        out = []
        while self._heap:
            out.append(self.pop())
        return out

    def depth_of(self, tenant: str) -> int:
        return self._depths.get(tenant, 0)

    def snapshot(self) -> dict:
        return {
            "depth": len(self._heap),
            "by_tenant": dict(sorted(self._depths.items())),
        }
