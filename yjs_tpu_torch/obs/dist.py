"""Distributed causal tracing: compact trace contexts propagated across
providers.

A :class:`TraceContext` is a Dapper-style triple — 16-byte trace id,
8-byte span id, 1-byte flags — minted at ingress (``receive_update`` /
session DATA / the fleet router seam) and carried to every downstream
seam two ways:

- **in-process** via a :mod:`contextvars` slot (:func:`use_context` /
  :func:`current_context`), so admission queues, replication fan-out,
  and flush visibility all see the ingress context without any
  signature churn; and
- **across peers** as an optional trailing key on the type-121 session
  DATA envelope (see ``sync/session.py``).  Readers older than this PR
  read only ``seq`` + ``inner`` and never touch trailing decoder bytes,
  and stock y-protocols v13.4.9 readers skip the whole unknown type-121
  message — zero wire change.

Trace identity is **deterministic**: the trace id is a keyed blake2b of
the raw update bytes, so two providers that each see the same update
independently compute the SAME trace id even before the envelope carry
reaches them — cross-provider stitching degrades gracefully instead of
breaking.  Sampling is equally deterministic (a residue test on the
trace-id integer, ``YTPU_TRACE_SAMPLE``, default 1-in-64), so every
peer makes the same keep/drop decision for a given update with no
coordination.  DLQ / rollback / failover paths force-sample
(:meth:`TraceContext.force`) so every failure has a trace.

Flow-arrow ids are derived from the same hash space
(:func:`flow_id_for`), replacing an earlier process-global
``itertools.count`` that could collide after ``YTPU_TRACE_EVENTS`` cap
truncation: a hash-derived id is stable under truncation and across
processes.
"""

from __future__ import annotations

import contextvars
import os
from contextlib import contextmanager
from hashlib import blake2b
from typing import Optional

from .registry import MetricsRegistry

__all__ = [
    "TraceContext",
    "current_context",
    "use_context",
    "mint_for_update",
    "flow_id_for",
    "sample_rate",
    "trace_metrics",
]

# wire layout: 16-byte trace id (BE) + 8-byte span id (BE) + 1 flag byte
TRACE_CTX_LEN = 25
_FLAG_SAMPLED = 0x01
_PERSON = b"ytpu-trace"


def sample_rate() -> int:
    """Head-sampling rate from ``YTPU_TRACE_SAMPLE``: ``N`` keeps one
    trace in N (default 64), ``1`` samples everything, ``0`` disables
    head sampling entirely (forced samples still trace)."""
    try:
        return max(0, int(os.environ.get("YTPU_TRACE_SAMPLE", "64")))
    except (TypeError, ValueError):
        return 64


def _head_sampled(trace_id: int) -> bool:
    rate = sample_rate()
    if rate == 0:
        return False
    if rate <= 1:
        return True
    return trace_id % rate == 0


class TraceContext:
    """One update's causal identity: ``(trace_id, span_id, sampled)``."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: int, span_id: int, sampled: bool):
        self.trace_id = trace_id & ((1 << 128) - 1)
        self.span_id = span_id & ((1 << 64) - 1)
        self.sampled = bool(sampled)

    # -- wire --------------------------------------------------------------

    def to_bytes(self) -> bytes:
        flags = _FLAG_SAMPLED if self.sampled else 0
        return (
            self.trace_id.to_bytes(16, "big")
            + self.span_id.to_bytes(8, "big")
            + bytes((flags,))
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> Optional["TraceContext"]:
        """Parse a wire blob; returns ``None`` on any shape mismatch
        (future flag bytes may extend the blob — only the 25-byte
        prefix is interpreted)."""
        if not isinstance(raw, (bytes, bytearray)) or len(raw) < TRACE_CTX_LEN:
            return None
        return cls(
            int.from_bytes(raw[:16], "big"),
            int.from_bytes(raw[16:24], "big"),
            bool(raw[24] & _FLAG_SAMPLED),
        )

    # -- identity ----------------------------------------------------------

    @property
    def trace_hex(self) -> str:
        return f"{self.trace_id:032x}"

    @property
    def span_hex(self) -> str:
        return f"{self.span_id:016x}"

    @property
    def flow_id(self) -> int:
        """A Perfetto flow id for this trace (low 48 bits of the trace
        id — JSON-safe, stable across peers and cap truncation)."""
        return (self.trace_id & ((1 << 48) - 1)) or 1

    def child(self, seed: str) -> "TraceContext":
        """A deterministic child span of this trace (same trace id and
        sampled bit; the span id is re-derived from ``seed``)."""
        h = blake2b(digest_size=8, person=_PERSON)
        h.update(self.span_id.to_bytes(8, "big"))
        h.update(seed.encode("utf-8", "replace"))
        return TraceContext(
            self.trace_id, int.from_bytes(h.digest(), "big"), self.sampled
        )

    def force(self, reason: str = "") -> "TraceContext":
        """Force-sample this trace (DLQ / rollback / failover paths —
        every failure gets a trace regardless of the head-sample
        draw)."""
        if self.sampled:
            return self
        if reason:
            trace_metrics().forced.labels(reason=reason).inc()
        return TraceContext(self.trace_id, self.span_id, True)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"TraceContext({self.trace_hex[:8]}…/{self.span_hex[:8]}…"
            f"{' sampled' if self.sampled else ''})"
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TraceContext)
            and self.trace_id == other.trace_id
            and self.span_id == other.span_id
            and self.sampled == other.sampled
        )

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id, self.sampled))


def mint_for_update(update: bytes, salt: bytes = b"") -> TraceContext:
    """Deterministically mint the :class:`TraceContext` for one raw
    update: every provider that hashes the same bytes computes the same
    trace id and the same sampling verdict."""
    h = blake2b(digest_size=24, person=_PERSON)
    h.update(bytes(update))
    if salt:
        h.update(salt)
    d = h.digest()
    trace_id = int.from_bytes(d[:16], "big")
    return TraceContext(
        trace_id, int.from_bytes(d[16:24], "big"), _head_sampled(trace_id)
    )


def flow_id_for(key) -> int:
    """A collision-resistant Perfetto flow id for an arbitrary hashable
    key (e.g. the SLO ``(client, clock)`` update key).  Hash-derived, so
    it stays stable after tracer-ring truncation and matches across
    providers — unlike a process-global counter."""
    h = blake2b(repr(key).encode("utf-8", "replace"), digest_size=6,
                person=_PERSON)
    return int.from_bytes(h.digest(), "big") or 1


# -- in-process propagation ---------------------------------------------------

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "ytpu_trace_context", default=None
)


def current_context() -> Optional[TraceContext]:
    """The trace context of the in-flight ingress call, if any."""
    return _CURRENT.get()


@contextmanager
def use_context(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the current trace context for the body (a
    ``None`` ctx clears it, isolating nested ingress paths)."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


# -- metrics ------------------------------------------------------------------


class _TraceMetrics:
    """``ytpu_trace_*`` families on the process-global registry."""

    def __init__(self, registry: MetricsRegistry) -> None:
        self.contexts = registry.counter(
            "ytpu_trace_contexts_total",
            "Trace contexts established at ingress, by origin "
            "(minted = hashed locally, adopted = carried in on the "
            "session envelope / in-process propagation)",
            labelnames=("origin",),
        )
        self.sampled = registry.counter(
            "ytpu_trace_sampled_total",
            "Ingress trace contexts whose head-sample draw kept them",
        )
        self.forced = registry.counter(
            "ytpu_trace_forced_total",
            "Trace contexts force-sampled by a failure path "
            "(dlq / rollback / failover / quarantine)",
            labelnames=("reason",),
        )
        self.carried = registry.counter(
            "ytpu_trace_carried_total",
            "Trace contexts carried on session DATA envelopes, by "
            "direction",
            labelnames=("dir",),
        )


_METRICS: Optional[_TraceMetrics] = None


def trace_metrics() -> _TraceMetrics:
    """Lazily register the ``ytpu_trace_*`` families (idempotent; the
    global registry dedupes by name)."""
    global _METRICS
    if _METRICS is None:
        from . import global_registry

        _METRICS = _TraceMetrics(global_registry())
    return _METRICS
