"""Black-box flight recorder.

A lock-guarded bounded ring of structured events — monotonic tick,
subsystem, severity, doc/tenant/shard, trace id, kv payload — fed from
every seam that already emits tracer instants: demotions, rollbacks,
dead letters, brownout transitions, failover convictions, migration
windows, plan-cache poisons.  Always on (the steady-state cost is one
lock + one deque append per *rare* event), capped by
``YTPU_BLACKBOX_CAP`` so it can idle forever.

``dump(reason)`` snapshots the ring into a JSON-able dict; the stack
calls it automatically on quarantine convictions, failovers,
``ProviderFullError``, and unhandled flush exceptions, so a chaos
failure ships forensics instead of a seed alone.  With
``YTPU_BLACKBOX_DIR`` set each dump is also written to
``<dir>/blackbox-<reason>-<n>.json``; without it dumps stay in-memory
(``recorder.dumps``, newest last).  ``YTPU_BLACKBOX=0`` disables
recording entirely.

The scrape path (:meth:`FlightRecorder.snapshot`) copies under the same
lock as the writers — the torn-scrape race family fixed in
``FlushHistory`` cannot recur here.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Optional

__all__ = ["FlightRecorder", "flight_recorder", "reset_flight_recorder"]

DEFAULT_CAP = 4096
# in-memory dump ring: enough for a chaos run's worth of forensics
# without growing unboundedly when no dump dir is configured
_DUMPS_KEPT = 16

SEVERITIES = ("debug", "info", "warning", "error")


def _env_cap() -> int:
    try:
        return max(16, int(os.environ.get("YTPU_BLACKBOX_CAP", DEFAULT_CAP)))
    except (TypeError, ValueError):
        return DEFAULT_CAP


def _env_enabled() -> bool:
    return os.environ.get("YTPU_BLACKBOX", "1") not in ("0", "false", "no")


class FlightRecorder:
    """Bounded, thread-safe ring of structured forensic events."""

    def __init__(self, cap: int | None = None) -> None:
        self._cap = cap if cap is not None else _env_cap()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self._cap)
        self._tick = 0          # monotonic event counter (never resets)
        self._dropped = 0       # events evicted by the cap
        self._n_dumps = 0
        self._last_dump_tick = 0
        self.dumps: deque = deque(maxlen=_DUMPS_KEPT)
        self._metrics = None

    # -- metrics (lazy: the recorder must work before obs wiring) ---------

    def _obs(self):
        if self._metrics is None:
            from . import global_registry

            r = global_registry()
            self._metrics = {
                "events": r.counter(
                    "ytpu_blackbox_events_total",
                    "Structured events recorded by the black-box flight "
                    "recorder, by subsystem",
                    labelnames=("subsystem",),
                ),
                "dropped": r.counter(
                    "ytpu_blackbox_dropped_total",
                    "Flight-recorder events evicted by the "
                    "YTPU_BLACKBOX_CAP ring bound",
                ),
                "dumps": r.counter(
                    "ytpu_blackbox_dumps_total",
                    "Automatic black-box dumps, by trigger reason",
                    labelnames=("reason",),
                ),
            }
        return self._metrics

    # -- recording ---------------------------------------------------------

    def record(
        self,
        subsystem: str,
        event: str,
        severity: str = "info",
        guid: Optional[str] = None,
        tenant: Optional[str] = None,
        shard: Optional[int] = None,
        trace: Optional[str] = None,
        **kv,
    ) -> None:
        """Append one structured event.  ``trace`` is the trace-id hex
        of the causal context, when one is in flight (callers pass
        ``ctx.trace_hex`` or use :func:`record_current`)."""
        if not _env_enabled():
            return
        entry = {
            "subsystem": subsystem,
            "event": event,
            "severity": severity if severity in SEVERITIES else "info",
        }
        if guid is not None:
            entry["guid"] = str(guid)
        if tenant is not None:
            entry["tenant"] = str(tenant)
        if shard is not None:
            entry["shard"] = int(shard)
        if trace is not None:
            entry["trace"] = str(trace)
        if kv:
            entry["kv"] = {k: _jsonable(v) for k, v in kv.items()}
        with self._lock:
            self._tick += 1
            entry["tick"] = self._tick
            if len(self._ring) == self._cap:
                self._dropped += 1
                self._obs()["dropped"].inc()
            self._ring.append(entry)
        self._obs()["events"].labels(subsystem=subsystem).inc()

    # -- scrape ------------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """A consistent copy of the ring (oldest first), taken under the
        writers' lock so a concurrent scrape can never observe a torn
        entry."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def stats(self) -> dict:
        with self._lock:
            return {
                "cap": self._cap,
                "events": self._tick,
                "in_ring": len(self._ring),
                "dropped": self._dropped,
                "dumps": self._n_dumps,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- dumps -------------------------------------------------------------

    def dump(self, reason: str, **context) -> Optional[dict]:
        """Snapshot the ring into a dump dict (and a JSON file when
        ``YTPU_BLACKBOX_DIR`` is set).  Returns ``None`` — and records
        nothing — when no new event arrived since the previous dump, so
        a hot failure seam (e.g. a full provider rejecting a burst)
        cannot amplify one incident into thousands of identical
        files."""
        if not _env_enabled():
            return None
        with self._lock:
            if self._tick == self._last_dump_tick:
                return None
            self._last_dump_tick = self._tick
            self._n_dumps += 1
            seq = self._n_dumps
            events = [dict(e) for e in self._ring]
        out = {
            "reason": reason,
            "seq": seq,
            "tick": events[-1]["tick"] if events else 0,
            "events": events,
        }
        if context:
            out["context"] = {k: _jsonable(v) for k, v in context.items()}
        try:
            # the metric context leading up to the failure:
            # the last YTPU_BLACKBOX_TSDB_WINDOW_S of key TSDB series
            from .tsdb import tsdb_window

            win = tsdb_window()
            if win:
                out["tsdb"] = win
        except Exception:
            pass  # forensics must never take the failing path down
        self._obs()["dumps"].labels(reason=reason).inc()
        self.dumps.append(out)
        directory = os.environ.get("YTPU_BLACKBOX_DIR")
        if directory:
            try:
                os.makedirs(directory, exist_ok=True)
                path = os.path.join(
                    directory, f"blackbox-{_slug(reason)}-{seq:04d}.json"
                )
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(out, f, indent=1)
                os.replace(tmp, path)
                out["path"] = path
            except OSError:
                pass  # forensics must never take the failing path down
        return out

    @property
    def last_dump(self) -> Optional[dict]:
        return self.dumps[-1] if self.dumps else None


def _slug(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-" for c in s)[:48]


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (bytes, bytearray)):
        return f"<{len(v)} bytes>"
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


# -- process-global default instance ------------------------------------------

_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process-global recorder every subsystem feeds (one black box
    per process, like a real aircraft)."""
    global _RECORDER
    rec = _RECORDER  # ytpu-lint: disable=lock-discipline -- double-checked fast path: publication of a fully-constructed recorder is atomic under the GIL
    if rec is None:
        with _RECORDER_LOCK:
            rec = _RECORDER
            if rec is None:
                rec = FlightRecorder()
                _RECORDER = rec
    return rec


def reset_flight_recorder() -> FlightRecorder:
    """Swap in a fresh recorder (tests that assert on ring contents)."""
    global _RECORDER
    with _RECORDER_LOCK:
        rec = FlightRecorder()
        _RECORDER = rec
    return rec
