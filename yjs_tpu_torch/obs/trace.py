"""Host-side span tracing with Chrome-trace-format JSON export.

Records phase spans (compact/plan/pack/dispatch/emit, planner-pool and
demotion events) into an in-memory bounded buffer and exports the
Chrome ``traceEvents`` JSON that Perfetto / chrome://tracing load
directly.  This LAYERS ON the existing ``jax.profiler.TraceAnnotation``
wrappers (which only surface inside an active device profiler trace) —
the host spans are always available, profiler attached or not.

``YTPU_TRACE_PATH=<file>`` makes every tracer created while the variable
is set register for an atexit dump: all their events merge into one
Chrome-trace JSON at interpreter exit.  ``Tracer.save(path)`` writes one
tracer's trace explicitly.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque

DEFAULT_MAX_EVENTS = 200_000


class _Span:
    """Reusable context manager recording one complete ("X") event."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        tr = self._tracer
        tr._events.append((
            self._name,
            "X",
            (self._t0 - tr._t0) * 1e6,
            (t1 - self._t0) * 1e6,
            threading.get_ident(),
            self._args,
            None,
        ))
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded in-memory span/event recorder (oldest events evicted)."""

    def __init__(self, enabled: bool = True, max_events: int | None = None):
        self.enabled = enabled
        if max_events is None:
            try:
                max_events = int(
                    os.environ.get("YTPU_TRACE_EVENTS", DEFAULT_MAX_EVENTS)
                )
            except ValueError:
                max_events = DEFAULT_MAX_EVENTS
        # (name, ph, ts_us, dur_us, tid, args, flow_id) tuples
        self._events: deque = deque(maxlen=max(16, max_events))
        self._t0 = time.perf_counter()
        self.pid = os.getpid()
        self.process_name = "ytpu"
        self._thread_names: dict[int, str] = {}
        if enabled and os.environ.get("YTPU_TRACE_PATH"):
            _register_for_exit_dump(self)

    def span(self, name: str, **args):
        """Context manager recording a complete span around its body."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """Record a zero-duration marker (demotion, pool event, ...)."""
        if not self.enabled:
            return
        self._events.append((
            name,
            "i",
            (time.perf_counter() - self._t0) * 1e6,
            0.0,
            threading.get_ident(),
            args or None,
            None,
        ))

    def flow_start(self, name: str, flow_id: int, **args) -> None:
        """Open a flow arrow (Perfetto ``ph="s"``): call inside the span
        the arrow should leave from (e.g. a provider receive span)."""
        self._flow(name, "s", flow_id, args)

    def flow_end(self, name: str, flow_id: int, **args) -> None:
        """Close a flow arrow (``ph="f"``, ``bp="e"`` so it binds to the
        enclosing slice): call inside the span the arrow lands on (the
        flush that applied the update)."""
        self._flow(name, "f", flow_id, args)

    def _flow(self, name, ph, flow_id, args) -> None:
        if not self.enabled:
            return
        self._events.append((
            name,
            ph,
            (time.perf_counter() - self._t0) * 1e6,
            0.0,
            threading.get_ident(),
            args or None,
            int(flow_id),
        ))

    def name_thread(self, name: str) -> None:
        """Label the calling thread in exported traces (a ``thread_name``
        metadata event; unnamed threads render as ``host-<tid>``)."""
        self._thread_names[threading.get_ident()] = name

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        self._events.clear()

    def trace_events(self) -> list[dict]:
        """Chrome ``traceEvents`` list: ``pid``/``tid`` metadata ("M")
        events first, then recorded events sorted by timestamp."""
        if not self._events:
            return []
        out = []
        tids = sorted({e[4] for e in self._events})
        meta = [{
            "name": "process_name", "ph": "M", "ts": 0.0,
            "pid": self.pid, "tid": tids[0], "cat": "__metadata",
            "args": {"name": self.process_name},
        }]
        for tid in tids:
            meta.append({
                "name": "thread_name", "ph": "M", "ts": 0.0,
                "pid": self.pid, "tid": tid, "cat": "__metadata",
                "args": {
                    "name": self._thread_names.get(tid, f"host-{tid}")
                },
            })
        for name, ph, ts, dur, tid, args, flow_id in sorted(
            self._events, key=lambda e: e[2]
        ):
            ev = {
                "name": name,
                "ph": ph,
                "ts": ts,
                "pid": self.pid,
                "tid": tid,
                "cat": "ytpu",
            }
            if ph == "X":
                ev["dur"] = dur
            elif ph == "i":  # instant events: thread scope
                ev["s"] = "t"
            if flow_id is not None:
                ev["id"] = flow_id
            if ph == "f":
                # bind the arrow to the ENCLOSING slice, not the next one
                ev["bp"] = "e"
            if args:
                ev["args"] = args
            out.append(ev)
        return meta + out

    def chrome_trace(self) -> dict:
        """The full Chrome-trace JSON object (loadable by Perfetto)."""
        return {
            "traceEvents": self.trace_events(),
            "displayTimeUnit": "ms",
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# -- YTPU_TRACE_PATH atexit dump --------------------------------------------

_EXIT_TRACERS: list[Tracer] = []
_EXIT_REGISTERED = False


def _register_for_exit_dump(tracer: Tracer) -> None:
    global _EXIT_REGISTERED
    _EXIT_TRACERS.append(tracer)
    if not _EXIT_REGISTERED:
        atexit.register(_dump_exit_traces)
        _EXIT_REGISTERED = True


def _dump_exit_traces() -> None:
    path = os.environ.get("YTPU_TRACE_PATH")
    if not path or not _EXIT_TRACERS:
        return
    events: list[dict] = []
    for tr in _EXIT_TRACERS:
        events.extend(tr.trace_events())
    events.sort(key=lambda e: e["ts"])
    try:
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    except OSError:
        pass  # tracing must never take the process down at exit
