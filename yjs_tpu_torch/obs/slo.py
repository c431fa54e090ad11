"""yjs_tpu.obs.slo: end-to-end convergence latency + burn-rate SLOs.

What a collaborator actually feels is not flush wall time — it is the
latency from an edit leaving its origin until every replica can read it.
This module measures that WITHOUT touching the wire format: an update is
keyed by the natural identity it already carries, the (client, clock) of
its first struct block (v1 layout: numClients, then numStructs, client,
clock — four varints in).  Delete-only payloads, v2 updates, and
unparseable bytes fall back to a CRC of the exact transported bytes;
both sides of a link compute the key from the same bytes, so the
fallback converges too.

Pipeline per update (Dapper-style causal stages, one flow id):

    origin ──> receive ──> integrate ──> visible
    (first    (provider    (queue_update  (provider.flush
     sighting  ingests)     accepts)       returns: readable)

``origin`` is stamped in a process-global :class:`OriginClock` the first
time any provider in the process sees the key — the emitting provider
stamps it at broadcast, so in-process relay chains measure true
end-to-end latency; cross-process receivers (no shared clock) floor the
origin at their own receive time, making every stage after transport
still attributable.

Burn-rate monitoring follows the Monarch/Prometheus multi-window rule:
breach fraction over a long window (``YTPU_SLO_WINDOW``, default 300 s)
and a short window (long/12), each divided by the error budget
(1 - ``YTPU_SLO_OBJECTIVE``).  Both windows >= 14.4 -> ``page``; both
>= 6 -> ``warning``; else ``ok``.  The convergence target is
``YTPU_SLO_CONVERGENCE_MS`` (default 250 ms).
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from collections import OrderedDict, deque

from ..lib0 import decoding
from ..lib0.decoding import Decoder
from .dist import flow_id_for

# classic multiwindow burn thresholds: 14.4x burns a 30-day budget in
# ~2 days (page); 6x in ~5 days (ticket/warning)
PAGE_BURN = 14.4
WARN_BURN = 6.0

DEFAULT_TARGET_MS = 250.0
DEFAULT_WINDOW_S = 300.0
DEFAULT_OBJECTIVE = 0.99

STAGES = ("receive", "integrate", "visible")
_STATE_CODES = {"ok": 0, "warning": 1, "page": 2}

# flow ids are hash-derived from the update key:
# the previous process-global counter restarted numbering relative to
# surviving events after a YTPU_TRACE_EVENTS cap truncation, so a
# truncated trace could pair a new flow-start with a stale flow-end of
# the same id.  A keyed hash is stable under truncation AND matches
# across providers/processes, which is what lets one update's
# convergence arrows stitch into a single cross-peer trace.


def update_key(update: bytes, v2: bool = False) -> tuple[int, int]:
    """The natural identity of an update: (client, clock) of its first
    struct block; ``(-1, crc32)`` for delete-only/v2/unparseable bytes.

    Pure read of the leading varints — never decodes structs, never
    copies, zero wire-format impact."""
    if not v2:
        try:
            dec = Decoder(bytes(update))
            if decoding.read_var_uint(dec):  # numClients >= 1
                decoding.read_var_uint(dec)  # numStructs (skipped)
                client = decoding.read_var_uint(dec)
                clock = decoding.read_var_uint(dec)
                return (client, clock)
        except Exception:
            pass
    return (-1, zlib.crc32(bytes(update)))


class OriginClock:
    """Bounded first-sighting timestamps, shared by every provider in
    the process (the emitting provider stamps; receivers look up)."""

    def __init__(self, maxlen: int = 8192):
        self._t: OrderedDict = OrderedDict()
        self.maxlen = maxlen
        # process-global instance: emitters stamp from provider threads
        # while receivers look up — OrderedDict reorders on eviction
        self._lock = threading.Lock()

    def record_once(self, key, t: float) -> None:
        with self._lock:
            if key in self._t:
                return
            self._t[key] = t
            while len(self._t) > self.maxlen:
                self._t.popitem(last=False)

    def lookup(self, key):
        with self._lock:
            return self._t.get(key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._t)


_ORIGINS = OriginClock()


def origin_clock() -> OriginClock:
    """The process-global origin clock (tests may build private ones)."""
    return _ORIGINS


class ConvergenceTracker:
    """Per-provider convergence pipeline timestamps + SLO burn state.

    ``now`` is injectable for deterministic tests; instruments register
    on the provider's engine registry so one exposition call covers
    them.  All hooks are no-ops under a disabled registry."""

    def __init__(
        self,
        registry,
        tracer=None,
        now=time.perf_counter,
        origins: OriginClock | None = None,
        target_ms: float | None = None,
        window_s: float | None = None,
        objective: float | None = None,
        max_pending: int = 4096,
        max_events: int = 65536,
    ):
        self.enabled = getattr(registry, "enabled", True)
        self.tracer = tracer
        self._now = now
        self._origins = origins if origins is not None else _ORIGINS
        self.target_ms = (
            target_ms
            if target_ms is not None
            else _env_float("YTPU_SLO_CONVERGENCE_MS", DEFAULT_TARGET_MS)
        )
        self.window_s = (
            window_s
            if window_s is not None
            else _env_float("YTPU_SLO_WINDOW", DEFAULT_WINDOW_S)
        )
        self.short_window_s = max(1.0, self.window_s / 12.0)
        self.objective = (
            objective
            if objective is not None
            else _env_float("YTPU_SLO_OBJECTIVE", DEFAULT_OBJECTIVE)
        )
        self.max_pending = max_pending
        # guards _pending and _events: exposition scrapes re-evaluate
        # the burn windows from other threads while a flush completes
        # pipelines (deque/dict iteration tears under mutation)
        self._lock = threading.Lock()
        # key -> [t_origin, t_receive, t_integrate, flow_id, trace_hex]
        self._pending: OrderedDict = OrderedDict()
        # (t_visible, breached) completions feeding the burn windows
        self._events: deque = deque(maxlen=max_events)
        self._completed = 0
        self._state = "ok"
        self._burns = {"short": 0.0, "long": 0.0}
        self._windows = {
            w: {"total": 0, "breached": 0, "breach_fraction": 0.0}
            for w in ("short", "long")
        }
        r = registry
        self._latency = r.histogram(
            "ytpu_convergence_latency_seconds",
            "End-to-end origin->visible latency per converged update",
            unit="s",
        )
        stage = r.histogram(
            "ytpu_convergence_stage_seconds",
            "Per-stage convergence latency (receive: origin->ingest; "
            "integrate: ingest->queued; visible: queued->flushed)",
            unit="s",
            labelnames=("stage",),
        )
        self._stage = {s: stage.labels(stage=s) for s in STAGES}
        self._m_completed = r.counter(
            "ytpu_slo_convergence_total",
            "Updates that completed the convergence pipeline",
        )
        self._m_breaches = r.counter(
            "ytpu_slo_breaches_total",
            "Converged updates whose end-to-end latency exceeded "
            "YTPU_SLO_CONVERGENCE_MS",
        )
        burn = r.gauge(
            "ytpu_slo_burn_rate",
            "Error-budget burn rate per SLO window (>=14.4 on both "
            "windows pages)",
            labelnames=("window",),
        )
        self._burn = {w: burn.labels(window=w) for w in ("short", "long")}
        self._m_state = r.gauge(
            "ytpu_slo_state",
            "Burn-rate alert state: 0 ok, 1 warning, 2 page",
        )

    # -- pipeline stages ----------------------------------------------

    def origin(self, update: bytes, v2: bool = False):
        """Stamp first-sighting time for an emitted update (no-op when
        the key was already stamped — e.g. a relay of foreign bytes)."""
        if not self.enabled:
            return None
        key = update_key(update, v2)
        self._origins.record_once(key, self._now())
        return key

    def receive(self, update: bytes, v2: bool = False, guid=None,
                trace=None):
        """An update entered this provider; returns its tracking key.
        ``trace`` is the ingress :class:`~yjs_tpu.obs.dist.TraceContext`
        when one is in flight — sampled contexts stamp their trace id
        onto the convergence flow arrows so the per-update flow joins
        the cross-provider trace."""
        if not self.enabled:
            return None
        key = update_key(update, v2)
        t = self._now()
        # cross-process senders share no clock: floor origin at receive
        self._origins.record_once(key, t)
        with self._lock:
            if key in self._pending:  # duplicate delivery: first one wins
                return key
            flow_id = flow_id_for(key)
            self._pending[key] = [
                self._origins.lookup(key), t, None, flow_id,
                trace.trace_hex if trace is not None and trace.sampled
                else None,
            ]
            while len(self._pending) > self.max_pending:
                self._pending.popitem(last=False)
        if self.tracer is not None:
            args = {"client": key[0], "clock": key[1], "guid": guid}
            if trace is not None and trace.sampled:
                args["trace"] = trace.trace_hex
            self.tracer.flow_start("ytpu.convergence", flow_id, **args)
        return key

    def integrated(self, key) -> None:
        """The update was accepted into the engine queue."""
        with self._lock:
            rec = self._pending.get(key) if key is not None else None
            if rec is not None and rec[2] is None:
                rec[2] = self._now()

    def rejected(self, key) -> None:
        """The update was diverted (dead-lettered): stop tracking it."""
        if key is not None:
            with self._lock:
                self._pending.pop(key, None)

    def visible(self, tracer=None) -> int:
        """A flush completed: every integrated pending update is now
        readable on this replica — close its pipeline.  Call INSIDE the
        flush span so the flow-end events bind to it in Perfetto."""
        if not self.enabled or not self._pending:  # ytpu-lint: disable=lock-discipline -- benign racy precheck: dict truthiness is atomic; a just-added pending closes on the next flush tick
            return 0
        if tracer is None:
            tracer = self.tracer
        t = self._now()
        with self._lock:
            done = [
                (k, self._pending.pop(k))
                for k in [
                    k for k, rec in self._pending.items()
                    if rec[2] is not None
                ]
            ]
        for k, rec in done:
            t_origin, t_recv, t_int, flow_id, trace_hex = rec
            total = max(0.0, t - t_origin)
            self._latency.observe(total)
            self._stage["receive"].observe(max(0.0, t_recv - t_origin))
            self._stage["integrate"].observe(max(0.0, t_int - t_recv))
            self._stage["visible"].observe(max(0.0, t - t_int))
            breached = total * 1000.0 > self.target_ms
            self._m_completed.inc()
            if breached:
                self._m_breaches.inc()
            with self._lock:
                self._events.append((t, breached))
            self._completed += 1
            if tracer is not None:
                args = {
                    "latency_ms": round(total * 1000.0, 3),
                    "breached": breached,
                }
                if trace_hex is not None:
                    args["trace"] = trace_hex
                tracer.flow_end("ytpu.convergence", flow_id, **args)
        if done:
            self._update_state()
        return len(done)

    # -- burn-rate state ----------------------------------------------

    def _update_state(self) -> None:
        now = self._now()
        budget = max(1e-9, 1.0 - self.objective)
        burns = {}
        windows = {}
        with self._lock:
            events = tuple(self._events)
        for wname, wlen in (
            ("short", self.short_window_s), ("long", self.window_s)
        ):
            total = breached = 0
            for t, b in reversed(events):
                if now - t > wlen:
                    break
                total += 1
                if b:
                    breached += 1
            frac = breached / total if total else 0.0
            burns[wname] = frac / budget
            windows[wname] = {
                "total": total,
                "breached": breached,
                "breach_fraction": frac,
            }
        worst_common = min(burns.values())
        if worst_common >= PAGE_BURN:
            state = "page"
        elif worst_common >= WARN_BURN:
            state = "warning"
        else:
            state = "ok"
        self._burns = burns
        self._windows = windows
        self._state = state
        self._burn["short"].set(burns["short"])
        self._burn["long"].set(burns["long"])
        self._m_state.set(_STATE_CODES[state])

    def state(self) -> str:
        """Current burn-rate verdict (``ok``/``warning``/``page``),
        re-evaluated so aged-out windows decay — cheap enough for the
        admission controller to poll every tick."""
        if self.enabled and self._events:  # ytpu-lint: disable=lock-discipline -- benign racy precheck: deque truthiness is atomic; _update_state snapshots under the lock
            self._update_state()
        return self._state

    def snapshot(self) -> dict:
        """JSON-able SLO state (served as ``provider.slo_snapshot()``)."""
        if self.enabled and self._events:  # ytpu-lint: disable=lock-discipline -- benign racy precheck: deque truthiness is atomic; _update_state snapshots under the lock
            self._update_state()  # re-evaluate: windows age out over time
        return {
            "target_ms": self.target_ms,
            "window_s": self.window_s,
            "short_window_s": self.short_window_s,
            "objective": self.objective,
            "state": self._state,
            "burn_rates": dict(self._burns),
            "windows": {w: dict(s) for w, s in self._windows.items()},
            "completed": self._completed,
            "pending": len(self._pending),  # ytpu-lint: disable=lock-discipline -- point-in-time gauge: len() of a dict is atomic under the GIL
        }


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default
