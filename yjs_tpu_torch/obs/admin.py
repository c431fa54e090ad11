"""Per-process HTTP introspection plane.

Every y-tpu process — shard, gateway, supervisor, or a plain
:class:`~yjs_tpu.provider.TpuProvider` / ``FleetRouter`` host — embeds
one :class:`AdminServer`: a zero-dependency ``http.server`` daemon
thread answering GETs on a loopback port.  This is the pull-based
Borgmon/Prometheus model the exposition format anticipated:
remote hosts cannot share a snapshot directory, but they can all answer
``GET /metrics``, so the admin plane is the seam the multi-host cluster
scales through (``obs/federate.py`` grew the matching
``scrape_endpoints`` HTTP mode).

Endpoints::

    /metrics         Prometheus exposition (text)
    /metrics.json    registry_snapshot JSON — byte-identical to the
                     shard-K.json file-drop payload, so HTTP-scrape
                     federation merges the exact same input
    /healthz         liveness: 200 the moment the server thread runs;
                     touches NO application state (a wedged provider
                     still answers; a SIGSTOPped process times out)
    /readyz          readiness: 200 only when recovery is complete,
                     the brownout ladder is below reject-writes, and
                     the fencing epoch is current (a fenced corpse or
                     mid-recovery shard answers 503 + JSON detail)
    /statusz         one JSON page: role, epoch, slot/tier occupancy,
                     session table, SLO verdict, brownout level,
                     plan-cache hit rate, segment-residue fraction
    /debug/blackbox  flight-recorder ring + stats
    /debug/prof      kernel profile, host-op stats, device-memory gauges
    /debug/trace     bounded recent-span dump (``?n=`` caps the tail)
    /query           embedded-TSDB range query:
                     ``?name=…&labels=…&start=…&end=…&agg=…&tier=…``;
                     malformed params answer 400
    /debug/tsdb      TSDB store stats (series/points/bytes per tier)

Knobs (constructor-overridable, env-derived defaults like
``ClusterConfig``): ``YTPU_ADMIN_PORT`` (default 0 = ephemeral),
``YTPU_ADMIN_BIND`` (default 127.0.0.1), ``YTPU_ADMIN_DISABLED=1``
(never serve), ``YTPU_ADMIN_MAX_INFLIGHT`` (concurrent request bound —
excess requests get 503, so a scrape storm cannot pile threads onto the
GIL the flush hot path is using).

The server is duck-typed over a *target*: any object optionally
providing ``metrics_text()`` / ``metrics_snapshot()`` / ``statusz()`` /
``readiness()`` / ``trace_events()``.  Missing pieces fall back to the
process-global registry, so a bare ``AdminServer(None)`` is already a
useful metrics endpoint.  Handlers never let a target exception escape:
they render as a 500 with the error name, keeping the plane up while
the application misbehaves — that is exactly when it is needed.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = [
    "AdminConfig",
    "AdminServer",
    "admin_metrics",
    "maybe_start_admin",
]


def _env_int(name: str, default: int, lo: int = 0) -> int:
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        return default
    return max(lo, v)


class AdminConfig:
    """Admin-plane knobs (env-derived defaults, constructor wins)."""

    __slots__ = ("port", "bind", "disabled", "max_inflight")

    def __init__(
        self,
        port: int | None = None,
        bind: str | None = None,
        disabled: bool | None = None,
        max_inflight: int | None = None,
    ):
        self.port = (
            port if port is not None else _env_int("YTPU_ADMIN_PORT", 0)
        )
        self.bind = (
            bind
            if bind is not None
            else os.environ.get("YTPU_ADMIN_BIND", "127.0.0.1")
        )
        self.disabled = (
            disabled
            if disabled is not None
            else os.environ.get("YTPU_ADMIN_DISABLED", "") == "1"
        )
        self.max_inflight = (
            max_inflight
            if max_inflight is not None
            else _env_int("YTPU_ADMIN_MAX_INFLIGHT", 8, lo=1)
        )


class _AdminMetrics:
    """``ytpu_admin_*`` families on the process-global registry."""

    def __init__(self):
        from . import global_registry

        reg = global_registry()
        self.requests = reg.counter(
            "ytpu_admin_requests_total",
            "Admin-plane HTTP requests served, by endpoint and status "
            "code (shed = bounced by the inflight bound)",
            labelnames=("endpoint", "code"),
        )
        self.inflight = reg.gauge(
            "ytpu_admin_inflight",
            "Admin-plane HTTP requests currently being served",
        )


_ADMIN_METRICS: _AdminMetrics | None = None
_ADMIN_METRICS_LOCK = threading.Lock()


def admin_metrics() -> _AdminMetrics:
    # cold path (a few calls per scrape): plain lock, like rpc_metrics
    global _ADMIN_METRICS
    with _ADMIN_METRICS_LOCK:
        if _ADMIN_METRICS is None:
            _ADMIN_METRICS = _AdminMetrics()
        return _ADMIN_METRICS


# endpoint label values are a closed set so the requests counter cannot
# grow a series per probed path
_KNOWN_ENDPOINTS = frozenset({
    "/metrics", "/metrics.json", "/healthz", "/readyz", "/statusz",
    "/debug/blackbox", "/debug/prof", "/debug/trace",
    "/query", "/debug/tsdb",
})


class _AdminHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    admin: "AdminServer"

    def handle_error(self, request, client_address):
        pass  # a torn client connection is the client's problem


class _Handler(BaseHTTPRequestHandler):
    server_version = "ytpu-admin"

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj) -> None:
        body = json.dumps(obj, indent=1, sort_keys=True).encode("utf-8")
        self._reply(code, body + b"\n", "application/json")

    def do_GET(self):  # noqa: N802 - stdlib handler name
        admin = self.server.admin
        path, _, query = self.path.partition("?")
        endpoint = path if path in _KNOWN_ENDPOINTS else "other"
        m = admin_metrics()
        if not admin._gate.acquire(blocking=False):
            # over the inflight bound: shed instead of stacking reader
            # threads against the flush hot path's GIL time
            m.requests.labels(endpoint=endpoint, code=503).inc()
            try:
                self._reply_json(503, {"error": "admin busy"})
            except OSError:
                pass
            return
        m.inflight.inc()
        try:
            code = self._route(admin, path, query)
        except OSError:
            code = 0  # client went away mid-body; nothing to answer
        except Exception as e:  # target bug: keep the plane serving
            code = 500
            try:
                self._reply_json(
                    500, {"error": type(e).__name__, "detail": str(e)}
                )
            except OSError:
                pass
        finally:
            admin._gate.release()
            m.inflight.dec()
            if code:
                m.requests.labels(endpoint=endpoint, code=code).inc()

    def _route(self, admin: "AdminServer", path: str, query: str) -> int:
        if path == "/healthz":
            # liveness only: no target call, no lock — answering at all
            # IS the signal (a SIGSTOPped process times the probe out)
            self._reply(200, b"ok\n", "text/plain; charset=utf-8")
            return 200
        if path == "/metrics":
            body = admin.metrics_text().encode("utf-8")
            self._reply(
                200, body, "text/plain; version=0.0.4; charset=utf-8"
            )
            return 200
        if path == "/metrics.json":
            self._reply_json(200, admin.metrics_snapshot())
            return 200
        if path == "/readyz":
            verdict = admin.readiness()
            code = 200 if verdict.get("ready") else 503
            self._reply_json(code, verdict)
            return code
        if path == "/statusz":
            self._reply_json(200, admin.statusz())
            return 200
        if path == "/debug/blackbox":
            from .blackbox import flight_recorder

            bb = flight_recorder()
            self._reply_json(
                200, {"stats": bb.stats(), "events": bb.snapshot()}
            )
            return 200
        if path == "/debug/prof":
            self._reply_json(200, admin.prof())
            return 200
        if path == "/query":
            from urllib.parse import parse_qs

            params = {
                k: v[-1] for k, v in parse_qs(query).items() if v
            }
            try:
                result = admin.tsdb_query(params)
            except ValueError as e:
                self._reply_json(400, {"error": str(e)})
                return 400
            self._reply_json(200, result)
            return 200
        if path == "/debug/tsdb":
            self._reply_json(200, admin.tsdb_stats())
            return 200
        if path == "/debug/trace":
            n = 256
            for part in query.split("&"):
                if part.startswith("n="):
                    try:
                        n = max(1, int(part[2:]))
                    except ValueError:
                        pass
            events = admin.trace_events()
            self._reply_json(200, {
                "total": len(events),
                "events": events[-n:],
            })
            return 200
        self._reply_json(404, {"error": f"no endpoint {path}"})
        return 404


class AdminServer:
    """One process-embedded introspection endpoint (module docstring).

    ``target`` is duck-typed; ``role`` names the process in
    ``/statusz`` and readiness output.  ``start()`` binds and serves
    from a daemon thread; a disabled config makes ``start()`` a no-op
    (``port`` stays 0), so callers embed unconditionally and the knob
    decides."""

    def __init__(
        self,
        target=None,
        role: str = "process",
        config: AdminConfig | None = None,
    ):
        self.target = target
        self.role = role
        self.config = config if config is not None else AdminConfig()
        self._gate = threading.Semaphore(self.config.max_inflight)
        self._httpd: _AdminHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "AdminServer":
        if self.config.disabled or self._httpd is not None:
            return self
        httpd = _AdminHTTPServer(
            (self.config.bind, self.config.port), _Handler
        )
        httpd.admin = self
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            name=f"ytpu-admin-{self.role}",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    @property
    def url(self) -> str:
        if not self._httpd:
            return ""
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- target facade (each falls back to the process-global view) ---------

    def metrics_text(self) -> str:
        fn = getattr(self.target, "metrics_text", None)
        if fn is not None:
            return fn()
        from . import global_registry, prometheus_text

        return prometheus_text(global_registry())

    def metrics_snapshot(self) -> dict:
        fn = getattr(self.target, "metrics_snapshot", None)
        if fn is not None:
            return fn()
        from . import global_registry, registry_snapshot

        return registry_snapshot(global_registry())

    def readiness(self) -> dict:
        fn = getattr(self.target, "readiness", None)
        if fn is not None:
            verdict = fn()
        else:
            verdict = {"ready": True, "checks": {}}
        verdict.setdefault("role", self.role)
        return verdict

    def statusz(self) -> dict:
        fn = getattr(self.target, "statusz", None)
        status = fn() if fn is not None else {}
        status.setdefault("role", self.role)
        status.setdefault("pid", os.getpid())
        status.setdefault("ready", bool(self.readiness().get("ready")))
        return status

    def prof(self) -> dict:
        out: dict = {}
        try:
            from .prof import kernel_profiler

            p = kernel_profiler()
            out["kernel"] = p.snapshot()
            out["host_ops"] = p.host_op_stats()
        except Exception as e:
            out["kernel_error"] = type(e).__name__
        # device-memory gauges live on the engine registry when the
        # target is provider-backed; surface them when reachable
        snap = {}
        try:
            snap = self.metrics_snapshot()
        except Exception:
            pass
        gauges = (snap.get("gauges") or {}) if isinstance(snap, dict) else {}
        out["device_memory"] = {
            name: series
            for name, series in gauges.items()
            if name.startswith("ytpu_prof_device_")
        }
        return out

    def trace_events(self) -> list:
        fn = getattr(self.target, "trace_events", None)
        if fn is not None:
            return fn()
        return []

    def tsdb_query(self, params: dict) -> dict:
        """``/query``: target override (the supervisor federates shard
        stores here) falling back to the process-global TSDB."""
        fn = getattr(self.target, "tsdb_query", None)
        if fn is not None:
            return fn(params)
        from .tsdb import tsdb

        return tsdb().query_params(params)

    def tsdb_stats(self) -> dict:
        fn = getattr(self.target, "tsdb_stats", None)
        if fn is not None:
            return fn()
        from .tsdb import tsdb, tsdb_enabled

        out = tsdb().stats()
        out["enabled"] = tsdb_enabled()
        return out


def maybe_start_admin(
    target, role: str, config: AdminConfig | None = None
) -> AdminServer | None:
    """Embed-and-start for library-constructed objects (TpuProvider,
    FleetRouter): serves only when the operator opted in by setting
    ``YTPU_ADMIN_PORT`` — a test constructing 200 providers must not
    open 200 sockets.  Cluster processes (shard/gateway/supervisor)
    construct :class:`AdminServer` directly and default to ON instead,
    since one process embeds exactly one plane."""
    if config is None:
        if "YTPU_ADMIN_PORT" not in os.environ:
            return None
        config = AdminConfig()
    if config.disabled:
        return None
    try:
        return AdminServer(target, role=role, config=config).start()
    except OSError:
        # a fixed YTPU_ADMIN_PORT already taken (second provider in
        # one process): the app must come up anyway — no admin plane
        # beats no process
        return None
