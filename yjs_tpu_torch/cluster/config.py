"""Knobs for the process-native cluster.

Two env families, both documented in README's "Cluster" section and
cross-checked by ytpu-lint's knob-drift checker:

- ``YTPU_CLUSTER_*`` — supervisor/shard process topology: bind host,
  heartbeat cadence, probe timeout, restart budget and backoff, and the
  federated snapshot directory the metrics/trace view writes into.
- ``YTPU_GATEWAY_*`` — the y-websocket-compatible front door: bind
  host/port, maximum accepted frame, session tick cadence, and the
  awareness passthrough toggle.

Both configs are constructor-overridable (tests pin values; the env is
the operator surface), mirroring ``SessionConfig`` / ``FleetConfig``.
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int, lo: int = 0) -> int:
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        return default
    return max(lo, v)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class ClusterConfig:
    """Supervisor-side topology knobs (env-derived defaults)."""

    __slots__ = (
        "host",
        "heartbeat_s",
        "probe_timeout_s",
        "restart_max",
        "restart_backoff_s",
        "snapshot_dir",
        "snapshot_s",
        "spawn_timeout_s",
        "rpc_timeout_s",
        "busy_retry_ticks",
        "scrape_timeout_s",
    )

    def __init__(
        self,
        host: str | None = None,
        heartbeat_s: float | None = None,
        probe_timeout_s: float | None = None,
        restart_max: int | None = None,
        restart_backoff_s: float | None = None,
        snapshot_dir: str | None = None,
        snapshot_s: float | None = None,
        spawn_timeout_s: float | None = None,
        rpc_timeout_s: float | None = None,
        busy_retry_ticks: int | None = None,
        scrape_timeout_s: float | None = None,
    ):
        self.host = (
            host
            if host is not None
            else os.environ.get("YTPU_CLUSTER_HOST", "127.0.0.1")
        )
        self.heartbeat_s = (
            heartbeat_s
            if heartbeat_s is not None
            else _env_float("YTPU_CLUSTER_HEARTBEAT_S", 0.25)
        )
        self.probe_timeout_s = (
            probe_timeout_s
            if probe_timeout_s is not None
            else _env_float("YTPU_CLUSTER_PROBE_TIMEOUT_S", 5.0)
        )
        self.restart_max = (
            restart_max
            if restart_max is not None
            else _env_int("YTPU_CLUSTER_RESTART_MAX", 2)
        )
        self.restart_backoff_s = (
            restart_backoff_s
            if restart_backoff_s is not None
            else _env_float("YTPU_CLUSTER_RESTART_BACKOFF_S", 0.1)
        )
        self.snapshot_dir = (
            snapshot_dir
            if snapshot_dir is not None
            else os.environ.get("YTPU_CLUSTER_SNAPSHOT_DIR", "")
        )
        self.snapshot_s = (
            snapshot_s
            if snapshot_s is not None
            else _env_float("YTPU_CLUSTER_SNAPSHOT_S", 2.0)
        )
        self.spawn_timeout_s = (
            spawn_timeout_s
            if spawn_timeout_s is not None
            else _env_float("YTPU_CLUSTER_SPAWN_TIMEOUT_S", 60.0)
        )
        self.rpc_timeout_s = (
            rpc_timeout_s
            if rpc_timeout_s is not None
            else _env_float("YTPU_CLUSTER_RPC_TIMEOUT_S", 30.0)
        )
        # the BUSY retry-after (in session ticks) a gateway session is
        # told while its room's shard is down/restarting — the peer
        # keeps the frame in its outbox, so nothing acked is ever lost
        self.busy_retry_ticks = (
            busy_retry_ticks
            if busy_retry_ticks is not None
            else _env_int("YTPU_CLUSTER_BUSY_RETRY_TICKS", 8, lo=1)
        )
        # per-target deadline for one HTTP admin-plane scrape during
        # metrics federation: a hung shard costs at most
        # this long and renders as a stale row, never an error
        self.scrape_timeout_s = (
            scrape_timeout_s
            if scrape_timeout_s is not None
            else _env_float("YTPU_CLUSTER_SCRAPE_TIMEOUT_S", 2.0)
        )


class GatewayConfig:
    """Front-door knobs (env-derived defaults)."""

    __slots__ = (
        "host",
        "port",
        "max_frame",
        "tick_s",
        "awareness",
        "send_timeout_s",
    )

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        max_frame: int | None = None,
        tick_s: float | None = None,
        awareness: bool | None = None,
        send_timeout_s: float | None = None,
    ):
        self.host = (
            host
            if host is not None
            else os.environ.get("YTPU_GATEWAY_HOST", "127.0.0.1")
        )
        self.port = (
            port
            if port is not None
            else _env_int("YTPU_GATEWAY_PORT", 0)
        )
        self.max_frame = (
            max_frame
            if max_frame is not None
            else _env_int("YTPU_GATEWAY_MAX_FRAME", 32 * 1024 * 1024, lo=1)
        )
        self.tick_s = (
            tick_s
            if tick_s is not None
            else _env_float("YTPU_GATEWAY_TICK_S", 0.05)
        )
        self.awareness = (
            awareness
            if awareness is not None
            else _env_int("YTPU_GATEWAY_AWARENESS", 1) != 0
        )
        # bound on a blocking ws send to one client (SO_SNDTIMEO): a
        # peer that stops reading is severed instead of stalling the
        # fan-out thread forever.  0 disables the bound.
        self.send_timeout_s = (
            send_timeout_s
            if send_timeout_s is not None
            else _env_float("YTPU_GATEWAY_SEND_TIMEOUT_S", 15.0)
        )
