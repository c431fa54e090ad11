"""Doc-sharded provider fleet.

One :class:`TpuProvider` caps the deployment at single-device slot
capacity.  :class:`FleetRouter` puts N provider shards behind the same
facade: bounded-load consistent-hash placement
(:class:`HashRing`), a versioned :class:`RoutingTable`, cross-shard
session fan-out, live doc migration over the WAL's
intent/release records, and an occupancy-driven :class:`Rebalancer`.
Crash recovery (:meth:`FleetRouter.recover`) replays every shard's WAL
and resolves mid-migration crashes to exactly one owner.

Survivability: every accepted update fans out to R
replica shards (:class:`ReplicationManager`, journal-only copies on the
replicas' own WALs), a tick-deterministic heartbeat
:class:`FailureDetector` convicts dead shards (suspect → dead with
jittered thresholds), and :class:`FailoverCoordinator` promotes the
freshest replica under a monotonic fencing epoch — a revived stale
primary is fenced out, never split-brained.

Knobs: ``YTPU_FLEET_*``, ``YTPU_REPL_*``, ``YTPU_FAILOVER_*``.
Metrics: the ``ytpu_fleet_*``, ``ytpu_repl_*``, and ``ytpu_failover_*``
families (README "Fleet" and "Replication & failover").
"""

from .failover import (
    DeadShard,
    FailoverConfig,
    FailoverCoordinator,
    FailoverMetrics,
    FailureDetector,
    ShardDownError,
)
from .hashring import (
    FleetFullError,
    HashRing,
    RoutingTable,
    stable_hash,
)
from .rebalance import Rebalancer
from .replication import (
    ReplicationConfig,
    ReplicationManager,
    ReplicationMetrics,
)
from .router import FleetConfig, FleetMetrics, FleetRouter

__all__ = [
    "DeadShard",
    "FailoverConfig",
    "FailoverCoordinator",
    "FailoverMetrics",
    "FailureDetector",
    "FleetConfig",
    "FleetFullError",
    "FleetMetrics",
    "FleetRouter",
    "HashRing",
    "Rebalancer",
    "ReplicationConfig",
    "ReplicationManager",
    "ReplicationMetrics",
    "RoutingTable",
    "ShardDownError",
    "stable_hash",
]
