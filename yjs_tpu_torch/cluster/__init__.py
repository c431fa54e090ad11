"""Process-native cluster: real OS-process shards behind a
y-websocket-compatible gateway.

Layering (each importable without jax until a provider is built):

- :mod:`.config` — ``YTPU_CLUSTER_*`` / ``YTPU_GATEWAY_*`` knobs
- :mod:`.rpc` — envelope-121 RPC framing over length-prefixed TCP, plus
  :class:`SocketTransport`, the threaded session transport with the
  drain-then-join shutdown contract
- :mod:`.shard` — one shard = one process wrapping one ``TpuProvider``
  (``python -m yjs_tpu_torch.cluster.shard``)
- :mod:`.supervisor` — spawn/monitor/restart/fail-over, federated
  metrics, structured recovery report
- :mod:`.gateway` — the wire-compatible front door (y-websocket and
  raw-session dialects), :class:`LocalCluster`, the in-process
  facade for tests and the bench baseline, and :class:`ProviderHost`,
  one provider's own sessions served over sockets
"""

from .config import ClusterConfig, GatewayConfig  # noqa: F401
from .gateway import (  # noqa: F401
    Gateway,
    LocalCluster,
    ProviderHost,
    decode_room_preamble,
    encode_room_preamble,
)
from .rpc import (  # noqa: F401
    FrameConn,
    RpcBusy,
    RpcClient,
    RpcClosed,
    RpcError,
    RpcServer,
    SocketTransport,
)
from .supervisor import Supervisor  # noqa: F401

__all__ = [
    "ClusterConfig",
    "FrameConn",
    "Gateway",
    "GatewayConfig",
    "LocalCluster",
    "ProviderHost",
    "RpcBusy",
    "RpcClient",
    "RpcClosed",
    "RpcError",
    "RpcServer",
    "SocketTransport",
    "Supervisor",
    "decode_room_preamble",
    "encode_room_preamble",
]
