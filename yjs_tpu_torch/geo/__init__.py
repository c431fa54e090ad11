"""Geo-distributed active-active replication.

See :mod:`yjs_tpu_torch.geo.replicator` for the region driver and
:mod:`yjs_tpu_torch.geo.space` for the doc-space codecs and session host.
"""

from .replicator import (
    GeoConfig,
    GeoLink,
    GeoMetrics,
    GeoReplicator,
    GeoSession,
)
from .space import (
    SpaceSessionHost,
    decode_space_sv,
    decode_space_update,
    encode_space_sv,
    encode_space_update,
)

__all__ = [
    "GeoConfig",
    "GeoLink",
    "GeoMetrics",
    "GeoReplicator",
    "GeoSession",
    "SpaceSessionHost",
    "decode_space_sv",
    "decode_space_update",
    "encode_space_sv",
    "encode_space_update",
]
