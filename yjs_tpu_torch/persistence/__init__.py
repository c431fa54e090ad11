"""Durability for the provider fleet.

Three pieces, all zero-dependency host-side code:

- :mod:`records` — the CRC-checksummed, length-prefixed record codec
  shared by segments and checkpoints;
- :mod:`wal` — :class:`WriteAheadLog`: per-provider append-only journal
  with segment rotation, a configurable fsync policy, and
  ``checkpoint()`` compaction (sealed segments folded into per-doc
  ``encode_state_as_update`` snapshots, y-leveldb style);
- :mod:`recovery` — ``replay_wal`` / ``TpuProvider.recover``:
  snapshot-then-tail replay tolerating torn tails (truncate at the
  first bad checksum on the final segment) and mid-log corruption
  (``validate_update`` → dead-letter queue, resync, continue).

Env knobs: ``YTPU_WAL_DIR`` (journal every provider constructed without
an explicit ``wal_dir``), ``YTPU_WAL_SEGMENT_BYTES`` (rotation
threshold, default 4 MiB), ``YTPU_WAL_FSYNC`` =
``always | interval | never`` (default ``interval``), and
``YTPU_WAL_FSYNC_INTERVAL`` (appends per fsync in interval mode,
default 64).  Metrics land in the ``ytpu_wal_*`` families (see
:class:`WalMetrics`); README "Durability" documents the format and the
fsync tradeoffs.
"""

from .records import (
    FLAG_V2,
    HEADER_SIZE,
    KIND_ACK,
    KIND_ADM,
    KIND_DLQ,
    KIND_GEO,
    KIND_MIGRATE,
    KIND_NAMES,
    KIND_RELEASE,
    KIND_REPL,
    KIND_SNAPSHOT,
    KIND_TIER,
    KIND_UPDATE,
    decode_tier_payload,
    encode_tier_payload,
    MAX_GUID,
    MAX_PAYLOAD,
    REC_MAGIC,
    SEG_HEADER,
    SNAP_HEADER,
    WalRecord,
    encode_record,
    try_decode_at,
)
from .recovery import (
    count_guids,
    iter_file_events,
    replay_wal,
    scan_wal,
)
from .wal import (
    WalConfig,
    WalMetrics,
    WriteAheadLog,
    list_checkpoints,
    list_segments,
)

__all__ = [
    "FLAG_V2",
    "HEADER_SIZE",
    "KIND_ACK",
    "KIND_ADM",
    "KIND_DLQ",
    "KIND_GEO",
    "KIND_MIGRATE",
    "KIND_NAMES",
    "KIND_RELEASE",
    "KIND_REPL",
    "KIND_SNAPSHOT",
    "KIND_TIER",
    "KIND_UPDATE",
    "MAX_GUID",
    "MAX_PAYLOAD",
    "REC_MAGIC",
    "SEG_HEADER",
    "SNAP_HEADER",
    "WalConfig",
    "WalMetrics",
    "WalRecord",
    "WriteAheadLog",
    "count_guids",
    "decode_tier_payload",
    "encode_record",
    "encode_tier_payload",
    "iter_file_events",
    "list_checkpoints",
    "list_segments",
    "replay_wal",
    "scan_wal",
    "try_decode_at",
]
