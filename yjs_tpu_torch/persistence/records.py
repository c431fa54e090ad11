"""WAL record codec: CRC-checksummed, length-prefixed binary records.

Every durable byte the provider writes — journaled updates, compaction
snapshots, dead-letter-queue dumps, slot releases — travels in one
record format so a single reader serves segments and checkpoints alike:

    segment file header:    b"YTPUWAL1"   (checkpoint: b"YTPUSNP1")
    record header (14 B, little-endian):
        magic        u16    0x7EA1
        kind         u8     1=update 2=snapshot 3=dlq 4=release 5=ack
                            6=migrate 7=tier 8=repl 9=adm 10=geo
        flags        u8     bit0 = payload uses the V2 update encoding
        guid_len     u16
        payload_len  u32
        crc32        u32    over kind..payload_len + guid + payload
    guid     utf-8 bytes
    payload  bytes

The CRC covers everything except the magic and itself, so any single
flipped bit — header or body — fails the check (CRC-32 detects all
burst errors up to 32 bits).  The magic exists purely for
resynchronization: a reader that hits a corrupt record in a sealed
segment scans forward for the next magic and keeps going.
"""

from __future__ import annotations

import json
import struct
import zlib

SEG_HEADER = b"YTPUWAL1"
SNAP_HEADER = b"YTPUSNP1"

REC_MAGIC = b"\xa1\x7e"
_HDR = struct.Struct("<2sBBHII")
HEADER_SIZE = _HDR.size  # 14

KIND_UPDATE = 1
KIND_SNAPSHOT = 2
KIND_DLQ = 3
KIND_RELEASE = 4
KIND_ACK = 5
# migration intent: journaled on the SOURCE shard before any
# state reaches the destination, so crash-mid-migration recovery can
# resolve ownership to exactly one shard.  Payload is JSON
# {"dst": shard, "epoch": routing_epoch}; a later KIND_RELEASE for the
# same guid marks the handoff complete.
KIND_MIGRATE = 6
# tier demotion marker: journaled when a doc leaves the hot
# tier.  Payload is a length-prefixed JSON meta header ({"tier": "warm"
# or "cold", "heat": score, "letters": [...]}) followed by the doc's
# full ``encode_state_as_update`` bytes at demotion time — recovery
# replays the state like a snapshot, then places the doc in the
# recorded tier unless LATER records show it was touched again.
KIND_TIER = 7
# replication role marker: journaled on a shard whose WAL
# holds a doc it does not OWN (a replica copy), and on a shard that
# just won ownership via failover promotion.  Payload is JSON
# {"role": "replica" | "primary", "epoch": fencing_epoch,
# "primary": shard?}; the LAST marker for a guid stands and a
# KIND_RELEASE clears it.  Recovery uses the markers to resolve
# ownership without treating replica journals as split-brain owners,
# and to fence a stale primary's claim behind a newer promotion epoch.
KIND_REPL = 8
# admission brownout transition: journaled on every attached
# provider's WAL when the fleet brownout controller changes degradation
# level, so a post-incident recovery can reconstruct exactly when and
# why service was degraded.  Guid is empty (the record is fleet-scoped,
# not doc-scoped); payload is JSON {"level": name, "reason": str,
# "tick": controller_tick}.  Recovery surfaces a count and the last
# level in its stats; the live level always restarts at "normal".
KIND_ADM = 9
# geo link state: journaled by a region's GeoReplicator when
# an inter-region link's ack floor advances or its fencing epoch moves.
# Guid is empty (link state is region-scoped, not doc-scoped); payload
# is JSON {"peer": region, "sid": session_id, "seq": recv_floor,
# "epoch": fencing_epoch}.  The LAST record per peer stands.  Recovery
# surfaces the floors as resume hints so a region recovering from
# kill -9 re-HELLOs its WAN links with the journaled floor and resumes
# retransmission instead of full-resyncing every doc in the space.
KIND_GEO = 10
KIND_NAMES = {
    KIND_UPDATE: "update",
    KIND_SNAPSHOT: "snapshot",
    KIND_DLQ: "dlq",
    KIND_RELEASE: "release",
    KIND_ACK: "ack",
    KIND_MIGRATE: "migrate",
    KIND_TIER: "tier",
    KIND_REPL: "repl",
    KIND_ADM: "adm",
    KIND_GEO: "geo",
}

FLAG_V2 = 1

# sanity bounds the reader trusts header lengths against — a corrupt
# length field must not make it allocate or skip gigabytes
MAX_GUID = 4096
MAX_PAYLOAD = 1 << 26  # 64 MiB


class WalRecord:
    """One decoded record."""

    __slots__ = ("kind", "guid", "payload", "v2")

    def __init__(self, kind: int, guid: str, payload: bytes, v2: bool):
        self.kind = kind
        self.guid = guid
        self.payload = payload
        self.v2 = v2

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"WalRecord({KIND_NAMES.get(self.kind, self.kind)}, "
            f"guid={self.guid!r}, bytes={len(self.payload)}, v2={self.v2})"
        )


def encode_record(
    kind: int, guid: str, payload: bytes, v2: bool = False
) -> bytes:
    if kind not in KIND_NAMES:
        raise ValueError(f"unknown record kind {kind}")
    guid_b = guid.encode("utf-8")
    if len(guid_b) > MAX_GUID:
        raise ValueError(f"guid too long ({len(guid_b)} > {MAX_GUID})")
    if len(payload) > MAX_PAYLOAD:
        raise ValueError(f"payload too large ({len(payload)} > {MAX_PAYLOAD})")
    flags = FLAG_V2 if v2 else 0
    body = struct.pack("<BBHI", kind, flags, len(guid_b), len(payload))
    crc = zlib.crc32(body)
    crc = zlib.crc32(guid_b, crc)
    crc = zlib.crc32(payload, crc)
    return (
        _HDR.pack(REC_MAGIC, kind, flags, len(guid_b), len(payload), crc)
        + guid_b
        + bytes(payload)
    )


def try_decode_at(data: bytes, pos: int):
    """Attempt one record at ``pos``.

    Returns ``("ok", WalRecord, end)`` for a valid record,
    ``("bad_crc", payload_or_None, end)`` when the header parses but the
    checksum fails (payload is the best-effort body slice),
    ``("bad_header", None, pos)`` when the bytes at ``pos`` are not a
    plausible record header, or ``("short", None, pos)`` when the record
    (header or body) extends past the end of the buffer — a torn write
    if this is the final segment.
    """
    n = len(data)
    if n - pos < HEADER_SIZE:
        return ("short", None, pos)
    magic, kind, flags, guid_len, payload_len, crc = _HDR.unpack_from(
        data, pos
    )
    if magic != REC_MAGIC or kind not in KIND_NAMES:
        return ("bad_header", None, pos)
    if guid_len > MAX_GUID or payload_len > MAX_PAYLOAD:
        return ("bad_header", None, pos)
    end = pos + HEADER_SIZE + guid_len + payload_len
    if end > n:
        return ("short", None, pos)
    guid_b = data[pos + HEADER_SIZE : pos + HEADER_SIZE + guid_len]
    payload = data[pos + HEADER_SIZE + guid_len : end]
    body = struct.pack("<BBHI", kind, flags, guid_len, payload_len)
    want = zlib.crc32(body)
    want = zlib.crc32(guid_b, want)
    want = zlib.crc32(payload, want)
    if want != crc:
        return ("bad_crc", payload, end)
    try:
        guid = guid_b.decode("utf-8")
    except UnicodeDecodeError:
        # CRC passed but the guid is not utf-8: only possible for bytes
        # we never wrote — treat as unparseable
        return ("bad_header", None, pos)
    return ("ok", WalRecord(kind, guid, payload, bool(flags & FLAG_V2)), end)


def encode_tier_payload(
    tier: str, heat: float, update: bytes, letters: list | None = None
) -> bytes:
    """KIND_TIER payload: ``u32 meta_len | meta JSON | update bytes``.

    ``letters`` are JSON-able dead-letter dicts (base64 update bodies,
    the DLQ snapshot shape) that rode out of the slot with the doc."""
    meta: dict = {"tier": tier, "heat": round(float(heat), 6)}
    if letters:
        meta["letters"] = letters
    mb = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    return struct.pack("<I", len(mb)) + mb + bytes(update)


def decode_tier_payload(payload: bytes) -> tuple[dict, bytes]:
    """Inverse of :func:`encode_tier_payload` → (meta, update bytes)."""
    if len(payload) < 4:
        raise ValueError("tier payload too short for meta length")
    (mlen,) = struct.unpack_from("<I", payload, 0)
    if 4 + mlen > len(payload):
        raise ValueError("tier payload meta overruns record")
    meta = json.loads(payload[4 : 4 + mlen].decode("utf-8"))
    if not isinstance(meta, dict) or meta.get("tier") not in (
        "hot",  # promotion marker: clears any earlier demote marker
        "warm",
        "cold",
    ):
        raise ValueError(f"tier payload meta invalid: {meta!r}")
    return meta, payload[4 + mlen :]


def resync(data: bytes, pos: int) -> int:
    """Next candidate record offset at or after ``pos`` (the next magic
    occurrence), or ``len(data)`` when none remains."""
    i = data.find(REC_MAGIC, pos)
    return len(data) if i < 0 else i
