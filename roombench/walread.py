"""Read a write-ahead-log directory back, written from its documented layout.

A segment ``wal-NNNNNNNN.log`` is the header ``YTPUWAL1`` and then records:
a 14-byte little-endian header (magic ``a1 7e``, kind u8, flags u8, guid
length u16, payload length u32, CRC-32 over kind..payload length, guid
and payload), the guid, the payload.  Kind 1 is a journaled update.  This
reader imports nothing of the program; it yields the updates it finds
whole, with a count of what it could not read.
"""

from __future__ import annotations

import os
import re
import struct
import zlib

_SEG = re.compile(r"wal-(\d{8})\.log$")
_HDR = struct.Struct("<2sBBHII")
_MAGIC = b"\xa1\x7e"
KIND_UPDATE = 1


def updates_by_guid(path: str) -> tuple[dict[str, list[bytes]], int]:
    """Every whole update record per guid, in log order, and the number of
    records that were torn or failed their checksum."""
    segs = sorted((int(m.group(1)), name) for name in os.listdir(path)
                  if (m := _SEG.match(name)))
    out: dict[str, list[bytes]] = {}
    bad = 0
    for _, name in segs:
        with open(os.path.join(path, name), "rb") as f:
            buf = f.read()
        if not buf.startswith(b"YTPUWAL1"):
            bad += 1
            continue
        pos = 8
        while pos < len(buf):
            if pos + _HDR.size > len(buf):
                bad += 1
                break
            magic, kind, flags, glen, plen, crc = _HDR.unpack_from(buf, pos)
            end = pos + _HDR.size + glen + plen
            if magic != _MAGIC or end > len(buf):
                bad += 1
                break
            body = buf[pos + 2:pos + 10]
            guid = buf[pos + _HDR.size:pos + _HDR.size + glen]
            payload = buf[pos + _HDR.size + glen:end]
            c = zlib.crc32(payload, zlib.crc32(guid, zlib.crc32(body)))
            if c != crc:
                bad += 1
            elif kind == KIND_UPDATE and not flags & 1:
                out.setdefault(guid.decode("utf-8"), []).append(payload)
            pos = end
    return out, bad
