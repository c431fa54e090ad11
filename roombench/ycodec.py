"""Plain Yjs v1 wire codec for text documents (lib0 varints, updates, sync).

Written from the Yjs encoding (``encoding.js`` writeStructs / readStructs,
``DeleteSet.js`` writeDeleteSet, y-protocols ``sync.js``) for the subset a
text room server sees: ``Item`` structs with string or deleted content in
the root ``Y.Text``, ``GC`` and ``Skip`` structs, and the delete set.  It
imports nothing of the program under test.

An id is one int: ``client << 32 | clock`` (``pack_id``); clients and
clocks are below 2**32 here.
"""

from __future__ import annotations

SYNC_STEP1 = 0
SYNC_STEP2 = 1

CONTENT_DELETED = 1
CONTENT_STRING = 4
_GC = 0
_SKIP = 10


def pack_id(client: int, clock: int) -> int:
    return (client << 32) | clock


def client_of(i: int) -> int:
    return i >> 32


def clock_of(i: int) -> int:
    return i & 0xFFFFFFFF


def write_uint(out: bytearray, n: int) -> None:
    while n > 0x7F:
        out.append(0x80 | (n & 0x7F))
        n >>= 7
    out.append(n)


def write_string(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    write_uint(out, len(b))
    out += b


class Reader:
    """lib0 decoder over one bytes object."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def uint(self) -> int:
        buf, pos = self.buf, self.pos
        b = buf[pos]
        pos += 1
        if b < 0x80:
            self.pos = pos
            return b
        n = b & 0x7F
        shift = 7
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            if b < 0x80:
                self.pos = pos
                return n
            shift += 7

    def string(self) -> str:
        n = self.uint()
        s = self.buf[self.pos:self.pos + n]
        if len(s) != n:
            raise ValueError("truncated string")
        self.pos += n
        return s.decode("utf-8")

    def bytes(self) -> bytes:
        n = self.uint()
        s = self.buf[self.pos:self.pos + n]
        if len(s) != n:
            raise ValueError("truncated byte array")
        self.pos += n
        return s

    def done(self) -> bool:
        return self.pos >= len(self.buf)


def _check_bmp(s: str) -> str:
    """``s`` as Yjs counts it, one UTF-16 unit a character; a character
    outside the BMP is refused, since no text of these rooms holds one."""
    if not s.isascii() and any(ord(ch) > 0xFFFF for ch in s):
        raise ValueError("non-BMP character in a text item")
    return s


def _uint_at(buf: bytes, pos: int) -> tuple[int, int]:
    n = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if b < 0x80:
            return n, pos
        shift += 7


class Run:
    """One decoded struct: ``length`` consecutive clocks of one client.

    ``kind`` is ``"item"``, ``"gc"`` or ``"skip"``; an item has ``origin``
    and ``right`` (packed ids or None), ``parent`` (the root type's name
    when neither origin is set) and ``text`` (None for deleted content).
    """

    __slots__ = ("client", "clock", "length", "kind", "origin", "right",
                 "parent", "text")

    def __init__(self, client, clock, length, kind, origin=None, right=None,
                 parent=None, text=None):
        self.client = client
        self.clock = clock
        self.length = length
        self.kind = kind
        self.origin = origin
        self.right = right
        self.parent = parent
        self.text = text


def decode_update(buf: bytes) -> tuple[list[Run], list[tuple[int, int, int]]]:
    """A v1 update's structs and its delete set ``(client, clock, len)``."""
    r = Reader(buf)
    runs: list[Run] = []
    for _ in range(r.uint()):
        n = r.uint()
        client = r.uint()
        clock = r.uint()
        pos = r.pos
        for _ in range(n):
            info = buf[pos]
            pos += 1
            ref = info & 0x1F
            if ref == _GC or ref == _SKIP:
                length, pos = _uint_at(buf, pos)
                runs.append(Run(client, clock, length,
                                "gc" if ref == _GC else "skip"))
                clock += length
                continue
            origin = right = parent = None
            if info & 0x80:
                c, pos = _uint_at(buf, pos)
                k, pos = _uint_at(buf, pos)
                origin = (c << 32) | k
            if info & 0x40:
                c, pos = _uint_at(buf, pos)
                k, pos = _uint_at(buf, pos)
                right = (c << 32) | k
            if not info & 0xC0:
                r.pos = pos
                if r.uint() == 1:
                    parent = r.string()
                else:
                    c = r.uint()
                    parent = pack_id(c, r.uint())
                pos = r.pos
                if info & 0x20:
                    raise ValueError("map entries are not text")
            if ref == CONTENT_STRING:
                m, pos = _uint_at(buf, pos)
                raw = buf[pos:pos + m]
                if len(raw) != m:
                    raise ValueError("truncated string")
                pos += m
                text = _check_bmp(raw.decode("utf-8"))
                length = len(text)
            elif ref == CONTENT_DELETED:
                text = None
                length, pos = _uint_at(buf, pos)
            else:
                raise ValueError(f"content ref {ref} is not text")
            if length <= 0:
                raise ValueError("empty struct")
            runs.append(Run(client, clock, length, "item", origin, right,
                            parent, text))
            clock += length
        r.pos = pos
    ds = []
    for _ in range(r.uint()):
        client = r.uint()
        for _ in range(r.uint()):
            clock = r.uint()
            ds.append((client, clock, r.uint()))
    if not r.done():
        raise ValueError("trailing bytes after the delete set")
    return runs, ds


def encode_insert(client: int, clock: int, origin: int | None,
                  right: int | None, text: str, root: str) -> bytes:
    """One update holding one text item of ``client`` at ``clock``."""
    out = bytearray((1, 1))
    write_uint(out, client)
    write_uint(out, clock)
    info = CONTENT_STRING
    if origin is not None:
        info |= 0x80
    if right is not None:
        info |= 0x40
    out.append(info)
    if origin is not None:
        write_uint(out, client_of(origin))
        write_uint(out, clock_of(origin))
    if right is not None:
        write_uint(out, client_of(right))
        write_uint(out, clock_of(right))
    if origin is None and right is None:
        write_uint(out, 1)
        write_string(out, root)
    write_string(out, text)
    out.append(0)  # empty delete set
    return bytes(out)


def encode_delete(target: int) -> bytes:
    """One update that deletes one character: no structs, one DS range."""
    out = bytearray((0, 1))
    write_uint(out, client_of(target))
    write_uint(out, 1)
    write_uint(out, clock_of(target))
    write_uint(out, 1)
    return bytes(out)


def encode_session(client: int, clock0: int, items, deletes, root: str) -> bytes:
    """One merged update of one client's consecutive items and a delete set.

    ``items`` are ``(origin, right, text)`` at clocks ``clock0, clock0+1,
    ...``; ``deletes`` packed ids, written one range each."""
    out = bytearray()
    if items:
        out += b"\x01"
        write_uint(out, len(items))
        write_uint(out, client)
        write_uint(out, clock0)
        for origin, right, text in items:
            info = CONTENT_STRING
            if origin is not None:
                info |= 0x80
            if right is not None:
                info |= 0x40
            out.append(info)
            if origin is not None:
                write_uint(out, client_of(origin))
                write_uint(out, clock_of(origin))
            if right is not None:
                write_uint(out, client_of(right))
                write_uint(out, clock_of(right))
            if origin is None and right is None:
                write_uint(out, 1)
                write_string(out, root)
            write_string(out, text)
    else:
        out += b"\x00"
    by_client: dict[int, list[int]] = {}
    for d in deletes:
        by_client.setdefault(client_of(d), []).append(clock_of(d))
    write_uint(out, len(by_client))
    for c, clocks in by_client.items():
        write_uint(out, c)
        write_uint(out, len(clocks))
        for k in clocks:
            write_uint(out, k)
            write_uint(out, 1)
    return bytes(out)


def encode_state_vector(sv: dict[int, int]) -> bytes:
    out = bytearray()
    write_uint(out, len(sv))
    for c, k in sv.items():
        write_uint(out, c)
        write_uint(out, k)
    return bytes(out)


def encode_step1(sv: dict[int, int]) -> bytes:
    """A y-protocols sync-step-1 message carrying ``sv``."""
    out = bytearray((SYNC_STEP1,))
    body = encode_state_vector(sv)
    write_uint(out, len(body))
    out += body
    return bytes(out)


def decode_step2(msg: bytes) -> bytes:
    """The update inside a sync-step-2 message."""
    r = Reader(msg)
    if r.uint() != SYNC_STEP2:
        raise ValueError("not a sync step 2")
    u = r.bytes()
    if not r.done():
        raise ValueError("trailing bytes after the step-2 payload")
    return u


def decode_delete_set_of(update: bytes) -> set[int]:
    """The packed ids an update's delete set names."""
    _, ds = decode_update(update)
    out = set()
    for c, k, n in ds:
        base = pack_id(c, k)
        out.update(range(base, base + n))
    return out
