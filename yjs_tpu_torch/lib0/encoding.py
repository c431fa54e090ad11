"""Binary encoders, byte-compatible with lib0/encoding.

Every byte layout here is pinned by the reference wire format:
- varuint / varint framing (used by every codec path)
- the `any` tagged-value codec (reference src/structs/ContentAny.js)
- the Rle / UintOptRle / IntDiffOptRle / String column encoders used by
  UpdateEncoderV2 (reference src/utils/UpdateEncoder.js:264-304)
"""

from __future__ import annotations

import math
import struct

from .binary import BIT7, BIT8, BITS6, BITS7, BITS31
from .u16 import u16_encode_utf8


class Undefined:
    """Singleton mirroring JS `undefined` inside the `any` codec."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


UNDEFINED = Undefined()


class Encoder:
    """Append-only byte buffer."""

    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def to_bytes(self) -> bytes:
        return bytes(self.buf)

    def __len__(self):
        return len(self.buf)


def write_uint8(encoder: Encoder, num: int) -> None:
    encoder.buf.append(num & 0xFF)


def write_uint8_array(encoder: Encoder, b: bytes) -> None:
    encoder.buf += b


def write_var_uint(encoder: Encoder, num: int) -> None:
    buf = encoder.buf
    while num > BITS7:
        buf.append(BIT8 | (num & BITS7))
        num >>= 7
    buf.append(num & BITS7)


def write_var_int(encoder: Encoder, num: int, negative_zero: bool = False) -> None:
    """Sign-magnitude varint: first byte holds sign (BIT7) + 6 bits.

    `negative_zero` mirrors JS `-0`, which the UintOptRle encoder relies on to
    signal "a run count follows" even when the run value is 0.
    """
    is_negative = num < 0 or negative_zero
    if is_negative:
        num = -num
    buf = encoder.buf
    buf.append((BIT8 if num > BITS6 else 0) | (BIT7 if is_negative else 0) | (num & BITS6))
    num >>= 6
    while num > 0:
        buf.append((BIT8 if num > BITS7 else 0) | (num & BITS7))
        num >>= 7


def write_var_string(encoder: Encoder, s: str) -> None:
    b = u16_encode_utf8(s)
    write_var_uint(encoder, len(b))
    encoder.buf += b


def write_var_uint8_array(encoder: Encoder, b: bytes) -> None:
    write_var_uint(encoder, len(b))
    encoder.buf += b


def write_float(encoder: Encoder, num: float) -> None:
    encoder.buf += struct.pack(">f", num)


def write_double(encoder: Encoder, num: float) -> None:
    encoder.buf += struct.pack(">d", num)


def write_big_int64(encoder: Encoder, num: int) -> None:
    encoder.buf += struct.pack(">q", num)


def _is_float32(num: float) -> bool:
    try:
        return struct.unpack(">f", struct.pack(">f", num))[0] == num
    except (OverflowError, struct.error):
        return False


def write_any(encoder: Encoder, data) -> None:
    """Tagged-value codec (tags 116-127, matching lib0's `any` encoding)."""
    if data is UNDEFINED:
        write_uint8(encoder, 127)
    elif data is None:
        write_uint8(encoder, 126)
    elif isinstance(data, bool):
        write_uint8(encoder, 120 if data else 121)
    elif isinstance(data, (int, float)) and not isinstance(data, bool):
        is_int = isinstance(data, int) or float(data).is_integer()
        if is_int and abs(data) <= BITS31:
            write_uint8(encoder, 125)
            neg_zero = isinstance(data, float) and data == 0 and math.copysign(1.0, data) < 0
            write_var_int(encoder, int(data), negative_zero=neg_zero)
        elif isinstance(data, float) and _is_float32(data):
            write_uint8(encoder, 124)
            write_float(encoder, data)
        else:
            write_uint8(encoder, 123)
            write_double(encoder, float(data))
    elif isinstance(data, str):
        write_uint8(encoder, 119)
        write_var_string(encoder, data)
    elif isinstance(data, (bytes, bytearray, memoryview)):
        write_uint8(encoder, 116)
        write_var_uint8_array(encoder, bytes(data))
    elif isinstance(data, (list, tuple)):
        write_uint8(encoder, 117)
        write_var_uint(encoder, len(data))
        for item in data:
            write_any(encoder, item)
    elif isinstance(data, dict):
        write_uint8(encoder, 118)
        write_var_uint(encoder, len(data))
        for key, value in data.items():
            write_var_string(encoder, key)
            write_any(encoder, value)
    else:
        raise TypeError(f"cannot encode value of type {type(data)!r} as any")


class RleEncoder(Encoder):
    """Run-length encoder over a basic writer (used for the info/parentInfo
    columns of UpdateEncoderV2)."""

    __slots__ = ("w", "s", "count")

    def __init__(self, writer=write_uint8):
        super().__init__()
        self.w = writer
        self.s = None
        self.count = 0

    def write(self, v) -> None:
        if self.s == v and self.count > 0:
            self.count += 1
        else:
            if self.count > 0:
                write_var_uint(self, self.count - 1)
            self.count = 1
            self.w(self, v)
            self.s = v


class UintOptRleEncoder:
    """Optional run-length encoding of unsigned ints: single values are
    written as positive varints; runs are written as the negated value
    followed by (count - 2)."""

    __slots__ = ("encoder", "s", "count")

    def __init__(self):
        self.encoder = Encoder()
        self.s = 0
        self.count = 0

    def write(self, v: int) -> None:
        if self.s == v:
            self.count += 1
        else:
            self._flush()
            self.count = 1
            self.s = v

    def _flush(self) -> None:
        if self.count > 0:
            if self.count == 1:
                write_var_int(self.encoder, self.s)
            else:
                write_var_int(self.encoder, -self.s, negative_zero=self.s == 0)
                write_var_uint(self.encoder, self.count - 2)

    def to_bytes(self) -> bytes:
        self._flush()
        return self.encoder.to_bytes()


class IntDiffOptRleEncoder:
    """Delta + optional-RLE encoder: diffs are doubled, with the low bit
    signalling that a run count follows."""

    __slots__ = ("encoder", "s", "count", "diff")

    def __init__(self):
        self.encoder = Encoder()
        self.s = 0
        self.count = 0
        self.diff = 0

    def write(self, v: int) -> None:
        if self.diff == v - self.s:
            self.s = v
            self.count += 1
        else:
            self._flush()
            self.count = 1
            self.diff = v - self.s
            self.s = v

    def _flush(self) -> None:
        if self.count > 0:
            encoded_diff = self.diff * 2 + (0 if self.count == 1 else 1)
            write_var_int(self.encoder, encoded_diff)
            if self.count > 1:
                write_var_uint(self.encoder, self.count - 2)

    def to_bytes(self) -> bytes:
        self._flush()
        return self.encoder.to_bytes()


class StringEncoder:
    """All strings concatenated into one var-string + UintOptRle of the
    individual UTF-16 lengths."""

    __slots__ = ("parts", "lens")

    def __init__(self):
        self.parts = []
        self.lens = UintOptRleEncoder()

    def write(self, s: str) -> None:
        self.parts.append(s)
        self.lens.write(len(s))  # s is in u16 form: len == UTF-16 units

    def to_bytes(self) -> bytes:
        encoder = Encoder()
        write_var_string(encoder, "".join(self.parts))
        write_uint8_array(encoder, self.lens.to_bytes())
        return encoder.to_bytes()
