"""Binary decoders mirroring `encoding.py` (lib0/decoding byte formats)."""

from __future__ import annotations

import struct

from .binary import BIT7, BIT8, BITS6, BITS7
from .encoding import UNDEFINED
from .u16 import utf8_decode_u16


class Decoder:
    __slots__ = ("arr", "pos")

    def __init__(self, arr: bytes):
        self.arr = arr
        self.pos = 0

    def has_content(self) -> bool:
        return self.pos < len(self.arr)


def read_uint8(decoder: Decoder) -> int:
    b = decoder.arr[decoder.pos]
    decoder.pos += 1
    return b


def read_var_uint(decoder: Decoder) -> int:
    num = 0
    shift = 0
    arr = decoder.arr
    n = len(arr)
    while decoder.pos < n:
        r = arr[decoder.pos]
        decoder.pos += 1
        num |= (r & BITS7) << shift
        shift += 7
        if r < BIT8:
            return num
    raise ValueError("unexpected end of array")


def read_var_int_signed(decoder: Decoder):
    """Returns (magnitude, sign) where sign is -1 or 1.

    The sign of a zero magnitude is meaningful (JS `-0`): the UintOptRle
    decoder uses it to detect that a run count follows.
    """
    arr = decoder.arr
    r = arr[decoder.pos]
    decoder.pos += 1
    num = r & BITS6
    sign = -1 if (r & BIT7) > 0 else 1
    if (r & BIT8) == 0:
        return num, sign
    shift = 6
    n = len(arr)
    while decoder.pos < n:
        r = arr[decoder.pos]
        decoder.pos += 1
        num |= (r & BITS7) << shift
        shift += 7
        if r < BIT8:
            return num, sign
    raise ValueError("unexpected end of array")


def read_var_int(decoder: Decoder) -> int:
    num, sign = read_var_int_signed(decoder)
    return sign * num


def read_var_string(decoder: Decoder) -> str:
    ln = read_var_uint(decoder)
    s = utf8_decode_u16(bytes(decoder.arr[decoder.pos:decoder.pos + ln]))
    decoder.pos += ln
    return s


def read_var_uint8_array(decoder: Decoder) -> bytes:
    ln = read_var_uint(decoder)
    b = bytes(decoder.arr[decoder.pos:decoder.pos + ln])
    decoder.pos += ln
    return b


def read_float(decoder: Decoder) -> float:
    v = struct.unpack_from(">f", decoder.arr, decoder.pos)[0]
    decoder.pos += 4
    return v


def read_double(decoder: Decoder) -> float:
    v = struct.unpack_from(">d", decoder.arr, decoder.pos)[0]
    decoder.pos += 8
    return v


def read_big_int64(decoder: Decoder) -> int:
    v = struct.unpack_from(">q", decoder.arr, decoder.pos)[0]
    decoder.pos += 8
    return v


def read_any(decoder: Decoder):
    tag = read_uint8(decoder)
    if tag == 127:
        return UNDEFINED
    if tag == 126:
        return None
    if tag == 125:
        return read_var_int(decoder)
    if tag == 124:
        return read_float(decoder)
    if tag == 123:
        return read_double(decoder)
    if tag == 122:
        return read_big_int64(decoder)
    if tag == 121:
        return False
    if tag == 120:
        return True
    if tag == 119:
        return read_var_string(decoder)
    if tag == 118:
        obj = {}
        for _ in range(read_var_uint(decoder)):
            key = read_var_string(decoder)
            obj[key] = read_any(decoder)
        return obj
    if tag == 117:
        return [read_any(decoder) for _ in range(read_var_uint(decoder))]
    if tag == 116:
        return read_var_uint8_array(decoder)
    raise ValueError(f"unknown any tag {tag}")


class RleDecoder(Decoder):
    __slots__ = ("reader", "s", "count")

    def __init__(self, arr: bytes, reader=read_uint8):
        super().__init__(arr)
        self.reader = reader
        self.s = None
        self.count = 0

    def read(self):
        if self.count == 0:
            self.s = self.reader(self)
            if self.has_content():
                self.count = read_var_uint(self) + 1
            else:
                self.count = -1  # the final value repeats forever
        self.count -= 1
        return self.s


class UintOptRleDecoder(Decoder):
    __slots__ = ("s", "count")

    def __init__(self, arr: bytes):
        super().__init__(arr)
        self.s = 0
        self.count = 0

    def read(self) -> int:
        if self.count == 0:
            num, sign = read_var_int_signed(self)
            self.count = 1
            self.s = num
            if sign < 0:
                self.count = read_var_uint(self) + 2
        self.count -= 1
        return self.s


class IntDiffOptRleDecoder(Decoder):
    __slots__ = ("s", "count", "diff")

    def __init__(self, arr: bytes):
        super().__init__(arr)
        self.s = 0
        self.count = 0
        self.diff = 0

    def read(self) -> int:
        if self.count == 0:
            num, sign = read_var_int_signed(self)
            diff = sign * num
            has_count = diff & 1
            self.diff = diff >> 1  # arithmetic shift == floor division by 2
            self.count = read_var_uint(self) + 2 if has_count else 1
        self.s += self.diff
        self.count -= 1
        return self.s


class StringDecoder:
    __slots__ = ("decoder", "string", "spos")

    def __init__(self, arr: bytes):
        self.decoder = UintOptRleDecoder(arr)
        self.string = read_var_string(self.decoder)
        self.spos = 0

    def read(self) -> str:
        ln = self.decoder.read()
        s = self.string[self.spos:self.spos + ln]
        self.spos += ln
        return s
