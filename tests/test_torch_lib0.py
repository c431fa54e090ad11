"""The cases of the JAX package's ``tests/test_lib0.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``.

Round-trip tests for the lib0-compatible binary primitives."""

import random

from yjs_tpu_torch.lib0 import decoding, encoding
from yjs_tpu_torch.lib0.encoding import UNDEFINED


def test_var_uint_roundtrip():
    values = [0, 1, 127, 128, 255, 256, 16383, 16384, 2**31 - 1, 2**32 - 1, 2**53 - 1]
    enc = encoding.Encoder()
    for v in values:
        encoding.write_var_uint(enc, v)
    dec = decoding.Decoder(enc.to_bytes())
    for v in values:
        assert decoding.read_var_uint(dec) == v


def test_var_int_roundtrip():
    values = [0, 1, -1, 63, -63, 64, -64, 127, -128, 2**31 - 1, -(2**31), 2**40]
    enc = encoding.Encoder()
    for v in values:
        encoding.write_var_int(enc, v)
    dec = decoding.Decoder(enc.to_bytes())
    for v in values:
        assert decoding.read_var_int(dec) == v


def test_var_int_negative_zero():
    enc = encoding.Encoder()
    encoding.write_var_int(enc, 0, negative_zero=True)
    dec = decoding.Decoder(enc.to_bytes())
    num, sign = decoding.read_var_int_signed(dec)
    assert num == 0 and sign == -1


def test_var_string_roundtrip():
    values = ["", "hello", "héllo wörld", "こんにちは", "a" * 1000, "emoji \U0001f600 pair"]
    enc = encoding.Encoder()
    for v in values:
        encoding.write_var_string(enc, v)
    dec = decoding.Decoder(enc.to_bytes())
    from yjs_tpu_torch.lib0.u16 import from_u16

    for v in values:
        assert from_u16(decoding.read_var_string(dec)) == v


def test_any_roundtrip():
    values = [
        None,
        UNDEFINED,
        True,
        False,
        0,
        -1,
        42,
        2**31 - 1,
        -(2**31),
        2**40,  # exceeds BITS31 -> float64
        1.5,
        -0.25,
        3.141592653589793,
        "string",
        b"\x00\x01\x02",
        [1, "two", None, [3]],
        {"a": 1, "b": {"c": [True]}},
    ]
    enc = encoding.Encoder()
    encoding.write_any(enc, values)
    out = decoding.read_any(decoding.Decoder(enc.to_bytes()))
    assert out == values


def test_any_integral_float_is_int():
    enc = encoding.Encoder()
    encoding.write_any(enc, 5.0)
    assert decoding.read_any(decoding.Decoder(enc.to_bytes())) == 5


def test_rle_encoder_roundtrip():
    rng = random.Random(42)
    values = [rng.choice([1, 2, 3]) for _ in range(1000)]
    enc = encoding.RleEncoder()
    for v in values:
        enc.write(v)
    dec = decoding.RleDecoder(enc.to_bytes())
    for v in values:
        assert dec.read() == v


def test_uint_opt_rle_roundtrip():
    rng = random.Random(7)
    values = []
    for _ in range(100):
        v = rng.randint(0, 2**20)
        values.extend([v] * rng.randint(1, 10))
    values.extend([0, 0, 0, 5, 0])
    enc = encoding.UintOptRleEncoder()
    for v in values:
        enc.write(v)
    dec = decoding.UintOptRleDecoder(enc.to_bytes())
    for v in values:
        assert dec.read() == v


def test_int_diff_opt_rle_roundtrip():
    rng = random.Random(13)
    values = []
    cur = 0
    for _ in range(500):
        cur += rng.randint(-50, 50)
        values.append(cur)
    values.extend([10, 11, 12, 13, 5, 4, 3, 0, 0, 0])
    enc = encoding.IntDiffOptRleEncoder()
    for v in values:
        enc.write(v)
    dec = decoding.IntDiffOptRleDecoder(enc.to_bytes())
    for v in values:
        assert dec.read() == v


def test_string_encoder_roundtrip():
    values = ["hello", "", "wörld", "x" * 50, "short", "\n"]
    enc = encoding.StringEncoder()
    for v in values:
        enc.write(v)
    dec = decoding.StringDecoder(enc.to_bytes())
    for v in values:
        assert dec.read() == v
