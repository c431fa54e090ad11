"""Update/DeleteSet wire encoders and decoders, V1 and V2.

Byte-compatible with the reference encoder hierarchy:
- V1: plain varints (reference src/utils/UpdateEncoder.js:110-227)
- V2: 9 independent columnar streams, each RLE/diff-RLE compressed and
  length-prefixed, plus an uncompressed "rest" stream appended at the end
  (reference src/utils/UpdateEncoder.js:264-408, UpdateDecoder.js:245-392).

The V2 layout *is* the struct-of-arrays format the TPU batch engine
(yjs_tpu.ops) consumes directly.
"""

from __future__ import annotations

import json

from .ids import ID
from .lib0 import decoding, encoding
from .lib0.decoding import (
    Decoder,
    IntDiffOptRleDecoder,
    RleDecoder,
    StringDecoder,
    UintOptRleDecoder,
)
from .lib0.encoding import (
    Encoder,
    IntDiffOptRleEncoder,
    RleEncoder,
    StringEncoder,
    UintOptRleEncoder,
)


# ---------------------------------------------------------------------------
# DeleteSet coders
# ---------------------------------------------------------------------------

class DSEncoderV1:
    def __init__(self):
        self.rest_encoder = Encoder()

    def to_bytes(self) -> bytes:
        return self.rest_encoder.to_bytes()

    def reset_ds_cur_val(self) -> None:
        pass

    def write_ds_clock(self, clock: int) -> None:
        encoding.write_var_uint(self.rest_encoder, clock)

    def write_ds_len(self, ln: int) -> None:
        encoding.write_var_uint(self.rest_encoder, ln)


class DSDecoderV1:
    def __init__(self, decoder: Decoder):
        self.rest_decoder = decoder

    def reset_ds_cur_val(self) -> None:
        pass

    def read_ds_clock(self) -> int:
        return decoding.read_var_uint(self.rest_decoder)

    def read_ds_len(self) -> int:
        return decoding.read_var_uint(self.rest_decoder)


class DSEncoderV2:
    """Delta-encodes DS clocks within each client
    (reference src/utils/UpdateEncoder.js:229-262)."""

    def __init__(self):
        self.rest_encoder = Encoder()
        self.ds_curr_val = 0

    def to_bytes(self) -> bytes:
        return self.rest_encoder.to_bytes()

    def reset_ds_cur_val(self) -> None:
        self.ds_curr_val = 0

    def write_ds_clock(self, clock: int) -> None:
        diff = clock - self.ds_curr_val
        self.ds_curr_val = clock
        encoding.write_var_uint(self.rest_encoder, diff)

    def write_ds_len(self, ln: int) -> None:
        if ln == 0:
            raise ValueError("delete-set range length must be > 0")
        encoding.write_var_uint(self.rest_encoder, ln - 1)
        self.ds_curr_val += ln


class DSDecoderV2:
    def __init__(self, decoder: Decoder):
        self.rest_decoder = decoder
        self.ds_curr_val = 0

    def reset_ds_cur_val(self) -> None:
        self.ds_curr_val = 0

    def read_ds_clock(self) -> int:
        self.ds_curr_val += decoding.read_var_uint(self.rest_decoder)
        return self.ds_curr_val

    def read_ds_len(self) -> int:
        diff = decoding.read_var_uint(self.rest_decoder) + 1
        self.ds_curr_val += diff
        return diff


# ---------------------------------------------------------------------------
# Update coders, V1
# ---------------------------------------------------------------------------

class UpdateEncoderV1(DSEncoderV1):
    def write_left_id(self, id: ID) -> None:
        encoding.write_var_uint(self.rest_encoder, id.client)
        encoding.write_var_uint(self.rest_encoder, id.clock)

    def write_right_id(self, id: ID) -> None:
        encoding.write_var_uint(self.rest_encoder, id.client)
        encoding.write_var_uint(self.rest_encoder, id.clock)

    def write_client(self, client: int) -> None:
        encoding.write_var_uint(self.rest_encoder, client)

    def write_info(self, info: int) -> None:
        encoding.write_uint8(self.rest_encoder, info)

    def write_string(self, s: str) -> None:
        encoding.write_var_string(self.rest_encoder, s)

    def write_parent_info(self, is_ykey: bool) -> None:
        encoding.write_var_uint(self.rest_encoder, 1 if is_ykey else 0)

    def write_type_ref(self, info: int) -> None:
        encoding.write_var_uint(self.rest_encoder, info)

    def write_len(self, ln: int) -> None:
        encoding.write_var_uint(self.rest_encoder, ln)

    def write_any(self, any_) -> None:
        encoding.write_any(self.rest_encoder, any_)

    def write_buf(self, buf: bytes) -> None:
        encoding.write_var_uint8_array(self.rest_encoder, buf)

    def write_json(self, embed) -> None:
        # V1 keeps legacy JSON-string encoding (UpdateEncoder.js:217-219)
        encoding.write_var_string(self.rest_encoder, _json_stringify(embed))

    def write_key(self, key: str) -> None:
        encoding.write_var_string(self.rest_encoder, key)


class UpdateDecoderV1(DSDecoderV1):
    def read_left_id(self) -> ID:
        return ID(
            decoding.read_var_uint(self.rest_decoder),
            decoding.read_var_uint(self.rest_decoder),
        )

    def read_right_id(self) -> ID:
        return self.read_left_id()

    def read_client(self) -> int:
        return decoding.read_var_uint(self.rest_decoder)

    def read_info(self) -> int:
        return decoding.read_uint8(self.rest_decoder)

    def read_string(self) -> str:
        return decoding.read_var_string(self.rest_decoder)

    def read_parent_info(self) -> bool:
        return decoding.read_var_uint(self.rest_decoder) == 1

    def read_type_ref(self) -> int:
        return decoding.read_var_uint(self.rest_decoder)

    def read_len(self) -> int:
        return decoding.read_var_uint(self.rest_decoder)

    def read_any(self):
        return decoding.read_any(self.rest_decoder)

    def read_buf(self) -> bytes:
        return decoding.read_var_uint8_array(self.rest_decoder)

    def read_json(self):
        return _json_parse(decoding.read_var_string(self.rest_decoder))

    def read_key(self) -> str:
        return decoding.read_var_string(self.rest_decoder)


# ---------------------------------------------------------------------------
# Update coders, V2 (columnar)
# ---------------------------------------------------------------------------

class UpdateEncoderV2(DSEncoderV2):
    def __init__(self):
        super().__init__()
        self.key_clock = 0
        self.key_map: dict[str, int] = {}
        self.key_clock_encoder = IntDiffOptRleEncoder()
        self.client_encoder = UintOptRleEncoder()
        self.left_clock_encoder = IntDiffOptRleEncoder()
        self.right_clock_encoder = IntDiffOptRleEncoder()
        self.info_encoder = RleEncoder()
        self.string_encoder = StringEncoder()
        self.parent_info_encoder = RleEncoder()
        self.type_ref_encoder = UintOptRleEncoder()
        self.len_encoder = UintOptRleEncoder()

    def to_bytes(self) -> bytes:
        encoder = Encoder()
        encoding.write_uint8(encoder, 0)  # feature flag, always 0 in v13.4
        encoding.write_var_uint8_array(encoder, self.key_clock_encoder.to_bytes())
        encoding.write_var_uint8_array(encoder, self.client_encoder.to_bytes())
        encoding.write_var_uint8_array(encoder, self.left_clock_encoder.to_bytes())
        encoding.write_var_uint8_array(encoder, self.right_clock_encoder.to_bytes())
        encoding.write_var_uint8_array(encoder, self.info_encoder.to_bytes())
        encoding.write_var_uint8_array(encoder, self.string_encoder.to_bytes())
        encoding.write_var_uint8_array(encoder, self.parent_info_encoder.to_bytes())
        encoding.write_var_uint8_array(encoder, self.type_ref_encoder.to_bytes())
        encoding.write_var_uint8_array(encoder, self.len_encoder.to_bytes())
        # the rest stream is appended raw (no length prefix)
        encoding.write_uint8_array(encoder, self.rest_encoder.to_bytes())
        return encoder.to_bytes()

    def write_left_id(self, id: ID) -> None:
        self.client_encoder.write(id.client)
        self.left_clock_encoder.write(id.clock)

    def write_right_id(self, id: ID) -> None:
        self.client_encoder.write(id.client)
        self.right_clock_encoder.write(id.clock)

    def write_client(self, client: int) -> None:
        self.client_encoder.write(client)

    def write_info(self, info: int) -> None:
        self.info_encoder.write(info)

    def write_string(self, s: str) -> None:
        self.string_encoder.write(s)

    def write_parent_info(self, is_ykey: bool) -> None:
        self.parent_info_encoder.write(1 if is_ykey else 0)

    def write_type_ref(self, info: int) -> None:
        self.type_ref_encoder.write(info)

    def write_len(self, ln: int) -> None:
        self.len_encoder.write(ln)

    def write_any(self, any_) -> None:
        encoding.write_any(self.rest_encoder, any_)

    def write_buf(self, buf: bytes) -> None:
        encoding.write_var_uint8_array(self.rest_encoder, buf)

    def write_json(self, embed) -> None:
        encoding.write_any(self.rest_encoder, embed)

    def write_key(self, key: str) -> None:
        # Quirk preserved from the v13.4.9 encoder (UpdateEncoder.js:399-407):
        # key_map is consulted but never populated, so every key write emits a
        # fresh keyClock AND the key string.  The decoder's cache makes this
        # correct; we must reproduce it for byte-identical output.
        if self.key_map.get(key) is None:
            self.key_clock_encoder.write(self.key_clock)
            self.key_clock += 1
            self.string_encoder.write(key)
        else:
            self.key_clock_encoder.write(self.key_clock)
            self.key_clock += 1


class UpdateDecoderV2(DSDecoderV2):
    def __init__(self, decoder: Decoder):
        super().__init__(decoder)
        self.keys: list[str] = []
        decoding.read_uint8(decoder)  # feature flag
        self.key_clock_decoder = IntDiffOptRleDecoder(decoding.read_var_uint8_array(decoder))
        self.client_decoder = UintOptRleDecoder(decoding.read_var_uint8_array(decoder))
        self.left_clock_decoder = IntDiffOptRleDecoder(decoding.read_var_uint8_array(decoder))
        self.right_clock_decoder = IntDiffOptRleDecoder(decoding.read_var_uint8_array(decoder))
        self.info_decoder = RleDecoder(decoding.read_var_uint8_array(decoder))
        self.string_decoder = StringDecoder(decoding.read_var_uint8_array(decoder))
        self.parent_info_decoder = RleDecoder(decoding.read_var_uint8_array(decoder))
        self.type_ref_decoder = UintOptRleDecoder(decoding.read_var_uint8_array(decoder))
        self.len_decoder = UintOptRleDecoder(decoding.read_var_uint8_array(decoder))

    def read_left_id(self) -> ID:
        return ID(self.client_decoder.read(), self.left_clock_decoder.read())

    def read_right_id(self) -> ID:
        return ID(self.client_decoder.read(), self.right_clock_decoder.read())

    def read_client(self) -> int:
        return self.client_decoder.read()

    def read_info(self) -> int:
        return self.info_decoder.read()

    def read_string(self) -> str:
        return self.string_decoder.read()

    def read_parent_info(self) -> bool:
        return self.parent_info_decoder.read() == 1

    def read_type_ref(self) -> int:
        return self.type_ref_decoder.read()

    def read_len(self) -> int:
        return self.len_decoder.read()

    def read_any(self):
        return decoding.read_any(self.rest_decoder)

    def read_buf(self) -> bytes:
        return decoding.read_var_uint8_array(self.rest_decoder)

    def read_json(self):
        return decoding.read_any(self.rest_decoder)

    def read_key(self) -> str:
        key_clock = self.key_clock_decoder.read()
        if key_clock < len(self.keys):
            return self.keys[key_clock]
        key = self.string_decoder.read()
        self.keys.append(key)
        return key


# ---------------------------------------------------------------------------
# JSON helpers matching JS JSON.stringify/parse for the V1 embed encoding.
# Single source of truth — core.py imports these for ContentJSON.
# ---------------------------------------------------------------------------

def _json_stringify(value) -> str:
    return json.dumps(value, separators=(",", ":"), ensure_ascii=False)


def _json_parse(s: str):
    return json.loads(s)


# module-global default coder selection (reference src/utils/encoding.js:44-61)
_defaults = {
    "ds_encoder": DSEncoderV1,
    "ds_decoder": DSDecoderV1,
    "update_encoder": UpdateEncoderV1,
    "update_decoder": UpdateDecoderV1,
}


def use_v1_encoding() -> None:
    _defaults.update(
        ds_encoder=DSEncoderV1,
        ds_decoder=DSDecoderV1,
        update_encoder=UpdateEncoderV1,
        update_decoder=UpdateDecoderV1,
    )


def use_v2_encoding() -> None:
    _defaults.update(
        ds_encoder=DSEncoderV2,
        ds_decoder=DSDecoderV2,
        update_encoder=UpdateEncoderV2,
        update_decoder=UpdateDecoderV2,
    )


def default_ds_encoder():
    return _defaults["ds_encoder"]()


def default_ds_decoder(decoder):
    return _defaults["ds_decoder"](decoder)


def default_update_encoder():
    return _defaults["update_encoder"]()


def default_update_decoder(decoder):
    return _defaults["update_decoder"](decoder)
