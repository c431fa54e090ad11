"""The 2-step state-vector sync handshake.

The reference keeps this in the external y-protocols package (see reference
INTERNALS.md:145-166 and tests/testHelper.js:6,51-52,160); here it is a
first-class framework module, byte-compatible with y-protocols/sync.js:

- step 1: send your state vector
- step 2: reply with `encode_state_as_update(doc, remote_sv)`
- update: incremental broadcast

Transport framing beyond these 3 message types (websocket, webrtc, ...)
remains provider territory (yjs_tpu_torch/provider).
"""

from __future__ import annotations

from ..core import Doc
from ..lib0 import decoding, encoding
from ..lib0.decoding import Decoder
from ..lib0.encoding import Encoder
from ..obs import global_registry
from ..updates import apply_update, encode_state_as_update, encode_state_vector

MESSAGE_YJS_SYNC_STEP_1 = 0
MESSAGE_YJS_SYNC_STEP_2 = 1
MESSAGE_YJS_UPDATE = 2

# skip-and-count marker returned by read_sync_message for frames it
# tolerated but could not dispatch (unknown type / malformed payload)
MESSAGE_UNKNOWN = -1

_TYPE_NAMES = {
    MESSAGE_YJS_SYNC_STEP_1: "step1",
    MESSAGE_YJS_SYNC_STEP_2: "step2",
    MESSAGE_YJS_UPDATE: "update",
}

# per-frame counters live on the process-global registry (these are free
# functions with no engine handle); engine/provider exposition merges it
_frames = global_registry().get("ytpu_sync_messages_total")


def _count(direction: str, message_type: int) -> None:
    if _frames is not None:
        # unknown types count under "unknown" instead of KeyError'ing —
        # a hostile peer must never be able to crash the frame counter
        name = _TYPE_NAMES.get(message_type, "unknown")
        _frames.labels(dir=direction, type=name).inc()


def write_sync_step1(encoder: Encoder, doc: Doc) -> None:
    encoding.write_var_uint(encoder, MESSAGE_YJS_SYNC_STEP_1)
    encoding.write_var_uint8_array(encoder, encode_state_vector(doc))
    _count("write", MESSAGE_YJS_SYNC_STEP_1)


def write_sync_step2(encoder: Encoder, doc: Doc, encoded_state_vector: bytes | None = None) -> None:
    encoding.write_var_uint(encoder, MESSAGE_YJS_SYNC_STEP_2)
    encoding.write_var_uint8_array(encoder, encode_state_as_update(doc, encoded_state_vector))
    _count("write", MESSAGE_YJS_SYNC_STEP_2)


def read_sync_step1(decoder: Decoder, encoder: Encoder, doc: Doc) -> None:
    _count("read", MESSAGE_YJS_SYNC_STEP_1)
    write_sync_step2(encoder, doc, decoding.read_var_uint8_array(decoder))


def read_sync_step2(decoder: Decoder, doc: Doc, transaction_origin=None,
                    slo=None) -> None:
    _count("read", MESSAGE_YJS_SYNC_STEP_2)
    _apply(decoder, doc, transaction_origin, slo)


def _apply(decoder: Decoder, doc: Doc, transaction_origin, slo) -> None:
    """Apply one framed update payload, optionally stamping convergence
    timestamps on a :class:`yjs_tpu_torch.obs.slo.ConvergenceTracker` — the
    receive seam for CPU-doc deployments (a Doc integrates synchronously,
    so receive → integrate → visible collapse into this one call; the
    bytes on the wire are untouched)."""
    u = decoding.read_var_uint8_array(decoder)
    if slo is None:
        apply_update(doc, u, transaction_origin)
        return
    key = slo.receive(u)
    try:
        apply_update(doc, u, transaction_origin)
    except Exception:
        slo.rejected(key)
        raise
    slo.integrated(key)
    slo.visible()


def write_update(encoder: Encoder, update: bytes) -> None:
    encoding.write_var_uint(encoder, MESSAGE_YJS_UPDATE)
    encoding.write_var_uint8_array(encoder, update)
    _count("write", MESSAGE_YJS_UPDATE)


def read_update_message(decoder: Decoder, doc: Doc, transaction_origin=None,
                        slo=None) -> None:
    """Same wire handling as read_sync_step2 (an update IS a partial
    step-2 payload); counted separately so frame-type traffic is visible."""
    _count("read", MESSAGE_YJS_UPDATE)
    _apply(decoder, doc, transaction_origin, slo)


def read_sync_message(decoder: Decoder, encoder: Encoder, doc: Doc,
                      transaction_origin=None, slo=None) -> int:
    """Dispatch one sync frame; returns its message type.

    Tolerant by contract (y-protocols sync.js readSyncMessage logs and
    continues): a frame whose type is unknown — a newer protocol
    revision, or transport corruption of the type varint — is counted
    as ``ytpu_sync_messages_total{type="unknown"}`` and skipped, and
    :data:`MESSAGE_UNKNOWN` is returned so callers can surface it.  A
    truncated/garbage type varint raises ``ValueError`` as before (there
    is no frame to skip past)."""
    message_type = decoding.read_var_uint(decoder)
    if message_type == MESSAGE_YJS_SYNC_STEP_1:
        read_sync_step1(decoder, encoder, doc)
    elif message_type == MESSAGE_YJS_SYNC_STEP_2:
        read_sync_step2(decoder, doc, transaction_origin, slo=slo)
    elif message_type == MESSAGE_YJS_UPDATE:
        read_update_message(decoder, doc, transaction_origin, slo=slo)
    else:
        _count("read", message_type)
        return MESSAGE_UNKNOWN
    return message_type
