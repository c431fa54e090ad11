"""Snapshot: DeleteSet + state vector = a point-in-time view
(reference src/utils/Snapshot.js)."""

from __future__ import annotations

from ..coding import DSDecoderV1, DSDecoderV2, DSEncoderV2, UpdateEncoderV2, default_ds_encoder
from ..core import (
    DeleteSet,
    Doc,
    create_delete_set_from_struct_store,
    find_index_ss,
    get_item_clean_start,
    get_state,
    get_state_vector,
    is_deleted,
    iterate_deleted_structs,
    read_delete_set,
    write_delete_set,
)
from ..ids import create_id
from ..lib0 import encoding
from ..lib0.decoding import Decoder
from ..updates import apply_update_v2, read_state_vector, write_state_vector


class Snapshot:
    __slots__ = ("ds", "sv")

    def __init__(self, ds: DeleteSet, sv: dict[int, int]):
        self.ds = ds
        self.sv = sv


def equal_snapshots(snap1: Snapshot, snap2: Snapshot) -> bool:
    ds1 = snap1.ds.clients
    ds2 = snap2.ds.clients
    sv1 = snap1.sv
    sv2 = snap2.sv
    if len(sv1) != len(sv2) or len(ds1) != len(ds2):
        return False
    for key, value in sv1.items():
        if sv2.get(key) != value:
            return False
    for client, dsitems1 in ds1.items():
        dsitems2 = ds2.get(client, [])
        if len(dsitems1) != len(dsitems2):
            return False
        for d1, d2 in zip(dsitems1, dsitems2):
            if d1.clock != d2.clock or d1.len != d2.len:
                return False
    return True


def encode_snapshot_v2(snapshot: Snapshot, encoder=None) -> bytes:
    if encoder is None:
        encoder = DSEncoderV2()
    write_delete_set(encoder, snapshot.ds)
    write_state_vector(encoder, snapshot.sv)
    return encoder.to_bytes()


def encode_snapshot(snapshot: Snapshot) -> bytes:
    return encode_snapshot_v2(snapshot, default_ds_encoder())


def decode_snapshot_v2(buf: bytes, decoder=None) -> Snapshot:
    if decoder is None:
        decoder = DSDecoderV2(Decoder(buf))
    return Snapshot(read_delete_set(decoder), read_state_vector(decoder))


def decode_snapshot(buf: bytes) -> Snapshot:
    return decode_snapshot_v2(buf, DSDecoderV1(Decoder(buf)))


def create_snapshot(ds: DeleteSet, sm: dict[int, int]) -> Snapshot:
    return Snapshot(ds, sm)


def empty_snapshot() -> Snapshot:
    return create_snapshot(DeleteSet(), {})


def snapshot(doc: Doc) -> Snapshot:
    return create_snapshot(
        create_delete_set_from_struct_store(doc.store), get_state_vector(doc.store)
    )


def is_visible(item, snap: Snapshot | None) -> bool:
    """Point-in-time visibility (reference Snapshot.js:133-135)."""
    if snap is None:
        return not item.deleted
    return (
        item.id.client in snap.sv
        and snap.sv.get(item.id.client, 0) > item.id.clock
        and not is_deleted(snap.ds, item.id)
    )


_SPLIT_META_KEY = "split_snapshot_affected_structs"


def split_snapshot_affected_structs(transaction, snap: Snapshot) -> None:
    """Pre-split items at snapshot boundaries, memoized per transaction
    (reference Snapshot.js:141-154)."""
    meta = transaction.meta.setdefault(_SPLIT_META_KEY, set())
    store = transaction.doc.store
    if snap not in meta:
        for client, clock in snap.sv.items():
            if clock < get_state(store, client):
                get_item_clean_start(transaction, create_id(client, clock))
        iterate_deleted_structs(transaction, snap.ds, lambda item: None)
        meta.add(snap)


def create_doc_from_snapshot(origin_doc: Doc, snap: Snapshot, new_doc: Doc | None = None) -> Doc:
    """Re-encode truncated history into a fresh doc; requires gc off
    (reference Snapshot.js:162-202)."""
    if origin_doc.gc:
        raise RuntimeError("originDoc must not be garbage collected")
    if new_doc is None:
        new_doc = Doc()
    sv = snap.sv
    ds = snap.ds
    encoder = UpdateEncoderV2()

    def _encode(transaction):
        size = sum(1 for clock in sv.values() if clock > 0)
        encoding.write_var_uint(encoder.rest_encoder, size)
        for client, clock in sv.items():
            if clock == 0:
                continue
            if clock < get_state(origin_doc.store, client):
                get_item_clean_start(transaction, create_id(client, clock))
            structs = origin_doc.store.clients.get(client, [])
            last_struct_index = find_index_ss(structs, clock - 1)
            encoding.write_var_uint(encoder.rest_encoder, last_struct_index + 1)
            encoder.write_client(client)
            encoding.write_var_uint(encoder.rest_encoder, 0)
            for i in range(last_struct_index + 1):
                structs[i].write(encoder, 0)
        write_delete_set(encoder, ds)

    origin_doc.transact(_encode)
    apply_update_v2(new_doc, encoder.to_bytes(), "snapshot")
    return new_doc
