"""L4 sync & update pipeline: apply/encode updates, state vectors.

Semantics match reference src/utils/encoding.js:
- writeClientsStructs / readClientsStructRefs ... :71-198
- resumeStructIntegration (dependency-stack integrator) ... :225-321
- applyUpdate(V2)/readUpdate(V2) ... :431-478
- encodeStateAsUpdate(V2) / state-vector codec ... :490-611

Plus first-class batch ops the v13.4.9 reference lacks (SURVEY.md caveat):
``merge_updates`` and ``diff_update`` — implemented doc-free so the TPU
engine can use them column-to-column.
"""

from __future__ import annotations

from .coding import (
    DSDecoderV1,
    DSDecoderV2,
    DSEncoderV1,
    DSEncoderV2,
    UpdateDecoderV1,
    UpdateDecoderV2,
    UpdateEncoderV1,
    UpdateEncoderV2,
    default_ds_decoder,
    default_ds_encoder,
    default_update_decoder,
    default_update_encoder,
)
from .core import (
    GC,
    Doc,
    Item,
    StructStore,
    Transaction,
    create_delete_set_from_struct_store,
    find_index_ss,
    get_state,
    get_state_vector,
    read_and_apply_delete_set,
    read_item_content,
    transact,
    write_delete_set,
)
from .ids import ID, create_id
from .lib0 import decoding, encoding
from .lib0.binary import BIT6, BIT7, BIT8, BITS5
from .lib0.decoding import Decoder


# ---------------------------------------------------------------------------
# Write side
# ---------------------------------------------------------------------------

def _write_structs(encoder, structs: list, client: int, clock: int) -> None:
    """Write structs of one client from `clock` on
    (reference encoding.js:71-84)."""
    start_new_structs = find_index_ss(structs, clock)
    encoding.write_var_uint(encoder.rest_encoder, len(structs) - start_new_structs)
    encoder.write_client(client)
    encoding.write_var_uint(encoder.rest_encoder, clock)
    first_struct = structs[start_new_structs]
    first_struct.write(encoder, clock - first_struct.id.clock)
    for i in range(start_new_structs + 1, len(structs)):
        structs[i].write(encoder, 0)


def write_clients_structs(encoder, store: StructStore, _sm: dict[int, int]) -> None:
    """Write all structs newer than `_sm`, clients in DESCENDING order —
    which heavily improves the conflict algorithm on the receiving side
    (reference encoding.js:94-116)."""
    sm: dict[int, int] = {}
    for client, clock in _sm.items():
        if get_state(store, client) > clock:
            sm[client] = clock
    for client in get_state_vector(store):
        if client not in _sm:
            sm[client] = 0
    encoding.write_var_uint(encoder.rest_encoder, len(sm))
    for client, clock in sorted(sm.items(), key=lambda e: -e[0]):
        _write_structs(encoder, store.clients[client], client, clock)


def write_structs_from_transaction(encoder, transaction: Transaction) -> None:
    write_clients_structs(encoder, transaction.doc.store, transaction.before_state)


# ---------------------------------------------------------------------------
# Read side
# ---------------------------------------------------------------------------

def read_clients_struct_refs(decoder, client_refs: dict, doc: Doc) -> dict:
    """Decode the flat struct stream into per-client ref arrays
    (reference encoding.js:127-198)."""
    num_of_state_updates = decoding.read_var_uint(decoder.rest_decoder)
    for _ in range(num_of_state_updates):
        number_of_structs = decoding.read_var_uint(decoder.rest_decoder)
        refs = []
        client = decoder.read_client()
        clock = decoding.read_var_uint(decoder.rest_decoder)
        client_refs[client] = refs
        for _ in range(number_of_structs):
            info = decoder.read_info()
            if (BITS5 & info) != 0:
                # an Item; whether parent info is encoded depends on the
                # presence of origin/rightOrigin
                cant_copy_parent_info = (info & (BIT7 | BIT8)) == 0
                origin = decoder.read_left_id() if (info & BIT8) == BIT8 else None
                right_origin = decoder.read_right_id() if (info & BIT7) == BIT7 else None
                if cant_copy_parent_info:
                    if decoder.read_parent_info():
                        parent = doc.get(decoder.read_string())
                    else:
                        parent = decoder.read_left_id()
                else:
                    parent = None
                parent_sub = (
                    decoder.read_string()
                    if cant_copy_parent_info and (info & BIT6) == BIT6
                    else None
                )
                struct = Item(
                    create_id(client, clock),
                    None,
                    origin,
                    None,
                    right_origin,
                    parent,
                    parent_sub,
                    read_item_content(decoder, info),
                )
                refs.append(struct)
                clock += struct.length
            else:
                ln = decoder.read_len()
                refs.append(GC(create_id(client, clock), ln))
                clock += ln
    return client_refs


def _resume_struct_integration(transaction: Transaction, store: StructStore) -> bool:
    """Iterative dependency-stack integrator (reference
    encoding.js:225-321).  A chain stalled on a missing causal dep is
    PARKED — the chained structs go back into their clients' pending
    refs and those clients retire from this pass — while integration
    continues for every other client (the reference's restStructs /
    addStackToRestSS mechanism).  Without parking, one permanently-lost
    struct (e.g. dropped on every replica) would block unrelated
    clients' structs forever and replicas could never reconverge.

    Returns True if at least one struct integrated (callers loop to a
    fixpoint so cross-client cascades drain in one apply)."""
    stack = store.pending_stack
    clients_struct_refs = store.pending_clients_struct_refs
    client_ids = sorted(clients_struct_refs.keys())
    if not client_ids and not stack:
        return False
    parked: set[int] = set()
    progressed = False

    def park_stalled(chain):
        for item in chain:
            c = item.id.client
            refs = clients_struct_refs.get(c)
            if refs is None:
                refs = clients_struct_refs[c] = {"refs": [], "i": 0}
            rest = refs["refs"][refs["i"]:]
            rest.append(item)
            rest.sort(key=lambda s: s.id.clock)
            refs["refs"] = rest
            refs["i"] = 0
            parked.add(c)
        client_ids[:] = [c for c in client_ids if c not in parked]
        stack.clear()

    def get_next_structs_target():
        if not client_ids:
            return None
        target = clients_struct_refs[client_ids[-1]]
        while len(target["refs"]) == target["i"]:
            client_ids.pop()
            if not client_ids:
                return None
            target = clients_struct_refs[client_ids[-1]]
        return target

    cur_structs_target = get_next_structs_target()
    if cur_structs_target is None and not stack:
        return False

    if stack:
        stack_head = stack.pop()
    else:
        stack_head = cur_structs_target["refs"][cur_structs_target["i"]]
        cur_structs_target["i"] += 1

    state_cache: dict[int, int] = {}
    while True:
        client = stack_head.id.client
        local_clock = state_cache.get(client)
        if local_clock is None:
            local_clock = get_state(store, client)
            state_cache[client] = local_clock
        offset = local_clock - stack_head.id.clock if stack_head.id.clock < local_clock else 0
        if stack_head.id.clock + offset != local_clock:
            # a previous struct from this client is missing: maybe a pending
            # ref with a smaller clock can fill the gap
            struct_refs = clients_struct_refs.get(client) or {"refs": [], "i": 0}
            if len(struct_refs["refs"]) != struct_refs["i"]:
                r = struct_refs["refs"][struct_refs["i"]]
                if r.id.clock < stack_head.id.clock:
                    struct_refs["refs"][struct_refs["i"]] = stack_head
                    stack_head = r
                    remaining = sorted(
                        struct_refs["refs"][struct_refs["i"]:], key=lambda s: s.id.clock
                    )
                    struct_refs["refs"] = remaining
                    struct_refs["i"] = 0
                    continue
            # the gap-filler hasn't arrived: park this chain, keep going
            park_stalled(stack + [stack_head])
            cur_structs_target = get_next_structs_target()
            if cur_structs_target is None:
                break
            stack_head = cur_structs_target["refs"][cur_structs_target["i"]]
            cur_structs_target["i"] += 1
            continue
        missing = stack_head.get_missing(transaction, store)
        if missing is None:
            if offset == 0 or offset < stack_head.length:
                stack_head.integrate(transaction, offset)
                state_cache[client] = stack_head.id.clock + stack_head.length
                progressed = True
            if stack:
                stack_head = stack.pop()
            elif (
                cur_structs_target is not None
                and cur_structs_target["i"] < len(cur_structs_target["refs"])
            ):
                stack_head = cur_structs_target["refs"][cur_structs_target["i"]]
                cur_structs_target["i"] += 1
            else:
                cur_structs_target = get_next_structs_target()
                if cur_structs_target is None:
                    break
                stack_head = cur_structs_target["refs"][cur_structs_target["i"]]
                cur_structs_target["i"] += 1
        else:
            struct_refs = clients_struct_refs.get(missing) or {"refs": [], "i": 0}
            if len(struct_refs["refs"]) == struct_refs["i"]:
                # causally depends on a not-yet-received update: park
                park_stalled(stack + [stack_head])
                cur_structs_target = get_next_structs_target()
                if cur_structs_target is None:
                    break
                stack_head = cur_structs_target["refs"][cur_structs_target["i"]]
                cur_structs_target["i"] += 1
                continue
            stack.append(stack_head)
            stack_head = struct_refs["refs"][struct_refs["i"]]
            struct_refs["i"] += 1
    # everything not parked either integrated or was fully consumed
    for c in list(clients_struct_refs):
        if c not in parked:
            del clients_struct_refs[c]
    return progressed


def try_resume_pending_delete_readers(transaction: Transaction, store: StructStore) -> None:
    pending_readers = store.pending_delete_readers
    store.pending_delete_readers = []
    for reader in pending_readers:
        read_and_apply_delete_set(reader, transaction, store)


def _merge_read_structs_into_pending_reads(store: StructStore, clients_structs_refs: dict) -> None:
    pending = store.pending_clients_struct_refs
    for client, struct_refs in clients_structs_refs.items():
        pending_refs = pending.get(client)
        if pending_refs is None:
            pending[client] = {"refs": struct_refs, "i": 0}
        else:
            merged = (
                pending_refs["refs"][pending_refs["i"]:]
                if pending_refs["i"] > 0
                else pending_refs["refs"]
            )
            merged.extend(struct_refs)
            pending_refs["i"] = 0
            pending_refs["refs"] = sorted(merged, key=lambda r: r.id.clock)


def _cleanup_pending_structs(pending_clients_struct_refs: dict) -> None:
    for client in list(pending_clients_struct_refs.keys()):
        refs = pending_clients_struct_refs[client]
        if refs["i"] == len(refs["refs"]):
            del pending_clients_struct_refs[client]
        else:
            del refs["refs"][: refs["i"]]
            refs["i"] = 0


def read_structs(decoder, transaction: Transaction, store: StructStore) -> None:
    clients_struct_refs: dict = {}
    read_clients_struct_refs(decoder, clients_struct_refs, transaction.doc)
    _merge_read_structs_into_pending_reads(store, clients_struct_refs)
    # fixpoint: each pass may integrate structs that unblock a client
    # parked in an earlier pass (the reference achieves the same by
    # recursively re-applying store.pendingStructs on progress)
    progressed = True
    while progressed and store.pending_clients_struct_refs:
        progressed = _resume_struct_integration(transaction, store)
        _cleanup_pending_structs(store.pending_clients_struct_refs)
    try_resume_pending_delete_readers(transaction, store)


# ---------------------------------------------------------------------------
# Public apply/encode API
# ---------------------------------------------------------------------------

def read_update_v2(decoder: Decoder, ydoc: Doc, transaction_origin=None, struct_decoder=None):
    if struct_decoder is None:
        struct_decoder = UpdateDecoderV2(decoder)

    def _apply(transaction):
        read_structs(struct_decoder, transaction, ydoc.store)
        read_and_apply_delete_set(struct_decoder, transaction, ydoc.store)

    transact(ydoc, _apply, transaction_origin, False)


def read_update(decoder: Decoder, ydoc: Doc, transaction_origin=None):
    read_update_v2(decoder, ydoc, transaction_origin, default_update_decoder(decoder))


def apply_update_v2(ydoc: Doc, update: bytes, transaction_origin=None, YDecoder=UpdateDecoderV2):
    decoder = Decoder(update)
    read_update_v2(decoder, ydoc, transaction_origin, YDecoder(decoder))


def apply_update(ydoc: Doc, update: bytes, transaction_origin=None):
    decoder = Decoder(update)
    read_update_v2(decoder, ydoc, transaction_origin, default_update_decoder(decoder))


def write_state_as_update(encoder, doc: Doc, target_state_vector: dict | None = None) -> None:
    write_clients_structs(encoder, doc.store, target_state_vector or {})
    write_delete_set(encoder, create_delete_set_from_struct_store(doc.store))


def encode_state_as_update_v2(doc: Doc, encoded_target_state_vector: bytes | None = None, encoder=None) -> bytes:
    if encoder is None:
        encoder = UpdateEncoderV2()
    target_sv = (
        {}
        if encoded_target_state_vector is None
        else decode_state_vector(encoded_target_state_vector)
    )
    write_state_as_update(encoder, doc, target_sv)
    return encoder.to_bytes()


def encode_state_as_update(doc: Doc, encoded_target_state_vector: bytes | None = None) -> bytes:
    return encode_state_as_update_v2(doc, encoded_target_state_vector, default_update_encoder())


def read_state_vector(decoder) -> dict[int, int]:
    ss: dict[int, int] = {}
    ss_length = decoding.read_var_uint(decoder.rest_decoder)
    for _ in range(ss_length):
        client = decoding.read_var_uint(decoder.rest_decoder)
        clock = decoding.read_var_uint(decoder.rest_decoder)
        ss[client] = clock
    return ss


def decode_state_vector_v2(decoded_state: bytes) -> dict[int, int]:
    return read_state_vector(DSDecoderV2(Decoder(decoded_state)))


def decode_state_vector(decoded_state: bytes) -> dict[int, int]:
    return read_state_vector(default_ds_decoder(Decoder(decoded_state)))


def write_state_vector(encoder, sv: dict[int, int]):
    encoding.write_var_uint(encoder.rest_encoder, len(sv))
    for client, clock in sv.items():
        encoding.write_var_uint(encoder.rest_encoder, client)
        encoding.write_var_uint(encoder.rest_encoder, clock)
    return encoder


def write_document_state_vector(encoder, doc: Doc):
    return write_state_vector(encoder, get_state_vector(doc.store))


def encode_state_vector_v2(doc: Doc, encoder=None) -> bytes:
    if encoder is None:
        encoder = DSEncoderV2()
    write_document_state_vector(encoder, doc)
    return encoder.to_bytes()


def encode_state_vector(doc: Doc) -> bytes:
    return encode_state_vector_v2(doc, default_ds_encoder())


# ---------------------------------------------------------------------------
# Validating decoder entry point (resilience seam)
# ---------------------------------------------------------------------------

class InvalidUpdate(ValueError):
    """Raised by :func:`validate_update` for bytes that cannot be decoded
    as a complete V1/V2 update (truncation, bit corruption, varint
    overflow, garbage framing).

    Distinct from :class:`yjs_tpu.ops.columns.UnsupportedUpdate`: that
    marks WELL-FORMED traffic outside the device path's scope (demote to
    the CPU core); this marks bytes no path can apply (quarantine +
    dead-letter, never integrate)."""


def validate_update(update: bytes, v2: bool = False) -> dict:
    """Structurally decode ``update`` without applying it anywhere.

    The single validation seam the resilience layer (quarantine,
    dead-letter triage, chaos suite) trusts: it walks the full struct
    section and the trailing DeleteSet exactly like integration would,
    so bytes that pass here decode on both the CPU core and the mirror
    planner.  Returns a summary ``{"clients", "structs", "ds_ranges",
    "bytes"}``; raises :class:`InvalidUpdate` on malformed input.
    """
    if not isinstance(update, (bytes, bytearray, memoryview)):
        raise InvalidUpdate(f"not a bytes payload: {type(update).__name__}")
    update = bytes(update)
    if not update:
        raise InvalidUpdate("empty update")
    # the doc-free ref scanner is the same decoder the flush planner runs
    # (native columnar scan with pure-Python arbitration on failure)
    from .ops.columns import decode_update_refs

    try:
        refs, ds = decode_update_refs(update, v2)
    except Exception as e:
        raise InvalidUpdate(f"{type(e).__name__}: {e}") from e
    return {
        "clients": len(refs),
        "structs": sum(len(rs) for rs in refs.values()),
        "ds_ranges": len(ds),
        "bytes": len(update),
    }


# ---------------------------------------------------------------------------
# Batch ops absent from the v13.4.9 reference (SURVEY.md version caveat):
# merge/diff directly on encoded updates.  The doc-level implementation here
# is the semantic oracle; the columnar engine in yjs_tpu/ops implements the
# same contract over struct-of-arrays.
# ---------------------------------------------------------------------------

def merge_updates(updates: list[bytes], v2: bool = False) -> bytes:
    """Merge several (possibly concurrent) updates into one equivalent
    update, by replaying them into a gc-disabled scratch doc and re-encoding
    full state.  Updates are commutative and idempotent, so any order works
    (reference README.md:650-652)."""
    doc = Doc(gc=False)
    for update in updates:
        if v2:
            apply_update_v2(doc, update)
        else:
            apply_update(doc, update)
    return encode_state_as_update_v2(doc) if v2 else encode_state_as_update(doc)


def merge_updates_v2(updates: list[bytes]) -> bytes:
    return merge_updates(updates, v2=True)


def diff_update(update: bytes, state_vector: bytes, v2: bool = False) -> bytes:
    """Extract from `update` only what a peer at `state_vector` is missing."""
    doc = Doc(gc=False)
    if v2:
        apply_update_v2(doc, update)
        return encode_state_as_update_v2(doc, state_vector)
    apply_update(doc, update)
    return encode_state_as_update(doc, state_vector)


def diff_update_v2(update: bytes, state_vector: bytes) -> bytes:
    return diff_update(update, state_vector, v2=True)


def encode_state_vector_from_update(update: bytes, v2: bool = False) -> bytes:
    doc = Doc(gc=False)
    if v2:
        apply_update_v2(doc, update)
    else:
        apply_update(doc, update)
    return encode_state_vector(doc)


def convert_update_format(update: bytes, from_v2: bool, to_v2: bool) -> bytes:
    """Transcode an update between V1 and V2 wire formats."""
    doc = Doc(gc=False)
    if from_v2:
        apply_update_v2(doc, update)
    else:
        apply_update(doc, update)
    return encode_state_as_update_v2(doc) if to_v2 else encode_state_as_update(doc)
