"""Host-side columnar (struct-of-arrays) transcoding for the TPU batch engine.

This module replaces the reference's pointer-graph decode/integrate prelude
(reference src/utils/encoding.js:127-198, src/structs/Item.js:354-397) with a
columnar pipeline:

  wire update bytes
    -> ``ItemRef`` records (flat decode, no Doc required)
    -> causal schedule  (the dependency-stack integrator of
       encoding.js:225-321, recast as a per-client queue fixpoint)
    -> pre-split pass   (all run splits computed *before* device integration,
       mirroring what Snapshot.splitSnapshotAffectedStructs does for
       snapshots — reference src/utils/Snapshot.js:141-154 — so the device
       item table is static)
    -> ``StepPlan``     (padded int32 columns ready for the JAX kernel)

The :class:`DocMirror` is the host twin of one document's struct store: it owns
the immutable per-row columns (client, clock, length, origin, rightOrigin) and
the variable-length payloads (content objects live host-side only; device
memory holds fixed-width columns, per SURVEY.md §7 core data layout).  The
device owns the *dynamic* integration state: linked-list links, list head,
deleted bits.

Pre-splitting is sound because YATA placement of a run is determined
element-wise by (origin, rightOrigin, client) — integrating the fragments of a
run (each fragment's origin = last id of its left sibling fragment, rightOrigin
inherited, exactly the splitItem rule of reference src/structs/Item.js:84-120)
yields the same total order as integrating the whole run and splitting later.
"""

from __future__ import annotations

import bisect
import os
from dataclasses import dataclass, field

import numpy as np

from ..coding import UpdateDecoderV1, UpdateDecoderV2
from ..core import read_item_content
from ..lib0 import decoding
from ..lib0.binary import BIT6, BIT7, BIT8, BITS5
from ..lib0.decoding import Decoder
from ..native import SRC_DELETED, SRC_FRAMED, SRC_NONE, SRC_SPILL, SRC_UTF8
from . import plan_cache as _pc

NULL = -1  # null id / null row sentinel in every int column
# sched8 sentinels (shared with the level kernel, yjs_tpu/ops/kernels.py)
NO_LEFT_WRITE = -3  # chain member: placed by its predecessor's succ write
GATHER_SUCC = -2  # succ: the old successor of `check` (== right when fast)


# ---------------------------------------------------------------------------
# Flat decode: wire bytes -> ItemRef records (no Doc involved)
# ---------------------------------------------------------------------------


class LazyContent:
    """Content payload referenced by byte range, decoded only on demand.

    The native transcoder (yjs_tpu/native) emits byte offsets instead of
    decoding payloads; most rows are never materialized (state vectors,
    diffs, integration itself need no payload bytes).  ``end`` is the
    exclusive end of the V1-framed payload bytes: the native wire encoder
    copies [ofs, end) verbatim when re-emitting unsplit rows."""

    __slots__ = ("buf", "ofs", "end", "ref")

    def __init__(self, buf: bytes, ofs: int, ref: int, end: int = -1):
        self.buf = buf
        self.ofs = ofs
        self.end = end
        self.ref = ref

    def realize(self):
        decoder = Decoder(self.buf)
        decoder.pos = self.ofs
        return read_item_content(UpdateDecoderV1(decoder), self.ref)


class _TypeNameShim:
    """Minimal decoder stand-in for type_refs constructors (only XmlElement
    and XmlHook read anything: the node/hook name string)."""

    __slots__ = ("_name",)

    def __init__(self, name: str | None):
        self._name = name

    def read_string(self) -> str:
        return self._name

    read_key = read_string


class LazyContentV2:
    """V2 content payload as byte ranges into the update's stream regions
    (UTF-8 string arena / self-delimiting rest-stream values), decoded on
    demand — the V2 twin of :class:`LazyContent` (reference
    UpdateDecoder.js:270-293 stream layout)."""

    __slots__ = ("buf", "kind", "ofs", "end", "ofs2", "end2", "count")

    def __init__(self, buf, kind, ofs, end, ofs2, end2, count):
        self.buf = buf
        self.kind = kind
        self.ofs = ofs
        self.end = end
        self.ofs2 = ofs2
        self.end2 = end2
        self.count = count

    def _any_at(self, ofs: int):
        d = Decoder(self.buf)
        d.pos = ofs
        return decoding.read_any(d)

    def realize(self):
        from ..core import (
            ContentBinary,
            ContentEmbed,
            ContentFormat,
            ContentString,
            ContentType,
            type_refs,
        )
        from ..lib0.u16 import utf8_decode_u16

        k = self.kind
        if k == 4:
            return ContentString(utf8_decode_u16(self.buf[self.ofs : self.end]))
        if k == 8:
            from ..core import ContentAny

            d = Decoder(self.buf)
            d.pos = self.ofs
            return ContentAny([decoding.read_any(d) for _ in range(self.count)])
        if k == 6:
            return ContentFormat(
                utf8_decode_u16(self.buf[self.ofs : self.end]),
                self._any_at(self.ofs2),
            )
        if k == 5:
            return ContentEmbed(self._any_at(self.ofs))
        if k == 3:
            d = Decoder(self.buf)
            d.pos = self.ofs
            return ContentBinary(decoding.read_var_uint8_array(d))
        if k == 7:
            name = (
                utf8_decode_u16(self.buf[self.ofs : self.end])
                if self.ofs >= 0
                else None
            )
            return ContentType(type_refs[self.count](_TypeNameShim(name)))
        raise ValueError(f"unexpected lazy v2 content kind {k}")


@dataclass(slots=True)
class ItemRef:
    """A decoded, not-yet-integrated struct (Item or GC) as plain data."""

    client: int
    clock: int
    length: int
    origin: tuple[int, int] | None = None  # (client, clock)
    right_origin: tuple[int, int] | None = None
    parent_name: str | None = None  # root-type key
    parent_id: tuple[int, int] | None = None  # nested type-item parent id
    parent_sub: str | None = None
    content: object | None = None  # AbstractContent | LazyContent; None = GC
    content_ref: int = 0  # wire content-ref (0 = GC struct)
    is_gc: bool = False

    def materialize(self):
        if isinstance(self.content, (LazyContent, LazyContentV2)):
            self.content = self.content.realize()
        return self.content

    def split(self, offset: int) -> "ItemRef":
        """Split off and return the right part at ``offset`` elements
        (reference src/structs/Item.js:84-120 field rules)."""
        right_content = self.materialize().splice(offset)
        right = ItemRef(
            client=self.client,
            clock=self.clock + offset,
            length=self.length - offset,
            origin=(self.client, self.clock + offset - 1),
            right_origin=self.right_origin,
            parent_name=self.parent_name,
            parent_id=self.parent_id,
            parent_sub=self.parent_sub,
            content=right_content,
            content_ref=self.content_ref,
        )
        self.length = offset
        return right

    def trim_left(self, offset: int) -> None:
        """Drop the first ``offset`` already-known elements (the dedup
        `offset` path of reference src/structs/Item.js:745-755 and
        GC.js integrate)."""
        if self.content is not None:
            self.content = self.materialize().splice(offset)
        self.clock += offset
        self.length -= offset
        if not self.is_gc:
            self.origin = (self.client, self.clock - 1)


def decode_update_refs(update: bytes, v2: bool):
    """Decode an update into (refs_per_client, delete_ranges) without a Doc.

    Mirrors reference src/utils/encoding.js:127-198 (struct section) and
    src/utils/DeleteSet.js:270-285 (DS section header/ranges), but resolves
    nothing — root parents stay names, origins stay IDs.  V1 updates take
    the native columnar scanner when available (payloads stay lazy).
    """
    from ..native import NativeDecodeError

    try:
        if v2:
            return _decode_update_refs_native_v2(update)
        return _decode_update_refs_native(update)
    except NativeDecodeError:
        pass  # no toolchain / malformed input / legacy payload kinds: the
        # pure-Python decoder decides whether the bytes are really malformed
    decoder = Decoder(update)
    yd = UpdateDecoderV2(decoder) if v2 else UpdateDecoderV1(decoder)
    refs: dict[int, list[ItemRef]] = {}
    num_of_state_updates = decoding.read_var_uint(yd.rest_decoder)
    for _ in range(num_of_state_updates):
        number_of_structs = decoding.read_var_uint(yd.rest_decoder)
        client = yd.read_client()
        clock = decoding.read_var_uint(yd.rest_decoder)
        out = refs.setdefault(client, [])
        for _ in range(number_of_structs):
            info = yd.read_info()
            if (BITS5 & info) != 0:
                cant_copy_parent_info = (info & (BIT7 | BIT8)) == 0
                origin = yd.read_left_id() if (info & BIT8) == BIT8 else None
                right_origin = yd.read_right_id() if (info & BIT7) == BIT7 else None
                parent_name = None
                parent_id = None
                if cant_copy_parent_info:
                    if yd.read_parent_info():
                        parent_name = yd.read_string()
                    else:
                        pid = yd.read_left_id()
                        parent_id = (pid.client, pid.clock)
                parent_sub = (
                    yd.read_string()
                    if cant_copy_parent_info and (info & BIT6) == BIT6
                    else None
                )
                content = read_item_content(yd, info)
                ref = ItemRef(
                    client=client,
                    clock=clock,
                    length=content.get_length(),
                    origin=None if origin is None else (origin.client, origin.clock),
                    right_origin=None
                    if right_origin is None
                    else (right_origin.client, right_origin.clock),
                    parent_name=parent_name,
                    parent_id=parent_id,
                    parent_sub=parent_sub,
                    content=content,
                    content_ref=info & BITS5,
                )
                out.append(ref)
                clock += ref.length
            else:
                ln = yd.read_len()
                out.append(ItemRef(client=client, clock=clock, length=ln, is_gc=True))
                clock += ln

    # DS section (reference DeleteSet.js:270-285): (client, clock, len) ranges
    ds: list[tuple[int, int, int]] = []
    num_clients = decoding.read_var_uint(yd.rest_decoder)
    for _ in range(num_clients):
        yd.reset_ds_cur_val()
        client = decoding.read_var_uint(yd.rest_decoder)
        num_deletes = decoding.read_var_uint(yd.rest_decoder)
        for _ in range(num_deletes):
            ds.append((client, yd.read_ds_clock(), yd.read_ds_len()))
    return refs, ds


def _decode_update_refs_native(update: bytes):
    """Build ItemRefs from the native scanner's columns (V1 only)."""
    from ..lib0.u16 import utf8_decode_u16
    from ..native import decode_v1_columns

    cols, ds_cols = decode_v1_columns(update)
    refs: dict[int, list[ItemRef]] = {}
    n = len(cols["client"])
    # tolist() once: plain-int indexing is ~10x cheaper than boxing a numpy
    # scalar per field in the row loop
    client_a = cols["client"].tolist()
    clock_a = cols["clock"].tolist()
    length_a = cols["length"].tolist()
    oc, ok = cols["origin_client"].tolist(), cols["origin_clock"].tolist()
    rc, rk = cols["right_client"].tolist(), cols["right_clock"].tolist()
    info_a = cols["info"].tolist()
    pno, pnl = cols["parent_name_ofs"].tolist(), cols["parent_name_len"].tolist()
    pic, pik = cols["parent_id_client"].tolist(), cols["parent_id_clock"].tolist()
    pso, psl = cols["parent_sub_ofs"].tolist(), cols["parent_sub_len"].tolist()
    c_ofs = cols["content_ofs"].tolist()
    c_end = cols["content_end"].tolist()
    for i in range(n):
        client = client_a[i]
        ref_kind = info_a[i] & BITS5
        if ref_kind == 0:
            ref = ItemRef(
                client=client, clock=clock_a[i], length=length_a[i],
                is_gc=True,
            )
        else:
            ref = ItemRef(
                client=client,
                clock=clock_a[i],
                length=length_a[i],
                origin=None if oc[i] < 0 else (oc[i], ok[i]),
                right_origin=None if rc[i] < 0 else (rc[i], rk[i]),
                parent_name=None
                if pno[i] < 0
                else utf8_decode_u16(update[pno[i] : pno[i] + pnl[i]]),
                parent_id=None if pic[i] < 0 else (pic[i], pik[i]),
                parent_sub=None
                if pso[i] < 0
                else utf8_decode_u16(update[pso[i] : pso[i] + psl[i]]),
                content=LazyContent(update, c_ofs[i], info_a[i], c_end[i]),
                content_ref=ref_kind,
            )
        refs.setdefault(client, []).append(ref)
    ds = list(
        zip(
            ds_cols["client"].tolist(),
            ds_cols["clock"].tolist(),
            ds_cols["len"].tolist(),
        )
    )
    return refs, ds


def _decode_update_refs_native_v2(update: bytes):
    """Build ItemRefs from the native V2 scanner's columns."""
    from ..core import ContentDeleted
    from ..lib0.u16 import utf8_decode_u16
    from ..native import decode_v2_columns

    cols, ds_cols = decode_v2_columns(update)
    refs: dict[int, list[ItemRef]] = {}
    n = len(cols["client"])
    client_a = cols["client"].tolist()
    clock_a = cols["clock"].tolist()
    length_a = cols["length"].tolist()
    oc, ok = cols["origin_client"].tolist(), cols["origin_clock"].tolist()
    rc, rk = cols["right_client"].tolist(), cols["right_clock"].tolist()
    info_a = cols["info"].tolist()
    pno, pnl = cols["parent_name_ofs"].tolist(), cols["parent_name_len"].tolist()
    pic, pik = cols["parent_id_client"].tolist(), cols["parent_id_clock"].tolist()
    pso, psl = cols["parent_sub_ofs"].tolist(), cols["parent_sub_len"].tolist()
    c_ofs = cols["content_ofs"].tolist()
    c_end = cols["content_end"].tolist()
    c_ofs2 = cols["content_ofs2"].tolist()
    c_end2 = cols["content_end2"].tolist()
    c_cnt = cols["content_count"].tolist()
    for i in range(n):
        client = client_a[i]
        ref_kind = info_a[i] & BITS5
        if ref_kind == 0:
            ref = ItemRef(
                client=client, clock=clock_a[i], length=length_a[i],
                is_gc=True,
            )
        else:
            if ref_kind == 1:
                content = ContentDeleted(length_a[i])
            else:
                content = LazyContentV2(
                    update, ref_kind, c_ofs[i], c_end[i],
                    c_ofs2[i], c_end2[i], c_cnt[i],
                )
            ref = ItemRef(
                client=client,
                clock=clock_a[i],
                length=length_a[i],
                origin=None if oc[i] < 0 else (oc[i], ok[i]),
                right_origin=None if rc[i] < 0 else (rc[i], rk[i]),
                parent_name=None
                if pno[i] < 0
                else utf8_decode_u16(update[pno[i] : pno[i] + pnl[i]]),
                parent_id=None if pic[i] < 0 else (pic[i], pik[i]),
                parent_sub=None
                if pso[i] < 0
                else utf8_decode_u16(update[pso[i] : pso[i] + psl[i]]),
                content=content,
                content_ref=ref_kind,
            )
        refs.setdefault(client, []).append(ref)
    ds = list(
        zip(
            ds_cols["client"].tolist(),
            ds_cols["clock"].tolist(),
            ds_cols["len"].tolist(),
        )
    )
    return refs, ds


class UnsupportedUpdate(Exception):
    """The update uses features outside the device path's scope (nested
    types, map entries, subdocuments); the owning doc must fall back to the
    CPU reference core (the Provider gating of BASELINE.json's north star)."""


# ---------------------------------------------------------------------------
# StepPlan: what one flush hands to the device kernel for one doc
# ---------------------------------------------------------------------------


class _PlanCtx:
    """Opaque phase A -> phase B carrier for the split cold plan
    : the engine holds these while the segment planner
    co-plans a whole chunk of cold docs in one batched kernel call."""

    __slots__ = ("plan", "frag_sched", "applicable", "queries", "sd")


@dataclass
class StepPlan:
    """Per-doc inputs for one device integration step (un-padded)."""

    n_rows: int  # total rows in the mirror after this step
    # splits of already-integrated rows: (orig_row, new_row), ordered so that
    # multiple cuts of one original row appear right-to-left
    splits: list[tuple[int, int]] = field(default_factory=list)
    # integration schedule: (row, left_row, right_row, seg) in causal order
    sched: list[tuple[int, int, int, int]] = field(default_factory=list)
    # rows to mark deleted after integration
    delete_rows: list[int] = field(default_factory=list)
    # delete ranges applied this step (client, clock, len) — the DS section
    # of the step's emitted incremental update
    applied_ds: list[tuple[int, int, int]] = field(default_factory=list)
    # 8-field bulk schedule (row, left, right, check, succ, seg, fb_left,
    # fb_right) with dependency levels (1-based): see assign_levels
    sched8: list[tuple[int, int, int, int, int, int, int, int]] = field(
        default_factory=list
    )
    levels: list[int] = field(default_factory=list)
    n_levels: int = 0
    max_width: int = 0  # widest level (engine pack bucket sizing)
    # bulk-apply form (the default device path): FINAL right-link values of
    # every row whose link changed this step, plus segment-head updates —
    # the host planner resolves YATA placement against its own list state,
    # so the device applies one conflict-free scatter (the sort/rank-style
    # layout; the YATA scan kernels remain as the levels/seq paths)
    link_rows: list[int] = field(default_factory=list)
    link_vals: list[int] = field(default_factory=list)
    head_segs: list[int] = field(default_factory=list)
    head_vals: list[int] = field(default_factory=list)
    # structs placed by the segment-sorted conflict-free fast path
    # instead of the sequential YATA walk (plan-cache accounting)
    fastpath_structs: int = 0

    def assign_levels(self, client_of_row) -> None:
        """Rewrite the causal schedule into the level-parallel bulk form.

        Items sharing a splice gap (same resolved left & right in the same
        segment) necessarily share (origin, rightOrigin) — post-split, a
        left row determines the origin id and vice versa — so YATA orders
        them by ascending client (reference Item.js case 1, :447-455).  The
        host pre-links each such group into a chain spliced in ONE bulk
        write; remaining items get one entry each.

        Chains also extend ACROSS groups: when a group's gap-left is the
        current tail of an already-emitted chain and its right matches the
        chain's right (sequential typing: each new run's origin is the last
        id of the previous run), the group joins that chain at the SAME
        level — the whole typing session splices in one bulk write instead
        of one level per run.  This flattens the reference's inherently
        sequential insertion chains (Item.js fast path :432-434) into O(1)
        levels for the common editing texture.

        Each sched8 entry is (row, left, right, check, succ, seg, fb_left,
        fb_right):
        - fast iff rl[check] == right (check==NULL: head test
          starts[seg]==right); all members of one chain share (check,
          right), so a chain is fast or deferred as a whole
        - splice: rl[left] = row (left>=0), starts[seg] = row (left==NULL),
          rl[row] = succ, where succ==GATHER_SUCC means the gathered old
          successor of `check`
        - on fast-check failure the item integrates sequentially with
          (row, fb_left, fb_right, seg) — its ORIGINAL YATA gap, which for
          stitched groups differs from the chain-head's (check, right).
        """
        groups: dict[tuple[int, int, int], list[int]] = {}
        order: list[tuple[int, int, int]] = []
        for i, (row, left, right, seg) in enumerate(self.sched):
            key = (left, right, seg)
            g = groups.get(key)
            if g is None:
                groups[key] = [i]
                order.append(key)
            else:
                g.append(i)

        self.sched8 = []
        self.levels = []
        lev_of_row: dict[int, int] = {}
        used: set[tuple[int, object]] = set()
        # chain tails open for stitching: tail row -> (entry idx, head
        # check, head right, level)
        tails: dict[int, tuple[int, int, int, int]] = {}
        n_levels = 0
        for key in order:
            left, right, seg = key
            idxs = groups[key]
            members = [self.sched[i][0] for i in idxs]
            if len(members) > 1:
                members.sort(key=client_of_row)
            t = tails.get(left) if left != NULL else None
            if t is not None and t[2] == right and self.sched8[t[0]][5] == seg:
                # stitch: continue the chain ending at `left` in place
                idx0, hchk, hr0, lev = t
                e = self.sched8[idx0]
                self.sched8[idx0] = e[:4] + (members[0],) + e[5:]
                for j, row in enumerate(members):
                    succ = (
                        members[j + 1] if j + 1 < len(members) else GATHER_SUCC
                    )
                    self.sched8.append(
                        (row, NO_LEFT_WRITE, hr0, hchk, succ, seg, left, right)
                    )
                    self.levels.append(lev)
                    lev_of_row[row] = lev
                del tails[left]
                tails[members[-1]] = (len(self.sched8) - 1, hchk, hr0, lev)
                # n_levels already covers lev: the head chain raised it
                continue
            base = 1 + max(lev_of_row.get(left, 0), lev_of_row.get(right, 0))
            # write-target key: rl[left] for real lefts, the segment's head
            # slot otherwise (distinct segments' head writes may share a
            # level — they scatter to distinct starts[] cells)
            gap: object = left if left != NULL else ("h", seg)
            lev = base
            while (lev, gap) in used:
                lev += 1
            used.add((lev, gap))
            for j, row in enumerate(members):
                entry_left = left if j == 0 else NO_LEFT_WRITE
                succ = members[j + 1] if j + 1 < len(members) else GATHER_SUCC
                self.sched8.append(
                    (row, entry_left, right, left, succ, seg, left, right)
                )
                self.levels.append(lev)
                lev_of_row[row] = lev
            tails[members[-1]] = (len(self.sched8) - 1, left, right, lev)
            n_levels = max(n_levels, lev)
        self.n_levels = n_levels
        width = [0] * n_levels
        for lev in self.levels:
            width[lev - 1] += 1
        self.max_width = max(width, default=0)

    def packed_levels(self):
        """The 8-field schedule grouped level-major ([L, W, 8] device pack)."""
        out: list[list[tuple[int, ...]]] = [[] for _ in range(self.n_levels)]
        for entry, lev in zip(self.sched8, self.levels):
            out[lev - 1].append(entry)
        return out


# ---------------------------------------------------------------------------
# DocMirror: host twin of one document
# ---------------------------------------------------------------------------


class DocMirror:
    """Host columnar mirror of one doc: immutable struct columns + payloads.

    Row indices are stable forever (append-only; splits append the right
    fragment as a new row).  The per-client fragment index maps (client,
    clock) -> row for origin/rightOrigin resolution, the columnar analogue of
    StructStore.find (reference src/utils/StructStore.js:123-177).

    Every (root type, map key) pair is a *segment*: an independent linked
    list on device.  Segment ``(name, None)`` is the root list of a
    YText/YArray/Xml root; ``(name, sub)`` is one YMap key's entry chain
    (reference AbstractType _start vs _map, src/types/AbstractType.js:255-
    288).  The same YATA kernel integrates both; the LWW rule for map
    chains (reference Item.js:497-507 tail-delete + :512-516 mid-chain
    self-delete, whose net effect is order-independent: every chain entry
    except the final tail is deleted) is applied host-side because the
    host replicates chain order anyway for exports.
    """

    def __init__(self, root_name: str = "text", device=None):
        self.root_name = root_name
        # where the segment planner runs its kernels (None: the CUDA
        # device, raising without it; an engine passes its own device)
        self.plan_device = device
        # client <-> dense slot mapping
        self.client_of_slot: list[int] = []
        self.slot_of_client: dict[int, int] = {}
        # segment registry: (root name or None, parent_sub or None,
        # parent type-item row or NULL) -> seg id.  Root segments carry the
        # share-map name; NESTED segments (shared types inside ContentType
        # items, reference ContentType.js) are keyed by the row holding the
        # type item — the same YATA kernel integrates either kind
        self.segments: dict[tuple[str | None, str | None, int], int] = {}
        self.seg_info: list[tuple[str | None, str | None, int]] = []
        # rows fully deleted as known host-side (delete resolution + LWW);
        # type rows are length-1 so this is exact for the parent checks
        self._host_deleted_rows: set[int] = set()
        # per-map-segment host chain: rows in YATA order (tiny lists — one
        # entry per concurrent writer of one key)
        self.map_chain: dict[int, list[int]] = {}
        # host linked lists: the mirror of the device right_link/starts
        # state, maintained by the planner's own YATA resolution so each
        # flush ships final link values (StepPlan.link_*)
        self.list_next: list[int] = []  # per row; NULL = tail/unlinked
        self.head_of_seg: list[int] = []  # per seg; NULL = empty
        # reverse indexes for the recursive type-delete rule
        self._segs_of_parent: dict[int, list[int]] = {}
        self._rows_of_seg: dict[int, list[int]] = {}
        # rows already LWW-deleted (dedup for DS bookkeeping)
        self._lww_deleted: set[int] = set()
        # per-row columns (python lists; converted to numpy at flush)
        self.row_slot: list[int] = []
        self.row_clock: list[int] = []
        self.row_len: list[int] = []
        self.row_origin_slot: list[int] = []
        self.row_origin_clock: list[int] = []
        self.row_right_slot: list[int] = []
        self.row_right_clock: list[int] = []
        self.row_is_gc: list[bool] = []
        self.row_countable: list[bool] = []
        self.row_content: list[object | None] = []
        self.row_content_ref: list[int] = []
        self.row_seg: list[int] = []  # segment id (NULL for GC rows)
        # per-row content source for the native wire encoder (kind codes
        # from yjs_tpu.native: NONE/DELETED/FRAMED/UTF8/SPILL), precomputed
        # at row creation so encode never inspects content objects
        self.row_src_kind: list[int] = []
        self.row_src_buf: list[int] = []
        self.row_src_ofs: list[int] = []
        self.row_src_end: list[int] = []
        # source-buffer registry backing row_src_buf
        self._bufs: list[bytes] = []
        self._buf_ids: dict[int, int] = {}
        # persistent interned segment-name strings blob (UTF-8)
        self._strings = bytearray()
        self._interned: dict[str, tuple[int, int]] = {}
        # per-seg interned name/sub offsets, aligned with seg_info
        self.seg_name_ofs: list[int] = []
        self.seg_name_len: list[int] = []
        self.seg_sub_ofs: list[int] = []
        self.seg_sub_len: list[int] = []
        # numpy-view cache of the row columns, invalidated on any mutation
        self._gen = 0
        self._np_gen = -1
        self._np: dict[str, np.ndarray] = {}
        # merged delete-set arrays cache (grouped for the native encoder)
        self._ds_gen = 0
        self._ds_np_gen = -1
        self._ds_np: tuple | None = None
        # per-slot fragment index, sorted by clock
        self.frag_clock: list[list[int]] = []
        self.frag_row: list[list[int]] = []
        # per-slot state (next expected clock)
        self.state: list[int] = []
        # causally-early refs parked until their deps arrive
        # (reference StructStore pendingClientsStructRefs, StructStore.js:25-35)
        self.pending: dict[int, list[ItemRef]] = {}
        # delete ranges beyond known state (reference DeleteSet.js:317-322)
        self.pending_ds: list[tuple[int, int, int]] = []
        # applied delete ranges per slot (host bookkeeping for sync/export)
        self.ds: dict[int, list[tuple[int, int]]] = {}
        # updates queued since the last flush
        self._incoming: list[tuple[bytes, bool]] = []
        # plan-cache digest chain: advances on every successful
        # prepare / deterministic compact, poisons on anything else
        self.plan_frontier = _pc.seed_frontier(root_name)

    # -- client slots -------------------------------------------------------

    def slot(self, client: int) -> int:
        s = self.slot_of_client.get(client)
        if s is None:
            s = len(self.client_of_slot)
            self.slot_of_client[client] = s
            self.client_of_slot.append(client)
            self.frag_clock.append([])
            self.frag_row.append([])
            self.state.append(0)
        return s

    def get_state(self, client: int) -> int:
        s = self.slot_of_client.get(client)
        return 0 if s is None else self.state[s]

    @property
    def n_rows(self) -> int:
        return len(self.row_slot)

    def host_nbytes(self) -> int:
        """Rough host bytes this mirror holds (warm-tier accounting,
        tiering): retained update payloads + interned strings + the
        packed row/segment columns (~14 int-ish lists per row)."""
        return (
            sum(len(b) for b in self._bufs)
            + len(self._strings)
            + self.n_rows * 8 * 14
            + self.n_segs * 8 * 6
        )

    def deleted_ratio(self) -> float:
        """Deleted content length / total inserted length — the tier GC
        trigger.  Computed from the host delete-range
        bookkeeping; no device traffic."""
        total = sum(self.state)
        if not total:
            return 0.0
        deleted = sum(
            ln
            for ranges in self.ds.values()
            for _clock, ln in self._union_ranges(ranges)
        )
        return min(1.0, deleted / total)

    # -- segments -----------------------------------------------------------

    def _intern(self, s: str) -> tuple[int, int]:
        r = self._interned.get(s)
        if r is None:
            from ..lib0.u16 import u16_encode_utf8

            b = u16_encode_utf8(s)
            r = (len(self._strings), len(b))
            self._interned[s] = r
            self._strings.extend(b)
        return r

    def _buf_idx(self, b) -> int:
        k = id(b)
        j = self._buf_ids.get(k)
        if j is None:
            j = len(self._bufs)
            self._buf_ids[k] = j
            self._bufs.append(b)
        return j

    def seg(
        self, name: str | None, sub: str | None = None, parent_row: int = NULL
    ) -> int:
        key = (name, sub, parent_row)
        s = self.segments.get(key)
        if s is None:
            s = len(self.seg_info)
            self.segments[key] = s
            self.seg_info.append(key)
            self.head_of_seg.append(NULL)
            if parent_row != NULL:
                self._segs_of_parent.setdefault(parent_row, []).append(s)
            if name is None:
                self.seg_name_ofs.append(NULL)
                self.seg_name_len.append(0)
            else:
                no, nl = self._intern(name)
                self.seg_name_ofs.append(no)
                self.seg_name_len.append(nl)
            if sub is None:
                self.seg_sub_ofs.append(NULL)
                self.seg_sub_len.append(0)
            else:
                so, sl = self._intern(sub)
                self.seg_sub_ofs.append(so)
                self.seg_sub_len.append(sl)
        return s

    @property
    def n_segs(self) -> int:
        return len(self.seg_info)

    def seg_is_map(self, seg: int) -> bool:
        return self.seg_info[seg][1] is not None

    # -- row / fragment bookkeeping ----------------------------------------

    def _add_row(self, slot, clock, length, origin, right_origin, is_gc, content,
                 content_ref=0, seg=NULL):
        row = len(self.row_slot)
        self.row_slot.append(slot)
        self.row_clock.append(clock)
        self.row_len.append(length)
        if origin is None:
            self.row_origin_slot.append(NULL)
            self.row_origin_clock.append(0)
        else:
            self.row_origin_slot.append(self.slot(origin[0]))
            self.row_origin_clock.append(origin[1])
        if right_origin is None:
            self.row_right_slot.append(NULL)
            self.row_right_clock.append(0)
        else:
            self.row_right_slot.append(self.slot(right_origin[0]))
            self.row_right_clock.append(right_origin[1])
        self.row_is_gc.append(is_gc)
        # countable by wire ref: GC(0), ContentDeleted(1), ContentFormat(6)
        # are not countable (reference Item.js info BIT2 rules)
        self.row_countable.append(not is_gc and content_ref not in (0, 1, 6))
        self.row_content.append(content)
        self.row_content_ref.append(content_ref)
        self.row_seg.append(NULL if is_gc else seg)
        self.list_next.append(NULL)
        # membership index only for NESTED segments (the recursive
        # type-delete rule's sole consumer) — not for every root row
        if not is_gc and seg != NULL and self.seg_info[seg][2] != NULL:
            self._rows_of_seg.setdefault(seg, []).append(row)
        # content source for the native encoder
        if is_gc:
            kind, sb, so, se = SRC_NONE, NULL, NULL, NULL
        elif content_ref == 1:
            kind, sb, so, se = SRC_DELETED, NULL, NULL, NULL
        elif isinstance(content, LazyContent) and content.end >= 0:
            if content_ref == 4:
                # skip the var_string length prefix: raw UTF-8 range
                b, p = content.buf, content.ofs
                blen = 0
                shift = 0
                while True:
                    c = b[p]
                    p += 1
                    blen |= (c & 0x7F) << shift
                    shift += 7
                    if c < 0x80:
                        break
                kind, sb, so, se = SRC_UTF8, self._buf_idx(b), p, p + blen
            else:
                kind = SRC_FRAMED
                sb = self._buf_idx(content.buf)
                so, se = content.ofs, content.end
        elif isinstance(content, LazyContentV2) and content.kind == 4:
            kind = SRC_UTF8
            sb = self._buf_idx(content.buf)
            so, se = content.ofs, content.end
        else:
            kind, sb, so, se = SRC_SPILL, NULL, NULL, NULL
        self.row_src_kind.append(kind)
        self.row_src_buf.append(sb)
        self.row_src_ofs.append(so)
        self.row_src_end.append(se)
        self._gen += 1
        if is_gc:
            # GC structs are always deleted: they belong in the derived
            # DeleteSet (reference DeleteSet.js createDeleteSetFromStructStore)
            self._note_deleted(slot, clock, length)
        # fragment index insert (appends are the common case)
        fc, fr = self.frag_clock[slot], self.frag_row[slot]
        if not fc or clock > fc[-1]:
            fc.append(clock)
            fr.append(row)
        else:
            i = bisect.bisect_left(fc, clock)
            fc.insert(i, clock)
            fr.insert(i, row)
        end = clock + length
        if end > self.state[slot]:
            self.state[slot] = end
        return row

    def content_gen(self) -> int:
        """Monotonic change counter: bumps on EVERY integrated mutation
        (inserts, deletes, splits, compaction) — the cache key for
        derived views like provider.RoomUserData."""
        return self._gen

    def _frag_containing(self, slot: int, clock: int) -> int | None:
        """Index into the fragment lists of the fragment covering ``clock``."""
        fc = self.frag_clock[slot]
        i = bisect.bisect_right(fc, clock) - 1
        if i < 0:
            return None
        row = self.frag_row[slot][i]
        if clock < self.row_clock[row] + self.row_len[row]:
            return i
        return None

    def realized_content(self, row: int):
        """The row's content object, decoding the lazy payload on demand."""
        content = self.row_content[row]
        if isinstance(content, (LazyContent, LazyContentV2)):
            content = content.realize()
            self.row_content[row] = content
        return content

    def _split_existing(self, slot: int, frag_idx: int, at_clock: int, plan: StepPlan):
        """Split an integrated row so a fragment starts at ``at_clock``;
        record the link-surgery instruction for the device."""
        row = self.frag_row[slot][frag_idx]
        offset = at_clock - self.row_clock[row]
        right_content = self.realized_content(row).splice(offset)
        # the row's content is now a realized, truncated object: its lazy
        # byte range no longer matches — the encoder must re-frame it
        self.row_src_kind[row] = SRC_SPILL
        self._gen += 1
        seg = self.row_seg[row]
        new_row = self._add_row(
            slot,
            at_clock,
            self.row_len[row] - offset,
            (self.client_of_slot[slot], at_clock - 1),
            self._right_origin_of(row),
            False,
            right_content,
            self.row_content_ref[row],
            seg=seg,
        )
        self.row_len[row] = offset
        plan.splits.append((row, new_row))
        # host list splice of the fragment (device split surgery twin)
        self.list_next[new_row] = self.list_next[row]
        self.list_next[row] = new_row
        plan._dl.update((row, new_row))
        if row in self._host_deleted_rows:
            self._host_deleted_rows.add(new_row)
            # the new fragment's device deleted bit must ship too: the
            # bulk-apply path has no on-device split surgery to copy it
            # (levels/seq copy dl[orig] in their split pre-pass)
            plan.delete_rows.append(new_row)
        if seg != NULL and self.seg_is_map(seg):
            # fragments of a map-chain entry sit adjacent in its chain
            chain = self.map_chain[seg]
            chain.insert(chain.index(row) + 1, new_row)
            if row in self._lww_deleted:
                self._lww_deleted.add(new_row)
        return new_row

    def _right_origin_of(self, row: int):
        rs = self.row_right_slot[row]
        if rs == NULL:
            return None
        return (self.client_of_slot[rs], self.row_right_clock[row])

    # -- update ingestion ---------------------------------------------------

    def ingest(self, update: bytes, v2: bool = False) -> None:
        self._incoming.append((update, v2))

    def _check_supported(self, ref: ItemRef) -> None:
        if ref.is_gc:
            return
        if ref.content_ref == 9:  # ContentDoc: independent doc lifecycle
            raise UnsupportedUpdate("subdocument (content ref 9)")

    # -- map-chain host bookkeeping ----------------------------------------

    def _origin_row(self, row: int) -> int:
        """The row containing ``row``'s origin id (NULL if no origin)."""
        s = self.row_origin_slot[row]
        if s == NULL:
            return NULL
        fi = self._frag_containing(s, self.row_origin_clock[row])
        return NULL if fi is None else self.frag_row[s][fi]

    def _row_origin_eq(self, a: int, b: int) -> bool:
        sa, sb = self.row_origin_slot[a], self.row_origin_slot[b]
        return sa == sb and (
            sa == NULL or self.row_origin_clock[a] == self.row_origin_clock[b]
        )

    def _row_right_eq(self, a: int, b: int) -> bool:
        sa, sb = self.row_right_slot[a], self.row_right_slot[b]
        return sa == sb and (
            sa == NULL or self.row_right_clock[a] == self.row_right_clock[b]
        )

    def _list_insert(
        self, seg: int, row: int, left_row: int, right_row: int, plan: StepPlan
    ) -> int:
        """Resolve the row's YATA placement against the host list state and
        splice it — the host twin of the device conflict scan (reference
        Item.js:403-517, the same itemsBeforeOrigin/conflictingItems walk).
        Each flush thereby ships FINAL link values (StepPlan.link_*) and the
        default device step is one conflict-free scatter.  Returns the
        resolved left row (NULL = new head)."""
        nxt = self.list_next
        left = left_row
        o = nxt[left_row] if left_row != NULL else self.head_of_seg[seg]
        items_before: set[int] = set()
        conflicting: set[int] = set()
        while o != NULL and o != right_row:
            items_before.add(o)
            conflicting.add(o)
            if self._row_origin_eq(row, o):
                if self._row_client(o) < self._row_client(row):
                    left = o
                    conflicting.clear()
                elif self._row_right_eq(row, o):
                    break
            else:
                oor = self._origin_row(o)
                if oor != NULL and oor in items_before:
                    if oor not in conflicting:
                        left = o
                        conflicting.clear()
                else:
                    break
            o = nxt[o]
        if left != NULL:
            nxt[row] = nxt[left]
            nxt[left] = row
            plan._dl.update((left, row))
        else:
            nxt[row] = self.head_of_seg[seg]
            self.head_of_seg[seg] = row
            plan._dl.add(row)
            plan._dh.add(seg)
        return left

    def _row_client(self, row: int) -> int:
        return self.client_of_slot[self.row_slot[row]]

    def _delete_row(self, row: int, plan: StepPlan) -> None:
        """Mark one (pre-split, fully covered) row deleted with all host
        bookkeeping, recursing into the subtree when the row holds a type
        item (reference ContentType.delete, ContentType.js:106-129)."""
        if row in self._host_deleted_rows or self.row_is_gc[row]:
            return
        self._host_deleted_rows.add(row)
        plan.delete_rows.append(row)
        self._note_deleted(
            self.row_slot[row], self.row_clock[row], self.row_len[row]
        )
        plan.applied_ds.append(
            (self._row_client(row), self.row_clock[row], self.row_len[row])
        )
        sg = self.row_seg[row]
        if sg != NULL and self.seg_is_map(sg):
            self._lww_deleted.add(row)
        if self.row_content_ref[row] == 7:
            for cs in self._segs_of_parent.get(row, ()):
                for child in list(self._rows_of_seg.get(cs, ())):
                    self._delete_row(child, plan)

    def _lww_pass(self, segs: set[int], plan: StepPlan) -> None:
        """Delete every map-chain entry except the final tail (the
        order-independent net effect of reference Item.js:497-507 +
        :512-516) for each segment touched this step."""
        for seg in segs:
            chain = self.map_chain.get(seg)
            if not chain:
                continue
            tail = chain[-1]
            for r in chain:
                if r != tail and r not in self._lww_deleted:
                    self._delete_row(r, plan)

    def _segment_queries(self, frag_sched):
        """Anchor-query columns for the segment planner,
        built AFTER the pre-split pass and BEFORE any row is added:
        per-ref id/origin/rightOrigin columns plus the facts span
        eligibility needs (GC flag, content kind, explicit parent).
        Returns a :class:`~yjs_tpu.ops.segment_planner.SegmentQueries`
        of fresh arrays, or None when planning is off or the batch is
        too small to pay for kernel dispatch."""
        from . import segment_planner as _sp  # deferred: imports kernels

        n = len(frag_sched)
        if _sp.plan_segment_mode() == "off" or n < _sp.MIN_RUN:
            return None
        q = _sp.SegmentQueries()
        q.n = n
        q.client = client = np.empty(n, np.int64)
        q.clock = clock = np.empty(n, np.int64)
        q.length = length = np.empty(n, np.int64)
        q.o_cl = o_cl = np.full(n, -1, np.int64)
        q.o_ck = o_ck = np.zeros(n, np.int64)
        q.o_slot = o_slot = np.full(n, -1, np.int64)
        q.r_cl = r_cl = np.full(n, -1, np.int64)
        q.r_ck = r_ck = np.zeros(n, np.int64)
        q.r_slot = r_slot = np.full(n, -1, np.int64)
        q.gc = gc = np.zeros(n, bool)
        q.cref = cref = np.zeros(n, np.int64)
        q.pid = pid = np.zeros(n, bool)
        q.pname = pname = np.zeros(n, bool)
        slot_of = self.slot_of_client.get
        for j, ref in enumerate(frag_sched):
            client[j] = ref.client
            clock[j] = ref.clock
            length[j] = ref.length
            if ref.is_gc:
                gc[j] = True
                continue
            cref[j] = ref.content_ref
            if ref.parent_id is not None:
                pid[j] = True
            if ref.parent_name is not None:
                pname[j] = True
            if ref.origin is not None:
                c, k = ref.origin
                o_cl[j] = c
                o_ck[j] = k
                s = slot_of(c)
                if s is not None:
                    o_slot[j] = s
            if ref.right_origin is not None:
                c, k = ref.right_origin
                r_cl[j] = c
                r_ck[j] = k
                s = slot_of(c)
                if s is not None:
                    r_slot[j] = s
        return q

    def _segment_snapshot(self):
        """Slot-major snapshot of the fragment index for batched anchor
        lookup: ``(flat_slot, flat_clock, flat_row, row_len, n_slots)``.
        Per-slot runs are clock-sorted, so the composed (slot, clock)
        key is globally sorted.  This is the planner's expensive rebuild
        — the segment planner only calls it when the chain masks leave
        enough anchors unresolved (monotone prepend/typing runs reuse
        the prior per-slot sorted segments instead)."""
        import time as _time

        from ..obs.prof import kernel_profiler

        t0 = _time.perf_counter()
        sizes = [len(fc) for fc in self.frag_clock]
        total = sum(sizes)
        if total:
            flat_clock = np.concatenate(
                [np.asarray(fc, np.int64) for fc in self.frag_clock]
            )
            flat_row = np.concatenate(
                [np.asarray(fr, np.int64) for fr in self.frag_row]
            )
            flat_slot = np.repeat(
                np.arange(len(sizes), dtype=np.int64), sizes
            )
        else:
            flat_clock = np.empty(0, np.int64)
            flat_row = np.empty(0, np.int64)
            flat_slot = np.empty(0, np.int64)
        row_len = np.asarray(self.row_len, np.int64)
        kernel_profiler().record_host_op(
            "plan_snapshot", _time.perf_counter() - t0
        )
        return flat_slot, flat_clock, flat_row, row_len, len(sizes)

    # -- the flush pipeline -------------------------------------------------

    def plan_key(self, want_levels: bool | None = None,
                 want_sched: bool = True):
        """Plan-cache key for the staged work : kind + frontier
        + staged content digest + plan-shape flag."""
        return (
            "p",
            self.plan_frontier,
            _pc.staged_digest(self._incoming),
            want_levels is None or bool(want_levels),
            True,
        )

    def prepare_step(self, want_levels: bool | None = None) -> StepPlan:
        """Consume queued updates and produce the device step plan — the
        cold planning path; advances the plan frontier on success and
        poisons it on any failure (the mirror may be mid-step then, see
        the inner docstring).  Equivalent to ``prepare_step_begin()``
        followed by ``prepare_step_finish(token, "auto", …)`` — the
        engine uses the split form to co-plan whole chunks of cold docs
        in one segment-planner call."""
        token = self.prepare_step_begin()
        return self.prepare_step_finish(token, "auto", want_levels)

    def prepare_step_begin(self):
        """Phase A of the cold plan: decode, causal scheduling, DS
        clamping, the pre-split pass, and the segment-planner query
        build.  Returns an opaque token for ``prepare_step_finish``;
        ``token.queries`` (may be None) and the mirror's
        ``_segment_snapshot`` are what :func:`segment_planner.plan_chunk`
        consumes to co-plan many docs at once.  Poisons the plan
        frontier on failure, exactly like ``prepare_step``."""
        sd = _pc.staged_digest(self._incoming)
        try:
            ctx = self._prepare_phase_a()
        except BaseException:
            self.plan_frontier = _pc.poison_frontier()
            _pc.note_invalidation("plan-error")
            raise
        ctx.sd = sd
        return ctx

    def prepare_step_finish(self, token, seg_plan,
                            want_levels: bool | None = None) -> StepPlan:
        """Phase B of the cold plan: integration (bulk fast-set runs +
        the sequential YATA fallback for the conflict residue), delete
        resolution and plan finalization.  ``seg_plan`` is the
        :class:`~yjs_tpu.ops.segment_planner.SegmentPlan` computed for
        this doc (possibly within a chunk), ``None`` to run the pure
        host walk, or ``"auto"`` to plan per-doc here.  Folds the plan
        frontier on success and poisons it on failure — together with
        ``prepare_step_begin`` this preserves ``prepare_step``'s cache
        interop exactly (device-planned results fold the same digest)."""
        try:
            if isinstance(seg_plan, str):  # "auto": per-doc planning
                from . import segment_planner as _sp

                seg_plan = _sp.plan_doc(
                    token.queries, snapshot=self._segment_snapshot,
                    device=self.plan_device,
                )
            plan = self._prepare_phase_b(token, seg_plan, want_levels)
        except BaseException:
            self.plan_frontier = _pc.poison_frontier()
            _pc.note_invalidation("plan-error")
            raise
        self.plan_frontier = _pc.fold(self.plan_frontier, b"u", token.sd)
        return plan

    def _prepare_phase_a(self):
        """Decode + schedule + pre-split (phase A of the cold plan).

        Raises :class:`UnsupportedUpdate` if an incoming ref is outside the
        device path's scope (nested types, subdocuments).  The mirror may
        be left mid-step in that case — the engine demotes the doc by
        replaying its update log into a CPU Doc and discards the mirror.
        """
        incoming: dict[int, list[ItemRef]] = {}
        ds_ranges: list[tuple[int, int, int]] = list(self.pending_ds)
        for update, v2 in self._incoming:
            refs, ds = decode_update_refs(update, v2)
            for client, rs in refs.items():
                for r in rs:
                    self._check_supported(r)
                incoming.setdefault(client, []).extend(rs)
            ds_ranges.extend(ds)
        self._incoming.clear()
        self.pending_ds = []

        # merge incoming refs into the pending queues, clock-sorted
        for client, rs in incoming.items():
            q = self.pending.setdefault(client, [])
            q.extend(rs)
            q.sort(key=lambda r: r.clock)

        # -- causal scheduling (encoding.js:225-321 recast as a fixpoint) --
        sched: list[ItemRef] = []
        overlay: dict[int, int] = {}  # client -> state incl. scheduled

        def state_of(client: int) -> int:
            s = overlay.get(client)
            return self.get_state(client) if s is None else s

        def dep_ok(dep, client) -> bool:
            # reference Item.getMissing: a dep on another client is satisfied
            # once state > dep.clock (Item.js:354-397)
            return dep is None or dep[0] == client or state_of(dep[0]) > dep[1]

        progress = True
        while progress:
            progress = False
            for client in sorted(self.pending.keys(), reverse=True):
                q = self.pending[client]
                while q:
                    ref = q[0]
                    st = state_of(client)
                    if ref.clock > st:
                        break  # clock gap: wait for the missing update
                    if ref.clock + ref.length <= st:
                        q.pop(0)  # fully known: dedupe
                        progress = True
                        continue
                    if not (
                        dep_ok(ref.origin, client)
                        and dep_ok(ref.right_origin, client)
                        and dep_ok(ref.parent_id, client)
                    ):
                        # the nested-parent type item is a causal dep too
                        # (reference Item.getMissing, Item.js:354-397)
                        break
                    if ref.clock < st:
                        ref.trim_left(st - ref.clock)
                    q.pop(0)
                    sched.append(ref)
                    overlay[client] = ref.clock + ref.length
                    progress = True
        for client in [c for c, q in self.pending.items() if not q]:
            del self.pending[client]

        # -- delete-set clamping against post-step state -------------------
        # (reference DeleteSet.js:270-323: apply the known prefix, park the
        # rest in pendingDeleteReaders)
        applicable: list[tuple[int, int, int]] = []
        for client, clock, ln in ds_ranges:
            st = state_of(client)
            if clock < st:
                applicable.append((client, clock, min(ln, st - clock)))
            if clock + ln > st:
                lo = max(clock, st)
                self.pending_ds.append((client, lo, clock + ln - lo))

        # -- pre-split pass: collect every boundary the step needs ---------
        cuts: dict[int, set[int]] = {}

        def need_start(client: int, clock: int) -> None:
            cuts.setdefault(client, set()).add(clock)

        for ref in sched:
            if ref.origin is not None:
                need_start(ref.origin[0], ref.origin[1] + 1)
            if ref.right_origin is not None:
                need_start(ref.right_origin[0], ref.right_origin[1])
        for client, clock, ln in applicable:
            need_start(client, clock)
            need_start(client, clock + ln)

        plan = StepPlan(n_rows=0)
        plan._dl = set()  # rows whose list_next changed this step
        plan._dh = set()  # segs whose head changed this step

        # cuts inside scheduled refs: fragment the refs themselves
        by_client_sched: dict[int, list[int]] = {}
        for i, ref in enumerate(sched):
            by_client_sched.setdefault(ref.client, []).append(i)
        frag_sched: list[ItemRef] = []
        replacement: dict[int, list[ItemRef]] = {}
        for client, idxs in by_client_sched.items():
            ks = cuts.get(client)
            if not ks:
                continue
            ks_sorted = sorted(ks)
            for i in idxs:
                ref = sched[i]
                if ref.is_gc:
                    continue
                lo = bisect.bisect_right(ks_sorted, ref.clock)
                hi = bisect.bisect_left(ks_sorted, ref.clock + ref.length, lo)
                inner = ks_sorted[lo:hi]
                if not inner:
                    continue
                parts = [ref]
                for k in inner:
                    parts.append(parts[-1].split(k - parts[-1].clock))
                replacement[i] = parts
        for i, ref in enumerate(sched):
            frag_sched.extend(replacement.get(i, [ref]))

        # cuts inside existing rows: split + device link surgery.
        # ascending order keeps the fragment index consistent; per original
        # row the device instructions must run right-to-left, so sort the
        # emitted (row, new_row) pairs afterwards.
        pre_split_marker = len(plan.splits)
        for client, ks in cuts.items():
            slot = self.slot_of_client.get(client)
            if slot is None:
                continue
            for k in sorted(ks):
                fi = self._frag_containing(slot, k)
                if fi is None:
                    continue
                row = self.frag_row[slot][fi]
                if self.row_is_gc[row] or self.row_clock[row] == k:
                    continue  # GC runs are never split (StructStore.js:184-207)
                self._split_existing(slot, fi + 0, k, plan)
        # right-to-left per original row: new_row descending within same orig
        plan.splits[pre_split_marker:] = sorted(
            plan.splits[pre_split_marker:], key=lambda p: (p[0], -p[1])
        )

        # segment-planner queries — built here because they
        # MUST see the post-pre-split batch and the pre-integration
        # fragment index (rows appended mid-loop are resolved by chain
        # or bisect fallback, never the snapshot)
        ctx = _PlanCtx()
        ctx.plan = plan
        ctx.frag_sched = frag_sched
        ctx.applicable = applicable
        ctx.queries = self._segment_queries(frag_sched)
        ctx.sd = None
        return ctx

    def _prepare_phase_b(self, ctx, seg_plan,
                         want_levels: bool | None = None) -> StepPlan:
        """Integration + finalization (phase B of the cold plan).

        ``seg_plan`` carries the device-computed answer: verified anchor
        hints, chain masks, and the fast-set spans integrated in bulk
        straight from the ranks; every struct it cannot place falls to
        the sequential YATA walk below — the conflict residue."""
        plan = ctx.plan
        frag_sched = ctx.frag_sched
        applicable = ctx.applicable
        q = ctx.queries
        # -- row assignment + pointer resolution ---------------------------
        hint_l = hint_r = chain_l = chain_r = None
        spans: dict[int, tuple[int, str]] = {}
        if seg_plan is not None and q is not None:
            chain_l, chain_r = seg_plan.chain_l, seg_plan.chain_r
            hint_l, hint_r = seg_plan.hint_l, seg_plan.hint_r
            spans = {s: (e, d) for s, e, d in seg_plan.spans}
        n_fastpath = 0
        seg_fast = 0
        seg_residue = 0
        prev_row = NULL  # row of frag_sched[j-1] (every branch adds one)
        touched_map_segs: set[int] = set()
        n_sched = len(frag_sched)
        j = 0
        while j < n_sched:
            ref = frag_sched[j]
            slot = self.slot(ref.client)
            if ref.is_gc:
                prev_row = self._add_row(
                    slot, ref.clock, ref.length, None, None, True, None
                )
                j += 1
                continue
            run = spans.get(j)
            left_row = right_row = NULL
            degrade = False
            if ref.origin is not None:
                if chain_l is not None:
                    if chain_l[j] and prev_row != NULL:
                        left_row = prev_row
                    elif hint_l is not None:
                        left_row = int(hint_l[j])
                if left_row == NULL:
                    oslot = self.slot(ref.origin[0])
                    fi = self._frag_containing(oslot, ref.origin[1])
                    if fi is None:
                        raise AssertionError(
                            "scheduled ref with unresolved origin"
                        )
                    left_row = self.frag_row[oslot][fi]
                if self.row_is_gc[left_row]:
                    degrade = True  # neighbour was GC'd (Item.js:380-395)
            if ref.right_origin is not None:
                if chain_r is not None:
                    if chain_r[j] and prev_row != NULL:
                        right_row = prev_row
                    elif hint_r is not None:
                        right_row = int(hint_r[j])
                if right_row == NULL:
                    rslot = self.slot(ref.right_origin[0])
                    fi = self._frag_containing(rslot, ref.right_origin[1])
                    if fi is None:
                        raise AssertionError(
                            "scheduled ref with unresolved rightOrigin"
                        )
                    right_row = self.frag_row[rslot][fi]
                if self.row_is_gc[right_row]:
                    degrade = True
            parent_row = NULL
            if not degrade and ref.parent_id is not None:
                pslot = self.slot(ref.parent_id[0])
                fi = self._frag_containing(pslot, ref.parent_id[1])
                if fi is None:
                    raise AssertionError("scheduled ref with unresolved parent")
                parent_row = self.frag_row[pslot][fi]
                if (
                    self.row_is_gc[parent_row]
                    or self.row_content_ref[parent_row] != 7
                ):
                    degrade = True  # parent type was GC'd (Item.js:380-395)
            if degrade:
                prev_row = self._add_row(
                    slot, ref.clock, ref.length, None, None, True, None
                )
                j += 1
                continue
            # segment: explicit parent, else copied from the neighbour the
            # wire omitted it for (reference encoding.js canCopyParentInfo)
            if parent_row != NULL:
                seg = self.seg(None, ref.parent_sub, parent_row)
            elif ref.parent_name is not None:
                seg = self.seg(ref.parent_name, ref.parent_sub)
            elif left_row != NULL:
                seg = self.row_seg[left_row]
            elif right_row != NULL:
                seg = self.row_seg[right_row]
            else:
                raise UnsupportedUpdate("item with no derivable parent")
            row = self._add_row(
                slot, ref.clock, ref.length, ref.origin, ref.right_origin, False,
                ref.content, ref.content_ref, seg=seg,
            )
            prev_row = row
            plan.sched.append((row, left_row, right_row, seg))
            # conflict-free fast splice: when the (left, right) gap is
            # intact, `_list_insert`'s conflict walk runs zero iterations
            # — splice inline and skip the call + per-call set churn.
            # Anything else (concurrent inserts at this gap) falls back
            # to the sequential YATA walk.
            nxt = self.list_next
            if (
                nxt[left_row] if left_row != NULL else self.head_of_seg[seg]
            ) == right_row:
                if left_row != NULL:
                    nxt[row] = nxt[left_row]
                    nxt[left_row] = row
                    plan._dl.update((left_row, row))
                else:
                    nxt[row] = self.head_of_seg[seg]
                    self.head_of_seg[seg] = row
                    plan._dl.add(row)
                    plan._dh.add(seg)
                actual_left = left_row
                n_fastpath += 1
            else:
                # conflict residue: the sequential YATA walk, now the
                # fallback for structs the segment planner cannot place
                seg_residue += 1
                actual_left = self._list_insert(
                    seg, row, left_row, right_row, plan
                )
            if self.seg_is_map(seg):
                chain = self.map_chain.setdefault(seg, [])
                if actual_left == NULL:
                    chain.insert(0, row)
                else:
                    chain.insert(chain.index(actual_left) + 1, row)
                touched_map_segs.add(seg)
            # an item integrated into a deleted parent is deleted with it
            # (reference Item.js:500-505)
            pr = self.seg_info[seg][2]
            if pr != NULL and pr in self._host_deleted_rows:
                self._delete_row(row, plan)
            if ref.content_ref == 1:  # ContentDeleted
                applicable.append((ref.client, ref.clock, ref.length))
            # fast-set bulk integration: ref j starts a
            # chained run the device ranks fully determine — verify the
            # live-state preconditions once, then splice the interior
            # without per-struct anchor resolution or walk.  Any miss
            # falls back to the scalar loop (placement cannot differ).
            if run is not None:
                e, d = run
                n_bulk, last_row = self._integrate_run(
                    frag_sched, j, e, d, seg, row, hint_r, plan
                )
                if n_bulk:
                    seg_fast += n_bulk
                    n_fastpath += n_bulk
                    prev_row = last_row
                    j = e
                    continue
            j += 1

        # -- resolve delete ranges to row ids ------------------------------
        for client, clock, ln in applicable:
            slot = self.slot_of_client.get(client)
            if slot is None:
                continue
            fc, fr = self.frag_clock[slot], self.frag_row[slot]
            i = bisect.bisect_right(fc, clock) - 1
            if i < 0:
                i = 0
            end = clock + ln
            # every covered row notes its own coverage in _delete_row (GC
            # rows at creation, earlier deletions in their own step), so no
            # range-level note is needed — it would only duplicate entries
            while i < len(fc) and fc[i] < end:
                row = fr[i]
                if fc[i] >= clock:
                    self._delete_row(row, plan)
                i += 1

        self._lww_pass(touched_map_segs, plan)
        plan.n_rows = self.n_rows
        plan.fastpath_structs = n_fastpath
        _pc.note_fastpath(n_fastpath)
        plan.segment_fast = seg_fast
        plan.segment_residue = seg_residue if seg_plan is not None else 0
        if seg_plan is not None:
            _pc.note_segment(seg_fast, plan.segment_residue)
        if want_levels is None or want_levels:
            plan.assign_levels(self._row_client)
        # finalize the bulk-apply deltas: FINAL values after all splices
        plan.link_rows = sorted(plan._dl)
        plan.link_vals = [self.list_next[r] for r in plan.link_rows]
        plan.head_segs = sorted(plan._dh)
        plan.head_vals = [self.head_of_seg[s] for s in plan.head_segs]
        # every prepare bumps the change counter even when no row was
        # appended (delete-only flushes) — the C++ twin does the same at
        # the end of Mirror::prepare, and content_gen() consumers rely
        # on it to see delete-only changes
        self._gen += 1
        return plan

    def _integrate_run(self, frag_sched, s, e, d, seg, row_s, hint_r,
                       plan):
        """Bulk-integrate the interior of a chained run straight from
        the device ranks (the fast set).

        ``frag_sched[s]`` was just integrated as ``row_s`` through the
        normal sequential path; refs ``s+1 .. e-1`` chain purely in
        direction ``d`` (statically verified by the planner: one
        client, ascending clocks, no GC/delete/explicit-parent refs).
        This verifies the LIVE-state preconditions the planner cannot
        see — root non-map segment, the splice gap actually intact, the
        shared right anchor not GC'd — and on any miss returns
        ``(0, NULL)`` so the scalar loop integrates the span instead
        (placement can never differ).  On success every interior struct
        is placed by its rank: one fragment-index append + one splice
        per row, no anchor resolution, no YATA walk."""
        if self.seg_info[seg][2] != NULL or self.seg_is_map(seg):
            return 0, NULL
        nxt = self.list_next
        right_const = NULL
        if d == "l":
            # the interior's one shared rightOrigin id, resolved once
            nref = frag_sched[s + 1]
            if nref.right_origin is not None:
                if hint_r is not None:
                    right_const = int(hint_r[s + 1])
                if right_const == NULL:
                    rslot = self.slot_of_client.get(nref.right_origin[0])
                    if rslot is None:
                        return 0, NULL
                    fi = self._frag_containing(rslot, nref.right_origin[1])
                    if fi is None:
                        return 0, NULL
                    right_const = self.frag_row[rslot][fi]
                if self.row_is_gc[right_const]:
                    return 0, NULL
            # gap: row_s must sit immediately left of the shared anchor
            if nxt[row_s] != right_const:
                return 0, NULL
        else:
            # prepend run: each interior ref must become the new head
            if self.head_of_seg[seg] != row_s:
                return 0, NULL
        slot = self.slot(frag_sched[s + 1].client)
        add_row = self._add_row
        rows = []
        for k in range(s + 1, e):
            ref = frag_sched[k]
            rows.append(add_row(
                slot, ref.clock, ref.length, ref.origin,
                ref.right_origin, False, ref.content, ref.content_ref,
                seg=seg,
            ))
        sched = plan.sched
        prev = row_s
        if d == "r":
            for row in rows:
                nxt[row] = prev
                sched.append((row, NULL, prev, seg))
                prev = row
            self.head_of_seg[seg] = prev
            plan._dl.update(rows)
            plan._dh.add(seg)
        else:
            for row in rows:
                nxt[prev] = row
                sched.append((row, prev, right_const, seg))
                prev = row
            nxt[prev] = right_const
            plan._dl.update(rows)
            plan._dl.add(row_s)
        return len(rows), prev

    def _note_deleted(self, slot: int, clock: int, ln: int) -> None:
        ranges = self.ds.setdefault(slot, [])
        ranges.append((clock, ln))
        self._ds_gen += 1

    # -- exports ------------------------------------------------------------

    # -- compaction ---------------------------------------------------------

    def rebuild_compacted_self(self, gc: bool):
        """Compact from the mirror's own list/deleted state — no device
        read-back needed (the flush invariant keeps ``list_next`` /
        ``_host_deleted_rows`` / ``head_of_seg`` equal to the device
        arrays; the YTPU_EXPORT_DEVICE test path pins that equality)."""
        n = max(1, self.n_rows)
        right = np.full(n, NULL, np.int32)
        if self.n_rows:
            right[: self.n_rows] = np.asarray(
                self.list_next[: self.n_rows], np.int32
            )
        deleted = np.zeros(n, bool)
        for r in self._host_deleted_rows:
            deleted[r] = True
        heads = (
            np.asarray(self.head_of_seg, np.int32)
            if self.n_segs
            else np.full(1, NULL, np.int32)
        )
        return self.rebuild_compacted(right, deleted, heads, gc)

    def rebuild_compacted(self, right_link, deleted, head_of_seg, gc: bool):
        """Merge adjacent runs and GC deleted payloads, renumbering rows.

        The columnar analogue of the reference's in-transaction GC + merge
        passes (tryGcDeleteSet / tryMergeDeleteSet / tryToMergeWithLeft,
        src/utils/Transaction.js:165-238): ``right_link``/``deleted`` are
        the device state read back for this doc, ``head_of_seg`` maps seg ->
        head row.  GC (when enabled) replaces deleted rows' content with a
        length-only tombstone (Item.gc parentGCd=false, Item.js:604-614);
        the merge pass collapses list-adjacent, clock-contiguous,
        origin-linked same-state rows (Item.mergeWith, Item.js:555-579).
        Map-key chains are left unmerged (tiny by construction).

        Returns (new_right, new_deleted, new_head_of_seg) numpy arrays over
        the NEW row numbering for device re-upload.
        """
        from ..core import ContentDeleted

        n = self.n_rows
        # per-seg order by walking the read-back links
        order_of_seg: dict[int, list[int]] = {}
        for seg in range(self.n_segs):
            head = int(head_of_seg[seg]) if seg < len(head_of_seg) else NULL
            out = []
            r = head
            while r != NULL:
                out.append(r)
                r = int(right_link[r])
            order_of_seg[seg] = out

        # GC pass: deleted content -> tombstone (payload freed)
        if gc:
            for row in range(n):
                if (
                    not self.row_is_gc[row]
                    and deleted[row]
                    and self.row_content_ref[row] != 1
                ):
                    self.row_content[row] = ContentDeleted(self.row_len[row])
                    self.row_content_ref[row] = 1
                    self.row_countable[row] = False
                    self.row_src_kind[row] = SRC_DELETED

        # merge pass: list segments right-to-left; GC rows by clock order
        absorbed: dict[int, int] = {}  # dead row -> surviving head row

        def try_merge(a: int, b: int) -> bool:
            if self.row_slot[a] != self.row_slot[b]:
                return False
            if self.row_clock[a] + self.row_len[a] != self.row_clock[b]:
                return False
            if bool(deleted[a]) != bool(deleted[b]):
                return False
            if self.row_is_gc[a] != self.row_is_gc[b]:
                return False
            if b in self._segs_of_parent or a in self._segs_of_parent:
                # a nested segment's parent row must keep its identity —
                # absorbing it would orphan its children's wire parent id
                # (even after the GC pass tombstones the type's content)
                return False
            if self.row_is_gc[a]:
                return True  # GC runs merge on contiguity alone (GC.js:24-27)
            # right.origin == this.lastId
            if self.row_origin_slot[b] != self.row_slot[a] or (
                self.row_origin_clock[b]
                != self.row_clock[a] + self.row_len[a] - 1
            ):
                return False
            if not self._row_right_eq(a, b):
                return False
            ca, cb = self.realized_content(a), self.realized_content(b)
            if type(ca) is not type(cb) or not ca.merge_with(cb):
                return False
            return True

        for seg, order in order_of_seg.items():
            if self.seg_is_map(seg):
                continue
            i = 0
            while i + 1 < len(order):
                a, b = order[i], order[i + 1]
                if try_merge(a, b):
                    self.row_len[a] += self.row_len[b]
                    if self.row_src_kind[a] != SRC_DELETED:
                        self.row_src_kind[a] = SRC_SPILL  # merged content
                    absorbed[b] = a
                    order.pop(i + 1)
                else:
                    i += 1
        # GC structs: not in any list; merge contiguous runs per client
        for slot in range(len(self.client_of_slot)):
            prev = None
            for row in self.frag_row[slot]:
                if not self.row_is_gc[row] or row in absorbed:
                    prev = None if not self.row_is_gc[row] else row
                    continue
                if prev is not None and try_merge(prev, row):
                    self.row_len[prev] += self.row_len[row]
                    absorbed[row] = prev
                else:
                    prev = row

        # renumber surviving rows (order preserved: absorbed rows vanish)
        new_of_old = np.full(n, NULL, np.int32)
        keep = [r for r in range(n) if r not in absorbed]
        for new, old in enumerate(keep):
            new_of_old[old] = new
        self._renumber(keep, new_of_old)

        n_new = len(keep)
        new_right = np.full(n_new, NULL, np.int32)
        new_deleted = np.zeros(n_new, bool)
        new_heads = np.full(max(1, self.n_segs), NULL, np.int32)
        for old in keep:
            new_deleted[new_of_old[old]] = bool(deleted[old])
        for seg, order in order_of_seg.items():
            prev = NULL
            for old in order:
                nr = new_of_old[old]
                if prev == NULL:
                    new_heads[seg] = nr
                else:
                    new_right[prev] = nr
                prev = nr
        self.list_next = new_right.tolist()
        self.head_of_seg = new_heads[: self.n_segs].tolist()
        # deterministic fold over the compaction inputs: same inputs ->
        # same chain, anything else diverges (plan-cache keying)
        self.plan_frontier = _pc.fold(
            self.plan_frontier,
            b"compact",
            np.ascontiguousarray(right_link, np.int32).tobytes()
            + np.ascontiguousarray(deleted, np.uint8).tobytes()
            + np.ascontiguousarray(head_of_seg, np.int32).tobytes()
            + (b"g" if gc else b"-"),
        )
        _pc.note_invalidation("compact")
        return new_right, new_deleted, new_heads

    def _renumber(self, keep: list[int], new_of_old: np.ndarray) -> None:
        """Apply a row renumbering to every host-side structure."""
        take = lambda col: [col[r] for r in keep]
        self.row_slot = take(self.row_slot)
        self.row_clock = take(self.row_clock)
        self.row_len = take(self.row_len)
        self.row_origin_slot = take(self.row_origin_slot)
        self.row_origin_clock = take(self.row_origin_clock)
        self.row_right_slot = take(self.row_right_slot)
        self.row_right_clock = take(self.row_right_clock)
        self.row_is_gc = take(self.row_is_gc)
        self.row_countable = take(self.row_countable)
        self.row_content = take(self.row_content)
        self.row_content_ref = take(self.row_content_ref)
        self.row_seg = take(self.row_seg)
        self.row_src_kind = take(self.row_src_kind)
        self.row_src_buf = take(self.row_src_buf)
        self.row_src_ofs = take(self.row_src_ofs)
        self.row_src_end = take(self.row_src_end)
        # prune the source-buffer registry: compaction tombstones/merges
        # rows, and buffers no surviving row references must not stay
        # pinned for the mirror's lifetime
        used = sorted({b for b in self.row_src_buf if b >= 0})
        remap = {old: new for new, old in enumerate(used)}
        self._bufs = [self._bufs[b] for b in used]
        self._buf_ids = {id(b): j for j, b in enumerate(self._bufs)}
        self.row_src_buf = [
            remap[b] if b >= 0 else b for b in self.row_src_buf
        ]
        self._gen += 1
        # fragment index: rebuild from the surviving rows (clock-sorted)
        n_slots = len(self.client_of_slot)
        self.frag_clock = [[] for _ in range(n_slots)]
        self.frag_row = [[] for _ in range(n_slots)]
        by_slot: dict[int, list[int]] = {}
        for row in range(len(self.row_slot)):
            by_slot.setdefault(self.row_slot[row], []).append(row)
        for slot, rows in by_slot.items():
            rows.sort(key=lambda r: self.row_clock[r])
            self.frag_clock[slot] = [self.row_clock[r] for r in rows]
            self.frag_row[slot] = rows
        self.map_chain = {
            seg: [int(new_of_old[r]) for r in chain]
            for seg, chain in self.map_chain.items()
        }
        self._lww_deleted = {
            int(new_of_old[r]) for r in self._lww_deleted if new_of_old[r] != NULL
        }
        self._host_deleted_rows = {
            int(new_of_old[r])
            for r in self._host_deleted_rows
            if new_of_old[r] != NULL
        }
        # nested-segment bookkeeping: parent rows renumber; type rows are
        # never absorbed (ContentType does not merge), so parents survive
        self._rows_of_seg = {
            seg: [int(new_of_old[r]) for r in rows if new_of_old[r] != NULL]
            for seg, rows in self._rows_of_seg.items()
        }
        remap_parent = (
            lambda p: p if p == NULL else int(new_of_old[p])
        )
        self.seg_info = [
            (name, sub, remap_parent(p)) for name, sub, p in self.seg_info
        ]
        self.segments = {key: s for s, key in enumerate(self.seg_info)}
        self._segs_of_parent = {}
        for s, (_n, _s2, p) in enumerate(self.seg_info):
            if p != NULL:
                self._segs_of_parent.setdefault(p, []).append(s)
        # compact the host DS ranges too (sorted union)
        for slot, ranges in self.ds.items():
            self.ds[slot] = self._union_ranges(ranges)

    def state_vector(self) -> dict[int, int]:
        return {
            self.client_of_slot[s]: st for s, st in enumerate(self.state) if st > 0
        }

    def encode_state_vector(self) -> bytes:
        from ..coding import DSEncoderV1
        from ..updates import write_state_vector

        encoder = DSEncoderV1()
        write_state_vector(encoder, self.state_vector())
        return encoder.to_bytes()

    @staticmethod
    def _union_ranges(ranges) -> list[tuple[int, int]]:
        """Sorted union of (clock, len) ranges.  The mirror's bookkeeping
        may note overlapping coverage (per-row deletes + remote DS ranges);
        the wire DS must be disjoint — the reference's sortAndMergeDeleteSet
        only coalesces exactly-touching ranges because its inputs are
        disjoint by construction (DeleteSet.js:113-135)."""
        out: list[tuple[int, int]] = []
        for clock, ln in sorted(ranges):
            if out and clock <= out[-1][0] + out[-1][1]:
                last_c, last_l = out[-1]
                out[-1] = (last_c, max(last_l, clock + ln - last_c))
            else:
                out.append((clock, ln))
        return out

    def delete_set(self):
        """The doc's derived DeleteSet (reference
        createDeleteSetFromStructStore, DeleteSet.js:185-210)."""
        from ..core import DeleteItem, DeleteSet

        ds = DeleteSet()
        for slot, ranges in self.ds.items():
            ds.clients[self.client_of_slot[slot]] = [
                DeleteItem(clock, ln)
                for clock, ln in self._union_ranges(ranges)
            ]
        return ds

    def encode_state_as_update(self, target_sv: dict[int, int] | None = None,
                               v2: bool = False) -> bytes:
        """Wire-encode this doc's missing state directly from the columns —
        the columnar writeStateAsUpdate (reference encoding.js:490-493,
        writeClientsStructs :94-116, Item.write Item.js:625-658).

        Emitted runs follow the mirror's fragmentation (never re-merged);
        the update is byte-valid and state-equivalent, like any Yjs update.
        """
        target_sv = target_sv or {}
        needed, offset = self._diff_mask(target_sv)
        return self.encode_masked_update(needed, offset, v2=v2)

    def _diff_mask(self, remote_sv: dict[int, int]):
        """Vectorized host twin of kernels.diff_mask_kernel: rows (or row
        suffixes) beyond a remote state vector (encoding.js:94-116)."""
        n = self.n_rows
        if n == 0:
            return np.zeros(0, bool), np.zeros(0, np.int64)
        c = self._np_cols()
        remote_of_slot = np.asarray(
            [remote_sv.get(cl, 0) for cl in self.client_of_slot], np.int64
        )
        remote = remote_of_slot[np.asarray(self.row_slot, np.int64)]
        needed = c["row_end"] > remote
        offset = np.where(needed, np.clip(remote - c["clock"], 0, None), 0)
        return needed, offset

    def encode_step_update(self, pre_sv: dict[int, int], plan: StepPlan,
                           v2: bool = False) -> bytes | None:
        """The incremental update one flush produced: structs beyond the
        pre-flush state vector + the step's applied delete ranges — the
        engine's doc.on('update') payload (reference Transaction.js:339-352
        emits exactly the transaction's novelty)."""
        needed, offset = self._diff_mask(pre_sv)
        if not needed.any() and not plan.applied_ds:
            return None
        return self.encode_masked_update(
            needed, offset, v2=v2, ds_ranges=plan.applied_ds
        )

    def encode_masked_update(self, needed, offset, v2: bool = False,
                             ds_ranges=None) -> bytes:
        """Wire-encode the rows selected by ``needed`` (bool [n_rows]) from
        element ``offset`` — the writer half of sync step 2, fed either by
        the host mask above or by the device ``diff_mask_kernel`` for the
        engine's batched path.  ``ds_ranges`` overrides the DS section
        (defaults to the doc's full derived DeleteSet)."""
        from ..coding import UpdateEncoderV1, UpdateEncoderV2
        from ..core import write_delete_set
        from ..lib0 import encoding as lib0enc

        if not v2:
            from ..native import NativeDecodeError

            try:
                return self._encode_masked_update_native(
                    needed, offset, ds_ranges
                )
            except NativeDecodeError:
                pass  # no toolchain: pure-Python writer below

        encoder = UpdateEncoderV2() if v2 else UpdateEncoderV1()
        # clients with news, descending id ("heavily improves the conflict
        # algorithm", reference encoding.js:112)
        todo = []
        for slot in range(len(self.client_of_slot)):
            rows = [r for r in self.frag_row[slot] if r < len(needed) and needed[r]]
            if rows:
                todo.append((self.client_of_slot[slot], rows))
        todo.sort(reverse=True)
        lib0enc.write_var_uint(encoder.rest_encoder, len(todo))
        for client, rows in todo:
            lib0enc.write_var_uint(encoder.rest_encoder, len(rows))
            encoder.write_client(client)
            first_ofs = int(offset[rows[0]])
            lib0enc.write_var_uint(
                encoder.rest_encoder, self.row_clock[rows[0]] + first_ofs
            )
            for j, row in enumerate(rows):
                self._write_row(encoder, row, first_ofs if j == 0 else 0)
        if ds_ranges is None:
            ds = self.delete_set()
        else:
            from ..core import DeleteItem, DeleteSet

            by_client: dict[int, list[tuple[int, int]]] = {}
            for client, clock, ln in ds_ranges:
                by_client.setdefault(client, []).append((clock, ln))
            ds = DeleteSet()
            for client, ranges in by_client.items():
                ds.clients[client] = [
                    DeleteItem(c, ln) for c, ln in self._union_ranges(ranges)
                ]
        write_delete_set(encoder, ds)
        return encoder.to_bytes()

    def _np_cols(self) -> dict[str, np.ndarray]:
        """Numpy views of the encode-relevant row columns, rebuilt only when
        the mirror mutated since the last build (generation counter)."""
        if self._np_gen == self._gen:
            return self._np
        client_of_slot = np.asarray(self.client_of_slot, np.int64)
        resolve = lambda slots: np.where(
            slots >= 0, client_of_slot[np.clip(slots, 0, None)], NULL
        )
        oslot = np.asarray(self.row_origin_slot, np.int64)
        rslot = np.asarray(self.row_right_slot, np.int64)
        seg = np.asarray(self.row_seg, np.int64)
        safe_seg = np.clip(seg, 0, None)
        seg_gather = lambda col, fill: np.where(
            seg >= 0,
            np.asarray(col, np.int64)[safe_seg] if len(col) else NULL,
            fill,
        )
        c = {
            "slot": np.asarray(self.row_slot, np.int64),
            "client": resolve(np.asarray(self.row_slot, np.int64)),
            "clock": np.asarray(self.row_clock, np.int64),
            "length": np.asarray(self.row_len, np.int64),
            "origin_client": resolve(oslot),
            "origin_clock": np.asarray(self.row_origin_clock, np.int64),
            "right_client": resolve(rslot),
            "right_clock": np.asarray(self.row_right_clock, np.int64),
            "content_ref": np.asarray(self.row_content_ref, np.int64),
            "src_kind": np.asarray(self.row_src_kind, np.int64),
            "src_buf": np.asarray(self.row_src_buf, np.int64),
            "src_ofs": np.asarray(self.row_src_ofs, np.int64),
            "src_end": np.asarray(self.row_src_end, np.int64),
            "name_ofs": seg_gather(self.seg_name_ofs, NULL),
            "name_len": seg_gather(self.seg_name_len, 0),
            "sub_ofs": seg_gather(self.seg_sub_ofs, NULL),
            "sub_len": seg_gather(self.seg_sub_len, 0),
        }
        # nested-segment parents: each row's parent type item id (NULL root)
        p_row = seg_gather([p for _n, _s, p in self.seg_info], NULL)
        safe_p = np.clip(p_row, 0, None)
        c["parent_client"] = np.where(p_row >= 0, c["client"][safe_p], NULL)
        c["parent_clock"] = np.where(p_row >= 0, c["clock"][safe_p], 0)
        c["row_end"] = c["clock"] + c["length"]
        # write order: client descending, clock ascending (encoding.js:112)
        c["order"] = np.lexsort((c["clock"], -c["client"]))
        self._np = c
        self._np_gen = self._gen
        return c

    def _encode_masked_update_native(self, needed, offset,
                                     ds_ranges=None) -> bytes:
        """Gather the masked rows from the cached numpy columns and let the
        C++ writer assemble the V1 update (ytpu_encode_v1).  Content bytes
        memcpy straight from the source update buffers the rows were decoded
        from (LazyContent / V2 arena ranges, precomputed at row creation);
        realized or partially-written non-string contents are pre-framed
        into a spill buffer by the Python encoder."""
        from ..coding import UpdateEncoderV1
        from ..native import NativeDecodeError, encode_v1_update, load

        if load() is None:
            raise NativeDecodeError("native transcoder unavailable")

        c = self._np_cols()
        n_rows = len(c["clock"])
        needed = np.asarray(needed, bool)
        offset = np.asarray(offset, np.int64)
        if len(needed) < n_rows:
            needed = np.pad(needed, (0, n_rows - len(needed)))
            offset = np.pad(offset, (0, n_rows - len(offset)))
        order = c["order"]
        sel = order[needed[order]]
        n = len(sel)
        cols = {
            k: c[k][sel]
            for k in (
                "clock", "length", "origin_client", "origin_clock",
                "right_client", "right_clock", "content_ref",
                "name_ofs", "name_len", "sub_ofs", "sub_len",
                "parent_client", "parent_clock",
                "src_kind", "src_buf", "src_ofs", "src_end",
            )
        }
        cols["offset"] = offset[sel]
        sel_client = c["client"][sel]

        # client groups: contiguous runs in the descending-client order
        if n:
            bounds = np.flatnonzero(np.diff(sel_client) != 0) + 1
            group_start = np.concatenate(([0], bounds))
            group_len = np.diff(np.concatenate((group_start, [n])))
            group_client = sel_client[group_start]
        else:
            group_start = group_len = group_client = np.zeros(0, np.int64)

        # spill pass: realized contents, partial non-string first structs,
        # and V2-framed payloads that have no V1-compatible byte range
        from ..native import SRC_V2LAZY

        spill_idx = np.flatnonzero(
            (cols["src_kind"] == SRC_SPILL)
            | (cols["src_kind"] == SRC_V2LAZY)
            | ((cols["src_kind"] == SRC_FRAMED) & (cols["offset"] > 0))
        )
        spill = UpdateEncoderV1()
        spill_buf = spill.rest_encoder.buf
        for j in spill_idx:
            row = int(sel[j])
            pos0 = len(spill_buf)
            self.realized_content(row).write(spill, int(cols["offset"][j]))
            cols["src_kind"][j] = SRC_SPILL
            cols["src_ofs"][j] = pos0
            cols["src_end"][j] = len(spill_buf)
        bufs = list(self._bufs)
        spill_id = len(bufs)
        bufs.append(bytes(spill_buf))
        if len(spill_idx):
            cols["src_buf"][spill_idx] = spill_id

        content_bytes = int(
            np.sum(
                np.where(
                    cols["src_end"] >= 0, cols["src_end"] - cols["src_ofs"], 10
                )
            )
            + np.sum(cols["name_len"])
            + np.sum(cols["sub_len"])
        ) if n else 0
        strings = self._strings

        # DS section groups (write_delete_set order: dict iteration)
        if ds_ranges is None:
            (ds_group_client, ds_group_start, ds_group_len,
             ds_clock, ds_len) = self._merged_ds_arrays()
        else:
            by_client: dict[int, list[tuple[int, int]]] = {}
            for client, clock, ln in ds_ranges:
                by_client.setdefault(client, []).append((clock, ln))
            merged = {
                client: self._union_ranges(ranges)
                for client, ranges in by_client.items()
            }
            ds_group_client = np.asarray(list(merged.keys()), np.int64)
            ds_group_len = np.asarray(
                [len(v) for v in merged.values()], np.int64
            )
            ds_group_start = np.zeros(len(merged), np.int64)
            if len(merged) > 1:
                ds_group_start[1:] = np.cumsum(ds_group_len)[:-1]
            ds_clock = np.asarray(
                [c for v in merged.values() for c, _l in v], np.int64
            )
            ds_len = np.asarray(
                [ln for v in merged.values() for _c, ln in v], np.int64
            )

        out_cap = (
            64
            + n * 80
            + content_bytes
            + 24 * (len(ds_clock) + len(ds_group_client))
        )
        return encode_v1_update(
            bufs,
            group_client, group_start, group_len,
            cols,
            bytes(strings),
            ds_group_client, ds_group_start, ds_group_len,
            ds_clock, ds_len,
            out_cap,
        )

    def _merged_ds_arrays(self):
        """The doc's derived DeleteSet as grouped, sorted+merged numpy
        arrays (DeleteSet.js:113-135 semantics, vectorized and cached)."""
        if self._ds_np_gen == self._ds_gen and self._ds_np is not None:
            return self._ds_np
        g_client, g_start, g_len = [], [], []
        clocks, lens = [], []
        pos = 0
        for slot, ranges in self.ds.items():
            if not ranges:
                continue
            a = np.asarray(ranges, np.int64).reshape(-1, 2)
            o = np.argsort(a[:, 0], kind="stable")
            cl, ln = a[o, 0], a[o, 1]
            end = cl + ln
            cummax = np.maximum.accumulate(end)
            # new interval iff start > max end of everything before it
            new_g = np.empty(len(cl), bool)
            new_g[0] = True
            new_g[1:] = cl[1:] > cummax[:-1]
            idx = np.flatnonzero(new_g)
            m_start = cl[idx]
            last = np.concatenate((idx[1:] - 1, [len(cl) - 1]))
            m_end = cummax[last]
            g_client.append(self.client_of_slot[slot])
            g_start.append(pos)
            g_len.append(len(idx))
            pos += len(idx)
            clocks.append(m_start)
            lens.append(m_end - m_start)
        out = (
            np.asarray(g_client, np.int64),
            np.asarray(g_start, np.int64),
            np.asarray(g_len, np.int64),
            np.concatenate(clocks) if clocks else np.zeros(0, np.int64),
            np.concatenate(lens) if lens else np.zeros(0, np.int64),
        )
        self._ds_np_gen = self._ds_gen
        self._ds_np = out
        return out

    def _write_row(self, encoder, row: int, offset: int) -> None:
        """Wire-encode one row (reference Item.js:625-658 / GC.js:45-48)."""
        from ..ids import create_id

        if self.row_is_gc[row]:
            encoder.write_info(0)
            encoder.write_len(self.row_len[row] - offset)
            return
        oslot = self.row_origin_slot[row]
        rslot = self.row_right_slot[row]
        if offset > 0:
            origin = create_id(
                self.client_of_slot[self.row_slot[row]],
                self.row_clock[row] + offset - 1,
            )
        elif oslot != NULL:
            origin = create_id(self.client_of_slot[oslot], self.row_origin_clock[row])
        else:
            origin = None
        right = (
            create_id(self.client_of_slot[rslot], self.row_right_clock[row])
            if rslot != NULL
            else None
        )
        name, sub, parent_row = self.seg_info[self.row_seg[row]]
        ref = self.row_content_ref[row]
        info = (
            ref
            | (0 if origin is None else BIT8)
            | (0 if right is None else BIT7)
            | (0 if sub is None else BIT6)
        )
        encoder.write_info(info)
        if origin is not None:
            encoder.write_left_id(origin)
        if right is not None:
            encoder.write_right_id(right)
        if origin is None and right is None:
            if parent_row != NULL:
                # nested type: parent is the type item's id (Item.js:644-648)
                encoder.write_parent_info(False)
                encoder.write_left_id(
                    create_id(
                        self.client_of_slot[self.row_slot[parent_row]],
                        self.row_clock[parent_row],
                    )
                )
            else:
                encoder.write_parent_info(True)  # root-type key parent
                encoder.write_string(name)
            if sub is not None:
                encoder.write_string(sub)
        self.realized_content(row).write(encoder, offset)

    def origin_rows(self, start: int = 0) -> np.ndarray:
        """For rows [start:], the row *containing* each origin id (NULL if
        no origin) — the columnar get_item(store, o.origin) of the case-2
        conflict check (reference src/structs/Item.js:447-470)."""
        n = self.n_rows
        out = np.full(n - start, NULL, np.int32)
        oslot = np.asarray(self.row_origin_slot[start:], np.int32)
        oclock = np.asarray(self.row_origin_clock[start:], np.int64)
        for s in range(len(self.client_of_slot)):
            mask = oslot == s
            if not mask.any():
                continue
            fc = np.asarray(self.frag_clock[s], np.int64)
            fr = np.asarray(self.frag_row[s], np.int32)
            idx = np.searchsorted(fc, oclock[mask], side="right") - 1
            out[np.nonzero(mask)[0]] = fr[np.clip(idx, 0, len(fr) - 1)]
        return out

    def static_columns(self, start: int = 0) -> dict[str, np.ndarray]:
        """The immutable device columns for rows [start:] — host cost scales
        with the delta when the caller keeps earlier rows resident."""
        return {
            "client_key": np.asarray(
                [self.client_of_slot[s] for s in self.row_slot[start:]],
                np.uint32,
            ),
            "origin_slot": np.asarray(self.row_origin_slot[start:], np.int32),
            "origin_clock": np.asarray(self.row_origin_clock[start:], np.int32),
            "right_slot": np.asarray(self.row_right_slot[start:], np.int32),
            "right_clock": np.asarray(self.row_right_clock[start:], np.int32),
            "origin_row": self.origin_rows(start),
        }

    def has_pending(self) -> bool:
        return bool(self.pending) or bool(self.pending_ds)

    def pending_depth(self) -> int:
        """Parked refs + delete ranges awaiting causal deps (metrics)."""
        return sum(len(q) for q in self.pending.values()) + len(self.pending_ds)
