"""YEvent-shaped change sets computed from a flush's step plan.

The reference delivers per-type events with ``changes = {delta, keys}``
after every transaction (reference YEvent.js:85-187, callObservers
AbstractType.js:360-389).  An engine-hosted doc has no Item graph to walk,
but the planner's host state is sufficient: add/delete classification is
clock-based exactly like the reference (``adds`` = clock >= beforeState,
``deletes`` = covered by the transaction's DeleteSet — here the flush's
``applied_ds``), the list walk follows the host ``list_next`` links, and
map key changes come from the per-key chains.  Semantics mirror the base
``YEvent.changes`` computation in yjs_tpu/types/events.py line for line so
the engine's payloads equal the CPU doc's on the same traffic (the parity
tests in tests/test_engine_events.py).
"""

from __future__ import annotations

from bisect import bisect_right

from ..core import UNDEFINED
from .columns import NULL


def _coverage(applied_ds):
    """Per-client sorted delete ranges of this flush (the transaction's
    DeleteSet, reference isDeleted DeleteSet.js:75-105)."""
    by_client: dict[int, list[tuple[int, int]]] = {}
    for client, clock, ln in applied_ds:
        by_client.setdefault(client, []).append((clock, clock + ln))
    for ranges in by_client.values():
        ranges.sort()
    return by_client


def _deleted_now(cov, client, clock) -> bool:
    ranges = cov.get(client)
    if not ranges:
        return False
    i = bisect_right(ranges, (clock, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= clock < ranges[i][1]


def compute_flush_events(mirror, plan, pre_state: dict[int, int]):
    """Events for one flush: list of ``{"path", "delta", "keys"}`` dicts,
    one per changed type, shaped like the CPU path's ``YEvent``.

    ``pre_state`` is the doc's state vector before the flush (the
    reference transaction's beforeState).
    """
    seg_info = mirror.seg_info
    row_seg = mirror.row_seg
    row_clock = mirror.row_clock
    row_len = mirror.row_len
    row_slot = mirror.row_slot
    client_of_slot = mirror.client_of_slot
    list_next = mirror.list_next
    head_of_seg = mirror.head_of_seg
    host_deleted = mirror._host_deleted_rows

    cov = _coverage(plan.applied_ds)

    def client_of(row):
        return client_of_slot[row_slot[row]]

    def adds(row) -> bool:
        return row_clock[row] >= pre_state.get(client_of(row), 0)

    def deletes(row) -> bool:
        return _deleted_now(cov, client_of(row), row_clock[row])

    def type_recorded(parent) -> bool:
        # the reference only records changed types that existed before the
        # transaction and are alive (addChangedTypeToTransaction,
        # Transaction.js:154-159): a type created this flush is reported
        # by its PARENT's event, not its own
        if parent == NULL:
            return True
        p = int(parent)
        return not adds(p) and p not in host_deleted

    # changed types: group touched segments by (name, parent_row) — the
    # reference fires one event per type with all its keys
    touched: dict[tuple, set] = {}  # type key -> set of parent_subs (None = list)
    rows_touched = [int(r) for r in plan.sched[:, 0]] if hasattr(
        plan.sched, "shape"
    ) else [s[0] for s in plan.sched]
    for r in rows_touched:
        sg = row_seg[r]
        if sg == NULL:
            continue
        name, sub, parent = seg_info[sg]
        if not type_recorded(parent):
            continue
        touched.setdefault((name, parent), set()).add(sub)
    for r in plan.delete_rows:
        r = int(r)
        sg = row_seg[r]
        if sg == NULL:
            continue
        name, sub, parent = seg_info[sg]
        # fragments of rows deleted in EARLIER flushes ride in delete_rows
        # (device bookkeeping) but are not part of this transaction's
        # DeleteSet — the reference would not fire for them
        if sub is None and not deletes(r):
            continue
        if not type_recorded(parent):
            continue
        touched.setdefault((name, parent), set()).add(sub)

    events = []
    for (name, parent), subs in touched.items():
        delta: list = []
        keys: dict = {}
        list_seg = mirror.segments.get((name, None, parent))
        if None in subs and list_seg is not None:
            # base YEvent.changes list walk (types/events.py:45-71)
            last_op = None

            def pack_op(op):
                if op is not None:
                    delta.append(op)

            r = head_of_seg[list_seg]
            while r != NULL:
                r = int(r)
                if r in host_deleted:
                    if deletes(r) and not adds(r):
                        if last_op is None or "delete" not in last_op:
                            pack_op(last_op)
                            last_op = {"delete": 0}
                        last_op["delete"] += int(row_len[r])
                else:
                    if adds(r):
                        if last_op is None or "insert" not in last_op:
                            pack_op(last_op)
                            last_op = {"insert": []}
                        content = mirror.realized_content(r)
                        last_op["insert"] = last_op["insert"] + (
                            content.get_content() if content is not None else []
                        )
                    else:
                        if last_op is None or "retain" not in last_op:
                            pack_op(last_op)
                            last_op = {"retain": 0}
                        last_op["retain"] += int(row_len[r])
                r = list_next[r]
            if last_op is not None and "retain" not in last_op:
                pack_op(last_op)
        for sub in subs:
            if sub is None:
                continue
            seg = mirror.segments.get((name, sub, parent))
            chain = mirror.map_chain.get(seg) if seg is not None else None
            if not chain:
                continue
            # reference key logic (types/events.py:73-101): classify the
            # chain tail against beforeState, old value from the last
            # pre-existing entry
            tail = int(chain[-1])
            if adds(tail):
                j = len(chain) - 2
                while j >= 0 and adds(int(chain[j])):
                    j -= 1
                prev = int(chain[j]) if j >= 0 else None
                if deletes(tail):
                    if prev is not None and deletes(prev):
                        action = "delete"
                        old = mirror.realized_content(prev).get_content()[-1]
                    else:
                        continue
                else:
                    if prev is not None and deletes(prev):
                        action = "update"
                        old = mirror.realized_content(prev).get_content()[-1]
                    else:
                        action = "add"
                        old = UNDEFINED
            else:
                if deletes(tail):
                    action = "delete"
                    old = mirror.realized_content(tail).get_content()[-1]
                else:
                    continue
            keys[sub] = {"action": action, "oldValue": old}
        if not delta and not keys:
            continue
        events.append({
            "path": _path_of(mirror, name, parent),
            "delta": delta,
            "keys": keys,
        })
    return events


# content refs whose CPU classes merge (Item.mergeWith succeeds:
# ContentDeleted/JSON/String/Any — core.py merge_with returns True)
_MERGEABLE_REFS = frozenset((1, 2, 4, 8))


def _rows_one_cpu_item(mirror, p: int, r: int) -> bool:
    """True when list-adjacent mirror rows p,r are ONE Item in the CPU
    store — the exact Item.mergeWith predicate (core.py:862-884 /
    reference Item.js:555-579) evaluated over columns: same client,
    consecutive clocks, r's origin = p's last id, equal right origins,
    equal deleted state, mergeable equal content kinds.  The CPU doc
    merges every such adjacent pair during transaction cleanup, while
    the mirror keeps rows split until compaction — this predicate is
    what keeps the two path indexings identical."""
    if int(mirror.row_slot[p]) != int(mirror.row_slot[r]):
        return False
    if int(mirror.row_clock[p]) + int(mirror.row_len[p]) != int(
        mirror.row_clock[r]
    ):
        return False
    ref = int(mirror.row_content_ref[r])
    if ref != int(mirror.row_content_ref[p]) or ref not in _MERGEABLE_REFS:
        return False
    # r.origin == p.last_id
    if (
        int(mirror.row_origin_slot[r]) != int(mirror.row_slot[p])
        or int(mirror.row_origin_clock[r])
        != int(mirror.row_clock[p]) + int(mirror.row_len[p]) - 1
    ):
        return False
    # equal right origins
    rs_p, rs_r = int(mirror.row_right_slot[p]), int(mirror.row_right_slot[r])
    if rs_p != rs_r:
        return False
    if rs_p != NULL and int(mirror.row_right_clock[p]) != int(
        mirror.row_right_clock[r]
    ):
        return False
    host_deleted = mirror._host_deleted_rows
    return (p in host_deleted) == (r in host_deleted)


def _path_of(mirror, name, parent_row) -> list:
    """Root-to-type path: map keys as strings, list positions counted
    exactly like the reference's getPathTo (YEvent.js:207-228): one per
    undeleted ITEM before the target.  The mirror keeps runs split that
    the CPU store has merged (cleanup merges eagerly, the mirror only at
    compaction), so consecutive rows forming one CPU item
    (_rows_one_cpu_item) count once — pinned against the CPU path by
    tests/test_engine_events.py::test_event_path_parity_*."""
    path: list = []
    host_deleted = mirror._host_deleted_rows
    while parent_row != NULL:
        r = int(parent_row)
        sg = mirror.row_seg[r]
        pname, psub, pparent = mirror.seg_info[sg]
        if psub is not None:
            path.insert(0, psub)
        else:
            i = 0
            c = mirror.head_of_seg[sg]
            prev = None  # previous row in LIST order (deleted included:
            # a deleted run between two live runs breaks CPU adjacency)
            while c != NULL and int(c) != r:
                c = int(c)
                if c not in host_deleted and not (
                    prev is not None and _rows_one_cpu_item(mirror, prev, c)
                ):
                    i += 1
                prev = c
                c = mirror.list_next[c]
            path.insert(0, i)
        name, parent_row = pname, pparent
    path.insert(0, name)
    return path
