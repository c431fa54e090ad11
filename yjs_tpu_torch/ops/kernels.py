"""Device kernels of the flush, as torch wrappers.

Three device programs carry the default (apply-lane) flush of
:class:`BatchEngine`:

- :func:`apply_lanes` (through :func:`apply_plan2`) scatters one packed
  lanes buffer of host-resolved final links, segment heads and delete
  marks into the resident tables — every flush;
- :func:`scatter_rows` replaces whole doc rows of the three tables —
  compaction rebuilds and warm-tier hydration;
- :func:`list_ranks` ranks each row's distance to its list tail by
  pointer doubling — exports that read the device tables back
  (``YTPU_EXPORT_DEVICE=1``).

Three more run YATA itself on the device (``YTPU_KERNEL=levels|seq``):

- :func:`scatter_statics` writes one packed block of new rows into the
  six resident static columns the conflict scan reads;
- :func:`batch_step` (``seq``) integrates each doc's causal schedule one
  item at a time;
- :func:`batch_step_levels` (``levels``) splices each dependency level
  in one pass and sends true conflicts through the same single-item
  integrate.

Two broadcast variants fan one doc's work out over the batch (the B4
replay shape; no engine path calls them, as in the JAX package):

- :func:`apply_plan_shared` scatters one resolved delta into every doc;
- :func:`batch_step_levels_shared` runs the level-parallel step with one
  static table, schedule and delete list read by every doc.

Two more serve the batched sync paths of the engine and the provider:

- :func:`state_vector_kernel` reduces each doc's rows to its dense state
  vector — ``BatchEngine.state_vectors_batched``;
- :func:`diff_mask_kernel` marks the rows (and row suffixes) a remote
  state vector is missing — the device branch of
  ``BatchEngine.sync_step2_batch`` (reconnect storms, checkpoints).

Each wrapper keeps the JAX package's signature and semantics
(``yjs_tpu/ops/kernels.py``, ``yjs_tpu/ops/engine.py``) and has a plain
PyTorch version beside it (``*_plain``).  The wrapper dispatches on the
device of the tensors it is given: CPU tensors take the plain version,
CUDA tensors launch the hand-written CUDA kernel from
``yjs_tpu_torch/csrc`` (built and bound by :mod:`._cuda`) or raise —
there is no fallback from one to the other.  The kernels write the
resident tables in place (the JAX versions donate them), so a wrapper
returns the same tensor objects it was given.

``launches`` counts, per wrapper, the CUDA kernel launches it made; the
plain version never counts.

The segment planner's two kernels live here too: :func:`conflict_scan`
(chain masks and run ids, per doc or over a doc-major chunk) and
:func:`anchor_lookup` (a batched int64 ``searchsorted``).  The planner
reaches them only through ``plan_conflict_scan``,
``plan_chunk_conflict_scan``, ``plan_anchor_lookup`` and
:func:`lookup_keys`, which take host numpy and give host numpy back:
``backend="np"`` (the default) stays on NumPy; ``"jax"``, the JAX
package's name for its device path, pads the columns to a power-of-two
length, copies them to ``device`` (the CUDA device unless told
otherwise), runs the wrapper and copies back.

A kernel that cannot be built, loaded or launched, or a CUDA device
asked for on a host without one, raises :class:`KernelError`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..obs.prof import profiled
from ._cuda import KernelError
from .columns import GATHER_SUCC

NULL = -1

# CUDA kernel launches per wrapper (chip_smoke.py zeroes and reads them)
launches = {
    "apply_lanes": 0, "scatter_rows": 0, "list_ranks": 0,
    "state_vector": 0, "diff_mask": 0,
    "scatter_statics": 0, "batch_step": 0, "batch_step_levels": 0,
    "apply_plan_shared": 0, "batch_step_levels_shared": 0,
    "conflict_scan": 0, "conflict_scan_chunk": 0, "anchor_lookup": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_cuda(*tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when all are
    on the CPU; raises on a mix or on another device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(
        f"kernel inputs must all be on the CPU or on one CUDA device, got "
        f"{sorted(str(t.device) for t in tensors)}"
    )


def _check(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# ---------------------------------------------------------------------------
# K1: bulk apply (the default flush path)
# ---------------------------------------------------------------------------


def _doc_lanes(counts: torch.Tensor, k: int, cap_oob: int):
    """Per-lane (doc, within-doc index) derived from per-doc counts:
    ``d = searchsorted(cumsum(counts), lane, right)`` clipped to ``B-1``,
    ``within = lane - (cum[d] - counts[d])``; lanes at or past the total
    get ``cap_oob`` (dropped by the store)."""
    b = counts.shape[0]
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    idx = torch.arange(k, dtype=torch.int32, device=counts.device)
    d = torch.searchsorted(cum, idx, right=True).to(torch.int32)
    d = torch.clamp(d, max=b - 1)
    dl = d.long()
    within = idx - (cum[dl] - counts[dl])
    within = torch.where(
        idx < cum[b - 1], within, torch.full_like(within, cap_oob)
    )
    return d, within


def _drop_set(table: torch.Tensor, d: torch.Tensor, r: torch.Tensor,
              v) -> None:
    """``table[d, r] = v`` in place with JAX ``mode="drop"`` semantics:
    negative ``r`` counts from the end, what is still out of bounds is
    dropped."""
    n = table.shape[1]
    r = r.long()
    r = torch.where(r < 0, r + n, r)
    keep = (r >= 0) & (r < n)
    if not isinstance(v, torch.Tensor):
        v = torch.full(r.shape, v, dtype=table.dtype, device=table.device)
    table.index_put_((d.long()[keep], r[keep]), v[keep].to(table.dtype))


def apply_lanes_plain(dyn, lanes, k_dn, k_sp, k_h, k_d):
    """Plain PyTorch version of :func:`apply_lanes` (in place)."""
    right_link, deleted, starts = dyn
    lanes = lanes.to(torch.int32)
    b = right_link.shape[0]
    n1 = right_link.shape[1]
    o = 4 * b
    cnt_dn, cnt_sp = lanes[0:b], lanes[b : 2 * b]
    cnt_h, cnt_d = lanes[2 * b : 3 * b], lanes[3 * b : 4 * b]
    if k_dn:
        d, r = _doc_lanes(cnt_dn, k_dn, n1)
        _drop_set(right_link, d, r, lanes[o : o + k_dn])
    o += k_dn
    if k_sp:
        d, _ = _doc_lanes(cnt_sp, k_sp, n1)
        _drop_set(
            right_link, d, lanes[o : o + k_sp], lanes[o + k_sp : o + 2 * k_sp]
        )
    o += 2 * k_sp
    if k_h:
        d, _ = _doc_lanes(cnt_h, k_h, starts.shape[1])
        _drop_set(starts, d, lanes[o : o + k_h], lanes[o + k_h : o + 2 * k_h])
    o += 2 * k_h
    if k_d:
        d, _ = _doc_lanes(cnt_d, k_d, n1)
        _drop_set(deleted, d, lanes[o : o + k_d], True)
    return right_link, deleted, starts


def apply_lanes(dyn, lanes, k_dn, k_sp, k_h, k_d):
    """Scatter one lanes buffer into the resident tables, in place.

    lanes layout (one i32 or i16 vector):
      [cnt_dense|cnt_sparse|cnt_heads|cnt_dels]  4 x [B] per-doc counts
      [dense_v]*k_dn    doc d's section i sets right_link[d, i] = v
      [r|v]*k_sp        sparse link writes at explicit rows
      [s|v]*k_h         segment-head writes
      [r]*k_d           delete marks
    Out-of-bounds targets (padding) are dropped.  Returns ``dyn``."""
    right_link, deleted, starts = dyn
    if not _on_cuda(right_link, deleted, starts, lanes):
        return apply_lanes_plain(dyn, lanes, k_dn, k_sp, k_h, k_d)
    from . import _cuda

    _check(right_link, "right_link", (torch.int32,), 2)
    _check(deleted, "deleted", (torch.bool,), 2)
    _check(starts, "starts", (torch.int32,), 2)
    _check(lanes, "lanes", (torch.int16, torch.int32), 1)
    b, n1 = right_link.shape
    if deleted.shape != right_link.shape or starts.shape[0] != b:
        raise ValueError("table shapes disagree")
    if lanes.shape[0] != 4 * b + k_dn + 2 * k_sp + 2 * k_h + k_d:
        raise ValueError("lanes length does not match the section widths")
    cum = torch.empty(4 * b, dtype=torch.int32, device=lanes.device)
    _cuda.apply_lanes(
        lanes, cum, right_link, deleted, starts, b, n1, starts.shape[1],
        k_dn, k_sp, k_h, k_d,
    )
    launches["apply_lanes"] += 1
    return right_link, deleted, starts


@profiled("apply_plan2")
def apply_plan2(dyn, lanes, k_dn, k_sp, k_h, k_d):
    """Bulk apply with device-derived indices (the flush entry point;
    see :func:`apply_lanes` for the lanes layout)."""
    return apply_lanes(dyn, lanes, k_dn, k_sp, k_h, k_d)


# ---------------------------------------------------------------------------
# K2: whole-row replacement
# ---------------------------------------------------------------------------


def scatter_rows_plain(right, deleted, starts, idx, new_right, new_deleted,
                       new_starts):
    """Plain PyTorch version of :func:`scatter_rows` (in place)."""
    b = right.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + b, idx)
    keep = (idx >= 0) & (idx < b)
    idx = idx[keep]
    right.index_copy_(0, idx, new_right[keep])
    deleted.index_copy_(0, idx, new_deleted[keep])
    starts.index_copy_(0, idx, new_starts[keep])
    return right, deleted, starts


@profiled("scatter_rows")
def scatter_rows(right, deleted, starts, idx, new_right, new_deleted,
                 new_starts):
    """Replace docs ``idx``'s link/deleted/head rows with freshly packed
    host columns, in place (compaction rebuilds, deferred warm-promotion
    hydrations).  Returns ``(right, deleted, starts)``."""
    args = (right, deleted, starts, idx, new_right, new_deleted, new_starts)
    if not _on_cuda(*args):
        return scatter_rows_plain(*args)
    from . import _cuda

    _check(right, "right", (torch.int32,), 2)
    _check(deleted, "deleted", (torch.bool,), 2)
    _check(starts, "starts", (torch.int32,), 2)
    _check(idx, "idx", (torch.int32,), 1)
    _check(new_right, "new_right", (torch.int32,), 2)
    _check(new_deleted, "new_deleted", (torch.bool,), 2)
    _check(new_starts, "new_starts", (torch.int32,), 2)
    k = idx.shape[0]
    b, n1 = right.shape
    s1 = starts.shape[1]
    if (
        deleted.shape != right.shape
        or starts.shape[0] != b
        or new_right.shape != (k, n1)
        or new_deleted.shape != (k, n1)
        or new_starts.shape != (k, s1)
    ):
        raise ValueError("row shapes disagree with the tables")
    if k:
        _cuda.scatter_rows(
            idx, new_right, new_deleted, new_starts, right, deleted, starts,
            k, b, n1, s1,
        )
        launches["scatter_rows"] += 1
    return right, deleted, starts


# ---------------------------------------------------------------------------
# K8: export ranks by pointer doubling
# ---------------------------------------------------------------------------


def _n_rounds(n1: int) -> int:
    return max(1, math.ceil(math.log2(max(2, n1))))


def list_ranks_plain(right_link, valid):
    """Plain PyTorch version of :func:`list_ranks`."""
    d = (right_link != NULL).to(torch.int32)
    p = right_link
    for _ in range(_n_rounds(right_link.shape[1])):
        live = p != NULL
        safe_p = torch.where(live, p, torch.zeros_like(p)).long()
        d = d + torch.where(
            live, torch.gather(d, 1, safe_p), torch.zeros_like(d)
        )
        p = torch.where(live, torch.gather(p, 1, safe_p), torch.full_like(p, NULL))
    return torch.where(valid, d, torch.full_like(d, NULL))


@profiled("list_ranks")
def list_ranks(right_link, valid):
    """Document order from right links by pointer doubling: d[i] =
    distance to the list tail; sorting valid rows by descending d gives
    the order.

    right_link: [B, N+1] i32 (NULL or a row of the same doc); valid:
    [B, N+1] bool host-known membership.  Returns d with -1 on invalid
    rows."""
    if not _on_cuda(right_link, valid):
        return list_ranks_plain(right_link, valid)
    from . import _cuda

    _check(right_link, "right_link", (torch.int32,), 2)
    _check(valid, "valid", (torch.bool,), 2)
    if valid.shape != right_link.shape:
        raise ValueError("valid must match right_link's shape")
    b, n1 = right_link.shape
    out = torch.empty_like(right_link)
    scratch = torch.empty(
        (2, 2, b, n1), dtype=torch.int32, device=right_link.device
    )
    if b:
        _cuda.list_ranks(right_link, valid, scratch, out, b, n1, _n_rounds(n1))
        launches["list_ranks"] += 1
    return out


# ---------------------------------------------------------------------------
# K9 / K10: the batched sync kernels
# ---------------------------------------------------------------------------

INT32_MIN = -(2**31)


def state_vector_kernel_plain(row_slot, row_end, n_slots: int):
    """Plain PyTorch version of :func:`state_vector_kernel`: a zero
    ``[B, n_slots+1]`` buffer takes each row's end by ``amax``; rows whose
    slot lies outside ``[0, n_slots)`` land in the extra column, which is
    cut off."""
    b = row_slot.shape[0]
    seg = torch.where(
        (row_slot >= 0) & (row_slot < n_slots), row_slot,
        torch.full_like(row_slot, n_slots),
    ).long()
    sv = torch.zeros((b, n_slots + 1), dtype=torch.int32,
                     device=row_slot.device)
    sv.scatter_reduce_(1, seg, row_end.to(torch.int32), "amax",
                       include_self=True)
    return sv[:, :n_slots].contiguous()


@profiled("state_vector_kernel")
def state_vector_kernel(row_slot, row_end, n_slots: int):
    """Dense per-doc state vectors: ``sv[b, s] = max(0, max{row_end[b, r]
    : row_slot[b, r] = s})`` — the segment-max recast of getStateVector
    (StructStore.js:49-56).

    row_slot: [B, N] i32 (NULL for unused rows), row_end: [B, N] i32;
    rows with a slot outside ``[0, n_slots)`` are dropped.  Returns
    ``[B, n_slots]`` i32."""
    if not _on_cuda(row_slot, row_end):
        return state_vector_kernel_plain(row_slot, row_end, n_slots)
    from . import _cuda

    _check(row_slot, "row_slot", (torch.int32,), 2)
    _check(row_end, "row_end", (torch.int32,), 2)
    if row_end.shape != row_slot.shape:
        raise ValueError("row_end must match row_slot's shape")
    b, n = row_slot.shape
    sv = torch.zeros((b, n_slots), dtype=torch.int32, device=row_slot.device)
    if b and n and n_slots:
        _cuda.state_vector(row_slot, row_end, sv, b, n, n_slots)
        launches["state_vector"] += 1
    return sv


def diff_mask_kernel_plain(row_slot, row_clock, row_end, sv):
    """Plain PyTorch version of :func:`diff_mask_kernel`, with JAX's
    gather rule: a slot at or past ``sv``'s width reads ``INT32_MIN``, and
    ``remote - clock`` wraps in int32."""
    n_slots = sv.shape[1]
    safe = torch.where(row_slot >= 0, row_slot, torch.zeros_like(row_slot))
    inb = safe < n_slots
    remote = torch.gather(
        sv, 1, torch.where(inb, safe, torch.zeros_like(safe)).long()
    )
    remote = torch.where(inb, remote, torch.full_like(remote, INT32_MIN))
    needed = (row_slot >= 0) & (row_end > remote)
    diff = remote.long() - row_clock.long()
    diff = (diff + 2**31) % 2**32 - 2**31  # int32 wrap-around
    offset = torch.clamp(diff, min=0).to(torch.int32)
    return needed, torch.where(needed, offset, torch.zeros_like(offset))


@profiled("diff_mask_kernel")
def diff_mask_kernel(row_slot, row_clock, row_end, sv):
    """Rows (or row suffixes) missing from a remote state vector: the
    columnar filter of writeClientsStructs (encoding.js:94-116).

    row_slot, row_clock, row_end: [B, N] i32; sv: [B, n_slots] i32.
    Returns ``(needed [B, N] bool, offset [B, N] i32)``: offset > 0 means
    the row must be written from that element offset (the
    partial-first-struct rule, encoding.js:71-84)."""
    if not _on_cuda(row_slot, row_clock, row_end, sv):
        return diff_mask_kernel_plain(row_slot, row_clock, row_end, sv)
    from . import _cuda

    for t, name in ((row_slot, "row_slot"), (row_clock, "row_clock"),
                    (row_end, "row_end"), (sv, "sv")):
        _check(t, name, (torch.int32,), 2)
    if row_clock.shape != row_slot.shape or row_end.shape != row_slot.shape:
        raise ValueError("row columns disagree in shape")
    b, n = row_slot.shape
    if sv.shape[0] != b or sv.shape[1] < 1:
        raise ValueError(f"sv must be [{b}, n_slots >= 1], got {tuple(sv.shape)}")
    needed = torch.empty((b, n), dtype=torch.bool, device=row_slot.device)
    offset = torch.empty((b, n), dtype=torch.int32, device=row_slot.device)
    if b and n:
        _cuda.diff_mask(row_slot, row_clock, row_end, sv, needed, offset,
                        b, n, sv.shape[1])
        launches["diff_mask"] += 1
    return needed, offset


# ---------------------------------------------------------------------------
# K3-K6: on-device YATA (YTPU_KERNEL=levels|seq)
# ---------------------------------------------------------------------------

# the six resident static columns, in the row order of the packed block
# scatter_statics takes (rows 2..7; rows 0 and 1 are doc and row).
# client_key holds the client id's u32 bit pattern in an int32 tensor
# (torch has no uint32 index_put_ on the CPU); YATA compares it unsigned.
STATIC_KEYS = (
    "client_key", "origin_slot", "origin_clock", "right_slot",
    "right_clock", "origin_row",
)
INT32_MAX = 2**31 - 1
# ceiling of the per-doc visit-epoch counter of the conflict scan: before
# an item whose scan could carry the counter past it, the doc's visit row
# is refilled with -1 and the counter restarts at 0 (see
# _integrate_plain), so it never passes 2**31 - 1 however long the
# launch.  Tests lower it to exercise the restart.
EPOCH_MAX = INT32_MAX


def _gather_idx(i: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather index rule: a negative index counts from the end,
    then the index is clamped into ``[0, n)``."""
    i = torch.where(i < 0, i + n, i)
    return i.clamp(0, n - 1).long()


def _take(table: torch.Tensor, docs: torch.Tensor,
          i: torch.Tensor) -> torch.Tensor:
    """``table[docs[j], i[j]]`` for each j, with JAX's gather rule."""
    return table[docs, _gather_idx(i, table.shape[1])]


def _put(table: torch.Tensor, docs: torch.Tensor, i: torch.Tensor,
         v: torch.Tensor, cond: torch.Tensor) -> None:
    """``table[docs[j], i[j]] = v[j]`` where ``cond[j]``, in place, with
    JAX's scatter rule (negative wraps, what is still out of range is
    dropped); ``docs`` holds distinct docs.  A doc whose write is masked
    or dropped rewrites one of its own cells with its current value (one
    write per doc, so no two writes collide): the JAX ``_upd``'s rewrite
    of the scratch row."""
    n = table.shape[1]
    i = i.long()
    i = torch.where(i < 0, i + n, i)
    keep = cond & (i >= 0) & (i < n)
    i = torch.where(keep, i, 0)
    old = table[docs, i]
    table[docs, i] = torch.where(keep, v.to(table.dtype), old)


def _ids_eq(s1, k1, s2, k2):
    """compare_ids on (slot, clock) columns; NULL slot == null id."""
    return (s1 == s2) & ((s1 == NULL) | (k1 == k2))


def _unsigned_order(key: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of u32 client ids, biased so that signed
    comparison gives the unsigned order (YATA case 1 compares client ids
    unsigned; half of all random 32-bit ids are >= 2**31)."""
    return torch.bitwise_xor(key, INT32_MIN)


def _integrate_plain(statics, rl, starts, visit, counter, docs, k, left0,
                     right0, seg, stats=None) -> None:
    """K4, the single-item YATA integrate, for one item of each doc in
    ``docs`` at once (``k`` NULL: the doc does nothing): the conflict scan
    (cases 1-3, reference Item.js:447-470) from ``left0``'s successor up
    to ``right0``, then the splice (Item.js:473-489).  Writes ``rl``,
    ``starts``, ``visit`` and the per-doc ``counter`` in place.

    Visit marks carry the scan's set semantics without clearing: a row is
    in itemsBeforeOrigin iff ``visit[row] >= scan_base`` (the counter's
    value when the item starts) and in conflictingItems iff ``visit[row]
    >= clear``.  The counter runs on across the items of one launch, so
    marks of earlier items fall below ``scan_base`` like unmarked rows
    (-1) do: the same answer as the JAX kernel's fresh ``visit`` array per
    item (``yjs_tpu/ops/kernels.py:124``) without allocating one.  A scan
    takes at most N+1 steps (a list without a cycle has no more rows);
    the bound also ends a scan over a corrupt, cyclic list, which the
    JAX kernel would loop on forever."""
    n1 = rl.shape[1]
    dummy = n1 - 1
    s_dummy = starts.shape[1] - 1
    oslot, oclock = statics["origin_slot"], statics["origin_clock"]
    rslot, rclock = statics["right_slot"], statics["right_clock"]
    origin_row, key = statics["origin_row"], statics["client_key"]
    valid = k >= 0
    # epoch restart: one scan adds at most n1 to the counter
    cnt = counter[docs]
    roll = valid & (cnt.long() > EPOCH_MAX - n1)
    if bool(roll.any()):
        visit[docs[roll]] = NULL
        cnt = torch.where(roll, 0, cnt)

    safe_seg = torch.where(seg >= 0, seg, s_dummy)
    st = _take(starts, docs, safe_seg)
    safe_k = torch.where(valid, k, dummy)
    rl_l = _take(rl, docs, torch.where(left0 >= 0, left0, dummy))
    # fast path (the negation of reference Item.js:432-434)
    skip = torch.where(left0 == NULL, (right0 != NULL) & (st == right0),
                       rl_l == right0)
    o = torch.where(valid & ~skip, torch.where(left0 == NULL, st, rl_l), NULL)
    scan_base = cnt
    clear = cnt
    left = left0
    k_os, k_oc = _take(oslot, docs, safe_k), _take(oclock, docs, safe_k)
    k_rs, k_rc = _take(rslot, docs, safe_k), _take(rclock, docs, safe_k)
    k_key = _unsigned_order(_take(key, docs, safe_k))
    done = torch.zeros_like(valid)
    steps = torch.zeros_like(k)
    while True:
        run = ~done & (o != NULL) & (o != right0) & (steps < n1)
        if not bool(run.any()):
            break
        _put(visit, docs, o, cnt, run)
        cnt = torch.where(run, cnt + 1, cnt)
        o_os = _take(oslot, docs, o)
        # case 1: same origin -> the lower client id goes left
        same = _ids_eq(k_os, k_oc, o_os, _take(oclock, docs, o))
        c1_left = same & (_unsigned_order(_take(key, docs, o)) < k_key)
        c1_break = same & ~c1_left & _ids_eq(
            k_rs, k_rc, _take(rslot, docs, o), _take(rclock, docs, o)
        )
        # case 2: o's origin lies between this.origin and this
        has_origin = o_os != NULL
        safe_orow = torch.where(has_origin, _take(origin_row, docs, o), dummy)
        v_orow = _take(visit, docs, safe_orow)
        in_before = has_origin & (v_orow >= scan_base)
        c2_left = ~same & in_before & ~(v_orow >= clear)
        # case 3: an unrelated item ends the scan
        c3_break = ~same & ~in_before
        take_left = run & (c1_left | c2_left)
        left = torch.where(take_left, o, left)
        clear = torch.where(take_left, cnt, clear)
        stop = run & (c1_break | c3_break)
        done = done | stop
        o = torch.where(run & ~stop, _take(rl, docs, o), o)
        steps = steps + run.to(steps.dtype)
    if stats is not None:
        stats["scan_steps"][docs] += steps.long()
        stats["scanned"][docs] += (steps > 0).long()
        # dependent loads: the gap read, the splice read, three per step
        stats["chain"][docs] += 2 * valid.long() + 3 * steps.long()

    # splice into the list (reference Item.js:473-489)
    right2 = torch.where(
        left == NULL, st, _take(rl, docs, torch.where(left >= 0, left, dummy))
    )
    _put(rl, docs, left, k, valid & (left != NULL))
    _put(starts, docs, safe_seg, k, valid & (left == NULL))
    _put(rl, docs, k, right2, valid)
    counter[docs] = cnt


def _split_prepass_plain(rl, deleted, splits, stats=None):
    """The split pre-pass of K5/K6 (the device half of splitItem,
    reference Item.js:84-120): per doc, in order, the fragment ``new`` of
    a host-split run takes over ``orig``'s right link and deleted bit and
    ``orig`` links to it."""
    dummy = rl.shape[1] - 1
    docs = torch.arange(rl.shape[0], device=rl.device)
    for j in range(splits.shape[1]):
        orig, new = splits[:, j, 0], splits[:, j, 1]
        valid = orig >= 0
        safe_orig = torch.where(valid, orig, dummy)
        old_right = _take(rl, docs, safe_orig)
        old_del = _take(deleted, docs, safe_orig)
        _put(rl, docs, new, old_right, valid)
        _put(rl, docs, orig, new, valid)
        _put(deleted, docs, new, old_del, valid)
        if stats is not None:
            stats["chain"] += valid.long()


def _deletes_plain(deleted, delete_rows):
    """Mark ``delete_rows`` (NULL-padded) deleted (reference DeleteSet.js
    readAndApplyDeleteSet tail)."""
    n1 = deleted.shape[1]
    r = delete_rows.long()
    keep = (r >= 0) & (r < n1)
    docs = torch.arange(deleted.shape[0], device=deleted.device)[:, None]
    docs = docs.expand_as(r)
    deleted[docs[keep], r[keep]] = True


def _yata_inputs(statics, dyn, *schedules):
    """The tensors a YATA kernel reads and writes, for the device check."""
    return [statics[k] for k in STATIC_KEYS] + list(dyn) + list(schedules)


def _check_yata(statics, dyn, *schedules) -> None:
    right, deleted, starts = dyn
    _check(right, "right_link", (torch.int32,), 2)
    _check(deleted, "deleted", (torch.bool,), 2)
    _check(starts, "starts", (torch.int32,), 2)
    for key in STATIC_KEYS:
        _check(statics[key], key, (torch.int32,), 2)
        if statics[key].shape != right.shape:
            raise ValueError(f"static column {key} does not match right_link")
    if deleted.shape != right.shape or starts.shape[0] != right.shape[0]:
        raise ValueError("table shapes disagree")
    for t in schedules:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("schedules must be contiguous int32")
        if t.shape[0] != right.shape[0]:
            raise ValueError("schedules must lead with the doc axis")


def scatter_statics_plain(statics, packed):
    """Plain PyTorch version of :func:`scatter_statics` (in place)."""
    b, n1 = statics[STATIC_KEYS[0]].shape
    d, r = packed[0].long(), packed[1].long()
    d = torch.where(d < 0, d + b, d)
    r = torch.where(r < 0, r + n1, r)
    keep = (d >= 0) & (d < b) & (r >= 0) & (r < n1)
    d, r = d[keep], r[keep]
    for j, key in enumerate(STATIC_KEYS):
        statics[key].index_put_((d, r), packed[2 + j][keep])
    return statics


@profiled("scatter_statics")
def scatter_statics(statics, packed):
    """Write one packed ``[8, K]`` int32 block into the six resident
    static columns, in place: row 0 is the doc, row 1 the row, rows 2-7
    the values in :data:`STATIC_KEYS` order (``client_key`` as its u32
    bit pattern).  Targets outside the columns are dropped; the engine's
    padding lanes all write the fill values to doc 0's scratch row.
    Returns ``statics``."""
    cols = [statics[k] for k in STATIC_KEYS]
    if not _on_cuda(*cols, packed):
        return scatter_statics_plain(statics, packed)
    from . import _cuda

    for key, col in zip(STATIC_KEYS, cols):
        _check(col, key, (torch.int32,), 2)
        if col.shape != cols[0].shape:
            raise ValueError("static columns disagree in shape")
    _check(packed, "packed", (torch.int32,), 2)
    if packed.shape[0] != 2 + len(STATIC_KEYS):
        raise ValueError(f"packed must be [8, K], got {tuple(packed.shape)}")
    b, n1 = cols[0].shape
    k = packed.shape[1]
    if k and b:
        _cuda.scatter_statics(packed, cols, k, b, n1)
        launches["scatter_statics"] += 1
    return statics


def new_yata_stats(b: int, device="cpu") -> dict:
    """Per-doc work counters the plain YATA versions fill when given
    them (on the tables' device): ``scan_steps`` (rows visited by
    conflict scans), ``scanned`` (integrated items whose scan visited a
    row; the others keep the gap they were planned into), ``deferred``
    (level lanes whose gap check failed) and ``chain`` (dependent loads
    in sequence: one per split, one per level's gap check, two per
    integrated item plus three per scan step)."""
    return {k: torch.zeros(b, dtype=torch.int64, device=device)
            for k in ("scan_steps", "scanned", "deferred", "chain")}


def _new_visit(rl: torch.Tensor):
    """Per-launch visit scratch (-1: unmarked) and per-doc counters."""
    visit = torch.full_like(rl, NULL)
    counter = torch.zeros(rl.shape[0], dtype=torch.int32, device=rl.device)
    return visit, counter


def batch_step_plain(statics, dyn, splits, sched, delete_rows, stats=None):
    """Plain PyTorch version of :func:`batch_step` (in place).  ``stats``
    (from :func:`new_yata_stats`) accumulates the per-doc work."""
    right, deleted, starts = dyn
    _split_prepass_plain(right, deleted, splits, stats)
    visit, counter = _new_visit(right)
    for j in range(sched.shape[1]):
        s = sched[:, j]
        docs = torch.nonzero(s[:, 0] >= 0)[:, 0]  # padding entries do nothing
        if docs.numel():
            s = s[docs]
            _integrate_plain(statics, right, starts, visit, counter, docs,
                             s[:, 0], s[:, 1], s[:, 2], s[:, 3], stats)
    _deletes_plain(deleted, delete_rows)
    return right, deleted, starts


def _check_step_shapes(splits, sched, sched_dims, delete_rows) -> None:
    if splits.dim() != 3 or splits.shape[2] != 2:
        raise ValueError("splits must be [B, S, 2]")
    if sched.dim() != len(sched_dims) + 1 or sched.shape[-1] != sched_dims[-1]:
        raise ValueError(f"schedule must be [B, ..., {sched_dims[-1]}]")
    if delete_rows.dim() != 2:
        raise ValueError("delete_rows must be [B, D]")


@profiled("batch_step")
def batch_step(statics, dyn, splits, sched, delete_rows):
    """The per-item YATA step of every doc (``YTPU_KERNEL=seq``), in
    place: the split pre-pass, then each ``sched`` entry (row, left,
    right, seg) through the single-item integrate in causal order, then
    the deletes.

    statics: the six ``[B, N+1]`` int32 columns; dyn: ``(right_link [B,
    N+1] i32, deleted [B, N+1] bool, starts [B, S+1] i32)``; splits
    ``[B, S', 2]``, sched ``[B, M, 4]``, delete_rows ``[B, D]``, all
    int32 and NULL-padded.  Returns ``dyn``."""
    if not _on_cuda(*_yata_inputs(statics, dyn, splits, sched, delete_rows)):
        return batch_step_plain(statics, dyn, splits, sched, delete_rows)
    from . import _cuda

    _check_yata(statics, dyn, splits, sched, delete_rows)
    _check_step_shapes(splits, sched, (0, 4), delete_rows)
    right = dyn[0]
    if right.shape[0]:
        visit = torch.full_like(right, NULL)
        _cuda.batch_step([statics[k] for k in STATIC_KEYS], dyn, visit,
                         splits, sched, delete_rows, EPOCH_MAX)
        launches["batch_step"] += 1
    return dyn


def batch_step_levels_plain(statics, dyn, splits, lv_sched, delete_rows,
                            scratch_base, stats=None):
    """Plain PyTorch version of :func:`batch_step_levels` (in place)."""
    right, deleted, starts = dyn
    b, n1 = right.shape
    s1 = starts.shape[1]
    dev = right.device
    _split_prepass_plain(right, deleted, splits, stats)
    visit, counter = _new_visit(right)
    w = lv_sched.shape[2]
    rows = torch.arange(b, device=dev)[:, None].expand(b, 2 * w)
    lanes = scratch_base.long()[:, None] + torch.arange(2 * w, device=dev)
    lane_ids = torch.arange(w, device=dev)
    null = torch.tensor(NULL, dtype=torch.int32, device=dev)
    for lv in range(lv_sched.shape[1]):
        e = lv_sched[:, lv]
        k, l0, r0, chk = e[..., 0], e[..., 1], e[..., 2], e[..., 3]
        succ, seg, fb_l, fb_r = e[..., 4], e[..., 5], e[..., 6], e[..., 7]
        mask = k >= 0
        safe_chk = torch.where(chk >= 0, chk, n1 - 1)
        safe_seg = torch.where(seg >= 0, seg, s1 - 1)
        st = starts.gather(1, _gather_idx(safe_seg, s1))
        # (a) a lane's splice gap is intact iff its left's successor is
        # still exactly its right (head gap: the segment head is)
        fast = mask & torch.where(
            chk == NULL, st == r0, right.gather(1, _gather_idx(safe_chk, n1)) == r0
        )
        # (b) one scatter of 2W unique targets: a chain head's left link
        # and every member's own link; masked lanes write NULL to the
        # doc's scratch rows
        succ_v = torch.where(succ == GATHER_SUCC, r0, succ)
        cond1 = fast & (l0 >= 0)
        idx = torch.cat([torch.where(cond1, l0.long(), lanes[:, :w]),
                         torch.where(fast, k.long(), lanes[:, w:])], 1)
        val = torch.cat([torch.where(cond1, k, null),
                         torch.where(fast, succ_v, null)], 1)
        idx = torch.where(idx < 0, idx + n1, idx)
        keep = (idx >= 0) & (idx < n1)
        if bool(keep.all()):  # the engine's case: unique in-range targets
            right.scatter_(1, idx, val)
        else:
            right[rows[keep], idx[keep]] = val[keep]
        # head writes take seg raw (JAX: kernels.py:294)
        hs = seg.long()
        hs = torch.where(hs < 0, hs + s1, hs)
        hkeep = fast & (l0 == NULL) & (hs >= 0) & (hs < s1)
        starts[rows[:, :w][hkeep], hs[hkeep]] = k[hkeep]
        if stats is not None:
            stats["chain"] += mask.any(1).long()
        # (c) true conflicts through the single-item integrate, in
        # ascending lane order per doc
        pending = mask & ~fast
        if stats is not None:
            stats["deferred"] += pending.sum(1)
        docs = torch.nonzero(pending.any(1))[:, 0]
        while docs.numel():
            pend = pending[docs]
            j = torch.where(pend, lane_ids, w).amin(1)
            _integrate_plain(statics, right, starts, visit, counter, docs,
                             k[docs, j], fb_l[docs, j], fb_r[docs, j],
                             seg[docs, j], stats)
            pending[docs, j] = False
            docs = docs[pend.sum(1) > 1]
    _deletes_plain(deleted, delete_rows)
    return right, deleted, starts


@profiled("batch_step_levels")
def batch_step_levels(statics, dyn, splits, lv_sched, delete_rows,
                      scratch_base):
    """The level-parallel YATA step of every doc (``YTPU_KERNEL=levels``),
    in place: the split pre-pass; then per level of ``lv_sched`` (``[B,
    L, W, 8]`` rows of row, left, right, check, succ, seg, fb_left,
    fb_right) the gap check of every lane, one scatter of the 2W link
    writes of the fast lanes (masked lanes write NULL to rows
    ``scratch_base + lane`` and ``scratch_base + W + lane``), the head
    writes, and the deferred true conflicts through the single-item
    integrate in ascending lane order; then the deletes.

    ``scratch_base [B]`` is each doc's row count: the engine keeps 2W
    spare rows past it.  Returns ``dyn``."""
    args = (splits, lv_sched, delete_rows, scratch_base)
    if not _on_cuda(*_yata_inputs(statics, dyn, *args)):
        return batch_step_levels_plain(statics, dyn, *args)
    from . import _cuda

    _check_yata(statics, dyn, splits, lv_sched, delete_rows, scratch_base)
    _check_step_shapes(splits, lv_sched, (0, 0, 8), delete_rows)
    right = dyn[0]
    b = right.shape[0]
    if scratch_base.dim() != 1:
        raise ValueError("scratch_base must be [B]")
    if b:
        visit = torch.full_like(right, NULL)
        fast = torch.empty((b, max(1, lv_sched.shape[2])), dtype=torch.uint8,
                           device=right.device)
        _cuda.batch_step_levels([statics[k] for k in STATIC_KEYS], dyn,
                                visit, fast, splits, lv_sched, delete_rows,
                                scratch_base, EPOCH_MAX)
        launches["batch_step_levels"] += 1
    return dyn


# ---------------------------------------------------------------------------
# K7: the broadcast variants (one doc's work fanned out over the batch)
# ---------------------------------------------------------------------------


def apply_plan_shared_plain(dyn, lanes, k_l, k_h, k_d):
    """Plain PyTorch version of :func:`apply_plan_shared` (in place)."""
    right_link, deleted, starts = dyn
    lanes = lanes.to(torch.int32)
    b = right_link.shape[0]
    rows, vals = lanes[:k_l], lanes[k_l : 2 * k_l]
    o = 2 * k_l
    segs, hvals = lanes[o : o + k_h], lanes[o + k_h : o + 2 * k_h]
    dels = lanes[o + 2 * k_h :]
    docs = torch.arange(b, device=lanes.device)

    def fan(idx):  # every doc's copy of a section: (doc, idx) pairs
        k = idx.shape[0]
        return docs.repeat_interleave(k), idx.repeat(b)

    if k_l:
        d, r = fan(rows)
        _drop_set(right_link, d, r, vals.repeat(b))
    if k_h:
        d, r = fan(segs)
        _drop_set(starts, d, r, hvals.repeat(b))
    if k_d:
        d, r = fan(dels)
        _drop_set(deleted, d, r, True)
    return right_link, deleted, starts


@profiled("apply_plan_shared")
def apply_plan_shared(dyn, lanes, k_l, k_h, k_d):
    """Broadcast bulk apply, in place: ONE doc's resolved delta written
    into every doc of the batch (the B4 replay shape).

    lanes: one i32 vector — ``[rows|vals]*k_l`` link writes,
    ``[segs|hvals]*k_h`` head writes, ``[dels]*k_d`` delete marks.
    Negative targets count from the end; what is still out of bounds
    (padding) is dropped.  Returns ``dyn``."""
    right_link, deleted, starts = dyn
    if not _on_cuda(right_link, deleted, starts, lanes):
        return apply_plan_shared_plain(dyn, lanes, k_l, k_h, k_d)
    from . import _cuda

    _check(right_link, "right_link", (torch.int32,), 2)
    _check(deleted, "deleted", (torch.bool,), 2)
    _check(starts, "starts", (torch.int32,), 2)
    _check(lanes, "lanes", (torch.int32,), 1)
    b = right_link.shape[0]
    if deleted.shape != right_link.shape or starts.shape[0] != b:
        raise ValueError("table shapes disagree")
    if lanes.shape[0] != 2 * k_l + 2 * k_h + k_d:
        raise ValueError("lanes length does not match the section widths")
    if b and k_l + k_h + k_d:
        _cuda.apply_plan_shared(lanes, right_link, deleted, starts,
                                k_l, k_h, k_d)
        launches["apply_plan_shared"] += 1
    return right_link, deleted, starts


def batch_step_levels_shared_plain(statics, dyn, splits, lv_sched,
                                   delete_rows, scratch_base, stats=None):
    """Plain PyTorch version of :func:`batch_step_levels_shared`: the
    shared inputs broadcast over the doc axis (views, no copies) into
    :func:`batch_step_levels_plain` — the reference's ``vmap`` with
    ``in_axes=None``."""
    b = dyn[0].shape[0]
    cols = {k: statics[k].expand(b, -1) for k in STATIC_KEYS}
    return batch_step_levels_plain(
        cols, dyn, splits.expand(b, *splits.shape),
        lv_sched.expand(b, *lv_sched.shape), delete_rows.expand(b, -1),
        scratch_base, stats,
    )


@profiled("batch_step_levels_shared")
def batch_step_levels_shared(statics, dyn, splits, lv_sched, delete_rows,
                             scratch_base):
    """:func:`batch_step_levels` where every doc shares one static table,
    split list, level schedule and delete list (the broadcast-replay
    shape), in place.

    statics: the six ``[N+1]`` int32 columns (``client_key`` as its u32
    bit pattern); splits ``[S, 2]``, lv_sched ``[L, W, 8]``, delete_rows
    ``[D]``, all int32 and NULL-padded; dyn and scratch_base ``[B]`` keep
    the doc axis.  Returns ``dyn``."""
    args = (splits, lv_sched, delete_rows, scratch_base)
    cols = [statics[k] for k in STATIC_KEYS]
    if not _on_cuda(*cols, *dyn, *args):
        return batch_step_levels_shared_plain(statics, dyn, *args)
    from . import _cuda

    right, deleted, starts = dyn
    _check(right, "right_link", (torch.int32,), 2)
    _check(deleted, "deleted", (torch.bool,), 2)
    _check(starts, "starts", (torch.int32,), 2)
    b, n1 = right.shape
    if deleted.shape != right.shape or starts.shape[0] != b:
        raise ValueError("table shapes disagree")
    for key, col in zip(STATIC_KEYS, cols):
        _check(col, key, (torch.int32,), 1)
        if col.shape[0] != n1:
            raise ValueError(f"static column {key} must be [{n1}]")
    for t, name, ndim in ((splits, "splits", 2), (lv_sched, "lv_sched", 3),
                          (delete_rows, "delete_rows", 1),
                          (scratch_base, "scratch_base", 1)):
        _check(t, name, (torch.int32,), ndim)
    if splits.shape[1] != 2 or lv_sched.shape[2] != 8:
        raise ValueError("splits must be [S, 2] and lv_sched [L, W, 8]")
    if scratch_base.shape[0] != b:
        raise ValueError("scratch_base must be [B]")
    if b:
        visit = torch.full_like(right, NULL)
        fast = torch.empty((b, max(1, lv_sched.shape[1])), dtype=torch.uint8,
                           device=right.device)
        _cuda.batch_step_levels(cols, dyn, visit, fast, splits, lv_sched,
                                delete_rows, scratch_base, EPOCH_MAX,
                                shared=True)
        launches["batch_step_levels_shared"] += 1
    return dyn


# ---------------------------------------------------------------------------
# K11 / K12: the segment planner's kernels
# ---------------------------------------------------------------------------

def resolve_device(device=None, who: str = "the device planner") -> torch.device:
    """``None`` is the CUDA device, which raises without CUDA (pass
    ``device="cpu"`` for the plain PyTorch kernels); ``who`` names the
    caller in that error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise KernelError(
                f"{who} needs a CUDA device (torch.cuda.is_available() "
                "is False); pass device='cpu' to run the plain PyTorch "
                "kernels on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _bucket_pow2(n: int, minimum: int = 64) -> int:
    """Next power-of-two lane width >= n: the kernels see the reference's
    bucketed shapes (its jitted kernels quantize so that a flush does
    not retrace)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def _pad_pow2(arr: np.ndarray, n_pad: int, fill) -> np.ndarray:
    """``arr`` as int64, padded to the bucketed length with ``fill``
    (fresh allocation — never a view of caller memory)."""
    out = np.full(n_pad, fill, np.int64)
    out[: arr.shape[0]] = arr
    return out


def _run_padded(device, fn, n_out: int, *padded):
    """Copy the padded host columns to ``device``, call the kernel
    wrapper ``fn`` on them and copy its outputs' first ``n_out`` lanes
    back: a tuple of fresh host numpy arrays (or one array).  The
    planner's kernels take and give host memory on every call, as the
    reference's ``np.asarray`` does."""
    dev = resolve_device(device)
    out = fn(*(torch.from_numpy(a).to(dev) for a in padded))
    if isinstance(out, torch.Tensor):
        return out[:n_out].cpu().numpy()
    return tuple(t[:n_out].cpu().numpy() for t in out)


_SCAN_COLS = ("client", "clock", "length", "o_cl", "o_ck", "r_cl", "r_ck")


def conflict_scan_plain(client, clock, length, o_cl, o_ck, r_cl, r_ck,
                        doc_id=None):
    """Plain PyTorch version of :func:`conflict_scan`."""
    n = client.shape[0]
    left = torch.zeros(n, dtype=torch.bool, device=client.device)
    right = torch.zeros_like(left)
    if n > 1:
        p_cl, p_ck = client[:-1], clock[:-1]
        p_end = p_ck + length[:-1]

        def inside(a_cl, a_ck):
            return ((a_cl[1:] == p_cl) & (a_cl[1:] >= 0)
                    & (a_ck[1:] >= p_ck) & (a_ck[1:] < p_end))

        same = (doc_id[1:] == doc_id[:-1]) if doc_id is not None else True
        left[1:] = inside(o_cl, o_ck) & same
        right[1:] = inside(r_cl, r_ck) & same
    run_id = torch.cumsum((~(left | right)).to(torch.int64), 0)
    return left, right, run_id


@profiled("conflict_scan")
def conflict_scan(client, clock, length, o_cl, o_ck, r_cl, r_ck,
                  doc_id=None):
    """Chain masks over a clock-sorted flush batch: ``left[j]`` /
    ``right[j]`` mean ref j's origin / rightOrigin lies inside ref j-1's
    id range (element 0 is never chained); ``run_id`` is the inclusive
    cumsum of ``~(left | right)``.  With ``doc_id`` (the doc-major
    concatenation of a chunk's batches) a chain never crosses a doc
    boundary.

    All inputs are ``[n]`` int64 (padding lanes: client and doc -1).
    Returns ``(left bool, right bool, run_id int64)``."""
    cols = (client, clock, length, o_cl, o_ck, r_cl, r_ck)
    ins = cols if doc_id is None else (*cols, doc_id)
    if not _on_cuda(*ins):
        return conflict_scan_plain(*cols, doc_id)
    from . import _cuda

    n = client.shape[0]
    for t, name in zip(ins, _SCAN_COLS + ("doc_id",)):
        _check(t, name, (torch.int64,), 1)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} lanes, client {n}")
    dev = client.device
    left = torch.empty(n, dtype=torch.bool, device=dev)
    right = torch.empty(n, dtype=torch.bool, device=dev)
    run_id = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        tiles = torch.empty(-(-n // 1024), dtype=torch.int64, device=dev)
        _cuda.conflict_scan(doc_id, cols, left, right, run_id, tiles)
        launches["conflict_scan" if doc_id is None
                 else "conflict_scan_chunk"] += 1
    return left, right, run_id


def anchor_lookup_plain(flat_key, q_key):
    """Plain PyTorch version of :func:`anchor_lookup`."""
    return torch.searchsorted(flat_key, q_key, right=True) - 1


@profiled("anchor_lookup")
def anchor_lookup(flat_key, q_key):
    """``searchsorted(flat_key, q_key, side="right") - 1`` over a sorted
    int64 haystack: the last fragment starting at or before each query
    key, or -1.  Both are ``[n]`` int64; returns ``[len(q_key)]`` int64."""
    if not _on_cuda(flat_key, q_key):
        return anchor_lookup_plain(flat_key, q_key)
    from . import _cuda

    _check(flat_key, "flat_key", (torch.int64,), 1)
    _check(q_key, "q_key", (torch.int64,), 1)
    out = torch.empty_like(q_key)
    if q_key.shape[0]:
        _cuda.anchor_lookup(flat_key, q_key, out)
        launches["anchor_lookup"] += 1
    return out


def _compose_keys(flat_slot, flat_clock, q_slot, q_clock):
    """(slot, clock) pairs -> one sortable int64 key space; invalid
    queries (slot < 0) map below every real key."""
    base = int(max(flat_clock.max() if flat_clock.size else 0,
                   q_clock.max() if q_clock.size else 0)) + 2
    flat_key = flat_slot * base + flat_clock
    q_key = np.where(q_slot >= 0, q_slot * base + q_clock, -1)
    return flat_key, q_key


def plan_anchor_lookup(flat_slot, flat_clock, q_slot, q_clock,
                       backend: str = "np", device=None):
    """Candidate fragment-index position for each (q_slot, q_clock): the
    last fragment starting at or before the queried clock, or -1.  The
    caller must verify slot match + containment before trusting it.
    ``backend="jax"`` runs :func:`anchor_lookup` on ``device``."""
    flat_key, q_key = _compose_keys(flat_slot, flat_clock, q_slot, q_clock)
    return lookup_keys(flat_key, q_key, backend, device)


def lookup_keys(flat_key, q_key, backend: str = "np", device=None):
    """``searchsorted(flat_key, q_key, side="right") - 1`` over composed
    int64 keys; ``backend="jax"`` runs :func:`anchor_lookup` on
    ``device``, the haystack padded with ``int64.max`` (sorts last) and
    the queries with -1."""
    if backend != "jax":
        return np.searchsorted(flat_key, q_key, side="right") - 1
    fb = _bucket_pow2(max(1, flat_key.shape[0]))
    qb = _bucket_pow2(q_key.shape[0])
    return _run_padded(
        device, anchor_lookup, q_key.shape[0],
        _pad_pow2(flat_key, fb, np.iinfo(np.int64).max),
        _pad_pow2(q_key, qb, -1),
    )


def _scan_np(doc_id, client, clock, length, o_client, o_clock, r_client,
             r_clock):
    p_client, p_clock = client[:-1], clock[:-1]
    p_end = p_clock + length[:-1]
    same_doc = True if doc_id is None else doc_id[1:] == doc_id[:-1]
    left = np.zeros(len(client), bool)
    right = np.zeros(len(client), bool)
    left[1:] = (
        same_doc
        & (o_client[1:] == p_client)
        & (o_client[1:] >= 0)
        & (o_clock[1:] >= p_clock)
        & (o_clock[1:] < p_end)
    )
    right[1:] = (
        same_doc
        & (r_client[1:] == p_client)
        & (r_client[1:] >= 0)
        & (r_clock[1:] >= p_clock)
        & (r_clock[1:] < p_end)
    )
    run_id = np.cumsum(~(left | right))
    return left, right, run_id


# padding lanes: no client (never chained, never chaining), doc -1
_SCAN_FILLS = (-1, 0, 0, -1, 0, -1, 0)


def _scan_on(device, doc_id, cols):
    """:func:`conflict_scan` on ``device`` over the pow2-padded host
    columns; returns the real lanes' masks and run ids."""
    n = cols[0].shape[0]
    nb = _bucket_pow2(n)
    padded = [_pad_pow2(c, nb, f) for c, f in zip(cols, _SCAN_FILLS)]
    if doc_id is not None:
        padded.append(_pad_pow2(doc_id, nb, -1))
    return _run_padded(device, conflict_scan, n, *padded)


def plan_conflict_scan(client, clock, length, o_client, o_clock,
                       r_client, r_clock, backend: str = "np", device=None):
    """Chain masks over a clock-sorted flush batch: ``left[j]`` /
    ``right[j]`` mean ref j's origin / rightOrigin lies inside ref j-1's
    id range (so its anchor row IS ref j-1's row); ``run_id`` groups the
    maximal chained (conflict-free) runs.  ``backend="jax"`` runs
    :func:`conflict_scan` on ``device``."""
    cols = (client, clock, length, o_client, o_clock, r_client, r_clock)
    if backend == "jax":
        return _scan_on(device, None, cols)
    return _scan_np(None, *cols)


def plan_chunk_conflict_scan(doc_id, client, clock, length, o_client,
                             o_clock, r_client, r_clock,
                             backend: str = "np", device=None):
    """Doc-aware twin of :func:`plan_conflict_scan` for whole-chunk
    planning: one scan over the doc-major concatenation of every cold
    doc's flush batch, ``doc_id`` breaking chains at doc boundaries."""
    cols = (client, clock, length, o_client, o_clock, r_client, r_clock)
    if backend == "jax":
        return _scan_on(device, doc_id, cols)
    return _scan_np(doc_id, *cols)
