"""Device kernels of the apply-lane flush, as torch wrappers.

Three device programs carry the default flush of :class:`BatchEngine`:

- :func:`apply_lanes` (through :func:`apply_plan2`) scatters one packed
  lanes buffer of host-resolved final links, segment heads and delete
  marks into the resident tables — every flush;
- :func:`scatter_rows` replaces whole doc rows of the three tables —
  compaction rebuilds and warm-tier hydration;
- :func:`list_ranks` ranks each row's distance to its list tail by
  pointer doubling — exports that read the device tables back
  (``YTPU_EXPORT_DEVICE=1``).

Two more serve the batched sync paths of the engine and the provider:

- :func:`state_vector_kernel` reduces each doc's rows to its dense state
  vector — ``BatchEngine.state_vectors_batched``;
- :func:`diff_mask_kernel` marks the rows (and row suffixes) a remote
  state vector is missing — the device branch of
  ``BatchEngine.sync_step2_batch`` (reconnect storms, checkpoints).

Each wrapper keeps the JAX package's signature and semantics
(``yjs_tpu/ops/kernels.py``) and has a plain PyTorch version beside it
(``*_plain``).  The wrapper dispatches on the device of the tensors it
is given: CPU tensors take the plain version, CUDA tensors launch the
hand-written CUDA kernel from ``yjs_tpu_torch/csrc`` (built and bound by
:mod:`._cuda`) or raise — there is no fallback from one to the other.
The kernels write the resident tables in place (the JAX versions donate
them), so a wrapper returns the same tensor objects it was given.

``launches`` counts, per wrapper, the CUDA kernel launches it made; the
plain version never counts.

The NumPy branches of the segment planner's kernels (K11/K12:
``plan_anchor_lookup``, ``plan_conflict_scan``) live here too; their
device versions are a later slice of the port and raise
``NotImplementedError``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..obs.prof import profiled

NULL = -1

# CUDA kernel launches per wrapper (chip_smoke.py zeroes and reads them)
launches = {
    "apply_lanes": 0, "scatter_rows": 0, "list_ranks": 0,
    "state_vector": 0, "diff_mask": 0,
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
# segment-sorted planning (NumPy; device versions come in a later slice)
# ---------------------------------------------------------------------------


def _device_planner_missing(name: str):
    return NotImplementedError(
        f"{name}: the device segment-planner kernels (K11-K13) are not "
        "ported yet (ROADMAP queue 1, item 9); use YTPU_PLAN_SEGMENT=np"
    )


def _compose_keys(flat_slot, flat_clock, q_slot, q_clock):
    """(slot, clock) pairs -> one sortable int64 key space; invalid
    queries (slot < 0) map below every real key."""
    base = int(max(flat_clock.max() if flat_clock.size else 0,
                   q_clock.max() if q_clock.size else 0)) + 2
    flat_key = flat_slot * base + flat_clock
    q_key = np.where(q_slot >= 0, q_slot * base + q_clock, -1)
    return flat_key, q_key


def plan_anchor_lookup(flat_slot, flat_clock, q_slot, q_clock,
                       backend: str = "np"):
    """Candidate fragment-index position for each (q_slot, q_clock): the
    last fragment starting at or before the queried clock, or -1.  The
    caller must verify slot match + containment before trusting it."""
    if backend != "np":
        raise _device_planner_missing("plan_anchor_lookup")
    flat_key, q_key = _compose_keys(flat_slot, flat_clock, q_slot, q_clock)
    return np.searchsorted(flat_key, q_key, side="right") - 1


def plan_conflict_scan(client, clock, length, o_client, o_clock,
                       r_client, r_clock, backend: str = "np"):
    """Chain masks over a clock-sorted flush batch: ``left[j]`` /
    ``right[j]`` mean ref j's origin / rightOrigin lies inside ref j-1's
    id range (so its anchor row IS ref j-1's row); ``run_id`` groups the
    maximal chained (conflict-free) runs."""
    if backend != "np":
        raise _device_planner_missing("plan_conflict_scan")
    p_client, p_clock = client[:-1], clock[:-1]
    p_end = p_clock + length[:-1]
    left = np.zeros(len(client), bool)
    right = np.zeros(len(client), bool)
    left[1:] = (
        (o_client[1:] == p_client)
        & (o_client[1:] >= 0)
        & (o_clock[1:] >= p_clock)
        & (o_clock[1:] < p_end)
    )
    right[1:] = (
        (r_client[1:] == p_client)
        & (r_client[1:] >= 0)
        & (r_clock[1:] >= p_clock)
        & (r_clock[1:] < p_end)
    )
    run_id = np.cumsum(~(left | right))
    return left, right, run_id

