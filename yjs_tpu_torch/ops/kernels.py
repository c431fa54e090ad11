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

The doc mesh (:mod:`yjs_tpu_torch.parallel`) runs these kernels per
shard.  Five wrappers here serve it, each with one launch (more in
rounds) for all the shards of a device:

- :func:`sharded_apply_lanes` (K14) and :func:`sharded_batch_step_levels`
  (K15) run the bulk apply and the level step on every shard's tables,
  counting each shard's progress into its ``[2]`` int32 counter;
  :func:`apply_lanes` and :func:`batch_step_levels` are their one-shard
  calls;
- :func:`shard_fold` folds equal per-shard int32 partials by SUM or
  MAX (the reference's ``psum`` of those counters, and ``pmax`` over a
  ``rows`` axis);
- :func:`sharded_anchor_lookup` runs the anchor lookup on each shard's
  query block (the chunk planner's sharded lookup);
- :func:`sharded_state_vector` (K16) reduces each shard's rows into one
  output a device, the row shards of a doc block meeting there by
  ``atomicMax``; :func:`state_vector_kernel` is its one-shard call.

A kernel that cannot be built, loaded or launched, or a CUDA device
asked for on a host without one, raises :class:`KernelError`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..obs.prof import profiled
from . import _cuda
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
    "sharded_apply_plan": 0, "sharded_batch_step": 0,
    "sharded_state_vectors": 0, "sharded_lookup": 0, "shard_fold": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_cuda(*tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when all are
    on the CPU; raises on a mix or on another device type."""
    dev = tensors[0].device
    if all(t.device == dev for t in tensors):
        if dev.type == "cuda":
            return True
        if dev.type == "cpu":
            return False
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


def _add_progress(counter, integrated, deleted) -> None:
    """``counter += [integrated, deleted]`` in int32 (wrapping, as the
    reference's int32 sums do)."""
    counter.add_(torch.stack([integrated, deleted]).to(torch.int32))


def apply_lanes_plain(dyn, lanes, k_dn, k_sp, k_h, k_d, counter=None):
    """Plain PyTorch version of :func:`apply_lanes` (in place)."""
    right_link, deleted, starts = dyn
    lanes = lanes.to(torch.int32)
    b = right_link.shape[0]
    if not b:  # no docs: every lane is dropped
        return right_link, deleted, starts
    if counter is not None:
        _add_progress(counter, lanes[: 2 * b].sum(),
                      lanes[3 * b : 4 * b].sum())
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


def apply_lanes(dyn, lanes, k_dn, k_sp, k_h, k_d, counter=None):
    """Scatter one lanes buffer into the resident tables, in place.

    lanes layout (one i32 or i16 vector):
      [cnt_dense|cnt_sparse|cnt_heads|cnt_dels]  4 x [B] per-doc counts
      [dense_v]*k_dn    doc d's section i sets right_link[d, i] = v
      [r|v]*k_sp        sparse link writes at explicit rows
      [s|v]*k_h         segment-head writes
      [r]*k_d           delete marks
    Out-of-bounds targets (padding) are dropped.  ``counter``: a ``[2]``
    int32 tensor that gains the dense plus sparse counts' sum and the
    delete counts' sum.  On CUDA it is the one-shard launch of
    :func:`sharded_apply_lanes`' kernel.  Returns ``dyn``."""
    right_link, deleted, starts = dyn
    ins = (right_link, deleted, starts, lanes)
    if not _on_cuda(*ins, *(() if counter is None else (counter,))):
        return apply_lanes_plain(dyn, lanes, k_dn, k_sp, k_h, k_d, counter)
    dev = lanes.device
    desc, dims, scratch = _apply_desc(dev, (0,), [dyn], [lanes], [counter],
                                      (k_dn, k_sp, k_h, k_d))
    if desc:
        launches["apply_lanes"] += _cuda.apply_lanes(
            desc, dev, scratch.data_ptr(), *dims, k_dn, k_sp, k_h, k_d)
        last_variant["apply_lanes"] = APPLY_VARIANTS[dims[3]]
    return right_link, deleted, starts


def _check_on(s, dev, named, dtypes) -> None:
    """Shard ``s``'s ``(name, tensor)`` pairs (None skipped) lie on
    ``dev``, contiguous, of one of ``dtypes``; raises ``ValueError`` (or
    ``TypeError`` for a dtype) naming the shard and the tensor."""
    for name, t in named:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"shard {s}: {name} on {t.device}, the launch "
                             f"on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"shard {s}: {name}: dtype {t.dtype} not in "
                            f"{dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"shard {s}: {name} must be contiguous")


_I32 = (torch.int32,)


def _apply_shard(s, dev, dyn, row, counter, lane_w):
    """Check shard ``s`` of a K1/K14 call once: int32 tables and a bool
    ``deleted`` of one ``[B, N+1]`` shape, int16 or int32 lanes of ``4 *
    B + lane_w``, a ``[2]`` int32 counter or None, all contiguous on
    ``dev``.  Returns ``(b, (wide, n1, s1))``."""
    right, deleted, starts = dyn
    _check_on(s, dev, (("right_link", right), ("starts", starts),
                       ("counter", counter)), _I32)
    _check_on(s, dev, (("deleted", deleted),), (torch.bool,))
    _check_on(s, dev, (("lanes", row),), (torch.int16, torch.int32))
    shape, ss = right.shape, starts.shape
    if len(shape) != 2 or deleted.shape != shape:
        raise ValueError(f"shard {s}: right_link and deleted must be one "
                         "[B, N+1]")
    b = shape[0]
    if len(ss) != 2 or ss[0] != b:
        raise ValueError(f"shard {s}: starts must be [B, S+1]")
    if row.shape != (4 * b + lane_w,):
        raise ValueError(f"shard {s}: lanes length does not match the "
                         "section widths")
    if counter is not None and counter.shape != (2,):
        raise ValueError(f"shard {s}: counter must be [2]")
    return b, (row.dtype == torch.int32, shape[1], ss[1])


# K1/K14's variants: "staged" lane blocks scan their own section's counts
# into shared memory (4 bytes a doc, besides APPLY_STATIC_SMEM of their
# own), "global" ones search the cum rows the scan blocks write to the
# scratch (csrc/apply_lanes.cu)
APPLY_VARIANTS = ("global", "staged")
APPLY_STATIC_SMEM = 1024


def apply_stage_max(limit: int) -> int:
    """The most docs a shard of the "staged" variant holds on a card whose
    blocks may opt into ``limit`` bytes of shared memory."""
    return max(0, (limit - APPLY_STATIC_SMEM) // 4)


def apply_variant(b: int, limit: int) -> str:
    """K1/K14's variant for a launch whose largest shard holds ``b`` docs
    on a card whose blocks may opt into ``limit`` bytes of shared memory:
    "staged" while the counts fit (:func:`apply_stage_max`), else
    "global"."""
    return APPLY_VARIANTS[b <= apply_stage_max(limit)]


# K1/K14's scratch, one a device and stream: {(device, stream): int32
# tensor}, the kernel's zeroed counters (_cuda.APPLY_SYNC_INTS) in front
# of the cum rows.  Keyed by stream because the counters order the blocks
# of one launch: launches on one stream run one after another and each
# leaves them zero, while two streams sharing one scratch would race.
_apply_scratch_by_stream: dict = {}


def _stream_key(dev) -> int:
    """``dev``'s current stream handle; 0 on the CPU."""
    return _cuda.current_stream(dev) if dev.type == "cuda" else 0


def _apply_scratch(dev, cum_ints: int) -> torch.Tensor:
    """The scratch of ``dev``'s current stream with room for ``cum_ints``
    cum entries, grown (to a power of two, zeroed) when it has less."""
    key = (dev, _stream_key(dev))
    need = _cuda.APPLY_SYNC_INTS + cum_ints
    buf = _apply_scratch_by_stream.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(1 << (need - 1).bit_length(), dtype=torch.int32,
                          device=dev)
        _apply_scratch_by_stream[key] = buf
    return buf


def _apply_desc(dev, shards, dyn, lanes, counters, widths, limit=None):
    """The K1/K14 launch descriptor for ``shards`` (indices into the
    per-shard lists ``dyn``, ``lanes`` and ``counters``; None for no
    counter), every tensor on ``dev``: each shard's tables, lanes row and
    counter checked once, and :data:`_cuda.APPLY_ROW` ints a shard with
    docs, in shard order — the ``data_ptr`` of its lanes, its cum rows
    (``4 * b`` int32 of the scratch, after the counters; 0 in the
    "staged" variant, which needs none), right, deleted, starts and
    counter (0 for none), then its doc count ``b``.  A shard whose N+1,
    S+1 or lanes dtype differs from the first's, or whose tensors lie on
    another device, raises ``ValueError``.  Returns ``(desc, (wide, n1,
    s1, staged), scratch)``: ``staged`` 1 for :func:`apply_variant`'s
    "staged" at the largest shard and ``limit`` (None: the card's opt-in
    limit), and the scratch of ``dev``'s current stream
    (:func:`_apply_scratch`)."""
    k_dn, k_sp, k_h, k_d = widths
    lane_w = k_dn + 2 * k_sp + 2 * k_h + k_d
    first = None
    live = []
    total = 0
    for s in shards:
        b, dims = _apply_shard(s, dev, dyn[s], lanes[s], counters[s], lane_w)
        if first is None:
            first = dims
        elif dims != first:
            raise ValueError(
                f"shard {s}: (int32 lanes, N+1, S+1) {dims} differ from "
                f"shard {shards[0]}'s {first}")
        if b:
            live.append((s, b))
            total += 4 * b
    if limit is None:
        limit = _cuda.smem_optin(dev)
    largest = max((b for _s, b in live), default=0)
    staged = apply_variant(largest, limit) == "staged"
    scratch = _apply_scratch(dev, 0 if staged else total)
    ptr = scratch.data_ptr() + 4 * _cuda.APPLY_SYNC_INTS
    desc = []
    for s, b in live:
        right, deleted, starts = dyn[s]
        counter = counters[s]
        desc += (lanes[s].data_ptr(), 0 if staged else ptr, right.data_ptr(),
                 deleted.data_ptr(), starts.data_ptr(),
                 0 if counter is None else counter.data_ptr(), b)
        ptr += 16 * b
    return desc, (*first, int(staged)), scratch


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


# K2's arguments in order: name, dtype, dims
_SCATTER_ARGS = (
    ("right", torch.int32, 2), ("deleted", torch.bool, 2),
    ("starts", torch.int32, 2), ("idx", torch.int32, 1),
    ("new_right", torch.int32, 2), ("new_deleted", torch.bool, 2),
    ("new_starts", torch.int32, 2),
)


@profiled("scatter_rows")
def scatter_rows(right, deleted, starts, idx, new_right, new_deleted,
                 new_starts):
    """Replace docs ``idx``'s link/deleted/head rows with freshly packed
    host columns, in place (compaction rebuilds, deferred warm-promotion
    hydrations).  Returns ``(right, deleted, starts)``."""
    args = (right, deleted, starts, idx, new_right, new_deleted, new_starts)
    dev = right.device
    cuda = dev.type == "cuda"
    for t, (name, dtype, ndim) in zip(args, _SCATTER_ARGS):
        if t.device != dev:
            raise ValueError(
                f"kernel inputs must all be on the CPU or on one CUDA "
                f"device, got {name} on {t.device} and right on {dev}")
        if cuda and (t.dtype != dtype or t.dim() != ndim
                     or not t.is_contiguous()):
            raise (TypeError if t.dtype != dtype else ValueError)(
                f"{name}: a contiguous {ndim}-D {dtype} tensor, got "
                f"{t.dim()}-D {t.dtype}")
    if not cuda:
        if dev.type != "cpu":
            raise _unsupported(dev)
        return scatter_rows_plain(*args)
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


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped into int32, as XLA's int32 arithmetic
    wraps."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def list_ranks_plain(right_link, valid, counter=None):
    """Plain PyTorch version of :func:`list_ranks`, with JAX's gather
    rule: a negative link other than NULL counts from the end, a link
    still outside ``[0, N+1)`` reads ``INT32_MIN`` for d and p, and d
    adds with int32 wrap-around.  The rounds stop once no p is live (the
    rest change nothing); ``counter`` (``[1]`` int32) takes the most
    rounds run, as the kernel's does."""
    n1 = right_link.shape[1]
    live = right_link != NULL
    d = live.to(torch.int32)
    p = right_link
    ran = 0
    for _ in range(_n_rounds(n1)):
        if not bool(live.any()):
            break
        idx = torch.where(p < 0, p + n1, p)
        inb = live & (idx >= 0) & (idx < n1)
        safe = torch.where(inb, idx, torch.zeros_like(idx)).long()
        fill = torch.full_like(p, INT32_MIN)
        gd = torch.where(inb, torch.gather(d, 1, safe), fill)
        gp = torch.where(inb, torch.gather(p, 1, safe), fill)
        d = torch.where(live, _wrap_i32(d.long() + gd.long()), d)
        p = torch.where(live, gp, torch.full_like(p, NULL))
        live = p != NULL
        ran += 1
    if counter is not None:
        counter.clamp_(min=ran)
    return torch.where(valid, d, torch.full_like(d, NULL))


# where a K8 block keeps its doc's four planes of d and p (csrc/list_ranks.cu):
# "staged" in shared memory, LIST_RANKS_ROW_BYTES a row; "global" in a
# [b, 4, N+1] int32 scratch, for docs whose planes do not fit a block
LIST_RANKS_ROW_BYTES = 16


def list_ranks_variant(n1: int, limit: int) -> str:
    """K8's variant for docs of ``n1`` (N+1) rows on a card whose blocks
    may opt into ``limit`` bytes of shared memory: "staged" when a doc's
    planes fit, else "global"."""
    return "staged" if LIST_RANKS_ROW_BYTES * n1 <= limit else "global"


@profiled("list_ranks")
def list_ranks(right_link, valid, counter=None):
    """Document order from right links by pointer doubling: d[i] =
    distance to the list tail; sorting valid rows by descending d gives
    the order.

    right_link: [B, N+1] i32 (NULL or a row of the same doc); valid:
    [B, N+1] bool host-known membership.  Returns d with -1 on invalid
    rows.  ``counter`` (optional ``[1]`` int32 on the same device) takes
    the most rounds any doc ran.  On CUDA the variant comes from
    :func:`list_ranks_variant` (``last_variant["list_ranks"]``)."""
    extra = () if counter is None else (counter,)
    if not _on_cuda(right_link, valid, *extra):
        return list_ranks_plain(right_link, valid, counter)
    _check(right_link, "right_link", (torch.int32,), 2)
    _check(valid, "valid", (torch.bool,), 2)
    if valid.shape != right_link.shape:
        raise ValueError("valid must match right_link's shape")
    if counter is not None:
        _check(counter, "counter", (torch.int32,), 1)
        if counter.shape != (1,):
            raise ValueError("counter must be [1]")
    b, n1 = right_link.shape
    out = torch.empty_like(right_link)
    if b and n1:
        variant = list_ranks_variant(n1, _cuda.smem_optin(right_link.device))
        scratch = None if variant == "staged" else torch.empty(
            (b, 4, n1), dtype=torch.int32, device=right_link.device)
        _cuda.list_ranks(right_link, valid, scratch, out, counter, b, n1,
                         _n_rounds(n1))
        launches["list_ranks"] += 1
        last_variant["list_ranks"] = variant
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
    ``[B, n_slots]`` i32.  On CUDA it is the one-shard launch of
    :func:`sharded_state_vector`'s kernel."""
    if not _on_cuda(row_slot, row_end):
        return state_vector_kernel_plain(row_slot, row_end, n_slots)
    _check(row_slot, "row_slot", (torch.int32,), 2)
    _check(row_end, "row_end", (torch.int32,), 2)
    if row_end.shape != row_slot.shape:
        raise ValueError("row_end must match row_slot's shape")
    b, n = row_slot.shape
    sv = torch.zeros((b, n_slots), dtype=torch.int32, device=row_slot.device)
    if b and n and n_slots:
        launches["state_vector"] += _cuda.state_vector(
            [row_slot.data_ptr(), row_end.data_ptr(), n, b, n, sv.data_ptr(),
             n_slots], row_slot.device, n_slots)
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
    offset = torch.clamp(_wrap_i32(remote.long() - row_clock.long()), min=0)
    return needed, torch.where(needed, offset, torch.zeros_like(offset))


_DIFF_NAMES = ("row_slot", "row_clock", "row_end", "sv")


@profiled("diff_mask_kernel")
def diff_mask_kernel(row_slot, row_clock, row_end, sv):
    """Rows (or row suffixes) missing from a remote state vector: the
    columnar filter of writeClientsStructs (encoding.js:94-116).

    row_slot, row_clock, row_end: [B, N] i32; sv: [B, n_slots] i32.
    Returns ``(needed [B, N] bool, offset [B, N] i32)``: offset > 0 means
    the row must be written from that element offset (the
    partial-first-struct rule, encoding.js:71-84).  On CUDA the two are
    views of one buffer (:func:`_cuda.diff_layout`) that one launch
    fills."""
    ins = (row_slot, row_clock, row_end, sv)
    dev = row_slot.device
    if dev.type != "cuda":
        _on_cuda(*ins)  # raises on a mix or another device type
        return diff_mask_kernel_plain(*ins)
    # one check pass; _diff_error names the fault
    shape = row_slot.shape
    if len(shape) != 2 or sv.dim() != 2 or sv.shape[0] != shape[0] \
            or sv.shape[1] < 1:
        raise _diff_error(ins)
    di = row_slot.get_device()
    for t in ins:
        if (t.dtype is not torch.int32 or t.get_device() != di
                or not t.is_contiguous()):
            raise _diff_error(ins)
    if row_clock.shape != shape or row_end.shape != shape:
        raise _diff_error(ins)
    b, n = shape
    total = b * n
    needed_at, nbytes = _cuda.diff_layout(total)
    out = torch.empty(nbytes >> 2, dtype=torch.int32, device=dev)
    offset = out.as_strided((b, n), (n, 1))
    needed = out.view(torch.bool).as_strided((b, n), (n, 1), needed_at)
    if total:
        _cuda.diff_mask(dev, row_slot.data_ptr(), row_clock.data_ptr(),
                        row_end.data_ptr(), sv.data_ptr(), needed.data_ptr(),
                        out.data_ptr(), b, n, sv.shape[1])
        launches["diff_mask"] += 1
    return needed, offset


def _diff_error(ins) -> Exception:
    """The error for the first of K10's inputs ``ins`` that is not a
    contiguous 2-D int32 tensor on row_slot's device, or whose shape
    disagrees: ``TypeError`` for a dtype, else ``ValueError``."""
    dev = ins[0].device
    for t, name in zip(ins, _DIFF_NAMES):
        if t.device != dev:
            return ValueError(
                f"kernel inputs must all be on the CPU or on one CUDA "
                f"device, got {name} on {t.device} and row_slot on {dev}")
        if t.dtype is not torch.int32:
            return TypeError(f"{name}: dtype {t.dtype} not in "
                             f"{(torch.int32,)}")
        if t.dim() != 2 or not t.is_contiguous():
            return ValueError(f"{name}: a contiguous 2-D tensor, got "
                              f"{t.dim()}-D")
    b = ins[0].shape[0]
    if ins[1].shape != ins[0].shape or ins[2].shape != ins[0].shape:
        return ValueError("row columns disagree in shape")
    return ValueError(f"sv must be [{b}, n_slots >= 1], got "
                      f"{tuple(ins[3].shape)}")


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

# where a YATA step block keeps its doc's rows (csrc/yata.cu): "shared"
# stages the link row, the segment heads, the visit row and the level
# step's fast flags in shared memory; "rows" all but the visit row, which
# stays in a global scratch; "global" nothing (global visit and fast
# scratch).  A launch takes the first that leaves room for
# YATA_MIN_DOCS_SM docs an SM.
YATA_VARIANTS = ("shared", "rows", "global")
# shared memory a YATA block declares besides the staged rows (K5's 1 KB
# ring of schedule entries and their rows, K15's 8-byte counter reduce),
# with room to spare, kept out of the budget the staged rows may use
YATA_STATIC_SMEM = 2048
# shared memory the card reserves for each block (Hopper: 1 KB); an SM
# holds a block's opt-in limit plus this (H100: 227 + 1 KB)
YATA_RESERVED_SMEM = 1024
# the docs an SM must hold at once for a staged variant to be taken: a
# doc's chain runs on one thread and docs side by side hide each other's
# latency, while L1 caches an unstaged doc's rows.  Measured on an H100
# (PERF.md, section 6): staged docs at 19-25 an SM ran 6-14% faster than
# unstaged, at 11-15 no faster, at 6-13 up to 8x slower
YATA_MIN_DOCS_SM = 16
# the variant each YATA wrapper's and K8's last CUDA launch took
# (chip_smoke.py and the card's tests read it)
last_variant = dict.fromkeys(("apply_lanes", "sharded_apply_plan",
                              "batch_step", "batch_step_levels",
                              "batch_step_levels_shared",
                              "sharded_batch_step", "list_ranks"))


def yata_layout(n1: int, s1: int, w: int,
                variant: str = "shared") -> tuple[int, int, int, int]:
    """Where a YATA block of ``variant`` stages one doc of ``n1`` (N+1)
    rows and ``s1`` (S+1) segment heads in its dynamic shared memory:
    ``(st_at, visit_at, fast_at, nbytes)``.  The link row starts at int32
    0 and the heads at ``st_at``, each in whole 16-byte words with room to
    start at its global row's address mod 16 (so that it copies 16 bytes
    at a time); the visit row (``"shared"``) at ``visit_at``; ``w``
    fast-flag bytes (the level step's ``max(1, W)``; 0 for K5) at int32
    ``fast_at``; ``nbytes`` in all.  All 0 for ``"global"``."""
    if variant == "global":
        return 0, 0, 0, 0

    def words(n):  # int32 in whole 16-byte words
        return -(-n // 4) * 4

    st_at = words(n1 + 3)
    visit_at = st_at + words(s1 + 3)
    fast_at = visit_at + (words(n1) if variant == "shared" else 0)
    return st_at, visit_at, fast_at, 4 * fast_at + w


def yata_smem_bytes(n1: int, s1: int, w: int, variant: str = "shared") -> int:
    """Dynamic shared-memory bytes a YATA block of ``variant`` stages for
    one doc (:func:`yata_layout`)."""
    return yata_layout(n1, s1, w, variant)[3]


def yata_docs_per_sm(nbytes: int, limit: int) -> int:
    """The staged docs of ``nbytes`` each that an SM's shared memory holds
    at once on a card whose blocks may opt into ``limit`` bytes."""
    if nbytes + YATA_STATIC_SMEM > limit:
        return 0
    return ((limit + YATA_RESERVED_SMEM)
            // (nbytes + YATA_STATIC_SMEM + YATA_RESERVED_SMEM))


def yata_variant(n1: int, s1: int, w: int, limit: int) -> tuple[str, int]:
    """The YATA step's variant for docs of these widths on a card whose
    blocks may opt into ``limit`` bytes of shared memory: the first of
    :data:`YATA_VARIANTS` whose staged doc (:func:`yata_smem_bytes`) still
    lets an SM hold :data:`YATA_MIN_DOCS_SM` docs, and its bytes."""
    for variant in YATA_VARIANTS[:2]:
        nbytes = yata_smem_bytes(n1, s1, w, variant)
        if yata_docs_per_sm(nbytes, limit) >= YATA_MIN_DOCS_SM:
            return variant, nbytes
    return "global", 0


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
    """Per-launch visit scratch (-1: unmarked) and per-doc counters (the
    plain versions')."""
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
    _check_yata(statics, dyn, splits, sched, delete_rows)
    _check_step_shapes(splits, sched, (0, 4), delete_rows)
    right, _deleted, starts = dyn
    if right.shape[0]:
        n1, s1 = right.shape[1], starts.shape[1]
        variant, _ = yata_variant(n1, s1, 0, _cuda.smem_optin(right.device))
        # the visit marks of a doc not staged whole live in global memory
        visit = None if variant == "shared" else torch.full_like(right, NULL)
        _cuda.batch_step([statics[k] for k in STATIC_KEYS], dyn, visit,
                         splits, sched, delete_rows, EPOCH_MAX,
                         YATA_VARIANTS.index(variant),
                         yata_layout(n1, s1, 0, variant))
        launches["batch_step"] += 1
        last_variant["batch_step"] = variant
    return dyn


def batch_step_levels_plain(statics, dyn, splits, lv_sched, delete_rows,
                            scratch_base, stats=None, counter=None):
    """Plain PyTorch version of :func:`batch_step_levels` (in place)."""
    right, deleted, starts = dyn
    b, n1 = right.shape
    if counter is not None:
        _add_progress(counter, (lv_sched[..., 0] >= 0).sum(),
                      (delete_rows >= 0).sum())
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
                      scratch_base, counter=None):
    """The level-parallel YATA step of every doc (``YTPU_KERNEL=levels``),
    in place: the split pre-pass; then per level of ``lv_sched`` (``[B,
    L, W, 8]`` rows of row, left, right, check, succ, seg, fb_left,
    fb_right) the gap check of every lane, one scatter of the 2W link
    writes of the fast lanes (masked lanes write NULL to rows
    ``scratch_base + lane`` and ``scratch_base + W + lane``), the head
    writes, and the deferred true conflicts through the single-item
    integrate in ascending lane order; then the deletes.

    ``scratch_base [B]`` is each doc's row count: the engine keeps 2W
    spare rows past it.  ``counter``: a ``[2]`` int32 tensor that gains
    the count of schedule lanes with a row (``lv_sched[..., 0] >= 0``)
    and of delete rows (``>= 0``).  On CUDA it is the one-shard launch of
    :func:`sharded_batch_step_levels`' kernel.  Returns ``dyn``."""
    args = (splits, lv_sched, delete_rows, scratch_base)
    extra = () if counter is None else (counter,)
    if not _on_cuda(*_yata_inputs(statics, dyn, *args), *extra):
        return batch_step_levels_plain(statics, dyn, *args, counter=counter)
    dev = dyn[0].device
    desc, dims, _scratch = _levels_desc(
        dev, (0,), [statics], [dyn], *([a] for a in args), [counter],
        limit=_cuda.smem_optin(dev))
    if desc:
        launches["batch_step_levels"] += _cuda.batch_step_levels(
            desc, dev, dims, EPOCH_MAX)
        last_variant["batch_step_levels"] = YATA_VARIANTS[dims[7]]
    return dyn


_LEVEL_DIMS = ("N+1", "S+1", "splits", "levels", "W", "deletes")


def _levels_row(cols, dyn, visit: int, fast: int, sched, counter: int,
                b: int) -> list:
    """One shard's :data:`_cuda.LEVELS_ROW` ints of the K6 descriptor:
    the ``data_ptr`` of the six static columns, right, deleted, starts,
    the visit and fast scratch rows (pointers given, 0 where the variant
    keeps them in shared memory), splits, lv, dels, scratch_base and the
    counter (0 for none), then the doc count."""
    return [*(c.data_ptr() for c in cols), *(t.data_ptr() for t in dyn),
            visit, fast, *(t.data_ptr() for t in sched), counter, b]


_SCHED_NAMES = ("splits", "lv_sched", "delete_rows", "scratch_base")


def _level_scratch(variant: str, b: int, n1: int, fast_w: int, dev):
    """The global scratch a level step of ``variant`` needs for ``b``
    docs: ``(visit, fast)``, a ``[b, N+1]`` int32 visit scratch filled
    with -1 unless ``"shared"`` and a ``[b, fast_w]`` uint8 fast-flag
    scratch for ``"global"``, None where the block stages them."""
    visit = fast = None
    if variant != "shared":
        visit = torch.full((b, n1), NULL, dtype=torch.int32, device=dev)
    if variant == "global":
        fast = torch.empty((b, fast_w), dtype=torch.uint8, device=dev)
    return visit, fast


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _levels_dims(first, fast_w: int, variant: str) -> tuple:
    """``_cuda.batch_step_levels``' dims: ``first`` (``n1, s1, n_splits,
    n_lv, w, n_del``), ``fast_w``, the variant's index in
    :data:`YATA_VARIANTS` and its :func:`yata_layout`."""
    n1, s1 = first[0], first[1]
    return (*first, fast_w, YATA_VARIANTS.index(variant),
            *yata_layout(n1, s1, fast_w, variant))


def _levels_shard(s, dev, cols, dyn, sched, counter):
    """Check shard ``s`` of a K6/K15 call once: the six statics, right
    and starts int32 and ``deleted`` bool, the statics and ``deleted`` of
    right's ``[B, N+1]``, starts ``[B, S+1]``, splits ``[B, S', 2]``,
    lv_sched ``[B, L, W, 8]``, delete_rows ``[B, D]`` and scratch_base
    ``[B]`` int32, a ``[2]`` int32 counter or None, all contiguous on
    ``dev``.  Returns ``(b, (n1, s1, n_splits, n_lv, w, n_del))``."""
    right, deleted, starts = dyn
    sp, lvs, dl, sb = sched
    _check_on(s, dev, (*zip(STATIC_KEYS, cols), ("right_link", right),
                       ("starts", starts), *zip(_SCHED_NAMES, sched),
                       ("counter", counter)), _I32)
    _check_on(s, dev, (("deleted", deleted),), (torch.bool,))
    shape = right.shape
    if len(shape) != 2 or deleted.shape != shape:
        raise ValueError(f"shard {s}: right_link and deleted must be one "
                         "[B, N+1]")
    for key, c in zip(STATIC_KEYS, cols):
        if c.shape != shape:
            raise ValueError(f"shard {s}: static column {key} does not "
                             "match right_link")
    b = shape[0]
    ss, ps, ls, ds = starts.shape, sp.shape, lvs.shape, dl.shape
    for ok, want in ((len(ss) == 2 and ss[0] == b, "starts [B, S+1]"),
                     (len(ps) == 3 and ps[0] == b and ps[2] == 2,
                      "splits [B, S, 2]"),
                     (len(ls) == 4 and ls[0] == b and ls[3] == 8,
                      "lv_sched [B, L, W, 8]"),
                     (len(ds) == 2 and ds[0] == b, "delete_rows [B, D]"),
                     (sb.shape == (b,), "scratch_base [B]"),
                     (counter is None or counter.shape == (2,),
                      "counter [2]")):
        if not ok:
            raise ValueError(f"shard {s}: expected {want}")
    return b, (shape[1], ss[1], ps[1], ls[1], ls[2], ds[1])


def _levels_desc(dev, shards, statics, dyn, splits, lv, dels, scratch,
                 counters, *, limit: int):
    """The K6/K15 launch descriptor for ``shards`` (indices into the
    per-shard lists: statics dicts, ``(right, deleted, starts)`` tables,
    schedules and counters, None for no counter), every tensor on
    ``dev``, whose blocks may opt into ``limit`` bytes of shared memory:
    each shard's tensors checked once, the variant
    (:func:`yata_variant`), the global scratch it needs for the device —
    a visit scratch ``[sum b, N+1]`` int32 filled with -1 unless
    ``"shared"``, a fast-flag scratch ``[sum b, max(1, W)]`` uint8 for
    ``"global"`` — and :func:`_levels_row` a shard with docs, in shard
    order, pointing at its rows of both (0 where there is none).  A shard
    whose N+1, S+1, split, level, lane or delete width differs from the
    first's, or whose tensors lie on another device, raises
    ``ValueError``.  Returns ``(desc, dims, (visit, fast))``: ``dims`` is
    ``_cuda.batch_step_levels``' (:func:`_levels_dims`); keep the scratch
    until the launch is enqueued."""
    first = None
    live = []
    total = 0
    for s in shards:
        cols = [statics[s][k] for k in STATIC_KEYS]
        sched = (splits[s], lv[s], dels[s], scratch[s])
        counter = counters[s]
        b, dims = _levels_shard(s, dev, cols, dyn[s], sched, counter)
        if first is None:
            first = dims
        elif dims != first:
            bad = [f"{n} {a} (shard {shards[0]}: {v})" for n, a, v in
                   zip(_LEVEL_DIMS, dims, first) if a != v]
            raise ValueError(f"shard {s}: " + ", ".join(bad))
        if b:
            live.append((s, b, cols, sched, counter))
            total += b
    if first is None:
        return [], None, None
    n1, s1, fast_w = first[0], first[1], max(1, first[4])
    variant, _ = yata_variant(n1, s1, fast_w, limit)
    visit, fast = _level_scratch(variant, total, n1, fast_w, dev)
    vp, fp = _ptr(visit), _ptr(fast)
    desc = []
    for s, b, cols, sched, counter in live:
        desc += _levels_row(cols, dyn[s], vp, fp, sched,
                            0 if counter is None else counter.data_ptr(), b)
        vp += 4 * n1 * b if vp else 0
        fp += fast_w * b if fp else 0
    return desc, _levels_dims(first, fast_w, variant), (visit, fast)


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


# Waves of blocks K7a's grid aims at (shared_docs_a_block), and the fewest
# docs a block takes: at the B4 replay 32 waves ran fastest on an H100,
# fewer leave blocks of unequal tiles idle at the end; a block compacts
# its tile (a few µs) before it writes its docs, which 8 docs amortise
# (PERF.md)
SHARED_WAVES = 32
SHARED_MIN_DOCS = 8


def shared_docs_a_block(b: int, n1: int, k_l: int, k_h: int, k_d: int,
                        sms: int, waves: int | None = None) -> int:
    """The docs a block of K7a takes: as many as make its grid of
    ``(doc groups, tiles)`` (:func:`_cuda.shared_tiles`) about ``waves``
    (default :data:`SHARED_WAVES`) times the blocks the card's ``sms``
    SMs hold at once, and at least :data:`SHARED_MIN_DOCS`.  Raises
    ``ValueError`` past the launch's tile limit."""
    tiles = _cuda.shared_tiles(k_l, k_h, k_d, n1)
    if tiles > _cuda.SHARED_MAX_TILES:
        raise ValueError(f"apply_plan_shared: {tiles} lane tiles, the most a "
                         f"launch takes is {_cuda.SHARED_MAX_TILES}")
    slots = max(1, (SHARED_WAVES if waves is None else waves) * sms
                * _cuda.SHARED_BLOCKS_SM)
    return max(SHARED_MIN_DOCS, -(-b * tiles // slots))


@profiled("apply_plan_shared")
def apply_plan_shared(dyn, lanes, k_l, k_h, k_d):
    """Broadcast bulk apply, in place: ONE doc's resolved delta written
    into every doc of the batch (the B4 replay shape).

    lanes: one i32 vector — ``[rows|vals]*k_l`` link writes,
    ``[segs|hvals]*k_h`` head writes, ``[dels]*k_d`` delete marks.
    Negative targets count from the end; what is still out of bounds
    (padding) is dropped.  Returns ``dyn``."""
    right_link, deleted, starts = dyn
    dev = right_link.device
    if dev.type != "cuda":
        _on_cuda(right_link, deleted, starts, lanes)  # raises on a mix
        return apply_plan_shared_plain(dyn, lanes, k_l, k_h, k_d)
    # one check pass; _shared_error names the fault
    shape = right_link.shape
    if (len(shape) != 2 or deleted.shape != shape or starts.dim() != 2
            or starts.shape[0] != shape[0] or lanes.dim() != 1
            or min(k_l, k_h, k_d) < 0
            or lanes.shape[0] != 2 * k_l + 2 * k_h + k_d
            or right_link.dtype is not torch.int32
            or starts.dtype is not torch.int32
            or deleted.dtype is not torch.bool
            or lanes.dtype is not torch.int32
            or not (right_link.is_contiguous() and deleted.is_contiguous()
                    and starts.is_contiguous() and lanes.is_contiguous())
            or deleted.device != dev or starts.device != dev
            or lanes.device != dev):
        raise _shared_error(dyn, lanes, k_l, k_h, k_d)
    b, n1 = shape
    if b and k_l + k_h + k_d:
        docs = shared_docs_a_block(b, n1, k_l, k_h, k_d, _cuda.sm_count(dev))
        _cuda.apply_plan_shared(dev, lanes.data_ptr(), right_link.data_ptr(),
                                deleted.data_ptr(), starts.data_ptr(), b, n1,
                                starts.shape[1], k_l, k_h, k_d, docs)
        launches["apply_plan_shared"] += 1
    return right_link, deleted, starts


def _shared_error(dyn, lanes, k_l, k_h, k_d) -> Exception:
    """The error for K7a's first fault: a tensor on another device than
    right_link, of another dtype (``TypeError``), not contiguous, or of a
    shape the others or the section widths disagree with."""
    named = (("right_link", dyn[0]), ("deleted", dyn[1]), ("starts", dyn[2]),
             ("lanes", lanes))
    dev = dyn[0].device
    for name, t in named:
        if t.device != dev:
            return ValueError(
                f"kernel inputs must all be on the CPU or on one CUDA "
                f"device, got {name} on {t.device} and right_link on {dev}")
    for name, t in named:
        want = torch.bool if name == "deleted" else torch.int32
        if t.dtype is not want:
            return TypeError(f"{name}: dtype {t.dtype} not in {(want,)}")
        if t.dim() != (1 if name == "lanes" else 2) or not t.is_contiguous():
            return ValueError(f"{name}: a contiguous "
                              f"{1 if name == 'lanes' else 2}-D tensor, got "
                              f"{t.dim()}-D")
    if dyn[1].shape != dyn[0].shape or dyn[2].shape[0] != dyn[0].shape[0]:
        return ValueError("table shapes disagree")
    return ValueError("lanes length does not match the section widths")


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
        dev = right.device
        s1, fast_w = starts.shape[1], max(1, lv_sched.shape[1])
        variant, _ = yata_variant(n1, s1, fast_w, _cuda.smem_optin(dev))
        visit, fast = _level_scratch(variant, b, n1, fast_w, dev)
        row = _levels_row(cols, dyn, _ptr(visit), _ptr(fast), args, 0, b)
        dims = _levels_dims((n1, s1, splits.shape[0], lv_sched.shape[0],
                             lv_sched.shape[1], delete_rows.shape[0]),
                            fast_w, variant)
        launches["batch_step_levels_shared"] += _cuda.batch_step_levels(
            row, dev, dims, EPOCH_MAX, shared=True)
        last_variant["batch_step_levels_shared"] = variant
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


_SCAN_NAMES = ("client", "clock", "length", "o_cl", "o_ck", "r_cl", "r_ck",
               "doc_id")


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


# K12's scratch, one a device and stream: {(device, stream): int64
# tensor}, the ticket, done-count and status words of csrc/conflict_scan.cu,
# zero between launches (each launch's last block clears them).  Keyed by
# stream as K1's is.  A scratch that grows is kept, not freed: a CUDA graph
# captured on it still launches on it.
_scan_scratch_by_stream: dict = {}
_scan_scratch_retired: list = []


def _scan_scratch(dev, tiles: int) -> torch.Tensor:
    """The K12 scratch of ``dev``'s current stream with room for
    ``tiles`` status words, grown (to a power of two, zeroed) when it has
    less."""
    key = (dev, _stream_key(dev))
    need = _cuda.SCAN_HEAD + tiles
    buf = _scan_scratch_by_stream.get(key)
    if buf is None or buf.numel() < need:
        if buf is not None:
            _scan_scratch_retired.append(buf)
        buf = torch.zeros(1 << (need - 1).bit_length(), dtype=torch.int64,
                          device=dev)
        _scan_scratch_by_stream[key] = buf
    return buf


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
    Returns ``(left bool, right bool, run_id int64)``; on CUDA the three
    are views of one buffer (:func:`_cuda.scan_layout`) that one launch
    fills."""
    cols = (client, clock, length, o_cl, o_ck, r_cl, r_ck)
    ins = cols if doc_id is None else (*cols, doc_id)
    dev = client.device
    if dev.type != "cuda":
        for t in ins:
            if t.device != dev:
                raise _scan_error(ins)
        if dev.type != "cpu":
            raise _unsupported(dev)
        return conflict_scan_plain(*cols, doc_id)
    # one check pass; _scan_error names the fault
    shape = client.shape
    if len(shape) != 1:
        raise _scan_error(ins)
    for t in ins:
        if (t.dtype is not torch.int64 or t.shape != shape
                or not t.is_contiguous() or t.device != dev):
            raise _scan_error(ins)
    n = shape[0]
    left_at, right_at, nbytes = _cuda.scan_layout(n)
    out = torch.empty(nbytes >> 3, dtype=torch.int64, device=dev)
    flags = out.view(torch.bool)
    if n:
        tiles = _cuda.scan_tiles(n)
        _cuda.conflict_scan(doc_id, cols, out,
                            _scan_scratch(dev, tiles) if tiles > 1 else None,
                            n)
        launches["conflict_scan" if doc_id is None
                 else "conflict_scan_chunk"] += 1
    return flags[left_at : left_at + n], flags[right_at : right_at + n], out[:n]


def _scan_error(ins) -> Exception:
    """The error for the first of K12's columns ``ins`` that is on another
    device than client, or (on CUDA) not a contiguous 1-D int64 tensor as
    long as client: ``TypeError`` for a dtype, else ``ValueError``."""
    dev = ins[0].device
    n = ins[0].shape[0] if ins[0].dim() == 1 else None
    for t, name in zip(ins, _SCAN_NAMES):
        if t.device != dev:
            return ValueError(
                f"kernel inputs must all be on the CPU or on one CUDA "
                f"device, got {name} on {t.device} and client on {dev}")
        if dev.type != "cuda":
            continue
        if t.dtype != torch.int64:
            return TypeError(f"{name}: dtype {t.dtype} not in "
                             f"{(torch.int64,)}")
        if t.dim() != 1 or not t.is_contiguous():
            return ValueError(f"{name}: a contiguous 1-D tensor, got "
                              f"{t.dim()}-D")
        if t.shape[0] != n:
            return ValueError(f"{name} has {t.shape[0]} lanes, client {n}")
    return ValueError("K12's columns must be contiguous 1-D int64 tensors "
                      "of one length on one device")


def anchor_lookup_plain(flat_key, q_key):
    """Plain PyTorch version of :func:`anchor_lookup`."""
    return torch.searchsorted(flat_key, q_key, right=True) - 1


@profiled("anchor_lookup")
def anchor_lookup(flat_key, q_key):
    """``searchsorted(flat_key, q_key, side="right") - 1`` over a sorted
    int64 haystack: the last fragment starting at or before each query
    key, or -1.  Both are ``[n]`` int64; returns ``[len(q_key)]`` int64.
    On CUDA it is the one-shard launch of :func:`sharded_anchor_lookup`'s
    kernel."""
    if not _on_cuda(flat_key, q_key):
        return anchor_lookup_plain(flat_key, q_key)
    _check(flat_key, "flat_key", (torch.int64,), 1)
    _check(q_key, "q_key", (torch.int64,), 1)
    out = torch.empty_like(q_key)
    n = q_key.shape[0]
    if n:
        launches["anchor_lookup"] += _cuda.anchor_lookup(
            [flat_key.data_ptr(), flat_key.shape[0], q_key.data_ptr(),
             out.data_ptr(), n], q_key.device)
    return out


def sharded_anchor_lookup_plain(hays, q_blocks):
    """Plain PyTorch version of :func:`sharded_anchor_lookup`."""
    return [anchor_lookup_plain(h, q) for h, q in zip(hays, q_blocks)]


def _device_groups(devices) -> dict:
    """The shards of each distinct device, in the order the devices first
    appear: ``{device: [shard index, ...]}``."""
    groups: dict = {}
    for s, dev in enumerate(devices):
        groups.setdefault(dev, []).append(s)
    return groups


def _shard_devices(dyn):
    """The ``{device: [shard, ...]}`` groups of a mesh's tables."""
    return _device_groups([t[0].device for t in dyn])


def _unsupported(dev) -> ValueError:
    return ValueError(f"unsupported device {dev}")


def sharded_apply_lanes(dyn, lanes, widths, counters):
    """K14, the bulk apply of the doc mesh, in place: shard ``s`` scatters
    its lanes row ``lanes[s]`` into its tables ``dyn[s]``, as
    :func:`apply_lanes` does, counting into ``counters[s]`` (a ``[2]``
    int32 row, or None).  ``widths`` (``k_dn, k_sp, k_h, k_d``) are every
    shard's.  The shards of one CUDA device share one scratch (that of
    its current stream) and one launch (a round per
    :data:`_cuda.MESH_MAX_SHARDS` shards with docs, counted in
    ``launches["sharded_apply_plan"]``); shards on the CPU take the plain
    version.  Returns ``dyn``."""
    for dev, shards in _shard_devices(dyn).items():
        if dev.type == "cuda":
            desc, dims, scratch = _apply_desc(dev, shards, dyn, lanes,
                                              counters, widths)
            if desc:
                launches["sharded_apply_plan"] += _cuda.apply_lanes(
                    desc, dev, scratch.data_ptr(), *dims, *widths)
                last_variant["sharded_apply_plan"] = APPLY_VARIANTS[dims[3]]
        elif dev.type == "cpu":
            for s in shards:
                apply_lanes_plain(dyn[s], lanes[s], *widths,
                                  counter=counters[s])
        else:
            raise _unsupported(dev)
    return dyn


def sharded_batch_step_levels(statics, dyn, splits, lv, dels, scratch,
                              counters):
    """K15, the level-parallel YATA step of the doc mesh, in place: shard
    ``s`` runs :func:`batch_step_levels` on its statics dict, tables and
    schedule blocks (``splits[s]``, ``lv[s]``, ``dels[s]``,
    ``scratch[s]``), counting into ``counters[s]`` (a ``[2]`` int32 row, or
    None).  The shards of one CUDA device share one launch (a round per
    :data:`_cuda.MESH_MAX_SHARDS` shards with docs, counted in
    ``launches["sharded_batch_step"]``) and whatever global scratch its
    variant needs; shards on the CPU take the plain version.  Returns
    ``dyn``."""
    for dev, shards in _shard_devices(dyn).items():
        if dev.type == "cuda":
            desc, dims, _scratch = _levels_desc(
                dev, shards, statics, dyn, splits, lv, dels, scratch,
                counters, limit=_cuda.smem_optin(dev))
            if desc:
                launches["sharded_batch_step"] += _cuda.batch_step_levels(
                    desc, dev, dims, EPOCH_MAX)
                last_variant["sharded_batch_step"] = YATA_VARIANTS[dims[7]]
        elif dev.type == "cpu":
            for s in shards:
                batch_step_levels_plain(statics[s], dyn[s], splits[s], lv[s],
                                        dels[s], scratch[s],
                                        counter=counters[s])
        else:
            raise _unsupported(dev)
    return dyn


def _same_device(s: int, hay, dev) -> None:
    if hay.device != dev:
        raise ValueError(f"shard {s}: haystack on {hay.device}, queries on "
                         f"{dev}")


def _lookup_on_device(dev, shards, hays, q_blocks, out) -> None:
    """K13 for the ``shards`` that lie on the CUDA device ``dev``: one
    output buffer, whose consecutive views become ``out[s]``, and one
    launch (a round per :data:`_cuda.LOOKUP_MAX_SHARDS` shards)."""
    sizes = [q_blocks[s].shape[0] for s in shards]
    buf = torch.empty(sum(sizes), dtype=torch.int64, device=dev)
    views = buf.split(sizes) if len(shards) > 1 else (buf,)
    ptr = buf.data_ptr()
    desc = []
    checked = None  # the shards of a device mostly share one haystack
    for s, view, n in zip(shards, views, sizes):
        hay, q = hays[s], q_blocks[s]
        if hay is not checked:
            _same_device(s, hay, dev)
            _check(hay, "flat_key", (torch.int64,), 1)
            checked = hay
        _check(q, "q_key", (torch.int64,), 1)
        out[s] = view
        if n:
            desc += (hay.data_ptr(), hay.shape[0], q.data_ptr(), ptr, n)
        ptr += 8 * n
    if desc:
        launches["sharded_lookup"] += _cuda.anchor_lookup(desc, dev)


@profiled("sharded_lookup")
def sharded_anchor_lookup(hays, q_blocks):
    """K13, the chunk anchor lookup sharded over the doc mesh: each
    shard's query block searched, as :func:`anchor_lookup` does, in the
    copy of the haystack that lies on its device (``hays[s]``, one copy
    per distinct device, shared by the shards there).  The shards of one
    CUDA device share one output buffer and one launch.  Returns the
    per-shard ``[len(q_blocks[s])]`` int64 candidates (views of that
    buffer)."""
    if len(hays) != len(q_blocks):
        raise ValueError("one haystack per query block")
    out = [None] * len(q_blocks)
    for dev, shards in _device_groups([q.device for q in q_blocks]).items():
        if dev.type == "cuda":
            _lookup_on_device(dev, shards, hays, q_blocks, out)
        elif dev.type == "cpu":
            for s in shards:
                _same_device(s, hays[s], dev)
                out[s] = anchor_lookup_plain(hays[s], q_blocks[s])
        else:
            raise _unsupported(dev)
    return out


def state_vector_groups(devices, docs) -> dict:
    """The shards of a K16 call by device.  ``devices[d][r]``: the device
    of doc block ``d``'s row shard ``r``; ``docs[d]``: the block's docs.
    Returns ``{device: (held, shards)}``, the devices in the order they
    first appear: ``held`` maps each doc block with a row shard there, in
    order of ``d``, to its first row in the device's output (the held
    blocks' docs stacked in that order); ``shards`` lists the ``(d, r)``
    there."""
    flat = [(d, r) for d, row in enumerate(devices) for r in range(len(row))]
    groups = {}
    for dev, ks in _device_groups([devices[d][r] for d, r in flat]).items():
        shards = [flat[k] for k in ks]
        held, row0 = {}, 0
        for d in sorted({d for d, _r in shards}):
            held[d], row0 = row0, row0 + docs[d]
        groups[dev] = (held, shards)
    return groups


def _sv_shard(d: int, r: int, slot, end, dev, docs: int) -> None:
    """Check shard ``(d, r)``'s slot and end blocks (``slot`` lies on
    ``dev``, its group's device): int32 ``[docs, cols]`` of one shape on
    ``dev``, with unit column strides and one row stride, which the
    kernel reads them by."""
    st = slot.stride()
    if (slot.dtype is torch.int32 and end.dtype is torch.int32
            and end.device == dev and len(st) == 2
            and slot.shape == end.shape and slot.shape[0] == docs
            and st == end.stride() and st[1] == 1):
        return
    for name, t in (("row_slot", slot), ("row_end", end)):
        if t.device != dev:
            raise ValueError(f"shard ({d}, {r}): {name} on {t.device}, its "
                             f"doc block's output on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"shard ({d}, {r}): {name}: dtype {t.dtype} not "
                            "int32")
    raise ValueError(
        f"shard ({d}, {r}): row_slot {tuple(slot.shape)} and row_end "
        f"{tuple(end.shape)} must be one [{docs}, cols], with unit column "
        "strides and one row stride")


def sharded_state_vector(slots, ends, n_slots: int):
    """K16, the state vectors of a doc batch split into doc blocks and
    their row shards: ``slots[d][r]`` and ``ends[d][r]`` are doc block
    ``d``'s column block ``r``, int32 ``[docs_d, cols_r]`` on the shard's
    device, read in place: their rows may lie apart (views of wider rows)
    but not their columns.  Returns ``[sum docs_d, n_slots]``
    int32 on the device of ``slots[0][0]``: each doc's per-slot maximum
    end over all its row shards, floored at 0.

    The shards of one device write, in any order, into one zero-filled
    output for the doc blocks it holds (:func:`state_vector_groups`):
    on CUDA by ``atomicMax`` in one launch (a round per
    :data:`_cuda.SV_MAX_SHARDS` shards with rows, counted in
    ``launches["sharded_state_vectors"]``), on the CPU by the plain
    version.  Starting from 0 that is JAX's ``max(sv, 0)`` and its
    ``pmax`` over the row shards.  Only where a doc block's row shards lie
    on distinct devices do their partials fold by :func:`shard_fold`, and
    only with more than one device do the blocks gather onto the first."""
    if len(slots) != len(ends) or not slots:
        raise ValueError("one end block per slot block, at least one")
    docs = []
    for d, (srow, erow) in enumerate(zip(slots, ends)):
        if len(srow) != len(erow) or not srow:
            raise ValueError(f"doc block {d}: one end block per slot block")
        if srow[0].dim() != 2:
            raise ValueError(f"shard ({d}, 0): row_slot must be [docs, cols]")
        docs.append(srow[0].shape[0])
    groups = state_vector_groups([[t.device for t in row] for row in slots],
                                 docs)
    parts = [[] for _ in slots]
    for dev, (held, shards) in groups.items():
        out = torch.zeros((sum(docs[d] for d in held), n_slots),
                          dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            desc = []
            base, row_bytes = out.data_ptr(), 4 * n_slots
            for d, r in shards:
                s, e = slots[d][r], ends[d][r]
                _sv_shard(d, r, s, e, dev, docs[d])
                cols = s.shape[1]
                if docs[d] and cols and n_slots:
                    desc += (s.data_ptr(), e.data_ptr(), s.stride(0),
                             docs[d], cols, base + row_bytes * held[d],
                             n_slots)
            if desc:
                launches["sharded_state_vectors"] += _cuda.state_vector(
                    desc, dev, n_slots)
        elif dev.type == "cpu":
            for d, r in shards:
                s, e = slots[d][r], ends[d][r]
                _sv_shard(d, r, s, e, dev, docs[d])
                rows = out[held[d] : held[d] + docs[d]]
                torch.maximum(rows, state_vector_kernel_plain(s, e, n_slots),
                              out=rows)
        else:
            raise _unsupported(dev)
        if len(groups) == 1:
            return out
        for d, row0 in held.items():
            parts[d].append(out[row0 : row0 + docs[d]])
    first = slots[0][0].device
    blocks = [p[0] if len(p) == 1 else shard_fold(p, "max") for p in parts]
    return torch.cat([b.to(first) for b in blocks])


# ---------------------------------------------------------------------------
# The doc mesh's cross-shard fold (psum / pmax)
# ---------------------------------------------------------------------------

FOLD_OPS = ("sum", "max")


def shard_fold_plain(parts, op: str = "sum"):
    """Plain PyTorch version of :func:`shard_fold`."""
    stacked = torch.stack([p.to(parts[0].device) for p in parts])
    if op == "max":
        return stacked.amax(0)
    return stacked.sum(0).to(torch.int32)  # int64 sum, wrapped to int32


def _mixed_partials(parts) -> ValueError:
    return ValueError(
        "partials must all be on the CPU or on CUDA devices, got "
        f"{sorted(str(p.device) for p in parts)}"
    )


@profiled("shard_fold")
def shard_fold(parts, op: str = "sum"):
    """The cross-shard reduction of the doc mesh, the port's ``psum``
    (``op="sum"``, wrapping in int32) and ``pmax`` (``"max"``): ``P``
    equal int32 partials folded elementwise into a fresh tensor on the
    device of ``parts[0]``, the owner.  A partial on another CUDA device
    is copied to the owner first, device to device; the partials on the
    owner's device are read where they lie.  On CUDA: one allocation,
    one device and shape check a partial and one call of the kernel's
    entry, which launches once per 64 partials."""
    if op not in FOLD_OPS:
        raise ValueError(f"op must be one of {FOLD_OPS}, got {op!r}")
    if not parts:
        raise ValueError("nothing to fold")
    owner = parts[0].device
    if owner.type == "cpu" and all(p.device.type == "cpu" for p in parts):
        return shard_fold_plain(parts, op)
    if owner.type != "cuda":
        raise _mixed_partials(parts)
    shape = parts[0].shape
    ptrs = []
    copies = []  # partials copied from other cards, alive until launched
    for p in parts:
        if p.device != owner:
            if p.device.type != "cuda":
                raise _mixed_partials(parts)
            p = p.to(owner)
            copies.append(p)
        if p.dtype != torch.int32 or p.shape != shape or not p.is_contiguous():
            _check(p, "partial", (torch.int32,), len(shape))
            raise ValueError("partials disagree in shape")
        ptrs.append(p.data_ptr())
    out = torch.empty(shape, dtype=torch.int32, device=owner)
    n = out.numel()
    if n:
        launches["shard_fold"] += _cuda.shard_fold(
            ptrs, n, FOLD_OPS.index(op), out)
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
