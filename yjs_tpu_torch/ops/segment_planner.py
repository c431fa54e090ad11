"""Cold planning of the Python mirror: conflict scan + anchor lookup.

The segment-sorted planner resolves anchors as verified *hints*
feeding the sequential host walk:

- one conflict scan over the clock-sorted flush batch detects chained
  runs (typing runs, prepend storms) — a chained struct's anchor IS the
  previous struct's row, no per-struct walk;
- one composed-key searchsorted resolves every remaining anchor;
- the structs the scan cannot chain form the *conflict residue* — the
  only structs handed to the sequential YATA walk.

Modes (``YTPU_PLAN_SEGMENT``):

========  ==================================================
device    whole-chunk planning on device kernels (JAX package
          default; K11-K13, not ported yet: raises)
np        per-doc planning on the NumPy kernels
jax       per-doc planning on device kernels (not ported yet:
          raises)
off       pure sequential host walk (the A/B lane)
========  ==================================================

The native planner (:mod:`.native_mirror`) reads the mode only as an
on/off flag, so the port's default flush path is unaffected by the
missing device modes; engines on the Python mirror
(``YTPU_NO_NATIVE_PLAN=1``) run with ``YTPU_PLAN_SEGMENT=np``.

Every array this module returns is freshly allocated host memory.

Monotone-run snapshot reuse: when the conflict scan chains all but a
handful of anchors (pure head-prepend / typing runs), rebuilding the
flat slot-major snapshot of the fragment index buys nothing.  The
planner detects that case and leaves those few anchors to the caller's
per-slot bisect against the *prior sorted segments*.
"""

from __future__ import annotations

import os

import numpy as np

from . import kernels
from . import plan_cache as _pc

NULL = -1  # must match columns.NULL

MODES = ("device", "np", "jax", "off")
_DEFAULT_MODE = "device"

# at or below this many unresolved anchors the planner reuses the
# per-slot sorted fragment segments directly (caller-side bisect per
# anchor) instead of rebuilding the flat snapshot
SNAPSHOT_SKIP_MAX = 8

# a chained run shorter than this is not worth bulk integration
MIN_RUN = 4


def plan_segment_mode() -> str:
    """Resolve ``YTPU_PLAN_SEGMENT`` to a known mode (default: device)."""
    mode = os.environ.get("YTPU_PLAN_SEGMENT", _DEFAULT_MODE)
    return mode if mode in MODES else _DEFAULT_MODE


class SegmentQueries:
    """Anchor-query columns for one doc's flush batch, built by
    ``DocMirror._segment_queries`` after the pre-split pass.

    ``o_*`` / ``r_*`` mirror origin / rightOrigin: client -1 means the
    anchor is absent, slot -1 means the anchor's client has no slot
    (resolved by the caller's bisect fallback).  ``gc``, ``cref``,
    ``pid`` and ``pname`` carry the per-ref facts span eligibility
    needs (GC tombstone, content kind, explicit parent id / name).
    """

    __slots__ = (
        "n", "client", "clock", "length",
        "o_cl", "o_ck", "o_slot", "r_cl", "r_ck", "r_slot",
        "gc", "cref", "pid", "pname",
    )


class SegmentPlan:
    """One doc's device-planned cold-path answer.

    ``hint_l`` / ``hint_r`` are verified candidate anchor rows
    (``NULL`` = resolve by bisect) or ``None`` when the snapshot was
    skipped entirely; ``chain_l`` / ``chain_r`` / ``run_id`` are the
    conflict-scan chain masks; ``spans`` lists the maximal
    single-direction chained runs eligible for bulk integration as
    ``(start, end, direction)`` with direction ``'l'`` (left chains to
    the previous ref, typing runs) or ``'r'`` (right chains, prepend
    runs).  All arrays are fresh host memory.
    """

    __slots__ = (
        "hint_l", "hint_r", "chain_l", "chain_r", "run_id", "spans",
        "snapshot_reused",
    )


def unported_mode_error(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"YTPU_PLAN_SEGMENT={mode}: the device segment-planner kernels "
        "(K11-K13) are not ported yet (ROADMAP queue 1, item 9); use "
        "YTPU_PLAN_SEGMENT=np or off"
    )


def _scan_doc(q: SegmentQueries):
    """Per-doc conflict scan (NumPy)."""
    return kernels.plan_conflict_scan(
        q.client, q.clock, q.length, q.o_cl, q.o_ck, q.r_cl, q.r_ck,
        backend="np",
    )


def _chain_spans(q: SegmentQueries, chain_l, chain_r, run_id):
    """Maximal single-direction chained spans eligible for bulk
    integration straight from device ranks.

    A span ``(s, e, d)`` promises: refs ``s+1 .. e-1`` chain purely in
    direction ``d`` onto their predecessor, are non-GC non-delete
    content from one client with strictly ascending clocks, carry no
    explicit parent, and (for ``'l'``) share one rightOrigin id.  The
    caller integrates ref ``s`` through the normal sequential path,
    verifies the live-state preconditions, then splices the interior in
    one pass — any precondition miss simply falls back to the scalar
    loop (the residue), so placement can never differ.
    """
    n = q.n
    if n < MIN_RUN:
        return []
    chained = chain_l | chain_r
    spans = []
    # run starts: positions where the chain breaks
    starts = np.flatnonzero(~chained)
    bounds = np.append(starts, n)
    for si in range(len(starts)):
        s, e = int(bounds[si]), int(bounds[si + 1])
        if e - s < MIN_RUN:
            continue
        il, ir = chain_l[s + 1 : e], chain_r[s + 1 : e]
        if il.all() and not ir.any():
            d = "l"
        elif ir.all() and not il.any():
            d = "r"
        else:
            continue  # mixed-direction run: scalar loop handles it
        sl = slice(s, e)
        if q.gc[sl].any() or q.pid[sl].any():
            continue
        if (q.cref[sl] == 1).any():  # ContentDeleted feeds delete ranges
            continue
        if q.pname[s + 1 : e].any():  # interior must copy the neighbour seg
            continue
        if not (q.client[sl] == q.client[s]).all():
            continue
        if not (np.diff(q.clock[sl]) > 0).all():
            continue  # fragment-index append needs ascending clocks
        if d == "r":
            # prepend run: interior origins must be absent (left = NULL)
            if (q.o_cl[s + 1 : e] != -1).any():
                continue
        else:
            # typing run: one shared rightOrigin id across the interior
            if not (
                (q.r_cl[s + 1 : e] == q.r_cl[s + 1]).all()
                and (q.r_ck[s + 1 : e] == q.r_ck[s + 1]).all()
            ):
                continue
        spans.append((s, e, d))
    return spans


def _verify_hints(cand, q_slot, q_ck, flat_slot, flat_clock, flat_row,
                  row_len):
    """Containment check: a candidate only becomes a hint when the live
    columns confirm the queried clock lies inside the candidate row."""
    total = flat_clock.shape[0]
    if total == 0:
        return np.full(q_slot.shape[0], NULL, np.int64)
    safe = np.clip(cand, 0, total - 1)
    c_row = flat_row[safe]
    ok = (
        (cand >= 0)
        & (q_slot >= 0)
        & (flat_slot[safe] == q_slot)
        & (q_ck >= flat_clock[safe])
        & (q_ck < flat_clock[safe] + row_len[c_row])
    )
    return np.where(ok, c_row, NULL)


def _needed(q: SegmentQueries, chain_l, chain_r) -> int:
    """Anchors the chain masks do NOT cover — the only ones a snapshot
    lookup could resolve."""
    need_l = int(((q.o_slot >= 0) & ~chain_l).sum())
    need_r = int(((q.r_slot >= 0) & ~chain_r).sum())
    return need_l + need_r


def plan_doc(q: SegmentQueries | None, mode: str | None = None,
             snapshot=None) -> SegmentPlan | None:
    """Plan one doc's flush batch.  ``snapshot`` is a zero-arg callable
    returning ``(flat_slot, flat_clock, flat_row, row_len, n_slots)``
    (the slot-major fragment-index snapshot); it is only invoked when
    the chain masks leave enough anchors unresolved to justify the
    rebuild."""
    if q is None:
        return None
    mode = mode or plan_segment_mode()
    if mode == "off" or q.n < MIN_RUN:
        return None
    if mode != "np":
        raise unported_mode_error(mode)
    chain_l, chain_r, run_id = _scan_doc(q)
    plan = SegmentPlan()
    plan.chain_l, plan.chain_r, plan.run_id = chain_l, chain_r, run_id
    plan.spans = _chain_spans(q, chain_l, chain_r, run_id)
    plan.hint_l = plan.hint_r = None
    plan.snapshot_reused = False
    if snapshot is None or _needed(q, chain_l, chain_r) <= SNAPSHOT_SKIP_MAX:
        # monotone chained run: the prior per-slot sorted segments are
        # reused as-is by the caller's bisect — no snapshot rebuild
        plan.snapshot_reused = True
        _pc.note_snapshot_reuse()
        return plan
    flat_slot, flat_clock, flat_row, row_len, _n_slots = snapshot()
    q_slot = np.concatenate([q.o_slot, q.r_slot])
    q_ck = np.concatenate([q.o_ck, q.r_ck])
    cand = kernels.plan_anchor_lookup(
        flat_slot, flat_clock, q_slot, q_ck, backend="np"
    )
    hint = _verify_hints(
        cand, q_slot, q_ck, flat_slot, flat_clock, flat_row, row_len
    )
    plan.hint_l, plan.hint_r = hint[: q.n], hint[q.n :]
    return plan


def plan_chunk(items, mode: str | None = None, mesh=None):
    """Plan a whole flush chunk of cold docs: ``items`` is a list of
    ``(queries, snapshot)`` pairs (either may be ``None``); returns a
    same-length list of :class:`SegmentPlan` (or ``None``) per doc.

    ``np`` plans each doc with :func:`plan_doc`; ``off`` plans none.
    The whole-chunk ``device`` mode (one batched scan and lookup,
    sharded over ``mesh``) is a later slice of the port and raises."""
    mode = mode or plan_segment_mode()
    out = [None] * len(items)
    if mode == "off":
        return out
    if mode != "np":
        raise unported_mode_error(mode)
    for i, (q, snap) in enumerate(items):
        if q is not None and q.n >= MIN_RUN:
            out[i] = plan_doc(q, mode=mode, snapshot=snap)
    return out
