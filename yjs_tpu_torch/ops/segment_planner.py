"""Cold planning of the Python mirror: conflict scan + anchor lookup.

The segment-sorted planner resolves anchors as verified *hints*
feeding the sequential host walk:

- one conflict scan over the (doc, client, clock)-sorted flush batch
  detects chained runs (typing runs, prepend storms) — a chained
  struct's anchor IS the previous struct's row, no per-struct walk;
- one composed-key searchsorted resolves every remaining anchor — in
  ``device`` mode for the whole flush chunk at once (all cold docs
  co-planned in one batched kernel call);
- the structs the scan cannot chain form the *conflict residue* — the
  only structs handed to the sequential YATA walk.

Modes (``YTPU_PLAN_SEGMENT``):

========  ==================================================
device    default: whole-chunk planning on the kernels
np        per-doc planning on the NumPy kernels
jax       per-doc planning on the kernels
off       pure sequential host walk (the A/B lane)
========  ==================================================

The kernels (``kernels.conflict_scan``, ``kernels.anchor_lookup``,
reached through ``kernels.plan_*`` and ``kernels.lookup_keys``, which
pad the columns to a power-of-two length) run on the ``device`` the
caller passes: the CUDA device unless told
otherwise (the engine passes its own), where they raise without CUDA;
on ``"cpu"`` their plain PyTorch versions serve.  Their keys are true
int64: the JAX package truncates them to int32 (ROADMAP R2), so its
candidates can differ from these, which equal the ``np`` mode's.  The
native planner (:mod:`.native_mirror`) reads the mode only as an on/off
flag.  A mesh of more than one device (the sharded lookup, K13) is not
ported and raises.

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
             snapshot=None, device=None) -> SegmentPlan | None:
    """Plan one doc's flush batch.  ``snapshot`` is a zero-arg callable
    returning ``(flat_slot, flat_clock, flat_row, row_len, n_slots)``
    (the slot-major fragment-index snapshot); it is only invoked when
    the chain masks leave enough anchors unresolved to justify the
    rebuild.  Every mode but ``np`` runs the kernels on ``device``."""
    if q is None:
        return None
    mode = mode or plan_segment_mode()
    if mode == "off" or q.n < MIN_RUN:
        return None
    backend = "np" if mode == "np" else "jax"
    chain_l, chain_r, run_id = kernels.plan_conflict_scan(
        q.client, q.clock, q.length, q.o_cl, q.o_ck, q.r_cl, q.r_ck,
        backend=backend, device=device,
    )
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
        flat_slot, flat_clock, q_slot, q_ck, backend=backend, device=device
    )
    hint = _verify_hints(
        cand, q_slot, q_ck, flat_slot, flat_clock, flat_row, row_len
    )
    plan.hint_l, plan.hint_r = hint[: q.n], hint[q.n :]
    return plan


def plan_chunk(items, mode: str | None = None, mesh=None, device=None):
    """Plan a whole flush chunk of cold docs in one batched kernel pass.

    ``items`` is a list of ``(queries, snapshot)`` pairs (either may be
    ``None``); returns a same-length list of :class:`SegmentPlan` (or
    ``None``) per doc.  Doc boundaries break chains via the doc-aware
    conflict scan; anchor lookups for every doc that still needs its
    snapshot compose ``(doc, slot, clock)`` into one key space so a
    single searchsorted resolves the entire chunk.  The kernels run on
    ``device``.  A ``mesh`` of more than one device (the reference's
    sharded lookup) raises ``NotImplementedError``.
    """
    # a mesh's device count, as a JAX mesh gives it (unknown: many)
    n_dev = getattr(getattr(mesh, "devices", None), "size", 2)
    if mesh is not None and n_dev > 1:
        raise NotImplementedError(
            "plan_chunk over a doc mesh of more than one device (the "
            "sharded anchor lookup, K13) is not ported yet (ROADMAP "
            "queue 1, item 10)"
        )
    mode = mode or plan_segment_mode()
    out = [None] * len(items)
    if mode == "off":
        return out
    live = [
        i for i, (q, _s) in enumerate(items)
        if q is not None and q.n >= MIN_RUN
    ]
    if not live:
        return out
    if mode != "device" or len(live) == 1:
        for i in live:
            q, snap = items[i]
            out[i] = plan_doc(q, mode=mode, snapshot=snap, device=device)
        return out
    _pc.note_segment_chunk()
    # ---- one conflict scan over the doc-major concatenation ----------
    qs = [items[i][0] for i in live]
    ns = np.array([q.n for q in qs], np.int64)
    doc_id = np.repeat(np.arange(len(qs), dtype=np.int64), ns)
    l, r, g = kernels.plan_chunk_conflict_scan(
        doc_id,
        *(np.concatenate([getattr(q, name) for q in qs])
          for name in ("client", "clock", "length", "o_cl", "o_ck",
                       "r_cl", "r_ck")),
        backend="jax", device=device,
    )
    offs = np.concatenate([[0], np.cumsum(ns)])
    for k, i in enumerate(live):
        q = qs[k]
        plan = SegmentPlan()
        sl = slice(int(offs[k]), int(offs[k + 1]))
        plan.chain_l = l[sl].copy()
        plan.chain_r = r[sl].copy()
        plan.run_id = g[sl].copy()
        plan.spans = _chain_spans(q, plan.chain_l, plan.chain_r, plan.run_id)
        plan.hint_l = plan.hint_r = None
        plan.snapshot_reused = False
        out[i] = plan
    # ---- one composed-key lookup for every doc still needing one -----
    lookup = []
    for k, i in enumerate(live):
        q, snap = items[i]
        if snap is None or _needed(q, out[i].chain_l, out[i].chain_r) \
                <= SNAPSHOT_SKIP_MAX:
            out[i].snapshot_reused = True
            _pc.note_snapshot_reuse()
            continue
        lookup.append((k, i, snap()))
    if not lookup:
        return out
    slot_base = 0
    f_parts, qk_parts, meta = [], [], []
    base_clock = 2
    for _k, _i, (fs, fc, _fr, _rl, n_slots) in lookup:
        if fc.shape[0]:
            base_clock = max(base_clock, int(fc.max()) + 2)
    for k, i, (fs, fc, fr, rl, n_slots) in lookup:
        q = qs[k]
        q_slot = np.concatenate([q.o_slot, q.r_slot])
        q_ck = np.concatenate([q.o_ck, q.r_ck])
        base_clock = max(
            base_clock, (int(q_ck.max()) + 2) if q_ck.shape[0] else 2
        )
        f_parts.append((fs + slot_base, fc))
        qk_parts.append(
            (np.where(q_slot >= 0, q_slot + slot_base, -1), q_ck, q_slot)
        )
        meta.append((k, i, fr, rl, q_ck))
        slot_base += n_slots
    flat_gkey = np.concatenate(
        [gs * base_clock + fc for gs, fc in f_parts]
    ) if f_parts else np.empty(0, np.int64)
    q_gkey = np.concatenate(
        [np.where(gs >= 0, gs * base_clock + ck, -1)
         for gs, ck, _ls in qk_parts]
    )
    cand_all = kernels.lookup_keys(flat_gkey, q_gkey, "jax", device)
    # ---- split hints back per doc ------------------------------------
    flat_slots_g = np.concatenate([gs for gs, _fc in f_parts])
    flat_clocks = np.concatenate([fc for _gs, fc in f_parts])
    qoff = 0
    # per-doc row_len tables differ, so verify per doc over its block
    foff = 0
    for (k, i, fr, rl, _q_ck), (gs_q, q_ck, _ls) in zip(meta, qk_parts):
        q = qs[k]
        nq = 2 * q.n
        nf = fr.shape[0]
        # global candidate -> doc-local index; a query whose key sorts
        # before this doc's flat block lands in a previous doc's region
        # (cand < 0 after the shift) and verifies to NULL
        cand = cand_all[qoff : qoff + nq] - foff
        hint = _verify_hints(
            cand,
            gs_q,
            q_ck,
            flat_slots_g[foff : foff + nf],
            flat_clocks[foff : foff + nf],
            fr,
            rl,
        )
        out[i].hint_l = hint[: q.n]
        out[i].hint_r = hint[q.n :]
        qoff += nq
        foff += nf
    return out
