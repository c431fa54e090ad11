"""BatchEngine: batched apply_update over many docs on a CUDA device.

The PyTorch port of ``yjs_tpu/ops/engine.py``.  Pending binary updates
from many docs are planned on the host (the C++ plan core behind
:class:`NativeMirror`, or the Python :class:`DocMirror`), and the
persistent device state (right links, segment heads, deleted bits) is
written by the hand-written kernels of :mod:`.kernels`.  Three flush
lanes, chosen by ``YTPU_KERNEL`` as in the JAX engine:

- ``apply`` (unset, the default): the planner resolves every final YATA
  link; one packed lanes buffer per chunk is copied to the device and
  scattered into the tables;
- ``seq``: YATA runs on the device, one item at a time per doc
  (``kernels.batch_step``), over the planner's causal schedule;
- ``levels`` (any other value): YATA runs on the device level by level
  (``kernels.batch_step_levels``), true conflicts through the same
  single-item integrate.

The device lanes read six resident static columns per row (client key,
origin and right-origin ids, origin row), uploaded as a per-flush delta
(``kernels.scatter_statics``).  Root text/list/map types and nested
shared types are all served; only docs embedding subdocuments fall back
to the CPU reference core — the Provider gating seam.

The resident tables are torch tensors on ``self.device``: a CUDA device
unless the caller asks for ``device="cpu"`` (the tests do), where the
kernels' plain PyTorch versions serve.  The batched sync paths
(``state_vectors_batched`` and the device branch of
``sync_step2_batch``) run the state-vector and diff-mask kernels.  On
Python mirrors the default segment-planner mode co-plans each flush's
cold docs in one chunk (:func:`.segment_planner.plan_chunk`), whose
conflict scan and anchor lookup run on the engine's device too.

``mesh=`` (a :class:`..parallel.DocMesh`) shards the doc batch: shard
``s`` keeps docs ``[s * B_loc, (s + 1) * B_loc)`` in tables on its own
device, each flush lane runs per shard with shard-local doc indices (the
apply lane through ``sharded_apply_plan``, ``levels`` through
``sharded_batch_step``), ``state_vectors_batched`` runs
``sharded_state_vectors``, and the chunk planner's anchor lookup splits
its queries over the shards.  Shards may share a device.  An unmeshed
engine is the one-shard case of the same code.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..core import Doc
from ..lib0.u16 import from_u16
from ..obs import EngineObs, new_flush_metrics
from ..resilience import DeadLetterQueue, HealthTracker
from ..updates import InvalidUpdate, validate_update
from ..updates import apply_update, apply_update_v2
from ..parallel.mesh import (
    fold_metrics,
    put_host,
    shard_rows,
    sharded_apply_plan,
    sharded_batch_step,
    sharded_state_vectors,
)
from .columns import NULL, DocMirror, UnsupportedUpdate
from . import plan_cache
from . import segment_planner
from .native_mirror import (
    NativeMirror,
    native_plan_available,
    pack_apply_lanes,
    plan_segment_stats,
    prepare_many,
)
from . import kernels


def _native_plan_threads() -> int:
    """Worker-pool width ymx_prepare_many fans out to (1 when the native
    planner is unavailable or the host has a single core)."""
    try:
        from ..native import has_plancore, load

        lib = load()
        if (
            lib is not None
            and has_plancore()
            and getattr(lib, "_has_plan_threads", False)
        ):
            return int(lib.ymx_plan_threads())
    except Exception:
        pass
    return 1


def make_mirror(root_name: str, device=None):
    """DocMirror served by the C++ plan core when available; the pure-
    Python mirror otherwise (no toolchain / YTPU_NO_NATIVE_PLAN), whose
    segment planner runs its kernels on ``device``."""
    if native_plan_available():
        return NativeMirror(root_name)
    return DocMirror(root_name, device=device)


def visible_text(mirror, rows, deleted) -> str:
    """Materialize visible text from document-ordered rows + deleted flags.

    Content strings are UTF-16 code units (surrogate pairs may be split
    across runs, reference ContentString.js:51-66); recombine like
    YText.to_string does."""
    out = []
    for r, d in zip(rows, deleted):
        if d or not mirror.row_countable[r]:
            continue
        content = mirror.realized_content(r)
        s = getattr(content, "str", None)
        if s is not None:
            out.append(s)
        else:
            out.append("".join(str(x) for x in getattr(content, "arr", [])))
    return from_u16("".join(out))


def _bucket(n: int, minimum: int = 64) -> int:
    """Round up to the padding bucket (power of two)."""
    b = minimum
    while b < n:
        b *= 2
    return b


# scatter-lane width quantization: 2**bits mantissa steps per power-of-two
# octave.  bits=3 (default) caps padding waste at 12.5% of the request
# (vs 50% for pure powers of two).  bits=0 restores pure powers of two.
_PAD_BITS = max(0, min(6, int(os.environ.get("YTPU_PAD_BITS", "3"))))


def _bucket_lanes(n: int, minimum: int = 64) -> int:
    """Round a per-flush LANE width up to the next mantissa-quantized
    bucket.  Used only for transfer-lane widths (the occupancy metric);
    device STATE capacities keep plain powers of two, where fewer, larger
    growth steps amortize the on-device copy better."""
    if n <= minimum:
        return minimum
    bits = _PAD_BITS
    if bits == 0:
        return _bucket(n, minimum)
    e = max(0, (n - 1).bit_length() - 1 - bits)
    return ((n + (1 << e) - 1) >> e) << e


# target size of one level-axis schedule tile (entries per doc-batch block);
# big enough that kernel launch overhead amortizes, small enough that the
# padded [B, block, W, 8] tile stays modest at any log length
_BLOCK_BUDGET = 1 << 22


def _block_levels(n_docs: int, w_lv: int) -> int:
    return _bucket(max(1, _BLOCK_BUDGET // max(1, n_docs * w_lv)), 1)


# resident immutable device columns, in packed-row order for the one-
# transfer statics scatter (client_key rides as its u32 bit pattern in an
# int32 column: torch has no uint32 index_put_ on the CPU)
_STATIC_COLS = (
    ("client_key", 0, "uint32"),
    ("origin_slot", NULL, "int32"),
    ("origin_clock", 0, "int32"),
    ("right_slot", NULL, "int32"),
    ("right_clock", 0, "int32"),
    ("origin_row", NULL, "int32"),
)


class _PhasePair:
    """Two stacked phase contexts without ExitStack overhead — _phase_ctx
    sits on the per-flush hot path (7 entries per flush)."""

    __slots__ = ("_outer", "_inner")

    def __init__(self, outer, inner):
        self._outer = outer
        self._inner = inner

    def __enter__(self):
        self._outer.__enter__()
        self._inner.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self._inner.__exit__(*exc)
        finally:
            self._outer.__exit__(*exc)


def _pipeline_on() -> bool:
    """YTPU_FLUSH_PIPELINE knob: pipelined flush is the default; ``0`` /
    ``false`` / ``off`` restores the fully synchronous dispatch (the A/B
    lane — byte-identical output is the pipeline's correctness bar)."""
    return os.environ.get("YTPU_FLUSH_PIPELINE", "1").lower() not in (
        "0", "false", "off",
    )


_TORCH_DTYPE = {
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
}


def _is_ready(marker) -> bool:
    """Non-blocking completion probe of a dispatch marker (a tuple of
    CUDA events, one per device the work ran on, or None for work that
    ran synchronously on the CPU)."""
    return marker is None or all(e.query() for e in marker)


class _StageSlot:
    """One half of the double-buffered staging pair: a reusable host
    lanes buffer (``host``, pinned on a CUDA engine; ``buf`` is its numpy
    view, which the packers write; row ``s`` is shard ``s``'s lanes) plus
    the CUDA events recorded right after the host-to-device copies that
    last read it, one per device the rows went to.  A ``non_blocking``
    copy from pinned memory reads the buffer after the call returns, so
    the host must not rewrite it until every one of those events has
    completed."""

    __slots__ = ("buf", "host", "event")

    def __init__(self):
        self.buf = None
        self.host = None
        self.event = None


class _PackTimer:
    """Times one host pack and books it as overlapped when a device
    dispatch was still outstanding (dispatched this flush, not yet
    blocked on) at pack start — the numerator of the bench overlap
    fraction (t_pack_overlap_s / t_pack_s).  The honest wait time is
    t_device_wait_s."""

    __slots__ = ("_pl", "_t0", "_overlap")

    def __init__(self, pl):
        self._pl = pl
        self._t0 = 0.0
        self._overlap = False

    def __enter__(self):
        self._overlap = self._pl.outstanding > 0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._overlap:
            self._pl.t_pack_overlap_s += time.perf_counter() - self._t0
        return False


class _FlushPipeline:
    """Pipelined flush state machine: stage N+1's host-side pack overlaps
    stage N's copy and kernel on the device.

    CUDA launches and ``non_blocking`` copies from pinned memory return
    as soon as the work is enqueued, so the pipeline needs no threads: it
    only has to (a) keep packing into a DIFFERENT staging buffer than the
    one an in-flight copy may still be reading (``acquire`` alternates
    the double-buffered pair and waits — counted as t_device_wait_s — on
    the slot's copy event only when that copy has not completed), and
    (b) account honestly for what overlapped (``_PackTimer``).
    ``sync=True`` is the YTPU_FLUSH_PIPELINE=0 A/B lane: every dispatch
    waits for completion before the host proceeds.

    One instance persists across flushes (the staging pair and in-flight
    markers carry over, so steady state reallocates nothing);
    ``begin_flush`` resets only the per-flush counters."""

    __slots__ = (
        "sync", "t_pack_overlap_s", "t_device_wait_s", "n_dispatches",
        "max_depth", "outstanding", "_slots", "_turn", "_inflight",
        "_pinned",
    )

    def __init__(self, pinned: bool):
        self.sync = False
        self.t_pack_overlap_s = 0.0
        self.t_device_wait_s = 0.0
        self.n_dispatches = 0
        self.max_depth = 0
        # dispatches this flush the host has not blocked on (the
        # _PackTimer overlap predicate; reset per flush so read-backs
        # between flushes can't inflate it)
        self.outstanding = 0
        self._slots = (_StageSlot(), _StageSlot())
        self._turn = 0
        self._inflight: list = []
        self._pinned = pinned

    def begin_flush(self, sync: bool) -> None:
        self.sync = sync
        self.t_pack_overlap_s = 0.0
        self.t_device_wait_s = 0.0
        self.n_dispatches = 0
        self.max_depth = 0
        self.outstanding = 0

    def _wait(self, marker) -> None:
        t0 = time.perf_counter()
        for event in marker:
            event.synchronize()
        self.t_device_wait_s += time.perf_counter() - t0
        self.outstanding = 0

    def acquire(self, shape, dtype) -> _StageSlot:
        """Next staging buffer of the pair, ready for host writes.  The
        copy that last read the slot (two dispatches back in steady
        state) must have completed before the buffer is rewritten; any
        wait here is real pipeline back-pressure, counted as device
        wait."""
        self._turn ^= 1
        slot = self._slots[self._turn]
        if slot.event is not None:
            if not _is_ready(slot.event):
                self._wait(slot.event)
            slot.event = None
        buf = slot.buf
        if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
            slot.host = torch.empty(
                tuple(shape), dtype=_TORCH_DTYPE[np.dtype(dtype)],
                pin_memory=self._pinned,
            )
            slot.buf = slot.host.numpy()
        return slot

    def pack(self) -> _PackTimer:
        return _PackTimer(self)

    def dispatched(self, marker, slot: _StageSlot | None = None) -> None:
        """Book one device dispatch.  ``marker`` holds a CUDA event per
        device, recorded after the dispatch's kernels (None when it ran
        synchronously on the CPU)."""
        self.n_dispatches += 1
        if self.sync:
            if marker is not None:
                self._wait(marker)
            self._inflight = []
            if slot is not None:
                slot.event = None
            return
        self.outstanding += 1
        self._inflight = [e for e in self._inflight if not _is_ready(e)]
        self._inflight.append(marker)
        if len(self._inflight) > self.max_depth:
            self.max_depth = len(self._inflight)


class BatchEngine:
    """Applies binary Yjs updates to a batch of docs on device.

    Parameters
    ----------
    n_docs: batch size.
    root_name: the default root type for text()/rows_in_order() when no
        name is passed; any number of root text/list/map types per doc —
        and the shared types nested inside them — are integrated on
        device (subdocs fall back to the CPU core per doc).
    mesh: a :class:`..parallel.DocMesh` to shard the doc batch over
        (``n_docs`` a multiple of its first axis' size), or None.
    device: where the resident tables live: ``None`` (the default) is
        the CUDA device and raises ``RuntimeError`` without CUDA;
        ``"cpu"`` runs the kernels' plain PyTorch versions.  On a mesh
        it is the mesh's first device (another ``device`` raises).
    """

    def __init__(
        self,
        n_docs: int,
        root_name: str = "text",
        mesh=None,
        gc: bool = False,
        compact_min_rows: int = 512,
        policy: str = "auto",
        device=None,
    ):
        if policy not in ("auto", "cpu", "device"):
            raise ValueError(f"unknown policy {policy!r}")
        shard_devs = None
        if mesh is not None:
            doc_axis = mesh.axis_names[0]
            axis_size = mesh.shape[doc_axis]
            if n_docs % axis_size != 0:
                raise ValueError(
                    f"n_docs={n_docs} must be a multiple of the {doc_axis!r} "
                    f"axis size {axis_size}"
                )
            shard_devs = mesh.axis_devices(doc_axis)
            if len({d.type for d in shard_devs}) != 1:
                raise ValueError("a mesh's shards must share a device type")
            want = None if device is None else torch.device(device)
            if want is not None and (
                want.type != shard_devs[0].type
                or want.index not in (None, shard_devs[0].index)
            ):
                raise ValueError(
                    f"device={device!r} conflicts with the mesh's first "
                    f"device {shard_devs[0]}"
                )
            device = shard_devs[0]
        self.device = kernels.resolve_device(device, "BatchEngine")
        self._cuda = self.device.type == "cuda"
        # the doc shards: shard s holds docs [s*b_loc, (s+1)*b_loc) on
        # _shard_devs[s] (one shard on self.device without a mesh)
        self._shard_devs = shard_devs or [self.device]
        self._b_loc = n_docs // len(self._shard_devs)
        self._mesh_devs = list(dict.fromkeys(self._shard_devs))
        # sharded callables: the bulk apply keyed by lane widths, the
        # state vectors by n_slots (as the reference caches its jits)
        self._sharded_step = (
            None if mesh is None
            else sharded_batch_step(mesh, mesh.axis_names[0])
        )
        self._sharded_apply: dict[tuple, object] = {}
        self._sharded_sv: dict[int, object] = {}
        # per-shard [2] progress counters of the last sharded flush,
        # folded lazily by last_metrics (None: unsharded or seq flush)
        self._counters: list | None = None
        self.n_docs = n_docs
        self.root_name = root_name
        self.mesh = mesh
        self.gc = gc
        self.compact_min_rows = compact_min_rows
        # backend policy: "auto" demotes out-of-scope docs to the CPU core,
        # "cpu" serves every doc on the CPU core (lazily, no device work),
        # "device" records demotions as in auto (state stays consistent and
        # no data is lost) but the Provider raises while any exist
        self.policy = policy
        # export source: host list walk (default — zero device round trips)
        # or device rank kernel (the verification path; the test suite sets
        # YTPU_EXPORT_DEVICE=1 so every oracle comparison validates the
        # DEVICE state, and a dedicated test pins host==device)
        self.export_from_device = os.environ.get("YTPU_EXPORT_DEVICE") == "1"
        # per-doc row count at the last compaction (growth trigger)
        self._rows_at_compact = [0] * n_docs
        # per-doc stats of the most recent flush's compactions
        self.last_compaction: list[dict] | None = None
        # doc.on('update') seam: callbacks (doc_idx, update_bytes) invoked
        # after each flush with the flush's incremental update per doc
        self._update_listeners: list = []
        # typed-event seam: doc idx -> callbacks(doc, events) where events
        # are YEvent-shaped dicts computed from the step plan (reference
        # observe/observeDeep, AbstractType.js:360-389)
        self._event_listeners: dict[int, list] = {}
        self.mirrors: list = [
            make_mirror(root_name, self.device) for _ in range(n_docs)
        ]
        # CPU fallback docs (Provider gating): doc idx -> Doc
        self.fallback: dict[int, Doc] = {}
        # every demotion ever, with its reason — scope gaps are measurable,
        # not silent (each entry: {"doc", "reason"})
        self.demotions: list[dict] = []
        # observability bundle: metrics registry + flush-history ring +
        # host span tracer (host-side per-phase timers + batch stats of
        # every flush live in obs.history; last_flush_metrics is the
        # compatibility view of the newest entry)
        self.obs = EngineObs()
        # resilience: per-doc failure isolation.  Strict mode
        # (YTPU_RESILIENCE_DISABLED=1) restores the pre-resilience
        # contract — integration failures raise out of flush()
        self._strict = os.environ.get("YTPU_RESILIENCE_DISABLED") == "1"
        self.health = HealthTracker(obs=self.obs)
        self.dead_letters = DeadLetterQueue()
        # every transactional per-doc rollback, with its reason (the
        # rollback subset of self.demotions)
        self.rollbacks: list[dict] = []
        self._update_log: list[list[tuple[bytes, bool]]] = [[] for _ in range(n_docs)]
        # warm-promotion column scatters deferred to the next flush /
        # device read-back: doc -> (right, deleted, seg_heads) rows
        self._pending_hydration: dict[int, tuple] = {}
        # persistent device state (no left-link array: order is ranked from
        # right links with a host-known membership mask), per shard:
        # [right [b_loc, N+1] i32, deleted [b_loc, N+1] bool, starts
        # [b_loc, S+1] i32] on the shard's device
        self._cap = 0  # row capacity N (arrays are [B, N+1] with scratch row)
        self._seg_cap = 0  # segment capacity S (starts is [B, S+1])
        self._tabs: list | None = None
        # resident immutable columns, updated by per-flush row scatters —
        # steady-state flush transfer scales with the DELTA, not with B*cap
        # (per shard: a dict of [b_loc, N+1] int32 columns)
        self._stat: list | None = None
        # rows per doc already uploaded and still valid on device
        self._uploaded_rows = [0] * n_docs
        # pipelined flush state: double-buffered staging pair (pinned on
        # a CUDA engine) + in-flight dispatch markers persist ACROSS
        # flushes so steady state neither reallocates nor stalls;
        # per-flush counters reset in _flush.  Sync (A/B) mode is re-read
        # from YTPU_FLUSH_PIPELINE at every flush.
        self._pl = _FlushPipeline(pinned=self._cuda)
        # device-table bytes (re)allocated during the current flush — 0 in
        # steady state, where every kernel writes the tables in place
        self._flush_realloc_bytes = 0
        # slots that ever accepted traffic (cleared by reset_doc): feeds
        # the ytpu_prof_slot_occupancy gauge in O(1) per update
        self._active_docs: set[int] = set()

    # -- update ingestion ---------------------------------------------------

    def queue_update(self, doc: int, update: bytes, v2: bool = False) -> bool:
        """Queue one update for ``doc``; returns True when accepted.

        False means the bytes were diverted to :attr:`dead_letters`
        instead of entering the pipeline: the doc is quarantined, or (on
        the CPU-served path, where apply is immediate) the update failed
        to apply.  Callers that track dirtiness should only mark dirty
        on True."""
        if (
            not self._strict
            and self.health.tracked
            and not self.health.admissible(doc)
        ):
            self._dead_letter(doc, update, v2, "quarantined")
            return False
        fb = self.fallback.get(doc)
        if fb is None and self.policy == "cpu":
            fb = self._cpu_serve(doc)
        if fb is not None:
            # CPU-served docs apply directly; the log is dead weight for them
            try:
                (apply_update_v2 if v2 else apply_update)(fb, update)
            except Exception as e:
                if self._strict:
                    raise
                reason = f"cpu-apply: {type(e).__name__}: {e}"
                self._dead_letter(doc, update, v2, reason)
                self.health.record_failure(doc, reason)
                return False
            if self.health.tracked:
                self.health.record_success(doc)
        else:
            self._update_log[doc].append((update, v2))
            self.mirrors[doc].ingest(update, v2)
        self._active_docs.add(doc)
        return True

    def _dead_letter(self, doc: int, update: bytes, v2: bool, reason: str) -> None:
        self.dead_letters.append(doc, update, v2, reason)
        self.obs.dead_lettered(
            reason, len(self.dead_letters), self.dead_letters.dropped
        )

    def _cpu_serve(self, doc: int) -> Doc:
        """Route a doc to the CPU reference core by configuration (policy
        'cpu') — not a demotion, so it is not recorded as one."""
        fb = Doc(gc=False)
        self.fallback[doc] = fb
        # dead mirror
        self.mirrors[doc] = DocMirror(self.root_name, device=self.device)
        fb.on("update", lambda u, origin, d, i=doc: self._emit(i, u))
        if doc in self._event_listeners:
            self._attach_cpu_events(doc, fb)
        return fb

    def on_update(self, callback) -> None:
        """Register ``callback(doc_idx, update_bytes)`` — called after each
        flush with that flush's incremental update per changed doc (the
        reference doc.on('update') broadcast contract,
        Transaction.js:339-352).  Demoted docs keep emitting via their CPU
        Doc's own update events."""
        self._update_listeners.append(callback)

    def off_update(self, callback) -> None:
        self._update_listeners.remove(callback)

    def observe(self, doc: int, callback) -> None:
        """Register ``callback(doc_idx, events)`` for one doc: after each
        flush that changes it, ``events`` is a list of YEvent-shaped dicts
        ``{"path", "delta", "keys"}`` — path[0] is the root type name,
        deeper elements are map keys / list indices (reference
        YEvent.path + YEvent.changes).  Demoted docs deliver the same
        shape from the CPU core's transactions.

        Numeric list positions in ``path`` match the reference getPathTo
        (YEvent.js:207-228) exactly: one per undeleted ITEM before the
        target, with mirror rows grouped into CPU-merged-item runs so the
        count equals what a CPU doc reports even though the mirror merges
        lazily (ops/events.py _path_of / _rows_one_cpu_item; parity
        pinned by test_engine_events.py::test_event_path_parity_*)."""
        self._event_listeners.setdefault(doc, []).append(callback)
        fb = self.fallback.get(doc)
        if fb is not None:
            self._attach_cpu_events(doc, fb)

    def unobserve(self, doc: int, callback) -> None:
        self._event_listeners[doc].remove(callback)
        if not self._event_listeners[doc]:
            del self._event_listeners[doc]

    def _attach_cpu_events(self, doc: int, fb: Doc) -> None:
        if getattr(fb, "_ytpu_events_attached", False):
            return
        fb._ytpu_events_attached = True
        from ..ids import find_root_type_key
        from ..types.events import YEvent, get_path_to

        def after_transaction(transaction, d, i=doc):
            cbs = self._event_listeners.get(i)
            if not cbs:
                return
            events = []
            for typ in transaction.changed:
                root = typ
                while root._item is not None:
                    root = root._item.parent
                ev = YEvent(typ, transaction)
                changes = ev.changes
                if not changes["delta"] and not changes["keys"]:
                    continue
                events.append({
                    "path": [find_root_type_key(root)]
                    + get_path_to(root, typ),
                    "delta": changes["delta"],
                    "keys": changes["keys"],
                })
            if events:
                for cb in cbs:
                    cb(i, events)

        fb.on("afterTransaction", after_transaction)

    def _emit(self, doc: int, update: bytes) -> None:
        self.obs.update_emitted(len(update))
        for cb in self._update_listeners:
            cb(doc, update)

    def _demote(
        self,
        doc: int,
        pre_sv: dict[int, int] | None = None,
        reason: str = "unspecified",
    ) -> Doc:
        """Move a doc to the CPU reference path by replaying its update log.

        When the doc is observed, the CPU event bridge attaches at the
        point of the replay where the pre-flush state vector is covered
        (the log prefix reproduces it exactly), so the demoting flush's
        own changes still deliver typed events — only historical replay
        stays silent."""
        self.demotions.append({"doc": doc, "reason": reason})
        self.obs.demoted(doc, reason)
        fb = Doc(gc=False)
        observed = doc in self._event_listeners
        attached = False
        if observed and not pre_sv:
            self._attach_cpu_events(doc, fb)
            attached = True
        for update, v2 in self._update_log[doc]:
            if observed and not attached:
                from ..core import get_state_vector

                sv = get_state_vector(fb.store)
                if all(sv.get(c, 0) >= v for c, v in pre_sv.items()):
                    self._attach_cpu_events(doc, fb)
                    attached = True
            try:
                (apply_update_v2 if v2 else apply_update)(fb, update)
            except Exception as e:
                # a log entry even the CPU reference core rejects cannot
                # be replayed anywhere: keep the bytes recoverable and
                # finish the demotion with the entries that do apply
                if self._strict:
                    raise
                self._dead_letter(
                    doc, update, v2, f"replay: {type(e).__name__}: {e}"
                )
        self.fallback[doc] = fb
        # dead mirror
        self.mirrors[doc] = DocMirror(self.root_name, device=self.device)
        plan_cache.note_invalidation("demote")
        self._update_log[doc] = []
        self._uploaded_rows[doc] = 0
        if self._update_listeners:
            # emit the demoting flush's novelty, then live-forward the
            # fallback doc's own update events
            from ..updates import encode_state_as_update, encode_state_vector
            from ..coding import DSEncoderV1
            from ..updates import write_state_vector

            enc_sv = None
            if pre_sv:
                e = DSEncoderV1()
                write_state_vector(e, pre_sv)
                enc_sv = e.to_bytes()
            novelty = encode_state_as_update(fb, enc_sv)
            if novelty:
                self._emit(doc, novelty)
        fb.on("update", lambda u, origin, d, i=doc: self._emit(i, u))
        if doc in self._event_listeners:
            self._attach_cpu_events(doc, fb)
        return fb

    def _isolate_failure(self, doc: int, exc: Exception, pre_sv=None) -> None:
        """Transactional per-doc rollback: contain one doc's failed
        integration without touching the rest of the batch.

        The update log is the transaction journal — every entry is
        re-validated, malformed entries are stripped to the dead-letter
        queue (bytes + reason preserved), and :meth:`_demote` replays
        the surviving prefix into a fresh CPU doc.  That replay IS the
        rollback: it rebuilds the doc's last good state, and replacing
        the mirror discards whatever poison its ``_incoming`` held, so
        the failure cannot re-wedge later flushes."""
        reason = f"{type(exc).__name__}: {exc}"
        clean: list[tuple[bytes, bool]] = []
        for update, v2 in self._update_log[doc]:
            try:
                validate_update(update, v2)
            except InvalidUpdate as ve:
                self._dead_letter(doc, update, v2, f"invalid-update: {ve}")
            else:
                clean.append((update, v2))
        self._update_log[doc] = clean
        self.rollbacks.append({"doc": doc, "reason": reason})
        self.obs.rollback(doc, reason)
        self.health.record_failure(doc, reason)
        self._demote(doc, pre_sv, reason=f"rollback: {reason}")

    def replay_dead_letters(
        self, doc: int | None = None, seqs=None, repair=None,
        readmit: bool = False, max_letters: int | None = None,
    ) -> dict:
        """Re-inject dead letters through the normal ingestion path.

        ``repair`` is an optional ``callable(DeadLetter) -> bytes | None``
        applied first: return fixed bytes to replay, or None to leave
        the letter queued (counted as requeued).  ``readmit=True``
        clears the targeted docs' health records first (operator
        override of quarantine backoff).  Letters that still fail
        validation or admission are re-dead-lettered and counted as
        failed.  Work per invocation is bounded: at most ``max_letters``
        (``YTPU_DLQ_REPLAY_BATCH``, default 256; 0 = unbounded) letters
        are taken, the rest stay queued and are reported as
        ``truncated`` (metered by
        ``ytpu_resilience_dlq_replay_truncated_total``) so a deep DLQ
        cannot stall a flush tick or an admission drain.  Returns
        ``{"replayed", "requeued", "failed", "truncated"}``."""
        if readmit:
            self.health.reset(doc)
        if max_letters is None:
            try:
                max_letters = int(
                    os.environ.get("YTPU_DLQ_REPLAY_BATCH", "256")
                )
            except ValueError:
                max_letters = 256
        cap = max_letters if max_letters and max_letters > 0 else None
        replayed = requeued = failed = 0
        truncated = 0
        if cap is not None:
            matching = self.dead_letters.count_matching(doc=doc, seqs=seqs)
            truncated = max(0, matching - cap)
        for e in self.dead_letters.take(doc=doc, seqs=seqs, limit=cap):
            update = e.update
            if repair is not None:
                fixed = repair(e)
                if fixed is None:
                    self.dead_letters.append(e.doc, e.update, e.v2, e.reason)
                    requeued += 1
                    continue
                update = bytes(fixed)
            try:
                validate_update(update, e.v2)
            except InvalidUpdate as ve:
                self._dead_letter(e.doc, update, e.v2, f"replay-invalid: {ve}")
                failed += 1
                continue
            if self.queue_update(e.doc, update, e.v2):
                replayed += 1
            else:
                failed += 1  # inadmissible: re-dead-lettered by queue_update
        self.obs.replayed(replayed)
        if truncated:
            self.obs.replay_truncated(truncated)
        return {
            "replayed": replayed,
            "requeued": requeued,
            "failed": failed,
            "truncated": truncated,
        }

    def resilience_snapshot(self) -> dict:
        """JSON-able view of the failure-isolation state (bench/expo)."""
        return {
            "strict": self._strict,
            "health": self.health.summary(),
            "docs": self.health.records(),
            "dead_letters": self.dead_letters.snapshot(),
            "n_rollbacks": len(self.rollbacks),
            "n_demotions": len(self.demotions),
        }

    # -- device placement ---------------------------------------------------

    def _put_r(self, x) -> torch.Tensor:
        """Place a host array on the engine's (first) device: a
        ``non_blocking`` copy from pinned memory on CUDA (the caching host
        allocator keeps the pinned copy alive until the transfer has read
        it), a zero-copy view on the CPU, where every kernel consumes its
        inputs before returning."""
        return put_host(x, self.device)

    def _put_b(self, x) -> list:
        """Place a batch-leading ``[B, ...]`` host array: split on the doc
        axis, each shard's block on its device."""
        return shard_rows(x, self._shard_devs)

    def _put_shards(self, arrays) -> list:
        """Per-shard host arrays (None: nothing for that shard), each
        placed on its shard's device."""
        return [
            None if a is None else put_host(a, dev)
            for a, dev in zip(arrays, self._shard_devs)
        ]

    def _put_staged(self, slot: _StageSlot) -> list:
        """Place the staged lanes rows of ``slot`` (row ``s`` for shard
        ``s``) on the shards' devices and fence the slot's buffer with an
        event per device recorded right after the copies
        (``_FlushPipeline.acquire`` waits on them before a rewrite)."""
        host = slot.host
        if not self._cuda:
            return list(host)
        rows = [
            host[s].to(dev, non_blocking=True)
            for s, dev in enumerate(self._shard_devs)
        ]
        slot.event = self._marker()
        return rows

    def _marker(self):
        """Dispatch marker: one CUDA event per device of the engine,
        recorded after the work enqueued so far on its current stream
        (None on the CPU, where it has already run)."""
        if not self._cuda:
            return None
        events = []
        for dev in self._mesh_devs:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            events.append(event)
        return tuple(events)

    def _table(self, k: int):
        if self._tabs is None:
            return None
        if len(self._tabs) == 1:
            return self._tabs[0][k]
        return torch.cat([t[k].to(self.device) for t in self._tabs])

    # whole-batch views of the resident tables: the tensors themselves
    # without a mesh, a gathered copy on the first device with one (read
    # only; the engine writes self._tabs / self._stat per shard)
    _right = property(lambda self: self._table(0))
    _deleted = property(lambda self: self._table(1))
    _starts = property(lambda self: self._table(2))

    @property
    def _statics(self) -> dict | None:
        if self._stat is None:
            return None
        if len(self._stat) == 1:
            return self._stat[0]
        return {
            key: torch.cat([st[key].to(self.device) for st in self._stat])
            for key in self._stat[0]
        }

    def shard_tables(self) -> list:
        """Per shard, its device tables ``[right, deleted, starts]`` and
        statics dict (None before the first levels/seq flush): the
        tensors themselves, on the shard's device."""
        if self._tabs is None:
            return []
        stat = self._stat or [None] * len(self._tabs)
        return [(list(t), st) for t, st in zip(self._tabs, stat)]

    # -- device state management -------------------------------------------

    def _ensure_capacity(self, n_rows: int, n_segs: int) -> None:
        cap = _bucket(n_rows)
        seg_cap = _bucket(n_segs, 8)
        if (
            cap <= self._cap
            and seg_cap <= self._seg_cap
            and self._tabs is not None
        ):
            return
        b = self._b_loc
        old_cap, old_seg = self._cap, self._seg_cap
        self._cap = max(cap, self._cap)
        self._seg_cap = max(seg_cap, self._seg_cap)

        # allocate/grow ON DEVICE (no host fill shipped over the link),
        # every shard at once: capacity is one for the whole batch
        def fresh(shape, fill, dtype, dev):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        def grow(old, old_w, new_w, fill, dtype):
            out = fresh((old.shape[0], new_w), fill, dtype, old.device)
            if old_w:
                out[:, :old_w] = old[:, :old_w]
            return out

        if self._tabs is None:
            self._tabs = [
                [
                    fresh((b, self._cap + 1), NULL, torch.int32, dev),
                    fresh((b, self._cap + 1), False, torch.bool, dev),
                    fresh((b, self._seg_cap + 1), NULL, torch.int32, dev),
                ]
                for dev in self._shard_devs
            ]
        else:
            # old scratch column (index old_cap) resets to padding
            for t in self._tabs:
                t[0] = grow(t[0], old_cap, self._cap + 1, NULL, torch.int32)
                t[1] = grow(t[1], old_cap, self._cap + 1, False, torch.bool)
                t[2] = grow(t[2], old_seg, self._seg_cap + 1, NULL,
                            torch.int32)
        # a grown table is a fresh allocation, so this flush cannot have
        # updated device state purely in place
        self._flush_realloc_bytes += sum(
            int(x.nbytes) for t in self._tabs for x in t
        )
        # grow the resident statics on the device (padded at the end, as
        # jnp.pad does: the old scratch column keeps its contents).
        # Allocation is lazy: the apply lane never reads them, so an
        # apply-only engine spends no device memory or transfer on statics
        # (_ensure_statics allocates on the first levels/seq flush)
        if self._stat is not None:
            for st in self._stat:
                for key, fill, _dtype in _STATIC_COLS:
                    old = st[key]
                    st[key] = grow(
                        old, old.shape[1], self._cap + 1, fill, torch.int32
                    )
            self._flush_realloc_bytes += sum(
                int(v.nbytes) for st in self._stat for v in st.values()
            )

    def _ensure_statics(self) -> None:
        if self._stat is not None:
            return
        self._stat = [
            {
                key: torch.full((self._b_loc, self._cap + 1), fill,
                                dtype=torch.int32, device=dev)
                for key, fill, _dtype in _STATIC_COLS
            }
            for dev in self._shard_devs
        ]
        self._flush_realloc_bytes += sum(
            int(v.nbytes) for st in self._stat for v in st.values()
        )
        # everything must (re-)upload into the fresh columns
        self._uploaded_rows = [0] * self.n_docs

    def _upload_statics(self, plans) -> None:
        """Scatter this flush's statics delta (its own dispatch, ahead of
        the levels/seq step that reads it).  Its host time is the
        ``statics`` phase, the host pack within it ``statics_pack``."""
        with self._phase_ctx("statics"):
            self._ensure_statics()
            with self._phase_ctx("statics_pack"):
                packed = self._statics_delta(plans)
            if packed is not None:
                self._dispatch("statics", self._put_shards(packed))

    def _statics_delta(self, plans):
        """This flush's NEW/changed rows as one packed [8, K] i32 block a
        shard (shard-local doc, row, six value columns; client_key as its
        bit pattern; None for a shard without new rows), or None when no
        shard has any.

        A doc's immutable columns only change by appending rows — except
        when a pre-split cuts an existing run (origin_row coverage moves to
        the new fragment) or compaction renumbered the table, which both
        force a full re-upload of that doc."""
        doc_idx: list[np.ndarray] = []
        row_idx: list[np.ndarray] = []
        vals: dict[str, list[np.ndarray]] = {k: [] for k, _f, _d in _STATIC_COLS}
        for i, p in plans.items():
            m = self.mirrors[i]
            n = m.n_rows
            start = 0 if len(p.splits) else self._uploaded_rows[i]
            if n <= start:
                continue
            cols = m.static_columns(start)
            doc_idx.append(np.full(n - start, i, np.int32))
            row_idx.append(np.arange(start, n, dtype=np.int32))
            for k in vals:
                vals[k].append(cols[k])
            self._uploaded_rows[i] = n
        if not doc_idx:
            return None
        d = np.concatenate(doc_idx)
        r = np.concatenate(row_idx)
        v = {}
        for k, _fill, dtype in _STATIC_COLS:
            v[k] = np.concatenate(vals[k])
            if dtype == "uint32":
                v[k] = v[k].astype(np.uint32).view(np.int32)
        n_shards = len(self._shard_devs)
        shard = d // self._b_loc if n_shards > 1 else None
        out = []
        for s in range(n_shards):
            sel = slice(None) if shard is None else shard == s
            total = len(d) if shard is None else int(sel.sum())
            if not total:
                out.append(None)
                continue
            # pad to a lane bucket (bounded distinct shapes, as the JAX
            # engine bounds its compiles); padding lanes write the fills to
            # the scratch row (index cap) of the shard's doc 0, whose
            # contents are never read
            padded = _bucket_lanes(total, 64)
            packed = np.empty((2 + len(_STATIC_COLS), padded), np.int32)
            packed[0, :total] = d[sel] - s * self._b_loc
            packed[0, total:] = 0
            packed[1, :total] = r[sel]
            packed[1, total:] = self._cap
            for j, (k, fill, _dtype) in enumerate(_STATIC_COLS):
                packed[2 + j, :total] = v[k][sel]
                packed[2 + j, total:] = fill
            out.append(packed)
        return out

    # -- compaction ---------------------------------------------------------

    def _maybe_compact(self) -> None:
        """Amortized run-merge + GC: when a doc's table doubles since its
        last compaction, read back its links/deleted bits and rebuild the
        mirror + device state with adjacent runs merged (the engine-side
        analogue of the reference's per-transaction merge/GC passes,
        Transaction.js:165-238,299-332).  Keeps row count bounded by the
        doc's true run structure instead of its edit history."""
        todo = [
            i
            for i, m in enumerate(self.mirrors)
            if i not in self.fallback
            and m.n_rows >= max(self.compact_min_rows, 2 * self._rows_at_compact[i])
        ]
        if not todo or self._tabs is None:
            return
        self.last_compaction = self._compact_rows(todo, self.gc)

    def _compact_rows(self, todo: list[int], gc: bool) -> list[dict]:
        """Rebuild ``todo``'s mirrors compacted and scatter the new rows
        into the device tables; returns per-doc row stats.

        The mirror's host list/deleted state equals the device arrays by
        flush invariant (YTPU_EXPORT_DEVICE pins it), so merges are
        decided WITHOUT any device read-back; the device gets the
        rebuilt rows in one write-only scatter — a gather+readback cycle
        would be the 100k-doc scaling liability."""
        cap1 = self._cap + 1
        seg1 = self._seg_cap + 1
        new_right = np.full((len(todo), cap1), NULL, np.int32)
        new_deleted = np.zeros((len(todo), cap1), bool)
        new_starts = np.full((len(todo), seg1), NULL, np.int32)
        stats = []
        for j, i in enumerate(todo):
            # a fresh rebuild supersedes any still-pending hydration
            self._pending_hydration.pop(i, None)
            m = self.mirrors[i]
            old_n = m.n_rows
            r, d, h = m.rebuild_compacted_self(gc)
            n_new = len(r)
            new_right[j, :n_new] = r
            new_deleted[j, :n_new] = d
            new_starts[j, : len(h)] = h
            self._rows_at_compact[i] = n_new
            self._uploaded_rows[i] = 0  # renumbered: statics re-upload
            stats.append(
                {"doc": i, "rows_before": old_n, "rows_after": n_new}
            )
        self._scatter_rows(todo, new_right, new_deleted, new_starts)
        return stats

    def _scatter_rows(self, todo, new_right, new_deleted, new_starts):
        """Dispatch the whole-row replacement of docs ``todo`` by the host
        rows aligned with it: each shard gets its own docs' rows, indexed
        shard-locally, on its device (one scatter a shard)."""
        todo = np.asarray(todo, np.int64)
        shard = todo // self._b_loc
        args = []
        for s, dev in enumerate(self._shard_devs):
            sel = np.nonzero(shard == s)[0]
            if not len(sel):
                args.append(None)
                continue
            rows = (new_right, new_deleted, new_starts)
            if len(sel) < len(todo):
                rows = tuple(a[sel] for a in rows)
            idx = (todo[sel] - s * self._b_loc).astype(np.int32)
            args.append(tuple(put_host(a, dev) for a in (idx, *rows)))
        self._dispatch("rows", args)

    def compact_docs(self, docs, gc: bool = True) -> list[dict]:
        """Forced tombstone/GC compaction of specific docs (the tier GC
        pass): rebuild their packed columns with gc'able
        deleted runs dropped NOW, regardless of the table-doubling
        heuristic — long-lived hot docs accumulate tombstones that the
        amortized pass never reaches.  Docs on the CPU fallback, with
        queued (unflushed) updates, or with no rows are skipped.
        Returns the same per-doc row stats as ``last_compaction``."""
        todo = [
            i
            for i in docs
            if i not in self.fallback
            and not self.mirrors[i]._incoming
            and self.mirrors[i].n_rows > 0
        ]
        if not todo or self._tabs is None:
            return []
        stats = self._compact_rows(todo, gc)
        self.last_compaction = stats
        return stats

    # -- doc eviction / tiering ---------------------------------------------

    def export_doc_columns(self, doc: int):
        """Detach and return slot ``doc``'s host mirror for warm tiering
        .  The mirror is self-contained host state — packed
        struct-of-arrays columns plus interned payloads, no engine
        references — so the caller can park it off-slot and re-install
        it later with :meth:`hydrate_doc_columns`.  Pair with
        :meth:`reset_doc` to actually free the slot.  Flush first:
        queued updates would stay behind in the slot's log."""
        if doc in self.fallback:
            raise ValueError(
                f"doc {doc} is CPU-served; its columns live in the "
                "fallback doc, not the packed tables"
            )
        if self.mirrors[doc]._incoming:
            raise RuntimeError(
                f"doc {doc} has un-integrated updates; flush before "
                "exporting"
            )
        return self.mirrors[doc]

    def hydrate_doc_columns(self, doc: int, mirror) -> dict:
        """Re-install an exported mirror into the (reset) slot ``doc``
        with NO decode round-trip (warm promotion): the host
        columns are rebuilt compacted and the device scatter is
        DEFERRED — it batches into the next flush dispatch (or the next
        device read-back) alongside any other pending hydrations, so
        the promotion itself is host-only work.  Statics lazily
        re-upload from row 0 on the next flush that needs them."""
        if doc in self.fallback:
            raise ValueError(f"doc {doc} is CPU-served; reset it first")
        if self.mirrors[doc].n_rows or self._update_log[doc]:
            raise RuntimeError(f"slot {doc} is not empty; reset_doc first")
        self._own(mirror)
        self.mirrors[doc] = mirror
        self._update_log[doc] = []
        r, d, h = mirror.rebuild_compacted_self(self.gc)
        self._ensure_capacity(max(1, len(r)), max(1, len(h)))
        self._pending_hydration[doc] = (r, d, h)
        self._rows_at_compact[doc] = len(r)
        self._uploaded_rows[doc] = 0
        if len(r):
            self._active_docs.add(doc)
        return {"rows": len(r), "segs": len(h)}

    def _apply_pending_hydrations(self) -> None:
        """Scatter every deferred hydration into the device tables in
        ONE write-only pass (the ``_compact_rows`` idiom).  Called at
        the top of flush and before any device read-back; a no-op when
        nothing is pending."""
        if not self._pending_hydration:
            return
        pend = self._pending_hydration
        self._pending_hydration = {}
        todo = sorted(pend)
        if self._tabs is None:
            self._ensure_capacity(1, 1)
        cap1 = self._cap + 1
        seg1 = self._seg_cap + 1
        new_right = np.full((len(todo), cap1), NULL, np.int32)
        new_deleted = np.zeros((len(todo), cap1), bool)
        new_starts = np.full((len(todo), seg1), NULL, np.int32)
        for j, i in enumerate(todo):
            r, d, h = pend[i]
            new_right[j, : len(r)] = r
            new_deleted[j, : len(d)] = d
            new_starts[j, : len(h)] = h
        # hydrations land as stage-0 dispatches of the flush pipeline (or
        # immediately before a device read-back): the in-place row scatter
        # sequences ahead of this flush's apply dispatches on the device
        # stream, so the apply kernels always see hydrated rows
        self._scatter_rows(todo, new_right, new_deleted, new_starts)

    def reset_doc(self, doc: int) -> None:
        """Return one slot to its just-constructed state (provider
        release_doc): fresh mirror, empty update log, cleared
        health record, and the device rows blanked to the same fills a
        new engine allocates — the slot's next tenant starts from
        nothing.  The dead-letter queue is NOT touched here (the caller
        decides whether the slot's letters travel with the evicted
        doc)."""
        self.mirrors[doc] = make_mirror(self.root_name, self.device)
        plan_cache.note_invalidation("reset")
        self.fallback.pop(doc, None)
        self._pending_hydration.pop(doc, None)
        self._update_log[doc] = []
        self._uploaded_rows[doc] = 0
        self._rows_at_compact[doc] = 0
        self._active_docs.discard(doc)
        self._event_listeners.pop(doc, None)
        self.health.reset(doc)
        if self._tabs is not None:
            # blank the slot's device rows in place (same fills as the
            # initial allocation); statics re-upload from row 0 is
            # already forced by _uploaded_rows above
            s, li = divmod(doc, self._b_loc)
            right, deleted, starts = self._tabs[s]
            right[li].fill_(NULL)
            deleted[li].fill_(False)
            starts[li].fill_(NULL)

    # -- flush: run one device integration step ----------------------------

    def _phase_ctx(self, name: str, **args):
        """One flush phase: a ``torch.profiler.record_function`` range
        (visible inside an active torch.profiler trace) stacked with an
        obs host span (always recorded, exported via
        export_chrome_trace)."""
        return _PhasePair(
            torch.profiler.record_function(f"ytpu.{name}"),
            self.obs.tracer.span(f"ytpu.{name}", **args),
        )

    def _own(self, mirror) -> None:
        """A Python mirror plans on this engine's device: one replayed
        from the plan cache or hydrated into a slot may come from an
        engine on another device."""
        if type(mirror) is DocMirror:
            mirror.plan_device = self.device

    def _replay_py(self, m, ent):
        """Replay a cached Python-mirror entry onto ``m``, keeping the
        mirror's object identity (engine internals and tests may hold
        references); returns the cached plan's copy."""
        m2, plan = ent.clone()
        m.__dict__.clear()
        m.__dict__.update(m2.__dict__)
        self._own(m)
        return plan

    def _finish_flush(self, metrics: dict) -> None:
        """The single exit point of every flush path: append to the flush
        ring (which serves last_flush_metrics) + update the registry.
        Pipeline bookkeeping lands here so EVERY exit — bulk, levels/seq,
        replay, and the empty flush — emits the full shared schema."""
        pl = self._pl
        metrics["t_pack_overlap_s"] = pl.t_pack_overlap_s
        metrics["t_device_wait_s"] = pl.t_device_wait_s
        metrics["pipeline_depth"] = pl.max_depth
        # donated: every dispatch this flush updated resident tables in
        # place (no B*cap growth allocation anywhere in the flush)
        metrics["flush_donated"] = int(
            pl.n_dispatches > 0 and self._flush_realloc_bytes == 0
        )
        metrics["realloc_bytes"] = self._flush_realloc_bytes
        self.obs.record_flush(metrics, row_capacity=self._cap)
        if self.obs.enabled:
            self._record_device_memory()

    def _record_device_memory(self) -> None:
        """Refresh the ytpu_prof device-memory gauges from the persistent
        device buffers (cost attribution).  Reads tensor metadata only —
        no device sync."""
        if self._tabs is None:
            return
        tables = {
            name: sum(int(t[k].nbytes) for t in self._tabs)
            for k, name in enumerate(("right_link", "deleted", "starts"))
        }
        if self._stat is not None:
            tables["statics"] = sum(
                int(v.nbytes) for st in self._stat for v in st.values()
            )
        self.obs.device_memory(
            tables,
            self.device.type,
            len(self._active_docs) / max(1, self.n_docs),
        )

    def flush(self) -> None:
        with self.obs.tracer.span("ytpu.flush"):
            self._flush()
            # one flush = one health-clock tick (quarantine backoff is
            # counted in flushes, keeping re-admission deterministic)
            self.health.tick()

    def _flush(self) -> None:
        t_start = time.perf_counter()
        # per-flush pipeline counters reset; the staging pair + in-flight
        # markers persist across flushes.  Sync (A/B) mode is re-read per
        # flush so tests can flip YTPU_FLUSH_PIPELINE between flushes.
        self._pl.begin_flush(sync=not _pipeline_on())
        self._flush_realloc_bytes = 0
        # deferred warm-promotion scatters land before anything reads or
        # integrates on top of the device link tables (pipeline stage 0)
        self._apply_pending_hydrations()
        with self._phase_ctx("compact"):
            self._maybe_compact()
        t_compact = time.perf_counter()
        plans = {}
        pre_svs: dict[int, dict[int, int]] = {}
        demoted_now = 0
        rolled_back = 0
        cache_hits = cache_misses = 0
        t_plan_cached = t_plan_cold = 0.0
        plan_fanout = 1  # docs co-planned by one whole-chunk planner call
        emitting = bool(self._update_listeners)
        observing = self._event_listeners
        # kernel selection: "apply" (default) ships the planner's final
        # link values in one conflict-free scatter; "seq" and any other
        # value ("levels") run YATA on the device
        mode = os.environ.get("YTPU_KERNEL")
        if not mode:
            mode = "apply"
        want_levels = mode != "apply"
        # bulk path + native planner: ONE ymx_prepare_many call plans every
        # staged doc (the per-doc ctypes loop dominated distinct-doc
        # flushes); levels/seq and the Python mirror keep the doc loop.
        # Gate on planner availability, not any particular doc's mirror: a
        # demoted doc 0 must not silently disable the fast path fleet-wide
        use_batch = (
            not want_levels
            and native_plan_available()
            and any(isinstance(m, NativeMirror) for m in self.mirrors)
        )
        work: list = []  # batched path: (doc, mirror)
        with self._phase_ctx("plan"):
            if use_batch:
                for i, m in enumerate(self.mirrors):
                    if i in self.fallback or not isinstance(m, NativeMirror):
                        continue
                    if not m._incoming and not m._had_pending:
                        continue  # idle doc: nothing to plan or emit
                    if emitting or i in observing:
                        pre_svs[i] = m.state_vector()
                    work.append((i, m))
                plans = dict(work)  # presence for the empty-flush check
            else:
                cache = plan_cache.get_cache()
                seg_mode = segment_planner.plan_segment_mode()
                # device mode co-plans every cold DocMirror's anchors in
                # ONE batched kernel pass: phase A runs per doc in the
                # loop, the whole-chunk segment plan lands between, phase
                # B finishes per doc below
                chunk_cold: list = []  # (doc, mirror, cache key, phase-A token)
                chunk_keys: set = set()
                # intra-flush duplicates of a chunked doc's key wait for
                # the leader's cache insert and replay it (the per-doc
                # loop gets this for free by inserting before the next
                # lookup)
                chunk_dup: list = []  # (doc, mirror, cache key)
                for i, m in enumerate(self.mirrors):
                    if i in self.fallback:
                        continue
                    if not m._incoming and not m.has_pending():
                        continue  # idle doc: nothing to plan, upload, or emit
                    if emitting or i in observing:
                        pre_svs[i] = m.state_vector()
                    key = ent = None
                    if cache is not None:
                        key = m.plan_key(want_levels)
                        ent = cache.lookup(key)
                    t_d0 = time.perf_counter()
                    if ent is not None:
                        # hit: replay the cached post-prepare snapshot
                        # onto this mirror instead of re-planning
                        if isinstance(m, NativeMirror):
                            plans[i] = m.make_plan(m.adopt_cached(ent))
                        else:
                            plans[i] = self._replay_py(m, ent)
                        cache_hits += 1
                        t_plan_cached += time.perf_counter() - t_d0
                        continue
                    if seg_mode == "device" and type(m) is DocMirror:
                        if key is not None and key in chunk_keys:
                            chunk_dup.append((i, m, key))
                            continue
                        try:
                            token = m.prepare_step_begin()
                        except UnsupportedUpdate as e:
                            self._demote(i, pre_svs.get(i), reason=str(e))
                            demoted_now += 1
                        except kernels.KernelError:
                            raise  # a dead kernel: stop, never demote
                        except Exception as e:
                            if self._strict:
                                raise
                            self._isolate_failure(i, e, pre_svs.get(i))
                            demoted_now += 1
                            rolled_back += 1
                        else:
                            chunk_cold.append((i, m, key, token))
                            if key is not None:
                                chunk_keys.add(key)
                        t_plan_cold += time.perf_counter() - t_d0
                        continue
                    try:
                        plans[i] = m.prepare_step(want_levels=want_levels)
                    except UnsupportedUpdate as e:
                        self._demote(i, pre_svs.get(i), reason=str(e))
                        demoted_now += 1
                    except kernels.KernelError:
                        raise  # a dead kernel: stop, never demote
                    except Exception as e:
                        # malformed bytes (or any integration fault):
                        # roll back and contain THIS doc; the rest of
                        # the batch flushes normally
                        if self._strict:
                            raise
                        self._isolate_failure(i, e, pre_svs.get(i))
                        demoted_now += 1
                        rolled_back += 1
                    else:
                        if key is not None:
                            cache_misses += 1
                            if isinstance(m, NativeMirror):
                                cache.insert_native(key, m, plans[i].counts)
                            else:
                                cache.insert_py(key, m, plans[i])
                    t_plan_cold += time.perf_counter() - t_d0
                if chunk_cold:
                    t_d0 = time.perf_counter()
                    try:
                        seg_plans = segment_planner.plan_chunk(
                            [
                                (t.queries, m._segment_snapshot)
                                for (_i, m, _k, t) in chunk_cold
                            ],
                            mode=seg_mode,
                            mesh=self.mesh,
                            device=self.device,
                        )
                    except kernels.KernelError:
                        raise
                    except Exception:
                        # planner fault: fall back to per-doc planning
                        # in finish (a doc-level fault there still
                        # poisons/demotes only its own doc)
                        seg_plans = ["auto"] * len(chunk_cold)
                    co_planned = sum(
                        1 for (_i, _m, _k, t) in chunk_cold
                        if t.queries is not None
                    )
                    plan_fanout = max(plan_fanout, co_planned)
                    for (i, m, key, token), sp in zip(chunk_cold, seg_plans):
                        try:
                            plans[i] = m.prepare_step_finish(
                                token, sp, want_levels
                            )
                        except UnsupportedUpdate as e:
                            self._demote(i, pre_svs.get(i), reason=str(e))
                            demoted_now += 1
                        except kernels.KernelError:
                            raise  # a dead kernel: stop, never demote
                        except Exception as e:
                            if self._strict:
                                raise
                            self._isolate_failure(i, e, pre_svs.get(i))
                            demoted_now += 1
                            rolled_back += 1
                        else:
                            if key is not None:
                                cache_misses += 1
                                cache.insert_py(key, m, plans[i])
                    t_plan_cold += time.perf_counter() - t_d0
                for i, m, key in chunk_dup:
                    t_d0 = time.perf_counter()
                    ent = cache.lookup(key) if cache is not None else None
                    if ent is not None:
                        plans[i] = self._replay_py(m, ent)
                        cache_hits += 1
                        t_plan_cached += time.perf_counter() - t_d0
                        continue
                    # leader demoted/failed before inserting: plan solo
                    try:
                        plans[i] = m.prepare_step(want_levels=want_levels)
                    except UnsupportedUpdate as e:
                        self._demote(i, pre_svs.get(i), reason=str(e))
                        demoted_now += 1
                    except kernels.KernelError:
                        raise  # a dead kernel: stop, never demote
                    except Exception as e:
                        if self._strict:
                            raise
                        self._isolate_failure(i, e, pre_svs.get(i))
                        demoted_now += 1
                        rolled_back += 1
                    else:
                        cache_misses += 1
                        cache.insert_py(key, m, plans[i])
                    t_plan_cold += time.perf_counter() - t_d0
        t_plan = time.perf_counter()
        # ONE schema (obs.FLUSH_METRICS_SCHEMA) for every exit: each path
        # overwrites only the fields it measures, so the key set cannot
        # drift between the apply/levels/seq/batched/empty-flush paths
        metrics = new_flush_metrics(
            n_demoted=demoted_now,
            n_rolled_back=rolled_back,
            n_fallback_docs=len(self.fallback),
            t_compact_s=t_compact - t_start,
            t_plan_s=t_plan - t_compact,
            t_plan_cached_s=t_plan_cached,
            t_plan_cold_s=t_plan_cold,
            plan_cache_hits=cache_hits,
            plan_cache_misses=cache_misses,
            plan_threads=plan_fanout,
            plan_fastpath_structs=sum(
                getattr(p, "fastpath_structs", 0) or 0
                for p in plans.values()
                if p is not None and not isinstance(p, NativeMirror)
            ),
            plan_segment_fast=sum(
                getattr(p, "segment_fast", 0) or 0
                for p in plans.values()
                if p is not None and not isinstance(p, NativeMirror)
            ),
            plan_segment_residue=sum(
                getattr(p, "segment_residue", 0) or 0
                for p in plans.values()
                if p is not None and not isinstance(p, NativeMirror)
            ),
        )
        if not plans:
            metrics["t_total_s"] = time.perf_counter() - t_start
            self._finish_flush(metrics)
            return
        if use_batch:
            self._flush_bulk(
                work, pre_svs, emitting, metrics, t_start,
                observed=set(observing), native=True,
            )
            return
        if mode == "apply":
            self._flush_bulk(
                sorted(plans.items()), pre_svs, emitting, metrics, t_start,
                native=False,
            )
            return
        self._flush_yata(mode, plans, pre_svs, emitting, metrics, t_start,
                         t_plan)

    def _flush_yata(self, mode, plans, pre_svs, emitting, metrics, t_start,
                    t_plan) -> None:
        """The on-device YATA lanes: pack the plans' splits, causal
        schedules (``seq``) or level schedules (``levels``) and deletes,
        upload the statics delta, and run the step kernel — blockwise over
        the level axis for ``levels``."""
        with self._phase_ctx("pack"), self._pl.pack():
            n_splits = _bucket(
                max((len(p.splits) for p in plans.values()), default=0), 1
            )
            n_sched = _bucket(
                max((len(p.sched) for p in plans.values()), default=0), 1
            )
            n_del = _bucket(
                max((len(p.delete_rows) for p in plans.values()), default=0), 1
            )
            n_lv = _bucket(
                max((p.n_levels for p in plans.values()), default=0), 1
            )
            w_lv = _bucket(
                max((p.max_width for p in plans.values()), default=0), 1
            )
            max_rows = max((p.n_rows for p in plans.values()), default=0)
            max_segs = max(
                (self.mirrors[i].n_segs for i in plans), default=0
            )
            # reserve >= 2*w_lv spare row slots per doc: the level kernel's
            # merged scatter uses two unique scratch lanes per schedule slot
            self._ensure_capacity(max_rows + 2 * w_lv, max_segs)
            b = self.n_docs

            splits = np.full((b, n_splits, 2), NULL, np.int32)
            sched = np.full((b, n_sched, 4), NULL, np.int32)
            lv_sched = np.full((b, n_lv, w_lv, 8), NULL, np.int32)
            dels = np.full((b, n_del), NULL, np.int32)
            for i, p in plans.items():
                if len(p.splits):
                    splits[i, : len(p.splits)] = p.splits
                if len(p.sched):
                    sched[i, : len(p.sched)] = p.sched
                if hasattr(p, "pack_into"):
                    p.pack_into(lv_sched[i])
                else:
                    for lv, entries in enumerate(p.packed_levels()):
                        if entries:
                            lv_sched[i, lv, : len(entries)] = entries
                if len(p.delete_rows):
                    dels[i, : len(p.delete_rows)] = p.delete_rows

            # EVERY doc needs its true row count here — masked scatter lanes
            # land at scratch_base+lane even for docs with no work this
            # flush, and must hit the padding region, not live rows
            scratch_base = np.asarray(
                [m.n_rows for m in self.mirrors], np.int32
            )

            self._upload_statics(plans)
            statics = self._stat
        t_pack = time.perf_counter()
        with self._phase_ctx("dispatch"):
            if mode == "seq":
                self._counters = None  # no sharded counters this flush
                self._dispatch(
                    "seq", statics, self._put_b(splits), self._put_b(sched),
                    self._put_b(dels),
                )
            else:
                # blockwise over the level axis: levels are causally
                # ordered and the device state persists between
                # dispatches, so slicing by level prefix is exact — splits
                # run only in the first block, deletes only in the last.
                # Bounds the padded [B, L, W, 8] transfer and device buffer
                # however long the log is.
                block = max(
                    1,
                    int(os.environ.get("YTPU_BLOCK_LEVELS", "0"))
                    or _block_levels(b, w_lv),
                )
                empty_splits = empty_dels = None
                if n_lv > block:  # multi-block: cache the no-op inputs
                    empty_splits = self._put_b(
                        np.full((b, 1, 2), NULL, np.int32)
                    )
                    empty_dels = self._put_b(np.full((b, 1), NULL, np.int32))
                scratch_d = self._put_b(scratch_base)
                self._counters = None  # the level blocks' counters add up
                for c0 in range(0, n_lv, block):
                    c1 = min(n_lv, c0 + block)
                    self._dispatch(
                        "levels",
                        statics,
                        self._put_b(splits) if c0 == 0 else empty_splits,
                        self._put_b(lv_sched[:, c0:c1]),
                        self._put_b(dels) if c1 == n_lv else empty_dels,
                        scratch_d,
                    )
        t_dispatch = time.perf_counter()

        with self._phase_ctx("emit"):
            self._emit_phase(plans, pre_svs, emitting)
        t_emit = time.perf_counter()

        n_sched_entries = sum(len(p.sched8) for p in plans.values())
        lv_slots = b * n_lv * w_lv
        pending_docs = [i for i in plans if self.mirrors[i].has_pending()]
        metrics.update({
            "n_docs_flushed": sum(
                1
                for p in plans.values()
                if len(p.sched8) or len(p.splits) or len(p.delete_rows)
            ),
            "n_rows_max": max_rows,
            "n_sched_entries": n_sched_entries,
            "n_levels": n_lv,
            "level_width": w_lv,
            # fraction of the padded [B, L, W] schedule that is real work
            "schedule_occupancy": n_sched_entries / lv_slots if lv_slots else 0.0,
            "n_pending_docs": len(pending_docs),
            "pending_depth": sum(
                self.mirrors[i].pending_depth() for i in pending_docs
            ),
            "t_pack_s": t_pack - t_plan,
            "t_dispatch_s": t_dispatch - t_pack,
            "t_emit_s": t_emit - t_dispatch,
            "t_total_s": t_emit - t_start,
        })
        self._finish_flush(metrics)

    def _emit_phase(self, plans, pre_svs, emitting, observed=None) -> None:
        """Post-dispatch host work shared by both dispatch paths: update-log
        compaction + doc.on('update') novelty emission (overlaps the async
        device execution).  ``observed`` restricts event computation to a
        prepare-time listener snapshot (the batched path may not have
        built plan.sched for docs unobserved at prepare)."""
        if self.health.tracked:
            # every doc that reached emit integrated cleanly this flush
            for i in plans:
                self.health.record_success(i)
        for i in plans:
            m = self.mirrors[i]
            if len(self._update_log[i]) > 64 and not m.has_pending():
                self._update_log[i] = [(m.encode_state_as_update(), False)]
        if emitting:
            for i, p in plans.items():
                u = self.mirrors[i].encode_step_update(pre_svs[i], p)
                if u is not None:
                    self._emit(i, u)
        if self._event_listeners:
            from .events import compute_flush_events

            for i, p in plans.items():
                if observed is not None and i not in observed:
                    continue
                cbs = self._event_listeners.get(i)
                if not cbs:
                    continue
                events = compute_flush_events(
                    self.mirrors[i], p, pre_svs[i]
                )
                if events:
                    for cb in cbs:
                        cb(i, events)

    def _dispatch(self, kind, *args, slot=None):
        """THE one flush dispatch path: every device mutation of the
        resident tables — bulk lanes (per-doc python plans, native
        batched plans, and cached-plan replay alike), the levels/seq YATA
        step, the statics delta scatter, and whole-row rebuild scatters
        (compaction, deferred hydration) — funnels
        through here, so the pipeline bookkeeping (in-flight markers,
        staging-buffer fences, sync A/B mode) and any future kernel
        change land exactly once.

        kinds (every array argument is a list with one entry a shard, on
        its device; doc indices are shard-local):
          "lanes"   (lanes, key)                    bulk-apply scatter
          "seq"     (statics, splits, sched, dels)  sequential YATA step
          "levels"  (statics, splits, lv_block, dels, scratch)  one
                    level-axis block (sharded or not; a mesh's progress
                    counters add up across blocks)
          "statics" (packed,)                       resident-column delta
          "rows"    (args,)                         whole-row rebuild:
                    (idx, right, deleted, starts) a shard, or None

        ``slot`` is the staging buffer a "lanes" dispatch consumes: its
        rows are copied to the shards' devices here and fenced for reuse.
        The other kinds' args are already device-placed by the caller."""
        tabs = [tuple(t) for t in self._tabs]
        if kind == "lanes":
            lanes, key = args
            k_dn, k_sp, k_h, k_d = key
            rows = (
                self._put_staged(slot) if slot is not None
                else self._put_b(lanes)
            )
            self._counters = None
            if self.mesh is not None:
                fn = self._sharded_apply.get(key)
                if fn is None:
                    fn = sharded_apply_plan(
                        self.mesh, self.mesh.axis_names[0], *key
                    )
                    self._sharded_apply[key] = fn
                _, self._counters = fn(tabs, rows)
            else:
                kernels.apply_plan2(tabs[0], rows[0], k_dn, k_sp, k_h, k_d)
        elif kind == "seq":
            statics, splits, sched, dels = args
            for s, dyn in enumerate(tabs):
                kernels.batch_step(statics[s], dyn, splits[s], sched[s],
                                   dels[s])
        elif kind == "levels":
            if self._sharded_step is not None:
                # counters stay on the device (reading them would block
                # the async dispatch); they add up across level blocks
                _, self._counters = self._sharded_step(
                    args[0], tabs, *args[1:], counters=self._counters
                )
            else:
                kernels.batch_step_levels(
                    args[0][0], tabs[0], *(a[0] for a in args[1:])
                )
        elif kind == "statics":
            (packed,) = args
            for st, p in zip(self._stat, packed):
                if p is not None:
                    kernels.scatter_statics(st, p)
        elif kind == "rows":
            (per_shard,) = args
            for dyn, a in zip(tabs, per_shard):
                if a is not None:
                    kernels.scatter_rows(*dyn, *a)
        else:  # pragma: no cover - programming error
            raise ValueError(f"unknown dispatch kind {kind!r}")
        self._pl.dispatched(self._marker(), slot)

    def _flush_bulk(
        self, items, pre_svs, emitting, metrics, t_start,
        observed=frozenset(), native=True,
    ):
        """ONE bulk flush path: native batched
        plans (ymx_prepare_many / ymx_pack_apply), per-doc python plans,
        and cached-plan replay all stream through the same chunked
        pack -> dispatch pipeline.  Chunk k+1's host-side work (plan +
        pack into the double-buffered staging pair) overlaps chunk k's
        asynchronous copy and kernels, and the apply kernels update the
        resident tables in place — steady-state flushes neither
        reallocate B*cap buffers nor block the host on the device.
        YTPU_FLUSH_PIPELINE=0 restores the synchronous A/B lane (every
        dispatch blocks); output is byte-identical either way.

        ``items``: ``(doc, NativeMirror)`` pairs when ``native`` (planned
        here, chunk by chunk), ``(doc, plan)`` pairs otherwise (planned
        by _flush's plan phase, already doc-ordered)."""
        pl = self._pl
        chunk_sz = int(os.environ.get("YTPU_FLUSH_CHUNK", "256"))
        # the lanes buffer has one row a doc shard (one without a mesh)
        n_shards = len(self._shard_devs)
        b_loc = self._b_loc
        t_plan_acc = t_pack_acc = t_disp_acc = 0.0
        seg_base = plan_segment_stats() if native else (0, 0)
        stats_tot = np.zeros(4, np.int64)
        lanes_padded_tot = 0
        work_ok: list = []  # native: (doc, mirror, counts); py: (doc, plan)
        max_rows_all = 0
        acc = SimpleNamespace(
            cache=plan_cache.get_cache() if native else None,
            # events read plan.sched; skip building it otherwise
            want_sched=bool(self._event_listeners),
            cfg_threads=_native_plan_threads() if native else 1,
            plan_threads=1,
            cache_hits=0,
            cache_misses=0,
            t_cached=0.0,
            t_cold=0.0,
            demoted=metrics["n_demoted"],
            rolled_back=metrics["n_rolled_back"],
        )
        for c0 in range(0, len(items), chunk_sz):
            chunk = items[c0 : c0 + chunk_sz]
            t0 = time.perf_counter()
            if native:
                with self._phase_ctx("plan", chunk=c0 // chunk_sz,
                                     docs=len(chunk)):
                    chunk_ok = self._plan_chunk_native(chunk, pre_svs, acc)
            else:
                chunk_ok = chunk
            t1 = time.perf_counter()
            t_plan_acc += t1 - t0
            if not chunk_ok:
                continue
            with self._phase_ctx("pack", chunk=c0 // chunk_sz), pl.pack():
                if native:
                    slot, key, stats, max_rows = self._pack_chunk_native(
                        chunk_ok, b_loc, n_shards
                    )
                else:
                    slot, key, stats, max_rows = self._pack_chunk_py(
                        chunk_ok, b_loc, n_shards
                    )
                stats_tot += stats
                max_rows_all = max(max_rows_all, max_rows)
                lanes_padded_tot += n_shards * sum(key)
                # the apply lane never reads the device statics; mark touched
                # docs for full (re-)upload if a levels/seq flush ever runs
                for t in chunk_ok:
                    self._uploaded_rows[t[0]] = 0
                work_ok.extend(chunk_ok)
            t2 = time.perf_counter()
            t_pack_acc += t2 - t1
            # async dispatch: the device copies and scatters this chunk's
            # staged lanes while the next loop iteration plans and packs
            # on the host (the slot's copy event fences its buffer)
            with self._phase_ctx("dispatch", chunk=c0 // chunk_sz):
                self._dispatch("lanes", slot.buf, key, slot=slot)
            t_disp_acc += time.perf_counter() - t2
        metrics["n_demoted"] = acc.demoted
        metrics["n_rolled_back"] = acc.rolled_back
        t_dispatch = time.perf_counter()
        with self._phase_ctx("emit"):
            if native:
                # real plan objects only where the emit phase will read
                # them: every doc when update listeners exist, observed
                # docs for events; the log-compaction walk touches keys
                # only.  The observed set is the PREPARE-TIME snapshot: a
                # listener registered mid-flush (e.g. from an update
                # callback) sees events from the next flush — plan.sched
                # for this one may not have been built (want_sched gate)
                plans = {
                    i: (m.make_plan(c) if emitting or i in observed else None)
                    for i, m, c in work_ok
                }
                self._emit_phase(plans, pre_svs, emitting, observed=observed)
            else:
                self._emit_phase(dict(work_ok), pre_svs, emitting)
        t_emit = time.perf_counter()

        if native:
            counts = (
                np.stack([c for _, _, c in work_ok])
                if work_ok
                else np.zeros((0, 16), np.int64)
            )
            n_flushed = int(
                ((counts[:, 12] > 0) | (counts[:, 13] > 0)
                 | (counts[:, 6] > 0)).sum()
            )
            pending_mask = counts[:, 8] == 1
            n_pending = int(pending_mask.sum())
            pending_depth = int(counts[pending_mask, 9].sum())
        else:
            n_flushed = sum(
                1
                for _, p in work_ok
                if len(p.link_rows) or len(p.head_segs) or len(p.delete_rows)
            )
            pending = [
                i for i, _ in work_ok if self.mirrors[i].has_pending()
            ]
            n_pending = len(pending)
            pending_depth = sum(
                self.mirrors[i].pending_depth() for i in pending
            )
        n_dense, n_sparse, n_heads, n_dels = (int(x) for x in stats_tot)
        lanes_real = n_dense + n_sparse + n_heads + n_dels
        metrics.update({
            "n_docs_flushed": n_flushed,
            "n_rows_max": max_rows_all,
            "n_sched_entries": n_dense + n_sparse,
            "n_levels": 1,
            "level_width": n_dense + n_sparse,
            # bulk path: fraction of dispatched scatter lanes that are real
            "schedule_occupancy": (
                lanes_real / lanes_padded_tot if lanes_padded_tot else 0.0
            ),
            "n_pending_docs": n_pending,
            "pending_depth": pending_depth,
            "t_pack_s": t_pack_acc,
            "t_dispatch_s": t_disp_acc,
            "t_emit_s": t_emit - t_dispatch,
            "t_total_s": t_emit - t_start,
        })
        if native:
            metrics.update({
                "t_plan_s": t_plan_acc,
                "t_plan_cached_s": acc.t_cached,
                "t_plan_cold_s": acc.t_cold,
                "plan_cache_hits": acc.cache_hits,
                "plan_cache_misses": acc.cache_misses,
                # widest worker pool any prepare batch in this flush
                # actually used — min(configured width, docs in the
                # batch); 1 when every doc was served from the plan cache
                "plan_threads": acc.plan_threads,
            })
            seg_now = plan_segment_stats()
            metrics["plan_segment_fast"] = max(0, seg_now[0] - seg_base[0])
            metrics["plan_segment_residue"] = max(
                0, seg_now[1] - seg_base[1]
            )
        self._finish_flush(metrics)

    def _plan_chunk_native(self, chunk, pre_svs, acc):
        """Plan one chunk of ``(doc, NativeMirror)`` work: cache hits
        adopt the cached post-prepare snapshot, cold group leaders plan
        via ONE ymx_prepare_many call, trailing same-key members clone
        their leader.  Per-doc error policy (demote / rollback) matches
        the python plan loop exactly; ``acc`` accumulates plan-phase
        bookkeeping across chunks.  Returns the surviving
        ``(doc, mirror, counts)`` triples in ascending doc order."""
        cache = acc.cache
        want_sched = acc.want_sched
        chunk_ok: list = []
        hits: list = []    # (doc, mirror, entry)
        cold: list = []    # (doc, mirror, key) — group leaders
        groups: dict = {}  # key -> trailing same-key members
        if cache is not None:
            for i, m in chunk:
                key = m.plan_key(False, want_sched)
                g = groups.get(key)
                if g is not None:
                    # intra-chunk duplicate (broadcast fan-out):
                    # cloned from the leader after it plans
                    g.append((i, m))
                    continue
                ent = cache.lookup(key)
                if ent is not None:
                    hits.append((i, m, ent))
                else:
                    groups[key] = []
                    cold.append((i, m, key))
        else:
            cold = [(i, m, None) for i, m in chunk]
        th0 = time.perf_counter()
        for i, m, ent in hits:
            chunk_ok.append((i, m, m.adopt_cached(ent)))
        acc.cache_hits += len(hits)
        acc.t_cached += time.perf_counter() - th0
        retry: list = []  # members whose leader failed
        if cold:
            tc0 = time.perf_counter()
            acc.cache_misses += len(cold)
            acc.plan_threads = max(
                acc.plan_threads, min(acc.cfg_threads, len(cold))
            )
            counts_all, rcs, staged_info = prepare_many(
                [(i, m) for i, m, _k in cold],
                want_levels=False,
                want_sched=want_sched,
                obs=self.obs,
            )
            for k, (i, m, key) in enumerate(cold):
                try:
                    m._finish_prepare(
                        int(rcs[k]), staged_info[k][0],
                        staged_info[k][1], counts_all[k],
                    )
                except UnsupportedUpdate as e:
                    self._demote(i, pre_svs.get(i), reason=str(e))
                    acc.demoted += 1
                    retry.extend(groups.get(key, ()))
                except Exception as e:
                    if self._strict:
                        raise
                    self._isolate_failure(i, e, pre_svs.get(i))
                    acc.demoted += 1
                    acc.rolled_back += 1
                    retry.extend(groups.get(key, ()))
                else:
                    chunk_ok.append((i, m, counts_all[k]))
                    members = groups.get(key)
                    if members:
                        # identical frontier + staged bytes plan
                        # identically: clone the leader's live
                        # post-prepare state instead of
                        # re-walking each member
                        th1 = time.perf_counter()
                        src = SimpleNamespace(
                            h=m._h,
                            counts=counts_all[k],
                            pins=m._py_bufs,
                            frontier_after=m.plan_frontier,
                        )
                        for j, mj in members:
                            chunk_ok.append(
                                (j, mj, mj.adopt_cached(src))
                            )
                        acc.cache_hits += len(members)
                        plan_cache.note_hits(len(members))
                        acc.t_cached += time.perf_counter() - th1
                    if key is not None:
                        # post-prepare, pre-pack: the snapshot a
                        # future hit adopts before running the
                        # pack/dispatch phases itself
                        cache.insert_native(key, m, counts_all[k])
            acc.t_cold += time.perf_counter() - tc0
        if retry:
            # a leader's demote/isolate says nothing about its
            # members under the per-doc error policy — plan each
            # individually, exactly as a cache-off flush would
            tc0 = time.perf_counter()
            acc.cache_misses += len(retry)
            plan_cache.note_misses(len(retry))
            acc.plan_threads = max(
                acc.plan_threads, min(acc.cfg_threads, len(retry))
            )
            counts2, rcs2, staged2 = prepare_many(
                retry, want_levels=False, want_sched=want_sched,
                obs=self.obs,
            )
            for k, (i, m) in enumerate(retry):
                try:
                    m._finish_prepare(
                        int(rcs2[k]), staged2[k][0], staged2[k][1],
                        counts2[k],
                    )
                except UnsupportedUpdate as e:
                    self._demote(i, pre_svs.get(i), reason=str(e))
                    acc.demoted += 1
                except Exception as e:
                    if self._strict:
                        raise
                    self._isolate_failure(i, e, pre_svs.get(i))
                    acc.demoted += 1
                    acc.rolled_back += 1
                else:
                    chunk_ok.append((i, m, counts2[k]))
            acc.t_cold += time.perf_counter() - tc0
        # hit/leader/member completion order is cache-dependent;
        # pack and emit must see the same doc order either way
        chunk_ok.sort(key=lambda t: t[0])
        return chunk_ok

    def _pack_chunk_native(self, chunk_ok, b_loc, n_shards):
        """Stage one planned native chunk: grow capacity, size the
        per-shard lane widths, pick the int16 downshift, and run the
        native pack (ymx_pack_apply) writing straight into the acquired
        staging buffer.  Returns ``(slot, key, stats, max_rows)``."""
        counts = np.stack([c for _, _, c in chunk_ok])
        doc_idx = np.asarray([i for i, _, _ in chunk_ok], np.int64)
        max_rows = int(counts[:, 0].max(initial=0))
        self._ensure_capacity(
            max_rows, int(counts[:, 11].max(initial=0))
        )
        oob_r = int(self._cap + 1)
        oob_s = int(self._seg_cap + 1)
        shard = doc_idx // b_loc
        link = counts[:, 12]
        dense = counts[:, 14].astype(bool)

        def shard_max(values, mask, minimum, shard=shard):
            sums = np.bincount(
                shard[mask], weights=values[mask].astype(np.float64),
                minlength=n_shards,
            )
            return _bucket_lanes(int(sums.max(initial=0)), minimum)

        all_mask = np.ones(len(chunk_ok), bool)
        k_dn = shard_max(link, dense, 64)
        k_sp = shard_max(link, ~dense, 64)
        k_h = shard_max(counts[:, 13], all_mask, 8)
        k_d = shard_max(counts[:, 6], all_mask, 64)
        # int16 lanes when every index/count fits: half the flush
        # bytes over the host->device link (the distinct-path
        # bottleneck on tunneled backends)
        lane_dtype = (
            np.int16
            if max(oob_r, oob_s, int(link.max(initial=0))) <= 32767
            else np.int32
        )
        key = (k_dn, k_sp, k_h, k_d)
        lane_w = 4 * b_loc + k_dn + 2 * k_sp + 2 * k_h + k_d
        slot = self._pl.acquire((n_shards, lane_w), lane_dtype)
        lanes, stats = pack_apply_lanes(
            chunk_ok, doc_idx, b_loc, n_shards, key,
            oob_r, oob_s, int(NULL), lane_dtype, out=slot.buf,
        )
        if lanes is not slot.buf:  # the dispatch copies slot.host
            raise RuntimeError("lanes were not packed into the staging slot")
        return slot, key, stats, max_rows

    def _pack_chunk_py(self, chunk_ok, b_loc, n_shards):
        """Python-mirror twin of :meth:`_pack_chunk_native`: bin one
        chunk of ``(doc, plan)`` pairs into the same counts-header +
        lanes layout (host-resolved YATA; see DocMirror._list_insert /
        plancore.cpp list_insert), packing into the acquired staging
        buffer.  Returns ``(slot, key, stats, max_rows)``.

        Per-doc counts ride in the lanes header; doc ids and dense row
        indices are derived ON DEVICE (kernels.apply_plan2), so the
        transfer carries the minimum: full-table ("dense") link loads
        ship values only.  One binning "shard" on a single device; the
        mesh path bins per device shard so each scatters its own lanes
        locally."""
        max_rows = max((p.n_rows for _, p in chunk_ok), default=0)
        max_segs = max(
            (self.mirrors[i].n_segs for i, _ in chunk_ok), default=0
        )
        self._ensure_capacity(max_rows, max_segs)
        oob_r = np.int32(self._cap + 1)
        counts = np.zeros((n_shards, 4, b_loc), np.int32)
        dense = [[] for _ in range(n_shards)]
        sp_r = [[] for _ in range(n_shards)]
        sp_v = [[] for _ in range(n_shards)]
        hd_s = [[] for _ in range(n_shards)]
        hd_v = [[] for _ in range(n_shards)]
        dl_r = [[] for _ in range(n_shards)]
        for i, p in chunk_ok:
            s, li = divmod(i, b_loc)
            k = len(p.link_rows)
            rows = np.asarray(p.link_rows, np.int32)
            vals = np.asarray(p.link_vals, np.int32)
            if k and k == p.n_rows and rows[-1] == k - 1:
                counts[s, 0, li] = k
                dense[s].append(vals)
            elif k:
                counts[s, 1, li] = k
                sp_r[s].append(rows)
                sp_v[s].append(vals)
            hn = len(p.head_segs)
            if hn:
                counts[s, 2, li] = hn
                hd_s[s].append(np.asarray(p.head_segs, np.int32))
                hd_v[s].append(np.asarray(p.head_vals, np.int32))
            dn = len(p.delete_rows)
            if dn:
                counts[s, 3, li] = dn
                dl_r[s].append(np.asarray(p.delete_rows, np.int32))

        def widths(parts_by_shard, minimum):
            return _bucket_lanes(
                max(
                    (sum(len(a) for a in parts) for parts in parts_by_shard),
                    default=0,
                ),
                minimum,
            )

        k_dn = widths(dense, 64)
        k_sp = widths(sp_r, 64)
        k_h = widths(hd_s, 8)
        k_d = widths(dl_r, 64)
        oob_s = np.int32(self._seg_cap + 1)

        def fill(out, parts, pad_val):
            flat = (
                np.concatenate(parts) if parts else np.zeros(0, np.int32)
            )
            out[: len(flat)] = flat
            out[len(flat):] = pad_val
            return len(flat)

        lane_w = 4 * b_loc + k_dn + 2 * k_sp + 2 * k_h + k_d
        slot = self._pl.acquire((n_shards, lane_w), np.int32)
        lanes = slot.buf
        n_dense = n_sparse = n_heads = n_dels = 0
        for s in range(n_shards):
            o = 0
            lanes[s, : 4 * b_loc] = counts[s].ravel()
            o = 4 * b_loc
            n_dense += fill(lanes[s, o : o + k_dn], dense[s], NULL)
            o += k_dn
            n_sparse += fill(lanes[s, o : o + k_sp], sp_r[s], oob_r)
            fill(lanes[s, o + k_sp : o + 2 * k_sp], sp_v[s], NULL)
            o += 2 * k_sp
            n_heads += fill(lanes[s, o : o + k_h], hd_s[s], oob_s)
            fill(lanes[s, o + k_h : o + 2 * k_h], hd_v[s], NULL)
            o += 2 * k_h
            n_dels += fill(lanes[s, o : o + k_d], dl_r[s], oob_r)
        stats = np.asarray([n_dense, n_sparse, n_heads, n_dels], np.int64)
        return slot, (k_dn, k_sp, k_h, k_d), stats, max_rows

    @property
    def last_metrics(self) -> dict | None:
        """Global progress counters of the last sharded flush:
        ``integrated`` (apply lane: dense plus sparse links; levels:
        schedule lanes) and ``deleted``, each shard's device counter
        summed by the shard-fold kernel when read (the reference's psum;
        reading synchronises).  None after an unsharded or ``seq``
        flush."""
        if self._counters is None:
            return None
        return fold_metrics(self._counters)

    @property
    def last_flush_metrics(self) -> dict | None:
        """Host-side per-phase timers + batch stats of the newest flush —
        the compatibility view over the obs flush-history ring (the SAME
        dict object as ``obs.history.latest``; the ring keeps the last
        ``YTPU_OBS_HISTORY`` flushes)."""
        return self.obs.history.latest

    # -- observability exposition -------------------------------------------

    def metrics_text(self) -> str:
        """Prometheus exposition-format dump of the engine registry merged
        with the process-global one (sync protocol counters)."""
        return self.obs.metrics_text()

    def metrics_snapshot(self) -> dict:
        """JSON-able snapshot: registry contents + newest flush metrics +
        the full flush-history ring."""
        return self.obs.snapshot()

    def export_chrome_trace(self) -> dict:
        """Chrome-trace JSON of recorded host spans — loadable by Perfetto
        / chrome://tracing.  Complements torch.profiler device traces."""
        return self.obs.tracer.chrome_trace()

    def save_trace(self, path: str) -> str:
        """Write export_chrome_trace() to ``path``; returns the path."""
        return self.obs.tracer.save(path)

    # -- exports ------------------------------------------------------------

    def state_vector(self, doc: int) -> dict[int, int]:
        fb = self.fallback.get(doc)
        if fb is not None:
            from ..core import get_state_vector

            return {c: v for c, v in get_state_vector(fb.store).items()}
        return self.mirrors[doc].state_vector()

    def _order(self, doc: int, seg: int) -> tuple[np.ndarray, np.ndarray]:
        """Segment-order row ids + deleted flags for one doc's segment.

        Host path (default): walk the planner's linked list — no device
        round trip per export.
        Device path (export_from_device): rank the doc's resident right
        links with the pointer-doubling kernel and read back — exports
        then PROVE the device state, which is how the test suite runs.
        """
        m = self.mirrors[doc]
        if not self.export_from_device:
            rows_l: list = []
            dele_l: list = []
            host_deleted = m._host_deleted_rows
            nxt = m.list_next
            r = m.head_of_seg[seg] if seg < len(m.head_of_seg) else NULL
            while r != NULL:
                r = int(r)
                rows_l.append(r)
                dele_l.append(r in host_deleted)
                r = nxt[r]
            return np.asarray(rows_l, np.int64), np.asarray(dele_l, bool)
        if self._tabs is None:
            return np.zeros(0, np.int64), np.zeros(0, bool)
        self._apply_pending_hydrations()  # device read-back must see them
        s, li = divmod(doc, self._b_loc)  # the doc's row on its shard
        right, deleted_t, _starts = self._tabs[s]
        valid_host = np.zeros(right.shape[1], bool)
        n = m.n_rows
        if n:
            valid_host[:n] = np.asarray(m.row_seg[:n], np.int32) == seg
        d = kernels.list_ranks(
            right[li : li + 1], put_host(valid_host[None], right.device)
        )[0].cpu().numpy()
        deleted = deleted_t[li].cpu().numpy()
        rows = np.nonzero(d >= 0)[0]
        # larger distance-to-tail = earlier in the document
        rows = rows[np.argsort(-d[rows], kind="stable")]
        return rows, deleted[rows]

    def rows_in_order(
        self, doc: int, name: str | None = None
    ) -> list[tuple[int, int, int, bool]]:
        """(client, clock, length, deleted) per row in list order of one root
        type — the convergence-oracle view (mirrors compare_struct_stores)."""
        name = name or self.root_name
        fb = self.fallback.get(doc)
        if fb is not None:
            out = []
            item = fb.get_text(name)._start
            while item is not None:
                out.append((item.id.client, item.id.clock, item.length, item.deleted))
                item = item.right
            return out
        m = self.mirrors[doc]
        seg = m.segments.get((name, None, NULL))
        if seg is None:
            return []
        rows, dels = self._order(doc, seg)
        return [
            (
                m.client_of_slot[m.row_slot[r]],
                m.row_clock[r],
                m.row_len[r],
                bool(d),
            )
            for r, d in zip(rows, dels)
        ]

    def text(self, doc: int, name: str | None = None) -> str:
        """Materialize the content of one root text/list type."""
        name = name or self.root_name
        fb = self.fallback.get(doc)
        if fb is not None:
            return fb.get_text(name).to_string()
        m = self.mirrors[doc]
        seg = m.segments.get((name, None, NULL))
        if seg is None:
            return ""
        rows, dels = self._order(doc, seg)
        return visible_text(m, rows, dels)

    def to_delta(
        self,
        doc: int,
        name: str | None = None,
        snapshot=None,
        prev_snapshot=None,
        compute_ychange=None,
    ) -> list:
        """Attributed rich-text delta of one root text type, straight from
        the mirror (reference YText.toDelta, YText.js:936-1030): format
        runs toggle current_attributes, strings/embeds emit insert ops —
        no CPU-doc replay needed for rich-text consumers.

        With ``snapshot`` (and optionally ``prev_snapshot``), renders the
        point-in-time / two-snapshot diff view with ``ychange``
        attribution (reference YText.js:936-1030 toDelta(snapshot,
        prevSnapshot, computeYChange)) for DEVICE-RESIDENT rooms — the
        mirror keeps deleted runs' content (engine default gc=False), so
        history renders without demoting the doc."""
        name = name or self.root_name
        fb = self.fallback.get(doc)
        if fb is not None:
            return fb.get_text(name).to_delta(
                snapshot, prev_snapshot, compute_ychange
            )
        m = self.mirrors[doc]
        seg = m.segments.get((name, None, NULL))
        if seg is None:
            return []
        if snapshot is None and prev_snapshot is None:
            return self._delta_of_seg(doc, seg)
        return self._delta_of_seg_snapshot(
            doc, seg, snapshot, prev_snapshot, compute_ychange
        )

    # -- relative positions (cursors) from mirror columns -------------------

    def relative_position_from_index(self, doc: int, index: int,
                                     name: str | None = None):
        """Stable cursor for one root type of a device-resident room,
        computed from mirror columns alone — no CPU-doc materialization,
        no device round trip (reference RelativePosition.js:85-104
        createRelativePositionFromTypeIndex).  Returns a standard
        :class:`~yjs_tpu.utils.relative_position.RelativePosition`
        (encode/decode/JSON interop with JS peers applies)."""
        from ..ids import create_id
        from ..utils.relative_position import (
            RelativePosition,
            create_relative_position_from_type_index,
        )

        name = name or self.root_name
        fb = self.fallback.get(doc)
        if fb is not None:
            # type-agnostic root access: the mirror branch below walks
            # segment rows without caring about the root's kind, so the
            # demoted branch must too (get_text on an already-typed
            # array/xml root raises)
            return create_relative_position_from_type_index(
                fb.get(name), index
            )
        m = self.mirrors[doc]
        seg = m.segments.get((name, None, NULL))
        if seg is not None:
            rows, dels = self._order(doc, seg)
            for r, d in zip(rows, dels):
                r = int(r)
                if d or not m.row_countable[r]:
                    continue
                ln = int(m.row_len[r])
                if ln > index:
                    client = m.client_of_slot[int(m.row_slot[r])]
                    return RelativePosition(
                        None, name, create_id(client, int(m.row_clock[r]) + index)
                    )
                index -= ln
        return RelativePosition(None, name, None)

    def _row_of_id(self, m, client: int, clock: int) -> int | None:
        """Row containing (client, clock) via the mirror fragment index,
        or None when that clock is not integrated yet (reference
        getItem/findIndexSS semantics against columnar state)."""
        slot = m.slot_of_client.get(client)
        if slot is None or m.state[slot] <= clock:
            return None
        fi = m._frag_containing(slot, clock)
        return None if fi is None else int(m.frag_row[slot][fi])

    def absolute_index_from_relative(self, doc: int, rpos) -> int | None:
        """Resolve a cursor back to a list index against the room's
        CURRENT state, from mirror columns alone (reference
        RelativePosition.js:214-262
        createAbsolutePositionFromRelativePosition).  Returns None when
        the anchor is unknown (not yet integrated / garbage collected),
        exactly like the reference.

        Deviation (documented): the return value is the index alone —
        on the engine path the type handle is the (doc, root-name) pair
        the caller already holds, not a live Y type object.  ``redone``
        chains are a CPU-replica concept (the pointers are local to the
        undoing replica and never on the wire), so the mirror path has
        none to follow; rooms with server-side undo enabled resolve
        through their replica instead (see TpuProvider
        .resolve_relative_position), which runs the reference
        follow-redone walk verbatim."""
        from ..utils.relative_position import (
            create_absolute_position_from_relative_position,
        )

        fb = self.fallback.get(doc)
        if fb is not None:
            a = create_absolute_position_from_relative_position(rpos, fb)
            return None if a is None else a.index
        m = self.mirrors[doc]

        def visible_len(seg: int) -> int:
            rows, dels = self._order(doc, seg)
            tot = 0
            for r, d in zip(rows, dels):
                r = int(r)
                if not d and m.row_countable[r]:
                    tot += int(m.row_len[r])
            return tot

        if rpos.item is not None:
            r = self._row_of_id(m, rpos.item.client, rpos.item.clock)
            if r is None or m.row_is_gc[r]:
                # unknown clock or GC'd anchor: reference returns null
                # (followRedone landed on a GC struct)
                return None
            seg = int(m.row_seg[r])
            _name, _sub, parent = m.seg_info[seg]
            if parent != NULL and parent in m._host_deleted_rows:
                # parent type deleted: reference keeps index 0
                return 0
            deleted = r in m._host_deleted_rows
            index = (
                0
                if (deleted or not m.row_countable[r])
                else rpos.item.clock - int(m.row_clock[r])
            )
            rows, dels = self._order(doc, seg)
            for rr, dd in zip(rows, dels):
                rr = int(rr)
                if rr == r:
                    return index
                if not dd and m.row_countable[rr]:
                    index += int(m.row_len[rr])
            return None  # anchor row not reachable in its segment
        if rpos.tname is not None:
            seg = m.segments.get((rpos.tname, None, NULL))
            # absent root = empty type (reference doc.get(tname)._length)
            return 0 if seg is None else visible_len(seg)
        if rpos.type is not None:
            r = self._row_of_id(m, rpos.type.client, rpos.type.clock)
            if r is None or m.row_is_gc[r] or int(m.row_content_ref[r]) != 7:
                return None
            seg = m.segments.get((None, None, r))
            return 0 if seg is None else visible_len(seg)
        raise ValueError("invalid relative position")

    def snapshot(self, doc: int):
        """Point-in-time capture (state vector + delete set) of one room,
        straight from the mirror — no CPU-doc materialization, no device
        round trip (reference Snapshot.js:118-121 snapshot()).  The
        result is a standard :class:`~yjs_tpu.utils.snapshot.Snapshot`:
        encode/decode/equality and createDocFromSnapshot interop apply."""
        from ..utils.snapshot import create_snapshot
        from ..utils.snapshot import snapshot as cpu_snapshot

        fb = self.fallback.get(doc)
        if fb is not None:
            return cpu_snapshot(fb)
        m = self.mirrors[doc]
        return create_snapshot(m.delete_set(), m.state_vector())

    def create_doc_from_snapshot(self, doc: int, snap, new_doc=None) -> Doc:
        """Rewind one room to ``snap`` as a standalone CPU :class:`Doc`
        (reference Snapshot.js:162-202 createDocFromSnapshot).  The room
        itself stays device-resident and untouched; the engine's full
        state is materialized host-side (gc=False history is retained by
        default) and truncated to the snapshot."""
        from ..updates import apply_update
        from ..utils.snapshot import create_doc_from_snapshot as _cdfs

        fb = self.fallback.get(doc)
        if fb is not None:
            return _cdfs(fb, snap, new_doc)
        if self.gc:
            raise RuntimeError("originDoc must not be garbage collected")
        origin = Doc(gc=False)
        apply_update(origin, self.encode_state_as_update(doc))
        return _cdfs(origin, snap, new_doc)

    def _delta_of_seg_snapshot(self, doc, seg, snap, prev, compute_ychange):
        """Snapshot-scoped delta from the mirror columns: each run is cut
        into element sub-ranges of uniform visibility under (sv, ds) of
        both snapshots, so no struct pre-splitting is needed — the exact
        twin of YText.js:936-1030 / types/ytext.py to_delta (the parity
        test pins them op-for-op)."""
        from bisect import bisect_right

        from ..core import ContentEmbed, ContentFormat, ContentString, is_deleted
        from ..ids import create_id
        from ..types.ytext import update_current_attributes

        if self.gc:
            # compaction GC'd deleted runs' content: historical views are
            # unrenderable, exactly like the reference's
            # createDocFromSnapshot guard (Snapshot.js:165)
            raise RuntimeError(
                "snapshot-scoped to_delta requires engine gc=False"
            )
        m = self.mirrors[doc]
        ops: list = []
        cur: dict = {}
        parts: list[str] = []
        # per-snapshot, per-client sorted (start, end) edge tables: the
        # row loop bisects instead of scanning the whole DeleteSet
        edge_tables: dict[int, dict[int, tuple[list, list]]] = {}
        for si, sn in enumerate((snap, prev)):
            if sn is None:
                continue
            tab: dict[int, tuple[list, list]] = {}
            for cl, items in sn.ds.clients.items():
                tab[cl] = (
                    [it.clock for it in items],
                    [it.clock + it.len for it in items],
                )
            edge_tables[si] = tab

        def pack_str():
            if parts:
                op = {"insert": from_u16("".join(parts))}
                if cur:
                    op["attributes"] = dict(cur)
                ops.append(op)
                parts.clear()

        def vis(sn, client, clk):
            # element-level twin of Snapshot.js:133-135 isVisible (the
            # reference checks post-split item starts; elements subsume)
            if sn is None:
                return None
            return (
                client in sn.sv
                and sn.sv.get(client, 0) > clk
                and not is_deleted(sn.ds, create_id(client, clk))
            )

        rows, dels = self._order(doc, seg)
        for r, dl in zip(rows, dels):
            r = int(r)
            if m.row_is_gc[r]:
                continue  # GC'd runs carry no content; see gc caveat
            client = m.client_of_slot[m.row_slot[r]]
            clock = int(m.row_clock[r])
            ln = int(m.row_len[r])
            # visibility boundaries inside this run: sv bounds + ds edges
            # (bisected — ds lists are sorted and disjoint)
            cuts = {clock, clock + ln}
            for si, sn in enumerate((snap, prev)):
                if sn is None:
                    continue
                b = sn.sv.get(client, 0)
                if clock < b < clock + ln:
                    cuts.add(b)
                starts_ends = edge_tables[si].get(client)
                if starts_ends is None:
                    continue
                starts, ends = starts_ends
                j = bisect_right(ends, clock)
                while j < len(starts) and starts[j] < clock + ln:
                    if clock < starts[j]:
                        cuts.add(starts[j])
                    if ends[j] < clock + ln:
                        cuts.add(ends[j])
                    j += 1
            content = None
            pts = sorted(cuts)
            for a, b in zip(pts, pts[1:]):
                v_now = vis(snap, client, a)
                if snap is None:
                    v_now = not dl  # plain visibility when only prev given
                v_prev = vis(prev, client, a)
                if not (v_now or (prev is not None and v_prev)):
                    continue
                if content is None:
                    content = m.realized_content(r)
                if isinstance(content, ContentString):
                    cy = cur.get("ychange")
                    if snap is not None and not v_now:
                        if (
                            cy is None
                            or cy.get("user") != client
                            or cy.get("state") != "removed"
                        ):
                            pack_str()
                            cur["ychange"] = (
                                compute_ychange("removed", create_id(client, a))
                                if compute_ychange
                                else {"type": "removed"}
                            )
                    elif prev is not None and not v_prev:
                        if (
                            cy is None
                            or cy.get("user") != client
                            or cy.get("state") != "added"
                        ):
                            pack_str()
                            cur["ychange"] = (
                                compute_ychange("added", create_id(client, a))
                                if compute_ychange
                                else {"type": "added"}
                            )
                    elif cy is not None:
                        pack_str()
                        cur.pop("ychange", None)
                    parts.append(content.str[a - clock : b - clock])
                elif isinstance(content, ContentEmbed):
                    pack_str()
                    op = {"insert": content.embed}
                    if cur:
                        op["attributes"] = dict(cur)
                    ops.append(op)
                elif isinstance(content, ContentFormat):
                    if v_now:
                        pack_str()
                        update_current_attributes(cur, content)
        pack_str()
        return ops

    def _delta_of_seg(self, doc: int, seg: int) -> list:
        from ..core import ContentEmbed, ContentFormat, ContentString
        from ..types.ytext import update_current_attributes

        m = self.mirrors[doc]
        ops: list = []
        cur: dict = {}
        parts: list[str] = []

        def pack_str():
            if parts:
                op = {"insert": from_u16("".join(parts))}
                if cur:
                    op["attributes"] = dict(cur)
                ops.append(op)
                parts.clear()

        rows, dels = self._order(doc, seg)
        for r, dl in zip(rows, dels):
            if dl:
                continue
            c = m.realized_content(int(r))
            if isinstance(c, ContentString):
                parts.append(c.str)
            elif isinstance(c, ContentEmbed):
                pack_str()
                op = {"insert": c.embed}
                if cur:
                    op["attributes"] = dict(cur)
                ops.append(op)
            elif isinstance(c, ContentFormat):
                pack_str()
                update_current_attributes(cur, c)
        pack_str()
        return ops

    def xml_string(self, doc: int, name: str | None = None) -> str:
        """Serialize a root XML fragment from the mirror (reference
        YXmlFragment/YXmlElement/YXmlText toString — sorted attributes,
        nested formatting tags), no CPU-doc replay."""
        name = name or self.root_name
        fb = self.fallback.get(doc)
        if fb is not None:
            from ..types.yxml import YXmlHook

            def render(t):
                # YXmlHook inherits YMap and has no serialization in the
                # reference; emit the same stable "" as the mirror path
                if isinstance(t, YXmlHook):
                    return ""
                return t.to_string()

            frag = fb.get_xml_fragment(name)
            return "".join(render(t) for t in frag.to_array())
        seg = self.mirrors[doc].segments.get((name, None, NULL))
        if seg is None:
            return ""
        return self._xml_children(doc, seg)

    def _xml_children(self, doc: int, seg: int) -> str:
        m = self.mirrors[doc]
        rows, dels = self._order(doc, seg)
        parts: list[str] = []
        for r, dl in zip(rows, dels):
            r = int(r)
            if dl or not m.row_countable[r]:
                continue
            c = m.realized_content(r)
            if getattr(c, "REF", None) == 7:
                parts.append(self._xml_node(doc, r, c))
            else:
                parts.extend(str(v) for v in c.get_content())
        return "".join(parts)

    def _xml_node(self, doc: int, row: int, content) -> str:
        m = self.mirrors[doc]
        t = content.type
        kind = type(t).__name__
        child_seg = m.segments.get((None, None, row))
        if kind == "YXmlElement":
            # sorted-attribute serialization (reference YXmlElement.js:97-113)
            attrs = self._map_json_of(doc, None, row)
            attrs_string = " ".join(
                f'{key}="{attrs[key]}"' for key in sorted(attrs.keys())
            )
            node_name = t.node_name.lower()
            inner = (
                self._xml_children(doc, child_seg)
                if child_seg is not None
                else ""
            )
            sep = " " + attrs_string if attrs_string else ""
            return f"<{node_name}{sep}>{inner}</{node_name}>"
        if kind == "YXmlText":
            # delta attributes as nested sorted tags (YXmlText.js:65-97)
            if child_seg is None:
                return ""
            out = []
            for delta in self._delta_of_seg(doc, child_seg):
                names = sorted(delta.get("attributes", {}))
                s = ""
                for node_name in names:
                    s += f"<{node_name}"
                    a = delta["attributes"][node_name]
                    for key in sorted(a):
                        s += f' {key}="{a[key]}"'
                    s += ">"
                s += str(delta["insert"])
                for node_name in reversed(names):
                    s += f"</{node_name}>"
                out.append(s)
            return "".join(out)
        if kind == "YXmlFragment":
            return (
                self._xml_children(doc, child_seg)
                if child_seg is not None
                else ""
            )
        # YXmlHook: a YMap with a hook name — the reference's toString
        # falls through Object.prototype; serialize it as the stable empty
        # form on BOTH paths (the CPU fallback goes through xml_string's
        # own renderer below, so modes agree)
        return ""

    def map_json(self, doc: int, name: str | None = None) -> dict:
        """The visible {key: value} content of one root YMap (LWW winners,
        reference typeMapGet / YMap.toJSON); nested shared types render
        recursively (dicts / lists / strings)."""
        name = name or self.root_name
        fb = self.fallback.get(doc)
        if fb is not None:
            return fb.get_map(name).to_json()
        return self._map_json_of(doc, name, NULL)

    def _map_json_of(self, doc: int, name: str | None, parent_row: int) -> dict:
        m = self.mirrors[doc]
        if parent_row != NULL:
            # nested: the reverse index lists exactly this type's segments
            segs = [
                (m.seg_info[s][1], s)
                for s in m._segs_of_parent.get(parent_row, ())
                if m.seg_info[s][1] is not None
            ]
        else:
            segs = [
                (sub, seg)
                for (n, sub, p), seg in m.segments.items()
                if n == name and sub is not None and p == NULL
            ]
        out = {}
        for sub, seg in segs:
            # the map-key chain is a device segment like any list: its
            # visible value is the last undeleted entry of the chain in
            # list order (LWW keeps only the final tail undeleted)
            rows, dels = self._order(doc, seg)
            if not len(rows) or dels[-1]:
                continue
            out[sub] = self._value_of_row(doc, int(rows[-1]))
        return out

    def _value_of_row(self, doc: int, row: int):
        """A row's visible value (reference typeMapGet: the last content
        element), recursing into nested shared types."""
        m = self.mirrors[doc]
        content = m.realized_content(row)
        if getattr(content, "REF", None) == 7:
            return self._type_json(doc, row)
        return content.get_content()[-1]

    def _list_json(self, doc: int, seg: int) -> list:
        """One list segment's visible values in document order, recursing
        into nested shared types (reference YArray.toJSON)."""
        m = self.mirrors[doc]
        rows, dels = self._order(doc, seg)
        out = []
        for r, dl in zip(rows, dels):
            if dl or not m.row_countable[r]:
                continue
            content = m.realized_content(r)
            if getattr(content, "REF", None) == 7:
                out.append(self._type_json(doc, r))
            else:
                out.extend(content.get_content())
        return out

    def _type_json(self, doc: int, row: int):
        """Materialize a nested shared type held by ``row``'s ContentType:
        maps render as dicts, text as strings, lists as JSON arrays
        (reference YMap/YText/YArray .toJSON)."""
        m = self.mirrors[doc]
        kind = type(m.realized_content(row).type).__name__
        if kind in ("YMap", "YXmlHook"):
            return self._map_json_of(doc, None, row)
        seg = m.segments.get((None, None, row))
        if seg is None:
            return "" if kind in ("YText", "YXmlText") else []
        if kind in ("YText", "YXmlText"):
            rows, dels = self._order(doc, seg)
            return visible_text(m, rows, dels)
        return self._list_json(doc, seg)

    def to_json(self, doc: int, name: str | None = None):
        """A root YArray's JSON content, nested types included
        (reference YArray.toJSON)."""
        name = name or self.root_name
        fb = self.fallback.get(doc)
        if fb is not None:
            return fb.get_array(name).to_json()
        seg = self.mirrors[doc].segments.get((name, None, NULL))
        if seg is None:
            return []
        return self._list_json(doc, seg)

    def encode_state_vector(self, doc: int) -> bytes:
        fb = self.fallback.get(doc)
        if fb is not None:
            from ..updates import encode_state_vector

            return encode_state_vector(fb)
        return self.mirrors[doc].encode_state_vector()

    def encode_state_as_update(
        self, doc: int, encoded_target_sv: bytes | None = None, v2: bool = False
    ) -> bytes:
        """Sync step 2 straight from the columnar mirror (no CPU Doc)."""
        fb = self.fallback.get(doc)
        if fb is not None:
            from ..updates import encode_state_as_update, encode_state_as_update_v2

            f = encode_state_as_update_v2 if v2 else encode_state_as_update
            return f(fb, encoded_target_sv)
        target = None
        if encoded_target_sv is not None:
            from ..updates import decode_state_vector

            target = decode_state_vector(encoded_target_sv)
        return self.mirrors[doc].encode_state_as_update(target, v2=v2)

    # -- batched sync kernels ----------------------------------------------

    def _sync_columns(self, docs: list[int]):
        """Stacked (row_slot, row_clock, row_end) columns for a doc subset,
        padded to the widest doc (NULL rows are masked by the kernels).
        Served from each mirror's cached numpy columns."""
        n = max((self.mirrors[i].n_rows for i in docs), default=0)
        n = max(n, 1)
        k = len(docs)
        row_slot = np.full((k, n), NULL, np.int32)
        row_clock = np.zeros((k, n), np.int32)
        row_end = np.zeros((k, n), np.int32)
        for j, i in enumerate(docs):
            m = self.mirrors[i]
            r = m.n_rows
            if r:
                c = m._np_cols()
                row_slot[j, :r] = c["slot"]
                row_clock[j, :r] = c["clock"]
                row_end[j, :r] = c["row_end"]
        return row_slot, row_clock, row_end

    def state_vectors_batched(self, docs: list[int]) -> list[dict[int, int]]:
        """State vectors for many docs in ONE ``state_vector_kernel``
        launch (the segment-max of StructStore.getStateVector batched
        over the doc axis).  Results align positionally with ``docs``;
        fallback docs are served by the CPU core."""
        out: list[dict[int, int] | None] = [None] * len(docs)
        dev = [(j, i) for j, i in enumerate(docs) if i not in self.fallback]
        for j, i in enumerate(docs):
            if i in self.fallback:
                out[j] = self.state_vector(i)
        if dev:
            dev_docs = [i for _, i in dev]
            row_slot, _clock, row_end = self._sync_columns(dev_docs)
            # bucket n_slots so client-count growth gives O(log) shapes
            n_slots = _bucket(
                max(1, max(len(self.mirrors[i].client_of_slot) for i in dev_docs)),
                4,
            )
            if self.mesh is not None:
                # the sharded segment max: pad the doc subset to the doc
                # axis, compute shard-locally, gather
                pad = (-len(dev_docs)) % len(self._shard_devs)
                if pad:
                    row_slot = np.pad(
                        row_slot, ((0, pad), (0, 0)), constant_values=NULL
                    )
                    row_end = np.pad(row_end, ((0, pad), (0, 0)))
                f = self._sharded_sv.get(n_slots)
                if f is None:
                    f = sharded_state_vectors(
                        self.mesh, n_slots, self.mesh.axis_names[0]
                    )
                    self._sharded_sv[n_slots] = f
                sv = f(row_slot, row_end).cpu().numpy()
            else:
                sv = kernels.state_vector_kernel(
                    self._put_r(row_slot), self._put_r(row_end), n_slots
                ).cpu().numpy()
            for r, (j, i) in enumerate(dev):
                m = self.mirrors[i]
                out[j] = {
                    m.client_of_slot[s]: int(sv[r, s])
                    for s in range(len(m.client_of_slot))
                    if sv[r, s] > 0
                }
        return out

    def sync_step2_batch(
        self, requests: list[tuple[int, dict[int, int] | None]], v2: bool = False
    ) -> list[bytes]:
        """Answer many sync-step-1 requests with ONE ``diff_mask_kernel``
        launch: (doc, remote state vector) pairs in, diff updates out
        (reference encodeStateAsUpdate, encoding.js:490-526, batched over
        the doc axis).  Fallback docs are served by the CPU core."""
        replies: list[bytes | None] = [None] * len(requests)
        dev = [
            (j, i, sv) for j, (i, sv) in enumerate(requests) if i not in self.fallback
        ]
        for j, (i, sv) in enumerate(requests):
            if i in self.fallback:
                enc_sv = None
                if sv:
                    from ..coding import DSEncoderV1
                    from ..updates import write_state_vector

                    e = DSEncoderV1()
                    write_state_vector(e, sv)
                    enc_sv = e.to_bytes()
                replies[j] = self.encode_state_as_update(i, enc_sv, v2=v2)
        # native mirrors answer straight from the C++ columns: one
        # ymx_encode_diff(_v2) call per request, no device round trip (the
        # device diff kernel still serves Python-mirror engines and can be
        # forced with YTPU_SYNC_DEVICE=1)
        if not os.environ.get("YTPU_SYNC_DEVICE"):
            rest = []
            for j, i, sv in dev:
                m = self.mirrors[i]
                enc = getattr(m, "encode_diff_update", None)
                u = enc(sv, v2=v2) if enc is not None else None
                if u is None:
                    rest.append((j, i, sv))
                else:
                    replies[j] = u
            dev = rest
        if dev:
            docs = [i for _, i, _ in dev]
            row_slot, row_clock, row_end = self._sync_columns(docs)
            # not bucketed (state_vectors_batched buckets its n_slots)
            n_slots = max(1, max(len(self.mirrors[i].client_of_slot) for i in docs))
            sv_dense = np.zeros((len(dev), n_slots), np.int32)
            for r, (_j, i, sv) in enumerate(dev):
                m = self.mirrors[i]
                for client, clock in (sv or {}).items():
                    s = m.slot_of_client.get(client)
                    if s is not None:
                        sv_dense[r, s] = clock
            needed, offset = kernels.diff_mask_kernel(
                self._put_r(row_slot),
                self._put_r(row_clock),
                self._put_r(row_end),
                self._put_r(sv_dense),
            )
            needed = needed.cpu().numpy()
            offset = offset.cpu().numpy()
            for r, (j, i, _sv) in enumerate(dev):
                replies[j] = self.mirrors[i].encode_masked_update(
                    needed[r], offset[r], v2=v2
                )
        return replies

    def encode_states_batched(
        self, docs: list[int], v2: bool = False
    ) -> list[bytes]:
        """Full-state exports for many docs in ONE batched dispatch (a
        sync-step-2 answer against the empty state vector) — the WAL
        checkpoint's snapshot producer: compacting a fleet
        must not cost one device round trip per doc."""
        return self.sync_step2_batch([(i, None) for i in docs], v2=v2)

    def has_pending(self, doc: int) -> bool:
        if doc in self.fallback:
            fb = self.fallback[doc]
            return bool(fb.store.pending_clients_struct_refs) or bool(
                fb.store.pending_delete_readers
            )
        return self.mirrors[doc].has_pending()
