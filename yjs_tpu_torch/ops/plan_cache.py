"""Frontier-keyed incremental plan cache.

Planning is deterministic: a mirror that has folded the same sequence of
updates (and the same structural events — compaction, GC, hydration)
from the same seed is bit-identical to any other mirror with that
history, and preparing the same staged bytes on top of it yields a
bit-identical post-plan state.  This module keys that fact:

- every mirror carries a 16-byte **plan frontier** — a blake2b digest
  chain seeded from the root type name and folded forward on every
  successful prepare (with the staged updates' content digest) and on
  every deterministic structural event (compact/GC, hydration).
  Nondeterministic events (rollback restore, plan errors that may leave
  the core mid-step) *poison* the frontier with a random nonce, so a
  stale mirror can never alias a cached entry;
- the cache maps ``(kind, frontier, staged_digest, want_levels,
  want_sched)`` to a snapshot of the post-prepare mirror state.  A hit
  replays the snapshot onto the probing doc (native: one
  ``ymx_clone_state`` deep copy; Python: a ``copy.deepcopy``) instead of
  re-planning — the resolved left/right-origin anchors, splice lists,
  and pending queues all ride along, so cached and cold flushes are
  byte-identical by construction.

Entries are immutable once inserted and never *become* wrong (the key is
the full mutation history); eviction is pure memory policy (LRU over
``YTPU_PLAN_CACHE_CAP`` entries / ``YTPU_PLAN_CACHE_BYTES`` bytes).

Env knobs: ``YTPU_PLAN_CACHE=0`` disables probing and insertion
entirely; ``YTPU_PLAN_CACHE_CAP`` (entries, default 4096),
``YTPU_PLAN_CACHE_BYTES`` (approx. host bytes, default 1 GiB),
``YTPU_PLAN_CACHE_MAX_ENTRY`` (largest cacheable snapshot, default
256 MiB).

The metric families live on the process-global registry (the cache is
process-global, like the kernel profiler): ``ytpu_plan_cache_hits_total``,
``ytpu_plan_cache_misses_total``,
``ytpu_plan_cache_invalidations_total{reason}``,
``ytpu_plan_fastpath_structs_total`` (structs placed by the segment-
sorted fast path in ``ops/kernels.py`` / ``DocMirror.prepare_step``),
plus ``ytpu_plan_cache_entries`` / ``ytpu_plan_cache_bytes`` gauges.
"""

from __future__ import annotations

import copy
import hashlib
import os
from collections import OrderedDict

import numpy as np

from ..obs import global_registry

# -- frontier digests ---------------------------------------------------------

_DIGEST_MEMO: dict[bytes, bytes] = {}
_DIGEST_MEMO_CAP = 4096


def update_digest(u: bytes) -> bytes:
    """Content digest of one update payload, memoized per bytes object
    (broadcast workloads queue the same object thousands of times; the
    dict key reuses Python's cached bytes hash after the first probe)."""
    d = _DIGEST_MEMO.get(u)
    if d is None:
        if len(_DIGEST_MEMO) >= _DIGEST_MEMO_CAP:
            _DIGEST_MEMO.clear()
        d = hashlib.blake2b(u, digest_size=16).digest()
        _DIGEST_MEMO[u] = d
    return d


def staged_digest(incoming) -> bytes:
    """Digest of a mirror's staged ``(update, v2)`` list, order-sensitive
    (ingest order is part of the deterministic history)."""
    h = hashlib.blake2b(digest_size=16)
    for u, v2 in incoming:
        h.update(b"\x02" if v2 else b"\x01")
        h.update(update_digest(u))
    return h.digest()


def seed_frontier(root_name: str) -> bytes:
    return hashlib.blake2b(
        b"ytpu-frontier:" + root_name.encode(), digest_size=16
    ).digest()


def fold(frontier: bytes, tag: bytes, payload: bytes = b"") -> bytes:
    """Advance a frontier by one deterministic event."""
    return hashlib.blake2b(
        frontier + tag + payload, digest_size=16
    ).digest()


def poison_frontier() -> bytes:
    """A frontier no other mirror can share — used after any event whose
    resulting state is not provably a deterministic function of the
    digest chain (rollback, mid-step plan errors)."""
    from ..obs.blackbox import flight_recorder
    from ..obs.dist import current_context

    ctx = current_context()
    if ctx is not None:
        ctx.force("frontier_poisoned")
    flight_recorder().record(
        "plan_cache", "frontier_poisoned", severity="warning",
        trace=ctx.trace_hex if ctx is not None else None,
    )
    return os.urandom(16)


# -- metric families (process-global, pre-registered at import) ---------------

_reg = global_registry()
_HITS = _reg.counter(
    "ytpu_plan_cache_hits_total",
    "Plan-cache probes served by a cached post-prepare snapshot",
)
_MISSES = _reg.counter(
    "ytpu_plan_cache_misses_total",
    "Plan-cache probes that fell through to a cold plan",
)
_INVALIDATIONS = _reg.counter(
    "ytpu_plan_cache_invalidations_total",
    "Doc plan-frontier advances/poisons outside the normal prepare flow "
    "(cached anchors no longer reachable under the old key), by reason",
    labelnames=("reason",),
)
_FASTPATH = _reg.counter(
    "ytpu_plan_fastpath_structs_total",
    "Structs placed by the segment-sorted conflict-free fast path "
    "instead of the sequential YATA walk",
)
_ENTRIES_G = _reg.gauge(
    "ytpu_plan_cache_entries", "Live plan-cache entries"
)
_BYTES_G = _reg.gauge(
    "ytpu_plan_cache_bytes", "Approximate host bytes held by the plan cache"
)
# segment-planner families: the device-authoritative cold
# planner partitions every flush batch into a fast set (integrated
# straight from device-computed ranks) and a conflict residue (the only
# structs handed to the sequential YATA walk, now a fallback)
_SEG_FAST = _reg.counter(
    "ytpu_plan_segment_fast_total",
    "Structs integrated directly from segment-planner ranks (no "
    "per-struct YATA walk)",
)
_SEG_RESIDUE = _reg.counter(
    "ytpu_plan_segment_residue_total",
    "Conflict-residue structs handed to the sequential YATA fallback",
)
_SEG_CHUNKS = _reg.counter(
    "ytpu_plan_segment_chunks_total",
    "Whole-chunk segment-planner invocations (cold docs co-planned in "
    "one batched kernel call)",
)
_SEG_SNAP_SKIP = _reg.counter(
    "ytpu_plan_segment_snapshot_reuse_total",
    "Flushes that reused the per-slot sorted fragment segments as-is "
    "(monotone chained runs) instead of rebuilding the flat snapshot",
)


def note_invalidation(reason: str) -> None:
    _INVALIDATIONS.labels(reason=reason).inc()


def note_hits(n: int) -> None:
    """Count probes served without a cold plan but outside ``lookup`` —
    intra-batch members cloned from a just-planned leader mirror."""
    if n:
        _HITS.inc(n)


def note_misses(n: int) -> None:
    """Count cold plans that never went through ``lookup`` — group
    members re-planned individually after their leader failed."""
    if n:
        _MISSES.inc(n)


def note_fastpath(n: int) -> None:
    if n:
        _FASTPATH.inc(n)


def note_segment(fast: int, residue: int) -> None:
    """Per-prepare fast-set / conflict-residue partition sizes from the
    segment planner."""
    if fast:
        _SEG_FAST.inc(fast)
    if residue:
        _SEG_RESIDUE.inc(residue)


def note_segment_chunk() -> None:
    _SEG_CHUNKS.inc()


def note_snapshot_reuse() -> None:
    _SEG_SNAP_SKIP.inc()


def enabled() -> bool:
    return os.environ.get("YTPU_PLAN_CACHE", "1") not in ("0", "false")


# -- cache entries ------------------------------------------------------------


class _NativeEntry:
    """A cloned C++ mirror handle frozen at post-prepare state, plus the
    Python-pinned update buffers its borrowed pointers reference and the
    counts row the engine's pack path needs.

    Donation safety: everything held here lives on the HOST
    — the clone, the pinned bytes, and a private copy of the counts row.
    The pipelined flush donates the leader's device column tables into
    the integrate/scatter kernels, so by the time a follower replays
    this entry those device buffers have been freed and re-used; a
    cached entry must therefore never retain a reference to any
    ``jax.Array`` the engine dispatched.  Adoption re-packs lanes from
    this host state into the engine's own staging slot."""

    kind = "native"
    __slots__ = ("lib", "h", "counts", "pins", "frontier_after", "nbytes")

    def __init__(self, lib, src_h, counts, pins, frontier_after):
        self.lib = lib
        self.h = lib.ymx_new()
        core = int(lib.ymx_clone_state(self.h, src_h))
        self.counts = np.array(counts, np.int64, copy=True)
        self.pins = dict(pins)
        self.frontier_after = frontier_after
        self.nbytes = core + sum(len(u) for u, _a in self.pins.values())

    def close(self):
        h, self.h = self.h, None
        if h:
            self.lib.ymx_free(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _PyEntry:
    """Deepcopied post-prepare DocMirror + StepPlan (the pure-Python
    planner path); hits hand back fresh deep copies."""

    kind = "py"
    __slots__ = ("mirror", "plan", "nbytes")

    def __init__(self, mirror, plan):
        self.mirror, self.plan = copy.deepcopy((mirror, plan))
        try:
            self.nbytes = int(mirror.host_nbytes())
        except Exception:
            self.nbytes = 1 << 20

    def clone(self):
        return copy.deepcopy((self.mirror, self.plan))

    def close(self):
        pass


# -- the cache ----------------------------------------------------------------


class PlanCache:
    def __init__(self):
        self._d: OrderedDict = OrderedDict()
        self._bytes = 0
        self.cap = int(os.environ.get("YTPU_PLAN_CACHE_CAP", "4096"))
        self.byte_cap = int(
            os.environ.get("YTPU_PLAN_CACHE_BYTES", str(1 << 30))
        )
        self.max_entry = int(
            os.environ.get("YTPU_PLAN_CACHE_MAX_ENTRY", str(1 << 28))
        )

    def __len__(self):
        return len(self._d)

    def lookup(self, key):
        ent = self._d.get(key)
        if ent is None:
            _MISSES.inc()
            return None
        self._d.move_to_end(key)
        _HITS.inc()
        return ent

    def _admit(self, key, ent) -> None:
        if ent.nbytes > self.max_entry:
            ent.close()
            return
        old = self._d.pop(key, None)
        if old is not None:
            self._bytes -= old.nbytes
            old.close()
        self._d[key] = ent
        self._bytes += ent.nbytes
        while self._d and (
            len(self._d) > self.cap or self._bytes > self.byte_cap
        ):
            _k, victim = self._d.popitem(last=False)
            self._bytes -= victim.nbytes
            victim.close()
        _ENTRIES_G.set(len(self._d))
        _BYTES_G.set(self._bytes)

    def insert_native(self, key, mirror, counts):
        """Snapshot a NativeMirror's post-prepare state under ``key``.
        ``mirror.plan_frontier`` has already been folded forward by
        ``_finish_prepare``, so it is the frontier a hit must adopt."""
        self._admit(
            key,
            _NativeEntry(
                mirror._lib, mirror._h, counts, mirror._py_bufs,
                mirror.plan_frontier,
            ),
        )

    def insert_py(self, key, mirror, plan):
        self._admit(key, _PyEntry(mirror, plan))

    def clear(self):
        for ent in self._d.values():
            ent.close()
        self._d.clear()
        self._bytes = 0
        _ENTRIES_G.set(0)
        _BYTES_G.set(0)

    def stats(self) -> dict:
        return {"entries": len(self._d), "bytes": self._bytes}


_CACHE: PlanCache | None = None


def get_cache() -> PlanCache | None:
    """The process-global cache, or None when YTPU_PLAN_CACHE=0 (the env
    is re-read per call so tests/benches can toggle in-process)."""
    if not enabled():
        return None
    global _CACHE
    if _CACHE is None:
        _CACHE = PlanCache()
    return _CACHE


def reset_cache() -> None:
    """Drop every entry (tests; also frees the native handles)."""
    global _CACHE
    if _CACHE is not None:
        _CACHE.clear()
    _CACHE = None
