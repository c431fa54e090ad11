"""NativeMirror: DocMirror's interface served by the C++ plan core.

The flush hot path (ingest -> prepare_step -> static_columns) runs entirely
inside yjs_tpu/native/plancore.cpp — the per-item Python interpreter cost
that dominated the distinct-doc benchmark (11.6ms/doc of plan
building) drops to one ctypes call per flush.  Everything *outside* the hot
path — exports, wire encodes, event payloads — is served by lazily syncing
the C++ columns into a shadow :class:`DocMirror` and delegating to its
(pure-read) methods, so the two implementations cannot drift in behavior:
the shadow IS the reference implementation operating on the same data.

Scope fallbacks keep semantics identical to the Python mirror:
- subdocuments (ContentDoc) raise :class:`UnsupportedUpdate`, demoting the
  doc to the CPU core exactly like the Python path (engine policy seam);
- payloads the native scanner will not carry (legacy ContentJSON inside a
  V2 update) also raise UnsupportedUpdate — the engine's CPU fallback
  serves them;
- malformed updates raise the same decode errors as the Python path
  (re-validated through decode_update_refs so the error type matches).
"""

from __future__ import annotations

import ctypes
import os
import time

import numpy as np

from ..lib0.decoding import Decoder
from ..lib0 import decoding
from ..lib0.u16 import utf8_decode_u16
from ..native import (
    SRC_ANYS,
    SRC_DELETED,
    SRC_FRAMED,
    SRC_JSONS,
    SRC_NONE,
    SRC_UTF8,
    SRC_V2LAZY,
    has_plancore,
    load,
)
from .columns import (
    NULL,
    DocMirror,
    LazyContent,
    LazyContentV2,
    UnsupportedUpdate,
    decode_update_refs,
)
from . import plan_cache as _pc

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u32p = ctypes.POINTER(ctypes.c_uint32)


def native_plan_available() -> bool:
    # env opt-out first: has_plancore() may trigger the g++ build
    return not os.environ.get("YTPU_NO_NATIVE_PLAN") and has_plancore()


def _sync_plan_segment(lib) -> None:
    """Mirror the YTPU_PLAN_SEGMENT knob into the core's emit_row gate
    so the ``off`` A/B lane also disables the native chain-run anchor
    adoption.  No-op on a stale binary-only .so."""
    if lib is None or not getattr(lib, "_has_plan_segment", False):
        return
    from . import segment_planner

    lib.ymx_set_plan_segment(
        0 if segment_planner.plan_segment_mode() == "off" else 1
    )


def plan_segment_stats() -> tuple[int, int]:
    """Cumulative (chain-run adoptions, fragment-search lookups) across
    every native prepare in the process; callers diff around a flush.
    (0, 0) when the core (or the symbol) is unavailable."""
    if not native_plan_available():
        return (0, 0)
    lib = load()
    if lib is None or not getattr(lib, "_has_plan_segment", False):
        return (0, 0)
    out = np.zeros(2, np.int64)
    lib.ymx_plan_segment_stats(_p64(out))
    return (int(out[0]), int(out[1]))


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


class NativePlan:
    """Array-backed step plan (the C++ twin of :class:`StepPlan`).

    ``splits``/``sched``/``sched8``/``delete_rows`` are numpy arrays (use
    ``len()``, not truthiness); ``applied_ds`` is a plain list of tuples
    for the encode path.  ``pack_into`` fills an engine-allocated
    ``[L, W, 8]`` int32 block level-major (vectorized, no per-entry
    Python)."""

    def __init__(self, lib, h, counts, mirror):
        (self.n_rows, n_splits, n_sched, self._n_s8, self.n_levels,
         self.max_width, n_del, self._n_ads) = (int(x) for x in counts[:8])
        n_links, n_heads = int(counts[12]), int(counts[13])
        # full counts row retained for the plan cache (insert after a
        # cold per-doc prepare needs it)
        self.counts = np.array(counts, np.int64, copy=True)
        self._lib, self._h = lib, h
        # staleness guard for lazy sections: the C++ plan buffers are
        # overwritten by the mirror's next prepare
        self._mirror = mirror
        self._seq = mirror._plan_seq
        self._n_sched = n_sched
        # hot-path sections fetched eagerly (the bulk apply + split count)
        self.splits = np.empty((n_splits, 2), np.int64)
        self.delete_rows = np.empty(n_del, np.int64)
        self.link_rows = np.empty(n_links, np.int64)
        self.link_vals = np.empty(n_links, np.int64)
        self.head_segs = np.empty(n_heads, np.int64)
        self.head_vals = np.empty(n_heads, np.int64)
        if n_splits:
            lib.ymx_plan_splits(h, _p64(self.splits))
        if n_del:
            lib.ymx_plan_deletes(h, _p64(self.delete_rows))
        if n_links:
            lib.ymx_plan_links(h, _p64(self.link_rows), _p64(self.link_vals))
        if n_heads:
            lib.ymx_plan_heads(h, _p64(self.head_segs), _p64(self.head_vals))
        self._sched = self._sched8 = self._levels = self._applied = None

    def _fresh(self):
        if self._seq != self._mirror._plan_seq:
            raise RuntimeError(
                "stale NativePlan: the mirror ran another prepare_step"
            )

    @property
    def sched(self):
        if self._sched is None:
            self._fresh()
            self._sched = np.empty((self._n_sched, 4), np.int64)
            if self._n_sched:
                self._lib.ymx_plan_sched(self._h, _p64(self._sched))
        return self._sched

    @property
    def sched8(self):
        if self._sched8 is None:
            self._fresh()
            self._sched8 = np.empty((self._n_s8, 8), np.int64)
            self._levels = np.empty(self._n_s8, np.int64)
            if self._n_s8:
                self._lib.ymx_plan_sched8(
                    self._h, _p64(self._sched8), _p64(self._levels)
                )
        return self._sched8

    @property
    def levels(self):
        self.sched8
        return self._levels

    @property
    def applied_ds(self):
        if self._applied is None:
            self._fresh()
            ads = np.empty((self._n_ads, 3), np.int64)
            if self._n_ads:
                self._lib.ymx_plan_applied_ds(self._h, _p64(ads))
            self._applied = [tuple(row) for row in ads.tolist()]
        return self._applied

    def pack_into(self, block: np.ndarray) -> None:
        if not len(self.sched8):
            return
        lv = self.levels - 1
        idx = np.argsort(lv, kind="stable")
        sorted_lv = lv[idx]
        starts = np.searchsorted(sorted_lv, np.arange(block.shape[0]))
        pos = np.arange(len(idx)) - starts[sorted_lv]
        block[sorted_lv, pos] = self.sched8[idx].astype(block.dtype)

    def packed_levels(self):
        out: list[list[tuple[int, ...]]] = [[] for _ in range(self.n_levels)]
        for entry, lev in zip(self.sched8.tolist(), self.levels.tolist()):
            out[lev - 1].append(tuple(entry))
        return out


def _empty_v2_update() -> bytes:
    """The no-novelty V2 container (feature byte + nine empty streams +
    0-group 0-DS rest) — the V2 analogue of the V1 b"\\x00\\x00"."""
    from ..coding import UpdateEncoderV2
    from ..lib0 import encoding as lib0enc

    e = UpdateEncoderV2()
    lib0enc.write_var_uint(e.rest_encoder, 0)
    lib0enc.write_var_uint(e.rest_encoder, 0)
    return e.to_bytes()


_EMPTY_V2 = _empty_v2_update()


class NativeMirror:
    """Drop-in DocMirror replacement backed by the native plan core."""

    def __init__(self, root_name: str = "text"):
        lib = load()
        if lib is None or not getattr(lib, "_has_plancore", False):
            raise RuntimeError("native plan core unavailable")
        self._lib = lib
        self._h = lib.ymx_new()
        self.root_name = root_name
        self._incoming: list[tuple[bytes, bool]] = []
        # buf id -> (bytes, pinned nparray view) keeping pointers stable
        self._py_bufs: dict[int, tuple[bytes, np.ndarray]] = {}
        self._realized: dict[int, object] = {}
        self._py = DocMirror(root_name)
        # spill/encode paths realize through the descriptor columns
        self._py.realized_content = self.realized_content
        self._synced_gen = -1
        self._plan_seq = 0
        # mirrors counts[8] of the last prepare: lets the engine skip the
        # per-doc ymx_has_pending call when binning flush work
        self._had_pending = False
        # plan-cache digest chain: advances on every successful
        # prepare / deterministic compact, poisons on anything else
        self.plan_frontier = _pc.seed_frontier(root_name)
        # extra per-row source columns the shadow DocMirror has no slot for
        self._src_ofs2: list[int] = []
        self._src_end2: list[int] = []
        self._src_count: list[int] = []
        self._src_v2: list[int] = []

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.ymx_free(h)

    # -- hot path -----------------------------------------------------------

    def ingest(self, update: bytes, v2: bool = False) -> None:
        self._incoming.append((update, v2))

    def _stage_bufs(self):
        """Register the staged updates with the core; returns
        (staged, buf_ids, v2_flags) with the facade pins recorded."""
        lib, h = self._lib, self._h
        staged = self._incoming
        n_up = len(staged)
        ids = np.empty(max(1, n_up), np.int64)
        v2s = np.empty(max(1, n_up), np.int64)
        for j, (u, v2) in enumerate(staged):
            arr = np.frombuffer(u, np.uint8)
            bid = lib.ymx_add_buf(
                h, arr.ctypes.data_as(_u8p), ctypes.c_uint64(len(u))
            )
            self._py_bufs[int(bid)] = (u, arr)
            ids[j] = bid
            v2s[j] = 1 if v2 else 0
        return staged, ids, v2s

    def plan_key(self, want_levels: bool, want_sched: bool = True):
        """Plan-cache key for the staged work: kind + frontier + staged
        content digest + plan-shape flags (the flags change the cloned
        ``plan`` member, not the integrated state)."""
        return (
            "n",
            self.plan_frontier,
            _pc.staged_digest(self._incoming),
            bool(want_levels),
            bool(want_sched),
        )

    def adopt_cached(self, entry) -> np.ndarray:
        """Replay a cached post-prepare snapshot onto this doc's handle
        instead of planning: one deep state clone, then the same
        bookkeeping a real prepare would do.  ``entry`` is anything with
        ``h`` (source handle), ``counts``, ``pins`` and
        ``frontier_after`` — a cache entry or a just-planned leader
        mirror wrapped by the engine."""
        self._lib.ymx_clone_state(self._h, entry.h)
        self._incoming = []
        self._plan_seq += 1
        self._had_pending = bool(entry.counts[8])
        # the clone's borrowed buffer pointers reference the source's
        # pinned update payloads; share the pins to keep them alive
        self._py_bufs = dict(entry.pins)
        self._realized.clear()
        self._synced_gen = -1  # force a full shadow rebuild on next _sync
        self.plan_frontier = entry.frontier_after
        return np.array(entry.counts, np.int64, copy=True)

    def _finish_prepare(self, rc, staged, ids, counts) -> None:
        """Post-prepare bookkeeping shared by the per-doc and batched
        paths; raises exactly like the old inline prepare_step body."""
        lib, h = self._lib, self._h
        n_up = len(staged)
        self._incoming = []
        self._plan_seq += 1
        self._had_pending = bool(counts[8])
        if rc != 0:
            # the core may have merged a prefix before failing — this
            # state is not a deterministic function of the digest chain,
            # so no other mirror may ever alias it
            self.plan_frontier = _pc.poison_frontier()
            _pc.note_invalidation("plan-error")
        if rc == -9:
            raise UnsupportedUpdate("subdocument (content ref 9)")
        if rc != 0:
            # truly malformed bytes must raise the same error the Python
            # mirror would; anything the Python decoder accepts is a
            # native-scope limitation -> demote like other scope gaps
            try:
                for u, v2 in staged:
                    decode_update_refs(u, v2)
            except Exception:
                # scan-phase failure: nothing merged; unregister the staged
                # buffers so a catch-and-retry loop cannot accumulate pins
                if n_up:
                    first = int(ids[0])
                    lib.ymx_drop_bufs_from(h, first)
                    for j in range(n_up):
                        self._py_bufs.pop(int(ids[j]), None)
                self._incoming = staged
                raise
            raise UnsupportedUpdate(f"native plan: unsupported payload (rc={rc})")
        self._realized.clear()
        self.plan_frontier = _pc.fold(
            self.plan_frontier, b"u", _pc.staged_digest(staged)
        )

    def make_plan(self, counts) -> NativePlan:
        """Wrap the core's current plan (valid until the next prepare)."""
        return NativePlan(self._lib, self._h, counts, self)

    def prepare_step(self, want_levels: bool | None = None) -> NativePlan:
        # default matches DocMirror: compute the full plan (level schedule
        # included); the engine passes want_levels=False on the bulk path
        if want_levels is None:
            want_levels = True
        lib, h = self._lib, self._h
        _sync_plan_segment(lib)
        staged, ids, v2s = self._stage_bufs()
        counts = np.zeros(16, np.int64)
        rc = lib.ymx_prepare(
            h, _p64(ids), _p64(v2s), len(staged), 1 if want_levels else 0,
            _p64(counts),
        )
        self._finish_prepare(rc, staged, ids, counts)
        return NativePlan(lib, h, counts, self)

    def content_gen(self) -> int:
        """Monotonic change counter (the C++ core's ``gen``): bumps on
        every integrated mutation AND at the end of every prepare, so
        delete-only flushes are visible to cached consumers."""
        return int(self._lib.ymx_gen(self._h))

    @property
    def n_rows(self) -> int:
        return int(self._lib.ymx_n_rows(self._h))

    @property
    def n_segs(self) -> int:
        return int(self._lib.ymx_n_segs(self._h))

    def has_pending(self) -> bool:
        return bool(self._lib.ymx_has_pending(self._h))

    def host_nbytes(self) -> int:
        """Rough host bytes this mirror holds (warm-tier accounting,
        tiering): pinned update payloads + a per-row core estimate."""
        return (
            sum(len(u) for u, _arr in self._py_bufs.values())
            + self.n_rows * 96
            + self.n_segs * 48
        )

    def deleted_ratio(self) -> float:
        """Deleted content length / total inserted length — the tier GC
        trigger.  Straight from the core's state/DS exports;
        no shadow sync, no device traffic."""
        lib, h = self._lib, self._h
        ns = int(lib.ymx_n_slots(h))
        if not ns:
            return 0.0
        state = np.empty(ns, np.int64)
        lib.ymx_state(h, _p64(state))
        total = int(state.sum())
        if not total:
            return 0.0
        nds = int(lib.ymx_ds_count(h))
        if not nds:
            return 0.0
        ds_slot = np.empty(nds, np.int64)
        ds_clock = np.empty(nds, np.int64)
        ds_len = np.empty(nds, np.int64)
        lib.ymx_ds(h, _p64(ds_slot), _p64(ds_clock), _p64(ds_len))
        return min(1.0, int(ds_len.sum()) / total)

    def pending_depth(self) -> int:
        return int(self._lib.ymx_pending_depth(self._h))

    def state_vector(self) -> dict[int, int]:
        lib, h = self._lib, self._h
        ns = int(lib.ymx_n_slots(h))
        if ns == 0:
            return {}
        clients = np.empty(ns, np.int64)
        state = np.empty(ns, np.int64)
        lib.ymx_clients(h, _p64(clients))
        lib.ymx_state(h, _p64(state))
        return {
            int(c): int(s) for c, s in zip(clients, state) if s > 0
        }

    def delete_set(self):
        """The doc's derived DeleteSet straight from the core — a cheap
        Snapshot capture (no shadow sync, no device I/O); the DocMirror
        twin is columns.py delete_set()."""
        from ..core import DeleteItem, DeleteSet

        lib, h = self._lib, self._h
        ds = DeleteSet()
        nds = int(lib.ymx_ds_count(h))
        if not nds:
            return ds
        ds_slot = np.empty(nds, np.int64)
        ds_clock = np.empty(nds, np.int64)
        ds_len = np.empty(nds, np.int64)
        lib.ymx_ds(h, _p64(ds_slot), _p64(ds_clock), _p64(ds_len))
        ns = int(lib.ymx_n_slots(h))
        clients = np.empty(max(1, ns), np.int64)
        lib.ymx_clients(h, _p64(clients))
        by_client: dict[int, list[tuple[int, int]]] = {}
        for s, c, ln in zip(
            ds_slot.tolist(), ds_clock.tolist(), ds_len.tolist()
        ):
            by_client.setdefault(int(clients[s]), []).append((c, ln))
        for cl, ranges in by_client.items():
            ds.clients[cl] = [
                DeleteItem(clock, ln)
                for clock, ln in DocMirror._union_ranges(ranges)
            ]
        return ds

    def static_columns(self, start: int = 0) -> dict[str, np.ndarray]:
        lib, h = self._lib, self._h
        n = self.n_rows - start
        client_key = np.empty(n, np.uint32)
        cols = {k: np.empty(n, np.int32) for k in
                ("origin_slot", "origin_clock", "right_slot", "right_clock",
                 "origin_row")}
        lib.ymx_static_cols(
            h, start, client_key.ctypes.data_as(_u32p),
            _p32(cols["origin_slot"]), _p32(cols["origin_clock"]),
            _p32(cols["right_slot"]), _p32(cols["right_clock"]),
            _p32(cols["origin_row"]),
        )
        return {"client_key": client_key, **cols}

    # -- compaction ---------------------------------------------------------

    def rebuild_compacted_self(self, gc: bool):
        """Compact from the mirror's own list state — no device read-back
        (the flush invariant keeps mirror links == device links).  On a
        stale binary-only .so without ymx_compact_self, the same inputs
        are synthesized host-side from the core's link/head exports and
        fed to the original ymx_compact — still zero device traffic."""
        lib, h = self._lib, self._h
        n = self.n_rows
        nseg = self.n_segs
        new_right = np.full(max(1, n), NULL, np.int32)
        new_del = np.zeros(max(1, n), np.uint8)
        new_heads = np.full(max(1, nseg), NULL, np.int32)
        if getattr(lib, "_has_compact_self", False):
            n_new = lib.ymx_compact_self(
                h, int(bool(gc)), _p32(new_right),
                new_del.ctypes.data_as(_u8p), _p32(new_heads),
                len(new_heads),
            )
            self._realized.clear()
            # compaction-from-self is a pure function of state already in
            # the chain: a deterministic fold, so two docs compacted at
            # the same point keep aliasing each other's cache entries
            self.plan_frontier = _pc.fold(
                self.plan_frontier, b"compact-self", b"g" if gc else b"-"
            )
            _pc.note_invalidation("compact")
            return (
                new_right[:n_new],
                new_del[:n_new].astype(bool),
                new_heads,
            )
        links = np.full(max(1, n), NULL, np.int64)
        if n:
            lib.ymx_links(h, _p64(links))
        heads = np.full(max(1, nseg), NULL, np.int64)
        if nseg:
            lib.ymx_heads(h, _p64(heads))
        deleted = np.zeros(max(1, n), bool)
        for r in self._host_deleted_rows:
            deleted[r] = True
        return self.rebuild_compacted(
            links.astype(np.int32), deleted, heads.astype(np.int32), gc
        )

    def rebuild_compacted(self, right_link, deleted, head_of_seg, gc: bool):
        lib, h = self._lib, self._h
        n = self.n_rows
        nseg = self.n_segs
        right = np.ascontiguousarray(np.asarray(right_link)[: max(1, n)],
                                     np.int32)
        dele = np.ascontiguousarray(
            np.asarray(deleted)[: max(1, n)].astype(np.uint8)
        )
        heads = np.ascontiguousarray(np.asarray(head_of_seg), np.int32)
        new_right = np.full(max(1, n), NULL, np.int32)
        new_del = np.zeros(max(1, n), np.uint8)
        new_heads = np.full(max(1, nseg), NULL, np.int32)
        n_new = lib.ymx_compact(
            h, _p32(right), dele.ctypes.data_as(_u8p), _p32(heads),
            len(heads), int(bool(gc)), _p32(new_right),
            new_del.ctypes.data_as(_u8p), _p32(new_heads), len(new_heads),
        )
        self._realized.clear()
        # link/deleted/head inputs come from the caller, so fold their
        # content in: same inputs -> same chain, anything else diverges
        self.plan_frontier = _pc.fold(
            self.plan_frontier,
            b"compact",
            right.tobytes() + dele.tobytes() + heads.tobytes()
            + (b"g" if gc else b"-"),
        )
        _pc.note_invalidation("compact")
        return (
            new_right[:n_new],
            new_del[:n_new].astype(bool),
            new_heads,
        )

    # -- native wire encodes -------------------------------------------------

    def encode_diff_update(
        self, target_sv: dict[int, int] | None, ds_ranges=None,
        v2: bool = False,
    ) -> bytes | None:
        """The doc's diff against ``target_sv`` encoded fully natively
        (reference encodeStateAsUpdate, encoding.js:490-526); ``ds_ranges``
        overrides the DS section (the flush-novelty form); ``v2`` selects
        the 9-stream columnar container.  Returns None when the native
        writer cannot serve the selection — for V1 output that is V2-framed
        embed/format/type payloads, for V2 output V1-framed ones, plus any
        Python-realized (spilled) content — and callers fall back to the
        shadow's encode."""
        lib, h = self._lib, self._h
        sv = target_sv or {}
        n_sv = len(sv)
        svc = np.fromiter(sv.keys(), np.int64, n_sv) if n_sv else np.zeros(1, np.int64)
        svk = np.fromiter(sv.values(), np.int64, n_sv) if n_sv else np.zeros(1, np.int64)
        if ds_ranges is None:
            ds = np.zeros(3, np.int64)
            n_ds, override = 0, 0
        else:
            n_ds = len(ds_ranges)
            ds = (
                np.asarray(ds_ranges, np.int64).reshape(-1)
                if n_ds
                else np.zeros(3, np.int64)
            )
            override = 1
        fn = lib.ymx_encode_diff_v2 if v2 else lib.ymx_encode_diff
        cap = int(lib.ymx_encode_bound(h))
        for _attempt in range(2):
            out = np.empty(cap, np.uint8)
            rc = int(
                fn(
                    h, _p64(svc), _p64(svk), n_sv, _p64(ds), n_ds,
                    override, out.ctypes.data_as(_u8p),
                    ctypes.c_uint64(len(out)),
                )
            )
            if rc < -100:  # overflow: the V2 writer reports the exact
                # size needed (the bound is V1-derived) — retry once with
                # an exact buffer rather than degrading to Python
                cap = -rc
                continue
            if rc < 0:
                return None
            return out[:rc].tobytes()
        return None

    def encode_state_as_update(self, target_sv=None, v2: bool = False) -> bytes:
        u = self.encode_diff_update(target_sv, v2=v2)
        if u is not None:
            return u
        self._sync()
        return DocMirror.encode_state_as_update(self._py, target_sv, v2=v2)

    def encode_step_update(self, pre_sv, plan, v2: bool = False) -> bytes | None:
        u = self.encode_diff_update(pre_sv, ds_ranges=plan.applied_ds, v2=v2)
        if u is not None:
            # a no-novelty update means the flush changed nothing visible —
            # match the None contract (V1: 0 groups + 0 DS clients; the V2
            # container's empty form is longer, compare against it)
            if not v2 and u == b"\x00\x00":
                return None
            if v2 and u == _EMPTY_V2:
                return None
            return u
        self._sync()
        return DocMirror.encode_step_update(self._py, pre_sv, plan, v2=v2)

    # -- content realization -------------------------------------------------

    def realized_content(self, row: int):
        c = self._realized.get(row)
        if c is not None:
            return c
        self._sync()
        py = self._py
        kind = py.row_src_kind[row]
        ref = py.row_content_ref[row]
        if kind == SRC_NONE:
            return None
        buf = py._bufs[py.row_src_buf[row]] if py.row_src_buf[row] >= 0 else b""
        ofs, end = py.row_src_ofs[row], py.row_src_end[row]
        if kind == SRC_DELETED:
            from ..core import ContentDeleted

            c = ContentDeleted(py.row_len[row])
        elif kind == SRC_UTF8:
            from ..core import ContentString

            c = ContentString(utf8_decode_u16(buf[ofs:end]))
        elif kind == SRC_FRAMED:
            c = LazyContent(buf, ofs, ref, end).realize()
        elif kind in (SRC_ANYS, SRC_JSONS):
            # synthesize the V1 framing (varuint count + elements) and use
            # the reference read path so element semantics cannot drift
            from ..lib0 import encoding as lib0enc

            enc = lib0enc.Encoder()
            lib0enc.write_var_uint(enc, self._src_count[row])
            synth = enc.to_bytes() + buf[ofs:end]
            c = LazyContent(synth, 0, ref, len(synth)).realize()
        elif kind == SRC_V2LAZY:
            c = LazyContentV2(
                buf, ref, ofs, end,
                self._src_ofs2[row], self._src_end2[row],
                self._src_count[row],
            ).realize()
        else:  # SRC_SPILL never originates here
            raise AssertionError(f"unexpected src kind {kind}")
        self._realized[row] = c
        return c

    # -- shadow sync + delegation -------------------------------------------

    def _sync(self) -> None:
        lib, h = self._lib, self._h
        gen = int(lib.ymx_gen(h))
        if gen == self._synced_gen:
            return
        py = self._py
        n = self.n_rows
        cols = {k: np.empty(n, np.int64) for k in (
            "slot", "clock", "len", "oslot", "oclock", "rslot", "rclock",
            "is_gc", "countable", "ref", "seg", "src_kind", "src_buf",
            "src_ofs", "src_end", "src_ofs2", "src_end2", "src_count",
            "src_v2", "host_deleted", "lww_deleted",
        )}
        if n:
            lib.ymx_rows(h, 0, *(_p64(cols[k]) for k in cols))
        # numpy-backed shadow columns: the fetch is pure memcpy (no per-row
        # Python boxing), and every DocMirror read path accepts sequence
        # indexing — a 100k-row sync is a few MB of memcpy, not 2M tolist()
        # boxings
        py.row_slot = cols["slot"]
        py.row_clock = cols["clock"]
        py.row_len = cols["len"]
        py.row_origin_slot = cols["oslot"]
        py.row_origin_clock = cols["oclock"]
        py.row_right_slot = cols["rslot"]
        py.row_right_clock = cols["rclock"]
        py.row_is_gc = cols["is_gc"]
        py.row_countable = cols["countable"]
        py.row_content = [None] * n
        py.row_content_ref = cols["ref"]
        py.row_seg = cols["seg"]
        py.row_src_kind = cols["src_kind"]
        py.row_src_buf = cols["src_buf"]
        py.row_src_ofs = cols["src_ofs"]
        py.row_src_end = cols["src_end"]
        self._src_ofs2 = cols["src_ofs2"]
        self._src_end2 = cols["src_end2"]
        self._src_count = cols["src_count"]
        self._src_v2 = cols["src_v2"]
        py._host_deleted_rows = set(
            np.flatnonzero(cols["host_deleted"]).tolist()
        )
        py._lww_deleted = set(np.flatnonzero(cols["lww_deleted"]).tolist())

        ns = int(lib.ymx_n_slots(h))
        clients = np.empty(max(1, ns), np.int64)
        state = np.empty(max(1, ns), np.int64)
        if ns:
            lib.ymx_clients(h, _p64(clients))
            lib.ymx_state(h, _p64(state))
        py.client_of_slot = clients[:ns].tolist()
        py.slot_of_client = {c: i for i, c in enumerate(py.client_of_slot)}
        py.state = state[:ns].tolist()
        # host list state (the device right_link/starts mirror)
        links = np.empty(max(1, n), np.int64)
        if n:
            lib.ymx_links(h, _p64(links))
        py.list_next = links[:n]
        # fragment index: straight memcpy of the C++ index (already sorted)
        counts = np.zeros(max(1, ns), np.int64)
        if ns:
            lib.ymx_frag_counts(h, _p64(counts))
        py.frag_clock = []
        py.frag_row = []
        for s in range(ns):
            k = int(counts[s])
            fc = np.empty(max(1, k), np.int64)
            fr = np.empty(max(1, k), np.int64)
            if k:
                lib.ymx_frag(h, s, _p64(fc), _p64(fr))
            py.frag_clock.append(fc[:k])
            py.frag_row.append(fr[:k])

        # segments + interned strings
        nseg = self.n_segs
        blob_len = int(lib.ymx_strings_len(h))
        blob = np.empty(max(1, blob_len), np.uint8)
        if blob_len:
            lib.ymx_strings(h, blob.ctypes.data_as(_u8p))
        py._strings = bytearray(blob[:blob_len].tobytes())
        segc = {k: np.empty(max(1, nseg), np.int64) for k in
                ("name_ofs", "name_len", "sub_ofs", "sub_len", "parent")}
        if nseg:
            lib.ymx_segs(h, *(_p64(segc[k]) for k in segc))
        heads = np.empty(max(1, nseg), np.int64)
        if nseg:
            lib.ymx_heads(h, _p64(heads))
        py.head_of_seg = heads[:nseg]
        py.seg_name_ofs = segc["name_ofs"][:nseg].tolist()
        py.seg_name_len = segc["name_len"][:nseg].tolist()
        py.seg_sub_ofs = segc["sub_ofs"][:nseg].tolist()
        py.seg_sub_len = segc["sub_len"][:nseg].tolist()
        sb = bytes(py._strings)
        seg_info = []
        for i in range(nseg):
            no, nl = py.seg_name_ofs[i], py.seg_name_len[i]
            so, sl = py.seg_sub_ofs[i], py.seg_sub_len[i]
            name = utf8_decode_u16(sb[no : no + nl]) if no >= 0 else None
            sub = utf8_decode_u16(sb[so : so + sl]) if so >= 0 else None
            seg_info.append((name, sub, int(segc["parent"][i])))
        py.seg_info = seg_info
        py.segments = {key: i for i, key in enumerate(seg_info)}
        py._segs_of_parent = {}
        for i, (_n, _s, p) in enumerate(seg_info):
            if p != NULL:
                py._segs_of_parent.setdefault(p, []).append(i)
        py.map_chain = {}
        for i, (_n, sub, _p) in enumerate(seg_info):
            if sub is None:
                continue
            cl = int(lib.ymx_chain_len(h, i))
            if cl:
                chain = np.empty(cl, np.int64)
                lib.ymx_chain(h, i, _p64(chain))
                py.map_chain[i] = chain.tolist()

        # delete-set ranges in slot first-note order
        nds = int(lib.ymx_ds_count(h))
        ds_slot = np.empty(max(1, nds), np.int64)
        ds_clock = np.empty(max(1, nds), np.int64)
        ds_len = np.empty(max(1, nds), np.int64)
        if nds:
            lib.ymx_ds(h, _p64(ds_slot), _p64(ds_clock), _p64(ds_len))
        py.ds = {}
        for s, c, ln in zip(
            ds_slot[:nds].tolist(), ds_clock[:nds].tolist(),
            ds_len[:nds].tolist()
        ):
            py.ds.setdefault(s, []).append((c, ln))

        # buffer table: Python-origin bytes + arena chunks fetched once
        nb = int(lib.ymx_n_bufs(h))
        bufs: list[bytes] = []
        for i in range(nb):
            known = self._py_bufs.get(i)
            if known is not None:
                bufs.append(known[0])
            else:
                ln = int(lib.ymx_buf_len(h, i))
                chunk = np.empty(max(1, ln), np.uint8)
                if ln:
                    lib.ymx_copy_bytes(
                        h, i, 0, ln, chunk.ctypes.data_as(_u8p)
                    )
                b = chunk[:ln].tobytes()
                self._py_bufs[i] = (b, chunk)
                bufs.append(b)
        py._bufs = bufs

        py._gen = gen
        py._np_gen = -1
        py._ds_gen = gen
        py._ds_np_gen = -1
        self._synced_gen = gen

    def __getattr__(self, name):
        if name.startswith("__") or "_py" not in self.__dict__:
            raise AttributeError(name)
        self._sync()
        return getattr(self.__dict__["_py"], name)


def prepare_many(work, want_levels: bool = False, want_sched: bool = True,
                 obs=None):
    """Batched ymx_prepare over many NativeMirrors in ONE native call.

    ``work`` is a list of ``(doc_idx, NativeMirror)``.  Returns
    ``(counts, rcs, staged_info)`` where ``counts`` is an ``(n, 16)``
    int64 array (ymx_prepare layout + ``[14]`` = dense-link flag),
    ``rcs`` the per-doc return codes, and ``staged_info`` the
    per-doc ``(staged, ids)`` needed by ``_finish_prepare``.

    ``obs`` (an :class:`yjs_tpu.obs.EngineObs`) records each call's wall
    time and doc count into the ``ytpu_native_prepare_many_*`` histograms
    — the planner-pool visibility the engine's per-flush timers cannot
    give once flushes span multiple chunks.

    ``want_sched=False`` skips building each plan's sched section
    (``NativePlan.sched`` then reads back empty) — ONLY safe when no
    consumer will read it, e.g. the bulk-apply flush with no event
    listeners; ``ymx_prepare``/``prepare_step`` always build it.

    Replaces the per-doc ctypes round trip that made the host planner
    72% of distinct-doc flush time (host phase timers).
    """
    t0 = time.perf_counter()
    n = len(work)
    lib = work[0][1]._lib
    _sync_plan_segment(lib)
    handles = (ctypes.c_void_p * n)()
    buf_ofs = np.zeros(n + 1, np.int64)
    if getattr(lib, "_has_add_bufs_many", False):
        # batched staging: ONE native call registers every staged buffer.
        # The c_char_p array extracts each bytes object's pointer in C
        # (no per-buffer numpy view); the bytes stay pinned via _py_bufs.
        all_bytes: list[bytes] = []
        v2_list: list[int] = []
        buf_hs = []
        for k, (_i, m) in enumerate(work):
            staged = m._incoming
            buf_ofs[k + 1] = buf_ofs[k] + len(staged)
            for u, v2 in staged:
                all_bytes.append(u)
                v2_list.append(1 if v2 else 0)
                buf_hs.append(m._h)
            handles[k] = m._h
        nb_tot = len(all_bytes)
        ids_flat = np.zeros(max(1, nb_tot), np.int64)
        v2_flat = np.asarray(v2_list or [0], np.int64)
        if nb_tot:
            ptrs = (ctypes.c_char_p * nb_tot)(*all_bytes)
            lens = np.fromiter(
                (len(u) for u in all_bytes), np.uint64, nb_tot
            )
            bhs = (ctypes.c_void_p * nb_tot)(*buf_hs)
            lib.ymx_add_bufs_many(
                bhs, ptrs,
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                nb_tot,
                _p64(ids_flat),
            )
        staged_info = []
        o = 0
        for k, (_i, m) in enumerate(work):
            staged = m._incoming
            nb = len(staged)
            ids = ids_flat[o : o + nb]
            for j, (u, _v2) in enumerate(staged):
                m._py_bufs[int(ids[j])] = (u, None)
            staged_info.append((staged, np.asarray(ids, np.int64)))
            o += nb
    else:  # stale binary-only .so: per-doc staging
        ids_parts, v2_parts, staged_info = [], [], []
        for k, (_i, m) in enumerate(work):
            staged, ids, v2s = m._stage_bufs()
            nb = len(staged)
            staged_info.append((staged, ids))
            buf_ofs[k + 1] = buf_ofs[k] + nb
            if nb:
                ids_parts.append(ids[:nb])
                v2_parts.append(v2s[:nb])
            handles[k] = m._h
        ids_flat = (
            np.concatenate(ids_parts) if ids_parts else np.zeros(1, np.int64)
        )
        v2_flat = (
            np.concatenate(v2_parts) if v2_parts else np.zeros(1, np.int64)
        )
    counts = np.zeros((n, 16), np.int64)
    rcs = np.zeros(n, np.int64)
    lib.ymx_prepare_many(
        handles, n, _p64(buf_ofs), _p64(ids_flat), _p64(v2_flat),
        1 if want_levels else 0, 1 if want_sched else 0, _p64(counts),
        _p64(rcs),
    )
    dt = time.perf_counter() - t0
    if obs is not None:
        obs.native_prepare(n, dt)
    from ..obs.prof import kernel_profiler

    kernel_profiler().record_host_op("prepare_many", dt)
    return counts, rcs, staged_info


def pack_apply_lanes(work, doc_ids, b_loc, n_shards, widths, oob_r, oob_s,
                     null_val, dtype=np.int32, out=None):
    """Fill the bulk-apply scatter lanes for ``work`` (post-prepare
    ``(doc_idx, NativeMirror)`` entries, rc==0) natively.  Returns
    ``(lanes, stats)`` with ``lanes`` shaped ``(n_shards, lane_w)`` and
    ``stats = [n_dense, n_sparse, n_heads, n_dels]`` real elements —
    the native twin of BatchEngine._flush_apply's pack loop.

    ``dtype=np.int16`` halves the transfer when every row/seg index fits
    16 bits (the caller checks capacity); the kernel widens on device.
    ``out`` reuses a caller-owned ``(n_shards, lane_w)`` staging buffer
    (the flush pipeline's double-buffered pair) instead of allocating."""
    k_dn, k_sp, k_h, k_d = widths
    n = len(work)
    lib = work[0][1]._lib
    handles = (ctypes.c_void_p * n)()
    for k, (_i, m, *_rest) in enumerate(work):
        handles[k] = m._h
    lane_w = 4 * b_loc + k_dn + 2 * k_sp + 2 * k_h + k_d
    if out is not None and out.shape == (n_shards, lane_w) and out.dtype == dtype:
        lanes = out
    else:
        lanes = np.empty((n_shards, lane_w), dtype)
    stats = np.zeros(4, np.int64)
    ids = np.ascontiguousarray(doc_ids, np.int64)
    fn = lib.ymx_pack_apply16 if dtype == np.int16 else lib.ymx_pack_apply
    fn(
        handles, _p64(ids), n, b_loc, n_shards, k_dn, k_sp, k_h, k_d,
        ctypes.c_int32(oob_r), ctypes.c_int32(oob_s),
        ctypes.c_int32(null_val),
        lanes.ctypes.data_as(ctypes.c_void_p), _p64(stats),
    )
    return lanes, stats
