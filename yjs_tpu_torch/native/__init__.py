"""ctypes loader for the native transcoder (transcode.cpp).

Builds lazily with g++ on first use into ``yjs_tpu_torch/_build/`` (see
:mod:`..buildlib`: a digest-named library, built under a file lock and
moved into place atomically); unavailable when no toolchain exists or
YTPU_NO_NATIVE is set — callers fall back to the pure-Python codec.
Unavailability is logged ONCE (a silent 10-50x host-path slowdown would
otherwise be invisible); set YTPU_NO_NATIVE to opt out quietly.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import time

import numpy as np

from ..buildlib import build_shared

logger = logging.getLogger("yjs_tpu_torch.native")

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "transcode.cpp")
_SRC_PLAN = os.path.join(_DIR, "plancore.cpp")
_SRC_WIRE = os.path.join(_DIR, "wire.h")

_lib = None
_tried = False
# wall seconds of the g++ build this process ran (0.0 when a cached
# build was loaded); chip_smoke.py reports it
build_seconds = 0.0


def _build() -> str | None:
    """Path of the built library, or None (logged) when g++ fails."""
    global build_seconds
    srcs = [_SRC, _SRC_PLAN]

    def cmd(out):
        return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                "-o", out] + srcs

    t0 = time.perf_counter()
    try:
        path, built, _out = build_shared(
            "_transcode", srcs, cmd, deps=[_SRC_WIRE], timeout=600
        )
    except subprocess.CalledProcessError as e:
        logger.warning(
            "native transcoder failed to compile (pure-Python codec will "
            "serve the host path, 10-50x slower): %s",
            (e.stderr or b"").decode(errors="replace")[-500:],
        )
        return None
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning(
            "native transcoder unavailable (%s: %s); pure-Python codec "
            "will serve the host path, 10-50x slower",
            type(e).__name__, e,
        )
        return None
    if built:
        build_seconds = time.perf_counter() - t0
    return path


def load():
    """The loaded library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("YTPU_NO_NATIVE"):
        return None
    so_path = _build()
    if so_path is None:
        return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError as e:
        logger.warning(
            "native transcoder failed to load (%s); pure-Python codec "
            "will serve the host path, 10-50x slower", e,
        )
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ytpu_count_v1.restype = ctypes.c_int
    lib.ytpu_count_v1.argtypes = [u8p, ctypes.c_uint64, u64p, u64p]
    lib.ytpu_decode_v1.restype = ctypes.c_int
    lib.ytpu_decode_v1.argtypes = [u8p, ctypes.c_uint64] + [i64p] * 19
    lib.ytpu_count_v2.restype = ctypes.c_int
    lib.ytpu_count_v2.argtypes = [u8p, ctypes.c_uint64, u64p, u64p]
    lib.ytpu_decode_v2.restype = ctypes.c_int
    lib.ytpu_decode_v2.argtypes = [u8p, ctypes.c_uint64] + [i64p] * 22
    lib.ytpu_encode_v1.restype = ctypes.c_int64
    lib.ytpu_encode_v1.argtypes = (
        [ctypes.POINTER(u8p), u64p, ctypes.c_uint64]      # bufs
        + [i64p] * 3 + [ctypes.c_uint64]                  # row groups
        + [i64p] * 18                                     # row columns
        + [u8p, ctypes.c_uint64]                          # strings blob
        + [i64p] * 3 + [ctypes.c_uint64] + [i64p] * 2     # ds groups
        + [u8p, ctypes.c_uint64]                          # out
    )
    # plan-core (plancore.cpp) entry points; absent in a stale binary-only
    # .so — the caller checks has_plancore()
    try:
        i64 = ctypes.c_int64
        u64 = ctypes.c_uint64
        vp = ctypes.c_void_p
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.ymx_new.restype = vp
        lib.ymx_free.argtypes = [vp]
        lib.ymx_add_buf.restype = i64
        lib.ymx_add_buf.argtypes = [vp, u8p, u64]
        lib.ymx_n_bufs.restype = i64
        lib.ymx_n_bufs.argtypes = [vp]
        lib.ymx_buf_len.restype = i64
        lib.ymx_buf_len.argtypes = [vp, i64]
        lib.ymx_prepare.restype = ctypes.c_int
        lib.ymx_prepare.argtypes = [vp, i64p, i64p, i64, ctypes.c_int, i64p]
        vpp = ctypes.POINTER(vp)
        lib.ymx_prepare_many.restype = None
        lib.ymx_prepare_many.argtypes = [vpp, i64, i64p, i64p, i64p,
                                         ctypes.c_int, ctypes.c_int, i64p,
                                         i64p]
        for pack_name in ("ymx_pack_apply", "ymx_pack_apply16"):
            fn = getattr(lib, pack_name)
            fn.restype = None
            fn.argtypes = [vpp, i64p, i64, i64, i64, i64, i64, i64, i64,
                           ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                           vp, i64p]
        for name, args in [
            ("ymx_plan_splits", [vp, i64p]),
            ("ymx_plan_sched", [vp, i64p]),
            ("ymx_plan_sched8", [vp, i64p, i64p]),
            ("ymx_plan_deletes", [vp, i64p]),
            ("ymx_plan_applied_ds", [vp, i64p]),
            ("ymx_plan_links", [vp, i64p, i64p]),
            ("ymx_links", [vp, i64p]),
            ("ymx_heads", [vp, i64p]),
            ("ymx_plan_heads", [vp, i64p, i64p]),
            ("ymx_clients", [vp, i64p]),
            ("ymx_state", [vp, i64p]),
            ("ymx_segs", [vp, i64p, i64p, i64p, i64p, i64p]),
            ("ymx_strings", [vp, u8p]),
            ("ymx_chain", [vp, i64, i64p]),
            ("ymx_ds", [vp, i64p, i64p, i64p]),
        ]:
            getattr(lib, name).restype = None
            getattr(lib, name).argtypes = args
        lib.ymx_frag_counts.restype = None
        lib.ymx_frag_counts.argtypes = [vp, i64p]
        lib.ymx_frag.restype = None
        lib.ymx_frag.argtypes = [vp, i64, i64p, i64p]
        lib.ymx_drop_bufs_from.restype = None
        lib.ymx_drop_bufs_from.argtypes = [vp, i64]
        for name in ("ymx_n_rows", "ymx_n_slots", "ymx_n_segs",
                     "ymx_pending_depth", "ymx_ds_count"):
            getattr(lib, name).restype = i64
            getattr(lib, name).argtypes = [vp]
        lib.ymx_gen.restype = u64
        lib.ymx_gen.argtypes = [vp]
        lib.ymx_strings_len.restype = u64
        lib.ymx_strings_len.argtypes = [vp]
        lib.ymx_chain_len.restype = i64
        lib.ymx_chain_len.argtypes = [vp, i64]
        lib.ymx_has_pending.restype = ctypes.c_int
        lib.ymx_has_pending.argtypes = [vp]
        lib.ymx_rows.restype = None
        lib.ymx_rows.argtypes = [vp, i64] + [i64p] * 21
        lib.ymx_static_cols.restype = None
        lib.ymx_static_cols.argtypes = [vp, i64, u32p] + [i32p] * 5
        lib.ymx_copy_bytes.restype = ctypes.c_int
        lib.ymx_copy_bytes.argtypes = [vp, i64, i64, i64, u8p]
        lib.ymx_encode_bound.restype = i64
        lib.ymx_encode_bound.argtypes = [vp]
        lib.ymx_encode_diff.restype = i64
        lib.ymx_encode_diff.argtypes = [vp, i64p, i64p, i64, i64p, i64,
                                        ctypes.c_int, u8p, u64]
        lib.ymx_encode_diff_v2.restype = i64
        lib.ymx_encode_diff_v2.argtypes = [vp, i64p, i64p, i64, i64p, i64,
                                           ctypes.c_int, u8p, u64]
        lib.ymx_compact.restype = i64
        lib.ymx_compact.argtypes = [vp, i32p, u8p, i32p, i64, ctypes.c_int,
                                    i32p, u8p, i32p, i64]
        lib._has_plancore = True
    except AttributeError:
        lib._has_plancore = False
    # per-feature probes: later symbols degrade gracefully on a
    # stale binary-only .so instead of disabling the whole planner
    try:
        p32 = ctypes.POINTER(ctypes.c_int32)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        lib.ymx_compact_self.restype = ctypes.c_int64
        lib.ymx_compact_self.argtypes = [
            ctypes.c_void_p, ctypes.c_int, p32, pu8, p32, ctypes.c_int64,
        ]
        lib._has_compact_self = True
    except AttributeError:
        lib._has_compact_self = False
    try:
        # diagnostic: ymx_prepare_many's worker-pool width (surfaced as
        # last_flush_metrics["plan_threads"])
        lib.ymx_plan_threads.restype = ctypes.c_int
        lib.ymx_plan_threads.argtypes = []
        lib._has_plan_threads = True
    except AttributeError:
        lib._has_plan_threads = False
    try:
        # one ctypes crossing registers every staged buffer of a flush
        lib.ymx_add_bufs_many.restype = None
        lib.ymx_add_bufs_many.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib._has_add_bufs_many = True
    except AttributeError:
        lib._has_add_bufs_many = False
    try:
        # deep state clone — the frontier-keyed plan cache replays a
        # cached post-prepare mirror state onto another doc's handle
        lib.ymx_clone_state.restype = ctypes.c_int64
        lib.ymx_clone_state.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib._has_clone_state = True
    except AttributeError:
        lib._has_clone_state = False
    try:
        # emit_row chain-run anchor adoption — Python mirrors the
        # YTPU_PLAN_SEGMENT knob into the lib and diffs the hit/lookup
        # totals around each flush for the shared metrics schema
        lib.ymx_set_plan_segment.restype = None
        lib.ymx_set_plan_segment.argtypes = [ctypes.c_int]
        lib.ymx_plan_segment_stats.restype = None
        lib.ymx_plan_segment_stats.argtypes = [
            ctypes.POINTER(ctypes.c_int64)
        ]
        lib._has_plan_segment = True
    except AttributeError:
        lib._has_plan_segment = False
    _lib = lib
    return _lib


def has_plancore() -> bool:
    lib = load()
    return bool(lib is not None and getattr(lib, "_has_plancore", False))


# content-source kinds for ytpu_encode_v1 (must match transcode.cpp)
SRC_NONE, SRC_DELETED, SRC_FRAMED, SRC_UTF8, SRC_SPILL = 0, 1, 2, 3, 4
# element-range kinds emitted by the native plan core (plancore.cpp):
# `length` elements at [ofs,end) — ContentAny any-values / ContentJSON
# var_strings; SRC_V2LAZY marks V2-framed embed/format/type payloads that
# must be re-framed via the Python spill path when writing V1
SRC_ANYS, SRC_JSONS, SRC_V2LAZY = 5, 6, 7


def encode_v1_update(
    bufs: list[bytes],
    group_client, group_start, group_len,
    row_cols: dict,
    strings: bytes,
    ds_group_client, ds_group_start, ds_group_len,
    ds_clock, ds_len,
    out_cap: int,
) -> bytes:
    """Assemble a V1 update natively from pre-marshalled columns.  All
    array arguments are int64 numpy arrays; ``row_cols`` holds the 18
    per-row columns in ABI order.  Raises NativeDecodeError when the
    library is unavailable or encoding fails (caller falls back to the
    Python encoder)."""
    lib = load()
    if lib is None:
        raise NativeDecodeError("native transcoder unavailable")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n_bufs = len(bufs)
    buf_arrs = [np.frombuffer(b, dtype=np.uint8) for b in bufs]
    buf_ptrs = (u8p * max(1, n_bufs))(
        *(a.ctypes.data_as(u8p) for a in buf_arrs)
    )
    buf_lens = np.asarray([len(b) for b in bufs], np.uint64)
    strings_a = np.frombuffer(strings, dtype=np.uint8) if strings else np.zeros(1, np.uint8)
    out = np.empty(out_cap, np.uint8)
    row_order = (
        "clock", "length", "offset",
        "origin_client", "origin_clock", "right_client", "right_clock",
        "content_ref", "name_ofs", "name_len", "sub_ofs", "sub_len",
        "parent_client", "parent_clock",
        "src_kind", "src_buf", "src_ofs", "src_end",
    )
    # materialize every array first: the ctypes pointers do not keep their
    # backing buffers alive
    keep = (
        [np.ascontiguousarray(a, np.int64)
         for a in (group_client, group_start, group_len)]
        + [np.ascontiguousarray(row_cols[k], np.int64) for k in row_order]
        + [np.ascontiguousarray(a, np.int64)
           for a in (ds_group_client, ds_group_start, ds_group_len,
                     ds_clock, ds_len)]
    )
    i64ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = lib.ytpu_encode_v1(
        buf_ptrs,
        buf_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_bufs,
        i64ptr(keep[0]), i64ptr(keep[1]), i64ptr(keep[2]),
        len(keep[0]),
        *(i64ptr(a) for a in keep[3:21]),
        strings_a.ctypes.data_as(u8p), len(strings),
        i64ptr(keep[21]), i64ptr(keep[22]), i64ptr(keep[23]),
        len(keep[21]),
        i64ptr(keep[24]), i64ptr(keep[25]),
        out.ctypes.data_as(u8p), out_cap,
    )
    if rc < 0:
        raise NativeDecodeError(f"native encode failed: {rc}")
    return out[:rc].tobytes()


class NativeDecodeError(Exception):
    pass


def decode_v1_columns(update: bytes):
    """Decode a V1 update into int64 column arrays via the native scanner.

    Returns (structs: dict[str, np.ndarray], ds: dict[str, np.ndarray]).
    Raises NativeDecodeError if the library is unavailable or parsing fails
    (caller falls back to the Python decoder).
    """
    lib = load()
    if lib is None:
        raise NativeDecodeError("native transcoder unavailable")
    buf = np.frombuffer(update, dtype=np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n_structs = ctypes.c_uint64()
    n_ds = ctypes.c_uint64()
    rc = lib.ytpu_count_v1(bp, len(update), ctypes.byref(n_structs), ctypes.byref(n_ds))
    if rc != 0:
        raise NativeDecodeError(f"count pass failed: {rc}")
    ns, nd = n_structs.value, n_ds.value
    cols = {
        k: np.empty(ns, np.int64)
        for k in (
            "client", "clock", "length",
            "origin_client", "origin_clock", "right_client", "right_clock",
            "info", "parent_name_ofs", "parent_name_len",
            "parent_id_client", "parent_id_clock",
            "parent_sub_ofs", "parent_sub_len", "content_ofs", "content_end",
        )
    }
    ds = {k: np.empty(nd, np.int64) for k in ("client", "clock", "len")}
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = lib.ytpu_decode_v1(
        bp, len(update),
        ptr(cols["client"]), ptr(cols["clock"]), ptr(cols["length"]),
        ptr(cols["origin_client"]), ptr(cols["origin_clock"]),
        ptr(cols["right_client"]), ptr(cols["right_clock"]),
        ptr(cols["info"]),
        ptr(cols["parent_name_ofs"]), ptr(cols["parent_name_len"]),
        ptr(cols["parent_id_client"]), ptr(cols["parent_id_clock"]),
        ptr(cols["parent_sub_ofs"]), ptr(cols["parent_sub_len"]),
        ptr(cols["content_ofs"]), ptr(cols["content_end"]),
        ptr(ds["client"]), ptr(ds["clock"]), ptr(ds["len"]),
    )
    if rc != 0:
        raise NativeDecodeError(f"decode pass failed: {rc}")
    return cols, ds


_V2_COLS = (
    "client", "clock", "length",
    "origin_client", "origin_clock", "right_client", "right_clock",
    "info", "parent_name_ofs", "parent_name_len",
    "parent_id_client", "parent_id_clock",
    "parent_sub_ofs", "parent_sub_len",
    "content_ofs", "content_end", "content_ofs2", "content_end2",
    "content_count",
)


def decode_v2_columns(update: bytes):
    """Decode a V2 columnar update (the 9-stream container, reference
    UpdateDecoder.js:270-293) into int64 column arrays via the native
    scanner.  String contents stay lazy as byte ranges into the in-buffer
    UTF-8 arena; rest-stream payloads (binary/embed/any) as self-delimiting
    byte ranges.  Raises NativeDecodeError when unavailable, on malformed
    input, or on legacy ContentJSON / subdoc ContentDoc payloads (caller
    falls back to the Python decoder)."""
    lib = load()
    if lib is None:
        raise NativeDecodeError("native transcoder unavailable")
    buf = np.frombuffer(update, dtype=np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n_structs = ctypes.c_uint64()
    n_ds = ctypes.c_uint64()
    rc = lib.ytpu_count_v2(bp, len(update), ctypes.byref(n_structs), ctypes.byref(n_ds))
    if rc != 0:
        raise NativeDecodeError(f"v2 count pass failed: {rc}")
    ns, nd = n_structs.value, n_ds.value
    cols = {k: np.empty(ns, np.int64) for k in _V2_COLS}
    ds = {k: np.empty(nd, np.int64) for k in ("client", "clock", "len")}
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = lib.ytpu_decode_v2(
        bp, len(update),
        *(ptr(cols[k]) for k in _V2_COLS),
        ptr(ds["client"]), ptr(ds["clock"]), ptr(ds["len"]),
    )
    if rc != 0:
        raise NativeDecodeError(f"v2 decode pass failed: {rc}")
    return cols, ds
