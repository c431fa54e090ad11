"""yjs_tpu_torch.obs.prof: compile-aware device/compile cost attribution.

Every device entry point (the kernel wrappers in ``ops/kernels.py``) is
wrapped with :func:`profiled`, which keeps a per-kernel set of abstract
call signatures — (shape, dtype, device) per tensor or array leaf, value
per static scalar.  A CUDA kernel is built once per process (the first
call builds ``ops/_cuda``'s library), and the signature set plays the
role a trace cache plays for a jitted program:

- first signature ever seen  -> a **compile**: the call's wall time
  (the first call's build + launch + run, synchronised) lands in
  ``ytpu_prof_compile_seconds{kernel,shape}``;
- a NEW signature on a kernel that already compiled -> additionally a
  **retrace**: counted in ``ytpu_prof_retraces_total`` and recorded as a
  bounded event list (``kernel_profiler().retrace_events``) carrying the
  offending abstract shapes, plus a tracer instant for Perfetto;
- a known signature -> a **cache hit**: dispatch wall time lands in
  ``ytpu_prof_device_seconds{kernel,shape}``.

Shape labels are power-of-two buckets of the largest array leaf's element
count, so label cardinality stays bounded while growth-driven retraces
remain attributable.

``YTPU_PROF_DEVICE=1`` additionally: synchronises the CUDA device
that holds the result (``torch.cuda.synchronize``) so device-time deltas
are exact instead of launch-only, and opens a
``torch.profiler.record_function`` range around every profiled call so
kernels are attributable inside a ``torch.profiler`` trace.  Leave it
unset on the hot path — forcing a sync per call defeats asynchronous
launches.

Host-side batch ops (``ops/batch.py`` columnar ops, the native planner's
``prepare_many``) record into ``ytpu_prof_batch_op_seconds{op}`` via
:func:`host_timed` / ``record_host_op``.

All families live on the process-global registry (kernels are
module-level, shared by every engine in the process), pre-registered at
import so exposition and ``scripts/check_metrics_schema.py`` see them
before the first kernel call.
"""

from __future__ import annotations

import functools
import os
import time
from collections import deque

from . import global_registry, obs_enabled
from .trace import Tracer

# retrace events kept for inspection (ytpu_top / tests); counters keep
# the full total
RETRACE_EVENTS_MAX = 256


def _leaves(obj, out: list) -> list:
    """Flatten tuples, lists and dict values (sorted by key) into
    ``out`` — the containers the kernel wrappers take."""
    if isinstance(obj, (tuple, list)):
        for x in obj:
            _leaves(x, out)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _leaves(obj[k], out)
    else:
        out.append(obj)
    return out


def _leaf_sig(leaf):
    shape = getattr(leaf, "shape", None)
    if shape is not None:
        dtype = str(getattr(leaf, "dtype", ""))
        device = getattr(leaf, "device", None)
        if device is not None and not isinstance(device, str):
            dtype = f"{dtype}@{device}"
        return (tuple(shape), dtype)
    if isinstance(leaf, (int, float, bool, str, bytes, type(None))):
        return leaf
    return type(leaf).__name__


def call_signature(args, kwargs) -> tuple:
    """Abstract signature of one call: (shape, dtype@device) per tensor
    leaf, value per hashable static."""
    return tuple(_leaf_sig(leaf) for leaf in _leaves((args, kwargs), []))


def _cuda_devices(out) -> set:
    return {
        leaf.device
        for leaf in _leaves(out, [])
        if getattr(getattr(leaf, "device", None), "type", None) == "cuda"
    }


def _sync(out) -> None:
    """Wait for the CUDA work that produced ``out`` (no-op on CPU)."""
    import torch

    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def shape_bucket(sig: tuple) -> str:
    """Power-of-two bucket of the largest array leaf's element count —
    the bounded-cardinality ``shape`` label."""
    biggest = 0
    for s in sig:
        if isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], tuple):
            n = 1
            for d in s[0]:
                n *= int(d)
            biggest = max(biggest, n)
    if biggest <= 0:
        return "scalar"
    p = 1
    while p < biggest:
        p <<= 1
    return f"le_{p}"


def _sig_str(sig: tuple, limit: int = 12) -> str:
    parts = []
    for s in sig[:limit]:
        if isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], tuple):
            parts.append(f"{s[1]}[{','.join(str(d) for d in s[0])}]")
        else:
            parts.append(repr(s))
    if len(sig) > limit:
        parts.append(f"...+{len(sig) - limit}")
    return " ".join(parts)


class KernelProfiler:
    """Process-wide build/launch cost attribution for device kernels.

    One instance per process (see :func:`kernel_profiler`); instruments
    live on the process-global registry so every engine's exposition
    includes them."""

    def __init__(self, registry=None, tracer: Tracer | None = None):
        self.enabled = obs_enabled()
        self.registry = registry if registry is not None else global_registry()
        # its own tracer: retrace instants ride YTPU_TRACE_PATH dumps
        # even with no engine in scope
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=self.enabled
        )
        r = self.registry
        self._compiles = r.counter(
            "ytpu_prof_compiles_total",
            "Profiled kernel calls that traced+compiled (first sighting "
            "of a call signature)",
            labelnames=("kernel",),
        )
        self._hits = r.counter(
            "ytpu_prof_cache_hits_total",
            "Profiled kernel calls served by an already-compiled "
            "signature",
            labelnames=("kernel",),
        )
        self._retraces = r.counter(
            "ytpu_prof_retraces_total",
            "New call signatures on already-compiled kernels (each one "
            "paid a fresh trace+compile)",
            labelnames=("kernel",),
        )
        self._compile_seconds = r.histogram(
            "ytpu_prof_compile_seconds",
            "Wall time of compiling calls (trace+lower+compile+run), by "
            "kernel and shape bucket",
            unit="s",
            labelnames=("kernel", "shape"),
        )
        self._device_seconds = r.histogram(
            "ytpu_prof_device_seconds",
            "Wall time of cache-hit kernel calls (dispatch; exact device "
            "time under YTPU_PROF_DEVICE=1), by kernel and shape bucket",
            unit="s",
            labelnames=("kernel", "shape"),
        )
        self._batch_op_seconds = r.histogram(
            "ytpu_prof_batch_op_seconds",
            "Host-side batch/columnar op wall time, by op",
            unit="s",
            labelnames=("op",),
        )
        self._signatures: dict[str, set] = {}
        self.retrace_events: deque = deque(maxlen=RETRACE_EVENTS_MAX)
        # (kernel, sig) -> (hit child, device-seconds child): the steady
        # state is two dict hits + arithmetic per call
        self._children: dict = {}
        self._host_children: dict = {}

    # -- recording -----------------------------------------------------

    def call(self, kernel: str, fn, args, kwargs):
        device_mode = os.environ.get("YTPU_PROF_DEVICE") == "1"
        sig = call_signature(args, kwargs)
        cached = self._children.get((kernel, sig))
        if cached is not None and not device_mode:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            cached[0].inc()
            cached[1].observe(dt)
            return out
        return self._call_slow(kernel, fn, args, kwargs, sig, device_mode)

    def _call_slow(self, kernel, fn, args, kwargs, sig, device_mode):
        import torch

        ann = (
            torch.profiler.record_function(f"ytpu.prof.{kernel}")
            if device_mode
            else None
        )
        compiling = (kernel, sig) not in self._children
        t0 = time.perf_counter()
        if ann is not None:
            with ann:
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        if device_mode or compiling:
            # block so the recorded delta covers the device work (and,
            # when compiling, the build itself) — not just the launch
            _sync(out)
        dt = time.perf_counter() - t0
        bucket = shape_bucket(sig)
        if not compiling:
            children = self._children[(kernel, sig)]
            children[0].inc()
            children[1].observe(dt)
            return out
        seen = self._signatures.setdefault(kernel, set())
        is_retrace = bool(seen)
        seen.add(sig)
        self._compiles.labels(kernel=kernel).inc()
        self._compile_seconds.labels(kernel=kernel, shape=bucket).observe(dt)
        if is_retrace:
            self._retraces.labels(kernel=kernel).inc()
            event = {
                "kernel": kernel,
                "shape": bucket,
                "signature": _sig_str(sig),
                "n_signatures": len(seen),
                "compile_s": dt,
            }
            self.retrace_events.append(event)
            self.tracer.instant("ytpu.prof.retrace", **event)
        self._children[(kernel, sig)] = (
            self._hits.labels(kernel=kernel),
            self._device_seconds.labels(kernel=kernel, shape=bucket),
        )
        return out

    def record_host_op(self, op: str, dt_s: float) -> None:
        child = self._host_children.get(op)
        if child is None:
            child = self._batch_op_seconds.labels(op=op)
            self._host_children[op] = child
        child.observe(dt_s)

    def host_op_stats(self) -> dict:
        """op -> ``{"count", "total_s"}`` from the host batch-op
        timers — the bench-phase view regression tests pin against
        (e.g. the snapshot-reuse fix asserts ``plan_snapshot``
        stays cold on monotone prepend runs)."""
        out: dict = {}
        for labels, series in self._batch_op_seconds.samples():
            op = labels.get("op", "")
            out[op] = {"count": series.count, "total_s": series.sum}
        return out

    # -- inspection ----------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able per-kernel compile/hit/retrace totals + the bounded
        retrace event list (newest last)."""
        kernels: dict[str, dict] = {}
        for fam, key in (
            (self._compiles, "compiles"),
            (self._hits, "hits"),
            (self._retraces, "retraces"),
        ):
            for labels, series in fam.samples():
                k = labels.get("kernel", "")
                kernels.setdefault(
                    k, {"compiles": 0, "hits": 0, "retraces": 0}
                )[key] = series.value
        for k, rec in kernels.items():
            total = rec["compiles"] + rec["hits"]
            rec["hit_rate"] = rec["hits"] / total if total else 0.0
        return {
            "kernels": kernels,
            "retrace_events": list(self.retrace_events),
        }


_PROFILER: KernelProfiler | None = None


def kernel_profiler() -> KernelProfiler:
    global _PROFILER
    if _PROFILER is None:
        _PROFILER = KernelProfiler()
    return _PROFILER


def profiled(kernel: str):
    """Wrap a kernel wrapper with compile/retrace/launch attribution.

    The wrapper is transparent under ``YTPU_OBS_DISABLED=1`` (checked
    per call: bench.py toggles it in-process to measure overhead)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            p = kernel_profiler()
            if not p.enabled or os.environ.get("YTPU_OBS_DISABLED") == "1":
                return fn(*args, **kwargs)
            return p.call(kernel, fn, args, kwargs)

        wrapped.__wrapped__ = fn
        return wrapped

    return deco


def host_timed(op: str):
    """Wall-time a host-side batch op into
    ``ytpu_prof_batch_op_seconds{op}`` (no signature tracking — these
    are plain Python, nothing compiles)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            p = kernel_profiler()
            if not p.enabled or os.environ.get("YTPU_OBS_DISABLED") == "1":
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            p.record_host_op(op, time.perf_counter() - t0)
            return out

        wrapped.__wrapped__ = fn
        return wrapped

    return deco


# pre-register the families: check_metrics_schema and exposition must
# see them before any kernel runs
kernel_profiler()
