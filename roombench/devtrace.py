"""Device time from ``torch.profiler``'s trace of the measured window.

The harness wraps the window and each phase of a tick in
``record_function`` ranges (``roombench.window``, ``tick.ingest``,
``tick.flush``, ``tick.joins``).  From the exported Chrome trace this
reads the device's kernel, copy and set events: their union is the busy
time, their sums by name the device operations, and the stretches of the
window with none are the idle gaps, each named by the tick phase the host
was in for most of it.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "roombench.window"


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def read_trace(path: str) -> dict:
    """``busy_s``, ``window_s``, ``kernels`` ({name: seconds}) and
    ``breakdown`` from an exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = None
    phases = []
    dev = []
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            by_name[e["name"]] += dur * 1e-6
        elif cat == "user_annotation":
            if e["name"] == WINDOW:
                win = (ts, ts + dur)
            elif e["name"].startswith("tick."):
                phases.append((ts, ts + dur, e["name"]))
    if win is None:
        raise ValueError("the trace holds no window range")
    w0, w1 = win
    busy = _union((max(a, w0), min(b, w1)) for a, b in dev if b > w0 and a < w1)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    t = w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        best, name = 0.0, "window"
        for a, b, n in phases:
            o = min(b, g1) - max(a, g0)
            if o > best:
                best, name = o, n
        named.append([f"{WINDOW}/{name}", (g1 - g0) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "kernels": dict(by_name),
        "breakdown": {"device_ops": [[k, v] for k, v in ops],
                      "idle_gaps": named},
    }
