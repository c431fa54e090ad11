"""What the host grants a run: CPUs, load, and the planner's pool width.

Everything here only reads: ``os.sched_getaffinity``, the cgroup's
``cpu.max`` and ``/proc/loadavg``.
"""

from __future__ import annotations

import math
import os


def _cgroup_cpu_quota() -> float | None:
    """CPUs the cgroup v2 ``cpu.max`` allows this process, or None."""
    try:
        with open("/proc/self/cgroup") as f:
            rel = next((ln.split(":", 2)[2].strip() for ln in f
                        if ln.startswith("0::")), "/")
    except OSError:
        rel = "/"
    for path in (f"/sys/fs/cgroup{rel}/cpu.max", "/sys/fs/cgroup/cpu.max"):
        try:
            with open(path) as f:
                quota, period = f.read().split()[:2]
        except (OSError, ValueError):
            continue
        if quota == "max":
            return None
        return int(quota) / int(period)
    return None


def granted_cpus() -> dict:
    """The host's CPU count, the affinity set's size, the cgroup quota and
    the CPUs a run may use: the affinity set capped by the quota."""
    affinity = len(os.sched_getaffinity(0))
    quota = _cgroup_cpu_quota()
    granted = affinity if quota is None else max(1, min(affinity, math.floor(quota)))
    return {"host": os.cpu_count(), "affinity": affinity, "quota": quota,
            "granted": granted}


def load_average() -> tuple[float, float, float]:
    return os.getloadavg()
