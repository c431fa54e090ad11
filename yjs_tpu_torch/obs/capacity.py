"""Sessions-per-device capacity model (the
ROADMAP's "sessions per device at interactive SLO" ask).

:func:`ramp_capacity` drives the loadgen harness against
fresh servers at geometrically increasing interactive session counts,
watching two degradation signals after each stage:

- the convergence-SLO verdict (``page`` = the multi-window
  burn rate blew the wall-clock target), and
- the tick-deterministic interactive visibility p99 against a
  configurable tick budget;

every stage's offered sessions / verdict / p99 are recorded into the
embedded TSDB (``obs/tsdb.py``), and the published figure — the
**knee**, the largest session count that still met SLO — is read back
out of that history by :func:`read_knee`, not from a side channel: the
capacity number is, by construction, a TSDB query over the ramp.

In the PyTorch port :func:`ramp_capacity` raises ``NotImplementedError``
until loadgen and the provider are ported (ROADMAP queue 1, items 6 and
11); :func:`read_knee` and :func:`sessions_per_device` (knee / visible
CUDA devices) work as in the JAX package.
"""

from __future__ import annotations

__all__ = [
    "CapacityConfig", "ramp_capacity", "read_knee", "sessions_per_device",
]

_SESSIONS_SERIES = "ytpu_capacity_sessions"
_OK_SERIES = "ytpu_capacity_ok"
_P99_SERIES = "ytpu_capacity_p99_ticks"


class CapacityConfig:
    """Shape of one capacity ramp."""

    __slots__ = (
        "start_sessions", "max_sessions", "growth", "ticks_per_stage",
        "flush_every", "p99_limit_ticks", "slo_target_ms", "seed",
    )

    def __init__(
        self,
        start_sessions: int = 8,
        max_sessions: int = 192,
        growth: float = 2.0,
        ticks_per_stage: int = 24,
        flush_every: int = 2,
        p99_limit_ticks: int | None = None,
        slo_target_ms: float = 5000.0,
        seed: int = 0,
    ):
        self.start_sessions = max(1, int(start_sessions))
        self.max_sessions = max(self.start_sessions, int(max_sessions))
        self.growth = max(1.25, float(growth))
        self.ticks_per_stage = max(4, int(ticks_per_stage))
        self.flush_every = max(1, int(flush_every))
        # interactive visibility budget: a healthy stage sees its edits
        # within a few flush intervals
        self.p99_limit_ticks = (
            p99_limit_ticks
            if p99_limit_ticks is not None
            else 4 * self.flush_every
        )
        self.slo_target_ms = float(slo_target_ms)
        self.seed = int(seed)

    def stages(self) -> list:
        out = []
        n = self.start_sessions
        while n < self.max_sessions:
            out.append(n)
            n = max(n + 1, int(n * self.growth))
        out.append(self.max_sessions)
        return out


def ramp_capacity(
    make_server, config: CapacityConfig | None = None, store=None,
    now: float | None = None,
) -> dict:
    """Ramp ``make_server(n_sessions)`` servers until the SLO verdict
    degrades; returns the ramp result with the knee read back from the
    TSDB history (module docstring).  ``store`` defaults to the
    process-global TSDB; ``now`` anchors the recorded stage timestamps
    (injectable for deterministic tests)."""
    raise NotImplementedError(
        "the capacity ramp drives the provider through loadgen, which the "
        "PyTorch port does not carry yet (ROADMAP queue 1, item 11)"
    )


def read_knee(store, start: float, end: float) -> int:
    """The knee, from TSDB history alone: the largest offered session
    count whose stage recorded ``ok == 1`` inside ``[start, end]``."""
    sessions = store.query(
        _SESSIONS_SERIES, start=start, end=end, tier="raw"
    )
    verdicts = dict(store.query(
        _OK_SERIES, start=start, end=end, tier="raw"
    ))
    knee = 0
    for ts, n in sessions:
        if verdicts.get(ts, 0.0) >= 1.0:
            knee = max(knee, int(n))
    return knee


def sessions_per_device(result: dict) -> dict:
    """Fold a ramp result into the published figure: knee sessions
    divided by the visible CUDA device count (1 when there is none)."""
    import torch

    n_devices = max(1, torch.cuda.device_count())
    knee = int(result.get("sessions_at_slo", 0))
    return {
        "sessions_at_slo": knee,
        "n_devices": n_devices,
        "sessions_per_device": round(knee / n_devices, 2),
        "ceiling_hit": bool(result.get("ceiling_hit")),
    }
