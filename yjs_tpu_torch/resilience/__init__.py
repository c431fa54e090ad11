"""yjs_tpu.resilience: failure isolation for the batched engine.

The reference survives a poison update trivially — each ``Y.Doc`` is an
isolated JS object and an exception stops at the doc boundary.  Our
struct-of-arrays batching shares fate across docs (SURVEY.md compound-
item batching), so one malformed byte in a 100k-doc flush used to raise
mid-``flush()`` and wedge the whole engine.  This package restores the
per-doc blast radius:

- :mod:`.health` — per-doc ``healthy → degraded → quarantined`` state
  machine with exponential (flush-tick) backoff before re-admission;
- :mod:`.deadletter` — bounded dead-letter queue keeping rejected update
  bytes with reason + timestamp, replayable after a fix;
- :mod:`.chaos` — deterministic fault injectors: ``ChaosInjector``
  (corrupt / truncate / duplicate / reorder / drop) for the
  provider/protocol seams, driven by ``YTPU_CHAOS_*`` env knobs and
  used by the chaos test suite, ``DiskFaultInjector``
  (disk_tear / disk_bitflip) for WAL files in the crash-recovery
  harness, and ``NetworkFaultInjector``
  (net_drop / net_delay / net_dup / net_reorder / net_partition,
  ``YTPU_CHAOS_NET_*`` knobs) for the session transport seam
  (peer sessions).

The engine-side half (transactional per-doc flush isolation, rollback
via the ``_demote`` replay machinery) lives in
:meth:`yjs_tpu.ops.engine.BatchEngine._isolate_failure`; the validation
seam is :func:`yjs_tpu.updates.validate_update`.

Env knobs: ``YTPU_RESILIENCE_DISABLED=1`` (strict mode — failures raise
like the pre-resilience engine), ``YTPU_RESILIENCE_THRESHOLD``
(consecutive failures before quarantine, default 3),
``YTPU_RESILIENCE_BACKOFF`` (base backoff in flushes, default 4),
``YTPU_RESILIENCE_BACKOFF_CAP`` (max backoff in flushes, default 256),
``YTPU_RESILIENCE_RECOVERY`` (successes for degraded → healthy, default
2), ``YTPU_DLQ_MAX`` (dead-letter capacity, default 1024).
"""

from __future__ import annotations

from .chaos import (  # noqa: F401
    ChaosConfig,
    ChaosInjector,
    DiskFaultInjector,
    NetChaosConfig,
    NetworkFaultInjector,
)
from .deadletter import DeadLetter, DeadLetterQueue  # noqa: F401
from .health import (  # noqa: F401
    DEGRADED,
    HEALTHY,
    QUARANTINED,
    DocHealth,
    HealthTracker,
)
