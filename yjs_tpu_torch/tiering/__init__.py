"""Heat-driven doc lifecycle tiering for the provider fleet.

Two pieces:

- :mod:`heat` — :class:`HeatTracker`: exponentially-decayed per-doc
  touch counters fed from the provider's receive/session/``doc_id``
  seams;
- :mod:`manager` — :class:`TierManager` + :class:`TierConfig`: the
  hot (device slot) / warm (detached host columns) / cold (WAL tier
  record) lifecycle with demand promotion, coldest-first auto-eviction
  behind ``doc_id`` (opt-in: ``YTPU_TIER_ENABLED``), tombstone/GC
  compaction for long-lived hot docs, and crash-consistent ``KIND_TIER``
  journaling so recovery lands every doc in exactly one tier.

Metrics land in the ``ytpu_tier_*`` families; knobs are the
``YTPU_TIER_*`` env vars documented in README "Tiered lifecycle".
"""

from .heat import HeatTracker
from .manager import COLD, HOT, WARM, TierConfig, TierManager

__all__ = [
    "COLD",
    "HOT",
    "WARM",
    "HeatTracker",
    "TierConfig",
    "TierManager",
]
