"""yjs_tpu.admission: fleet-wide admission control and brownout
degradation.

Public surface:

- :class:`AdmissionController` / :class:`AdmissionConfig` — the shared
  per-fleet (or per-provider) rate-limit + brownout state machine;
- :class:`AdmissionRejected` — typed veto raised at the admission seam;
- :class:`TokenBucket` / :class:`WeightedFairQueue` — the deterministic
  primitives underneath;
- :class:`BrownoutController` and the level constants
  ``NORMAL``/``SHED_BACKGROUND``/``COALESCE``/``REJECT_WRITES`` with
  ``LEVEL_NAMES``.
"""

from .brownout import (  # noqa: F401
    COALESCE,
    LEVEL_NAMES,
    NORMAL,
    REJECT_WRITES,
    SHED_BACKGROUND,
    BrownoutController,
)
from .controller import (  # noqa: F401
    AdmissionConfig,
    AdmissionController,
)
from .limiter import (  # noqa: F401
    AdmissionRejected,
    TokenBucket,
    WeightedFairQueue,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionRejected",
    "BrownoutController",
    "TokenBucket",
    "WeightedFairQueue",
    "NORMAL",
    "SHED_BACKGROUND",
    "COALESCE",
    "REJECT_WRITES",
    "LEVEL_NAMES",
]
