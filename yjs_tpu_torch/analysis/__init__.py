"""ytpu-lint: project-specific static analysis for the y-tpu codebase.

Pure-:mod:`ast` checkers for the hazard classes this project actually
ships: buffer-donation aliasing, jit retrace storms, lock discipline and
lock-ordering deadlocks, ingress/WAL/failure-path seam completeness, and
README knob/metric drift.  Front door: ``scripts/torch_ytpu_lint.py``.
"""

from .base import Checker
from .donation import DonationChecker
from .donation import RULE as RULE_DONATION
from .drift import DriftChecker, RULE_KNOB, RULE_METRIC, live_comparison
from .locks import LockChecker, RULE_DISCIPLINE, RULE_ORDERING
from .model import (
    Baseline,
    Finding,
    RULE_BARE_SUPPRESSION,
    RULE_PARSE_ERROR,
    RULE_USELESS_SUPPRESSION,
    SEVERITIES,
    Suppression,
    parse_suppressions,
)
from .project import JitInfo, ProjectIndex, iter_python_files
from .retrace import RetraceChecker
from .retrace import RULE as RULE_RETRACE
from .runner import (
    LintResult,
    all_rules,
    default_checkers,
    default_targets,
    render_report,
    run_lint,
)
from .seams import RULE_FORCE, RULE_TRACE, RULE_WAL_KIND, SeamChecker

__all__ = [
    "Baseline",
    "Checker",
    "DonationChecker",
    "DriftChecker",
    "Finding",
    "JitInfo",
    "LintResult",
    "LockChecker",
    "ProjectIndex",
    "RetraceChecker",
    "RULE_BARE_SUPPRESSION",
    "RULE_DISCIPLINE",
    "RULE_DONATION",
    "RULE_FORCE",
    "RULE_KNOB",
    "RULE_METRIC",
    "RULE_ORDERING",
    "RULE_PARSE_ERROR",
    "RULE_RETRACE",
    "RULE_TRACE",
    "RULE_USELESS_SUPPRESSION",
    "RULE_WAL_KIND",
    "SEVERITIES",
    "SeamChecker",
    "Suppression",
    "all_rules",
    "default_checkers",
    "default_targets",
    "iter_python_files",
    "live_comparison",
    "parse_suppressions",
    "render_report",
    "run_lint",
]
