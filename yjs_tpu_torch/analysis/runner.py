"""Lint run orchestration: build the :class:`ProjectIndex`, run every
checker, apply inline suppressions and the committed baseline, and emit
the meta-findings that keep the escape hatches honest:

- ``bare-suppression`` — a ``disable=`` comment without a ``-- reason``;
- ``useless-suppression`` — a suppression that matched nothing (so
  deleting any real suppression reproduces its finding, and a fixed
  finding forces its suppression to be removed);
- stale baseline entries — a baseline fingerprint that matched nothing
  (the baseline can only shrink).

The run also feeds the observability registry when one is importable:
``ytpu_lint_findings_total{rule,severity}`` counts every raw finding
(pre-suppression), so a fleet dashboard can watch debt trend toward
zero without parsing lint output.  The import is best-effort — the lint
path itself never needs torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from .base import Checker
from .donation import DonationChecker
from .drift import DriftChecker
from .locks import LockChecker
from .model import (
    Baseline,
    Finding,
    RULE_BARE_SUPPRESSION,
    RULE_USELESS_SUPPRESSION,
    parse_suppressions,
)
from .project import ProjectIndex, iter_python_files
from .retrace import RetraceChecker
from .seams import SeamChecker

DEFAULT_EXCLUDE = ("tests", ".git", "__pycache__", "build", "dist")


def default_targets(root) -> list:
    """The port's full sweep: the package, ``chip_smoke.py`` and the
    port's own scripts (``scripts/torch_*.py``); the JAX package, its
    scripts and ``bench.py`` are the reference's lint run."""
    root = Path(root)
    targets = [root / "yjs_tpu_torch"]
    if (root / "chip_smoke.py").is_file():
        targets.append(root / "chip_smoke.py")
    targets.extend(sorted((root / "scripts").glob("torch_*.py")))
    return targets


def default_checkers(stale_docs: bool = True) -> list[Checker]:
    return [
        DonationChecker(),
        RetraceChecker(),
        LockChecker(),
        SeamChecker(),
        DriftChecker(stale_docs=stale_docs),
    ]


def all_rules(checkers=None) -> dict:
    """rule id -> severity for every registered rule + the meta rules."""
    out = {
        RULE_BARE_SUPPRESSION: "warning",
        RULE_USELESS_SUPPRESSION: "warning",
        "parse-error": "error",
    }
    for c in checkers or default_checkers():
        out.update(c.rules)
    return out


@dataclass
class LintResult:
    """Everything one run produced, pre-partitioned for reporting."""

    findings: list = field(default_factory=list)   # active (reportable)
    suppressed: list = field(default_factory=list)
    baselined: list = field(default_factory=list)
    stale_baseline: list = field(default_factory=list)
    raw_count: int = 0

    @property
    def failed(self) -> bool:
        return bool(self.findings or self.stale_baseline)

    def counts(self) -> dict:
        out: dict = {}
        for f in self.findings:
            key = (f.rule, f.severity)
            out[key] = out.get(key, 0) + 1
        return out


def run_lint(
    root,
    targets=None,
    checkers=None,
    baseline: Baseline | None = None,
    exclude: tuple = DEFAULT_EXCLUDE,
    emit_metrics: bool = True,
) -> LintResult:
    root = Path(root)
    full_run = targets is None
    if targets is None:
        targets = default_targets(root)
    paths = iter_python_files([Path(t) for t in targets], exclude=exclude)
    index = ProjectIndex(root, paths)
    # explicit targets = a partial view of the project: the drift
    # checker's "documented but dead" direction would flag every knob
    # the targeted files don't happen to read, so it runs only on full
    # sweeps (pass checkers=default_checkers() to override)
    checkers = (
        list(checkers)
        if checkers is not None
        else default_checkers(stale_docs=full_run)
    )
    baseline = baseline or Baseline([])

    raw: list[Finding] = list(index.parse_findings)
    for checker in checkers:
        raw.extend(checker.check(index))

    suppressions = []
    for sf in index.files.values():
        suppressions.extend(parse_suppressions(sf.path, sf.text))

    result = LintResult(raw_count=len(raw))
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        sup = next((s for s in suppressions if s.covers(f)), None)
        if sup is not None:
            sup.used = True
            result.suppressed.append(f)
            continue
        if baseline.covers(f):
            result.baselined.append(f)
            continue
        result.findings.append(f)

    for s in suppressions:
        if not s.reason:
            result.findings.append(
                Finding(
                    rule=RULE_BARE_SUPPRESSION,
                    severity="warning",
                    path=s.path,
                    line=s.line,
                    message=(
                        "suppression without a '-- reason' — every "
                        "disable must say why it is safe"
                    ),
                    symbol=",".join(s.rules),
                )
            )
        if not s.used:
            result.findings.append(
                Finding(
                    rule=RULE_USELESS_SUPPRESSION,
                    severity="warning",
                    path=s.path,
                    line=s.line,
                    message=(
                        f"suppression of {','.join(s.rules)} matched no "
                        "finding — the hazard is gone; delete the comment"
                    ),
                    symbol=",".join(s.rules),
                )
            )
    result.stale_baseline = baseline.stale_entries()
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))

    if emit_metrics:
        _emit_metrics(raw)
    return result


def register_lint_metric():
    """The process-global findings counter (idempotent — the registry
    returns the existing family on re-registration)."""
    from ..obs import global_registry

    return global_registry().counter(
        "ytpu_lint_findings_total",
        "static-analysis findings per run, pre-suppression",
        unit="findings",
        labelnames=("rule", "severity"),
    )


def _emit_metrics(raw_findings) -> None:
    """Count raw findings on the process-global registry, best-effort
    (the registry import pulls in numpy-free obs core only; any failure
    leaves the lint result untouched)."""
    try:
        counter = register_lint_metric()
        for f in raw_findings:
            counter.labels(rule=f.rule, severity=f.severity).inc()
    except Exception:
        pass


def render_report(result: LintResult, verbose: bool = False) -> str:
    lines: list = []
    for f in result.findings:
        lines.append(f.render())
    for e in result.stale_baseline:
        lines.append(
            f"{e['path']}: error: stale-baseline: baseline entry "
            f"{e['fingerprint']} ({e['rule']}: {e['message'][:60]}…) "
            "matched no finding — remove it from the baseline file"
        )
    if verbose and result.suppressed:
        lines.append("")
        for f in result.suppressed:
            lines.append(f"suppressed: {f.render()}")
    if verbose and result.baselined:
        lines.append("")
        for f in result.baselined:
            lines.append(f"baselined:  {f.render()}")
    n_err = sum(1 for f in result.findings if f.severity == "error")
    n_warn = sum(1 for f in result.findings if f.severity == "warning")
    lines.append(
        f"ytpu-lint: {len(result.findings)} finding(s) "
        f"({n_err} error, {n_warn} warning), "
        f"{len(result.suppressed)} suppressed, "
        f"{len(result.baselined)} baselined, "
        f"{len(result.stale_baseline)} stale baseline entr"
        f"{'y' if len(result.stale_baseline) == 1 else 'ies'}"
    )
    return "\n".join(lines)
