"""knob/metric drift: the README is the operator contract — every
``YTPU_*`` environment knob the code reads and every ``ytpu_*`` metric
family it registers must appear there, and (for the curated knob
prefixes) nothing documented may be dead.

This subsumes the original ``scripts/check_metrics_schema.py`` README
cross-check with an AST collection pass (only *real* ``os.environ.get``
reads and literal ``.counter/.gauge/.histogram("ytpu_…")`` registrations
count — a knob named in a comment no longer satisfies the contract).
The old script survives as a thin shim over :func:`live_comparison`,
which additionally diffs the *live* registry (instantiating a provider
+ fleet) against the README — that check builds a provider and so
stays out of the pure-``ast`` lint path.

Rules:

- **knob-drift** — a ``YTPU_*`` env var read in code but absent from
  README (anchored at the read site), or documented under one of the
  curated :data:`KNOB_PREFIXES` yet read nowhere (anchored at its
  README line).
- **metric-drift** — a literal ``ytpu_*`` family registered in code but
  missing from README's Observability table (anchored at the
  registration), or a table row whose name appears nowhere in the
  source tree.
"""

from __future__ import annotations

import ast
import re

from .base import Checker
from .project import ProjectIndex, dotted_name

RULE_KNOB = "knob-drift"
RULE_METRIC = "metric-drift"

# the curated families whose documentation may not go stale; reads of
# ANY YTPU_* name must be documented, but only these prefixes are
# checked in the README -> code direction (test-only knobs like
# YTPU_FUZZ_ITERS are documented without being read by the package)
KNOB_PREFIXES = (
    "CHAOS", "RESILIENCE", "DLQ", "WAL", "PROF", "SLO", "NET", "FLEET",
    "TIER", "REPL", "FAILOVER", "PLAN", "ADM", "ADMIN", "TRACE",
    "BLACKBOX", "FLUSH", "LINT", "CLUSTER", "GATEWAY", "GEO", "TSDB",
    "COST",
)

KNOB_RE = re.compile(
    "YTPU_(?:" + "|".join(KNOB_PREFIXES) + r")_[A-Z0-9_]+"
)
_ANY_KNOB_RE = re.compile(r"YTPU_[A-Z0-9_]*[A-Z0-9]")
_NATIVE_GETENV_RE = re.compile(r"getenv\(\s*\"(YTPU_[A-Z0-9_]+)\"")
_METRIC_ROW_RE = re.compile(r"\|\s*`(ytpu_[a-z0-9_]+)`\s*\|")
_METRIC_METHODS = frozenset({"counter", "gauge", "histogram"})


_KNOB_LITERAL_RE = re.compile(r"YTPU_[A-Z0-9_]+\Z")


def _env_read_names(call: ast.Call):
    """YTPU_* names this call reads.  The package reads env through
    ``os.environ.get`` AND wrapper helpers (``_env_int(name, default)``,
    ``pick(value, name, default)``, ``_env_float(env, name)``) — so any
    ``"YTPU_X"`` string literal in argument position counts as a read."""
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if _KNOB_LITERAL_RE.fullmatch(arg.value):
                yield arg.value


def _env_subscript_name(node: ast.Subscript):
    """``"YTPU_X"`` for ``os.environ["YTPU_X"]`` style access."""
    recv = dotted_name(node.value) or ""
    if not recv.endswith("environ"):
        return None
    sl = node.slice
    if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
        if _KNOB_LITERAL_RE.fullmatch(sl.value):
            return sl.value
    return None


def _metric_reg_name(call: ast.Call):
    """``"ytpu_x"`` when ``call`` is ``….counter/gauge/histogram("ytpu_x",
    …)``; else None."""
    f = call.func
    if not isinstance(f, ast.Attribute) or f.attr not in _METRIC_METHODS:
        return None
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        if arg.value.startswith("ytpu_"):
            return arg.value
    return None


def documented_metrics(readme_text: str) -> set:
    """ytpu_* names from README's Observability table rows."""
    return {
        m.group(1)
        for line in readme_text.splitlines()
        for m in [_METRIC_ROW_RE.match(line)]
        if m
    }


def documented_knobs(readme_text: str) -> set:
    """Every YTPU_* name mentioned anywhere in the README."""
    return set(_ANY_KNOB_RE.findall(readme_text))


def knob_reads(index: ProjectIndex) -> dict:
    """name -> (path, line) of the first ``os.environ.get`` read."""
    out: dict = {}
    for sf in index.files.values():
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                for nm in _env_read_names(node):
                    out.setdefault(nm, (sf.path, node.lineno))
            elif isinstance(node, ast.Subscript):
                nm = _env_subscript_name(node)
                if nm is not None:
                    out.setdefault(nm, (sf.path, node.lineno))
    return out


def metric_registrations(index: ProjectIndex) -> dict:
    """name -> (path, line) of the first literal registration."""
    out: dict = {}
    for sf in index.files.values():
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                nm = _metric_reg_name(node)
                if nm is not None:
                    out.setdefault(nm, (sf.path, node.lineno))
    return out


def native_knob_reads(root, globs) -> dict:
    """``getenv("YTPU_X")`` reads in native (C/C++) sources — knobs the
    Python AST pass cannot see but which are real read sites."""
    from pathlib import Path

    out: dict = {}
    for pattern in globs:
        for p in sorted(Path(root).glob(pattern)):
            try:
                text = p.read_text(encoding="utf-8", errors="replace")
            except OSError:
                continue
            try:
                rel = p.resolve().relative_to(
                    Path(root).resolve()
                ).as_posix()
            except ValueError:
                rel = p.as_posix()
            for i, line in enumerate(text.splitlines(), start=1):
                for m in _NATIVE_GETENV_RE.finditer(line):
                    out.setdefault(m.group(1), (rel, i))
    return out


class DriftChecker(Checker):
    name = "drift"
    rules = {RULE_KNOB: "warning", RULE_METRIC: "warning"}

    NATIVE_GLOBS = (
        "yjs_tpu_torch/native/*.c",
        "yjs_tpu_torch/native/*.cc",
        "yjs_tpu_torch/native/*.cpp",
        "yjs_tpu_torch/native/*.h",
    )

    def __init__(
        self, readme_path: str = "README.md", stale_docs: bool = True
    ):
        self.readme_path = readme_path
        # the README -> code direction ("documented but dead") is only
        # meaningful when the WHOLE project is in the index — a partial
        # run (ytpu_lint some/file.py) would call every knob the target
        # doesn't happen to read stale.  The runner turns it off for
        # explicit-target runs.
        self.stale_docs = stale_docs

    def check(self, index: ProjectIndex):
        readme = index.read_adjacent(self.readme_path)
        if readme is None:
            return
        doc_knobs = documented_knobs(readme)
        doc_metrics = documented_metrics(readme)
        reads = knob_reads(index)
        for nm, loc in native_knob_reads(
            index.root, self.NATIVE_GLOBS
        ).items():
            reads.setdefault(nm, loc)
        regs = metric_registrations(index)

        for name in sorted(reads):
            if name not in doc_knobs:
                path, line = reads[name]
                yield self.finding(
                    RULE_KNOB,
                    path,
                    line,
                    f"env knob {name} is read here but never mentioned "
                    "in README — operators cannot discover it; add it "
                    "to the relevant knob table",
                    symbol=name,
                )
        # README -> code, curated prefixes only
        readme_lines = readme.splitlines()
        for name in sorted(doc_knobs) if self.stale_docs else ():
            if not KNOB_RE.fullmatch(name) or name in reads:
                continue
            if f"{name}_*" in readme or f"{name}*" in readme:
                continue  # wildcard family mention, not a single knob
            line = next(
                (
                    i + 1
                    for i, text in enumerate(readme_lines)
                    if name in text
                ),
                1,
            )
            yield self.finding(
                RULE_KNOB,
                self.readme_path,
                line,
                f"env knob {name} is documented in README but read "
                "nowhere in the package — stale docs; delete the row "
                "or wire the knob back up",
                symbol=name,
            )

        for name in sorted(regs):
            if name not in doc_metrics:
                path, line = regs[name]
                yield self.finding(
                    RULE_METRIC,
                    path,
                    line,
                    f"metric family {name} is registered here but has "
                    "no row in README's Observability table",
                    symbol=name,
                )
        all_text_names: set = set()
        for sf in index.files.values():
            all_text_names |= set(
                re.findall(r"ytpu_[a-z0-9_]+", sf.text)
            )
        for name in sorted(doc_metrics) if self.stale_docs else ():
            if name not in all_text_names:
                line = next(
                    (
                        i + 1
                        for i, text in enumerate(readme_lines)
                        if f"`{name}`" in text
                    ),
                    1,
                )
                yield self.finding(
                    RULE_METRIC,
                    self.readme_path,
                    line,
                    f"metric family {name} is documented in README's "
                    "Observability table but appears nowhere in the "
                    "source tree — stale row",
                    symbol=name,
                )


def curated_knobs_in_code(package_dir) -> set:
    """The curated-prefix ``YTPU_*`` names (:data:`KNOB_RE`) that the
    ``*.py`` files under ``package_dir`` mention anywhere."""
    from pathlib import Path

    knobs: set = set()
    for path in Path(package_dir).rglob("*.py"):
        knobs |= set(KNOB_RE.findall(path.read_text()))
    return knobs


def live_metric_names(device=None) -> set:
    """The metric families the port registers live: one provider and
    the smallest fleet built on ``device`` (``None`` is the CUDA device,
    which raises without one; ``device="cpu"`` runs the plain kernels),
    plus every lazily-registered process-global family touched once."""
    from yjs_tpu_torch.fleet import FleetRouter
    from yjs_tpu_torch.obs import global_registry
    from yjs_tpu_torch.provider import TpuProvider

    from .runner import register_lint_metric

    prov = TpuProvider(1, device=device)
    FleetRouter(1, 1, device=device)
    register_lint_metric()  # the lint counter is part of the contract
    # the cluster families are lazily-registered process-global
    # singletons (no Supervisor/Gateway is spun up here) — touch each
    # holder so the live set includes them
    from yjs_tpu_torch.cluster.gateway import _GatewayMetricsSingleton
    from yjs_tpu_torch.cluster.rpc import rpc_metrics
    from yjs_tpu_torch.cluster.supervisor import _ClusterMetrics

    _GatewayMetricsSingleton.get()
    rpc_metrics()
    _ClusterMetrics()
    # ... as are the admin-plane and federation-scrape families
    #: first request / first scrape registers them
    from yjs_tpu_torch.obs.admin import admin_metrics
    from yjs_tpu_torch.obs.federate import fed_metrics

    admin_metrics()
    fed_metrics()
    # ... and the geo families: registered by the first
    # GeoReplicator; instantiating the metrics holder is enough
    from yjs_tpu_torch.geo.replicator import GeoMetrics

    GeoMetrics()
    # ... and the TSDB store families: lazily registered by
    # the first sample/query — touch the holder (the ytpu_cost_*
    # families register on the provider registry at construction above)
    from yjs_tpu_torch.obs.tsdb import tsdb_metrics

    tsdb_metrics()
    return set(prov.engine.obs.registry.names()) | set(
        global_registry().names()
    )


def live_comparison(root, device=None) -> list:
    """The original check_metrics_schema live diff: registered metric
    names (:func:`live_metric_names`, instantiating TpuProvider +
    FleetRouter on ``device``) vs README's table, plus the curated-knob
    README/code cross-check.  Returns a list of human-readable problem
    strings (empty = in agreement).  Callers needing a path that builds
    nothing use :class:`DriftChecker`.
    """
    from pathlib import Path

    root = Path(root)
    readme = (root / "README.md").read_text()
    problems: list = []

    live = live_metric_names(device)
    if not live:
        return []  # obs disabled (YTPU_OBS_DISABLED) — nothing to check
    doc = documented_metrics(readme)
    for n in sorted(live - doc):
        problems.append(
            f"registered but NOT in README's Observability table: {n}"
        )
    for n in sorted(doc - live):
        problems.append(f"documented in README but NOT registered: {n}")

    code_knobs = curated_knobs_in_code(root / "yjs_tpu_torch")
    doc_knobs = set(KNOB_RE.findall(readme))
    for n in sorted(code_knobs - doc_knobs):
        problems.append(f"env knob read by the code but NOT in README: {n}")
    for n in sorted(doc_knobs - code_knobs):
        problems.append(f"env knob in README but NOT read by the code: {n}")
    return problems
