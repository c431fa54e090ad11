"""seam-completeness: the conventions every ingress/durability/failure
seam must honor, machine-checked.

- **seam-trace** — every ingress seam (any method named
  ``receive_update`` / ``handle_sync_message``, or the cluster's
  cross-process entry points ``handle_rpc_request`` /
  ``handle_client_message``) must adopt-or-mint a
  TraceContext (a call to ``_trace_ingress`` / ``current_context`` /
  ``mint_for_update`` / ``use_context``) AND feed the SLO pipeline
  (``…slo.receive/origin/…``) — or visibly delegate to another seam
  method (``self.shards[k].receive_update(...)``), which carries both
  obligations.  Same-class private helpers called from the seam are
  searched one level deep, so a routed implementation still passes.
- **seam-wal-kind** — the module defining the WAL record kinds must map
  every ``KIND_*`` constant in ``KIND_NAMES``, and every handler module
  (``persistence/recovery.py`` by default) must reference every kind:
  adding kind 10 without teaching recovery about it fails the lint, not
  a 3 a.m. recovery.
- **seam-force-sample** — a flight-recorder ``record(...)`` at
  ``severity="warning"|"error"`` that attaches a ``trace=`` must sit in
  a function that ``.force(…)``-samples the context first; otherwise
  the one trace you need after an incident was head-sampled away.
"""

from __future__ import annotations

import ast

from .base import Checker, iter_functions
from .project import ProjectIndex, dotted_name, terminal_name

RULE_TRACE = "seam-trace"
RULE_WAL_KIND = "seam-wal-kind"
RULE_FORCE = "seam-force-sample"

INGRESS_METHODS = frozenset(
    {
        "receive_update",
        "handle_sync_message",
        # the process-native cluster's ingress seams: every frame that
        # crosses a process boundary enters through one of these
        "handle_rpc_request",
        "handle_client_message",
    }
)
TRACE_ESTABLISHERS = frozenset(
    {"_trace_ingress", "current_context", "mint_for_update", "use_context"}
)
SLO_FEEDERS = frozenset({"receive", "origin", "integrated"})
RECORD_SEVERITIES = frozenset({"warning", "error"})


def _severity_values(node) -> set:
    """Possible constant values of a ``severity=`` argument — a plain
    string, or both arms of a conditional like
    ``"warning" if count else "error"``."""
    if isinstance(node, ast.Constant):
        return {node.value}
    if isinstance(node, ast.IfExp):
        return _severity_values(node.body) | _severity_values(node.orelse)
    return set()


def _call_desc(call: ast.Call):
    """(terminal_name, receiver) for a call; receiver is the dotted
    chain of the callee's object (``"self.slo"``), ``""`` for a bare
    name, or ``"?"`` when unresolvable (subscripts, call results) —
    ``self.shards[k].receive_update`` must still read as a delegation."""
    f = call.func
    if isinstance(f, ast.Attribute):
        recv = dotted_name(f.value)
        return f.attr, recv if recv is not None else "?"
    if isinstance(f, ast.Name):
        return f.id, ""
    return None, ""


class SeamChecker(Checker):
    name = "seams"
    rules = {
        RULE_TRACE: "error",
        RULE_WAL_KIND: "error",
        RULE_FORCE: "warning",
    }

    def __init__(
        self,
        kinds_module_suffix: str = "persistence/records.py",
        handler_module_suffixes: tuple = ("persistence/recovery.py",),
    ):
        self.kinds_module_suffix = kinds_module_suffix
        self.handler_module_suffixes = tuple(handler_module_suffixes)

    def check(self, index: ProjectIndex):
        for sf in index.files.values():
            if sf.tree is None:
                continue
            for ci in sf.classes.values():
                for mname, fn in ci.methods.items():
                    if mname in INGRESS_METHODS:
                        yield from self._check_ingress(sf, ci, mname, fn)
            for symbol, _cls, fn in iter_functions(sf):
                yield from self._check_force(sf, symbol, fn)
        yield from self._check_wal_kinds(index)

    # -- seam-trace --------------------------------------------------------

    def _check_ingress(self, sf, ci, mname, fn):
        calls = self._calls_with_helpers(ci, fn)
        has_trace = any(t in TRACE_ESTABLISHERS for t, _ in calls)
        delegates = any(
            t in INGRESS_METHODS and recv not in ("", "self")
            for t, recv in calls
        )
        has_slo = any(
            t in SLO_FEEDERS and "slo" in recv.lower() for t, recv in calls
        )
        if not (has_trace or delegates):
            yield self.finding(
                RULE_TRACE,
                sf.path,
                fn.lineno,
                f"ingress seam {ci.name}.{mname} neither adopts-or-mints "
                "a TraceContext (_trace_ingress / current_context / "
                "mint_for_update) nor delegates to another seam — "
                "updates entering here are invisible to causal tracing",
                symbol=f"{ci.name}.{mname}",
            )
        if not (has_slo or delegates):
            yield self.finding(
                RULE_TRACE,
                sf.path,
                fn.lineno,
                f"ingress seam {ci.name}.{mname} does not feed the SLO "
                "convergence pipeline (slo.receive/origin) and does not "
                "delegate to a seam that does — updates entering here "
                "never count against the convergence objective",
                symbol=f"{ci.name}.{mname}",
            )

    def _calls_with_helpers(self, ci, fn) -> list:
        """(terminal, receiver) call descriptors in ``fn`` plus, one
        level deep, in any same-class private helper it calls."""
        out: list = []
        helper_names: set = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                term, recv = _call_desc(node)
                if term is None:
                    continue
                out.append((term, recv))
                if recv == "self" and term in ci.methods and (
                    term != fn.name
                ):
                    helper_names.add(term)
        for nm in helper_names:
            for node in ast.walk(ci.methods[nm]):
                if isinstance(node, ast.Call):
                    term, recv = _call_desc(node)
                    if term is not None:
                        out.append((term, recv))
        return out

    # -- seam-force-sample -------------------------------------------------

    def _check_force(self, sf, symbol, fn):
        risky: list = []
        has_force = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            term, _recv = _call_desc(node)
            if term == "force":
                has_force = True
            if term != "record":
                continue
            sev = trace_kw = None
            for kw in node.keywords:
                if kw.arg == "severity":
                    sev = _severity_values(kw.value)
                elif kw.arg == "trace":
                    trace_kw = kw.value
            if sev and sev & RECORD_SEVERITIES and trace_kw is not None \
                    and not (
                isinstance(trace_kw, ast.Constant)
                and trace_kw.value is None
            ):
                risky.append(node)
        if has_force:
            return
        for node in risky:
            yield self.finding(
                RULE_FORCE,
                sf.path,
                node.lineno,
                "failure-path record() attaches a trace at severity "
                "warning/error but the function never .force()-samples "
                "the context — a head-sample miss leaves this incident "
                "without its trace",
                symbol=symbol,
            )

    # -- seam-wal-kind -----------------------------------------------------

    def _check_wal_kinds(self, index: ProjectIndex):
        kinds_sf = None
        for sf in index.files.values():
            if sf.path.endswith(self.kinds_module_suffix):
                kinds_sf = sf
                break
        if kinds_sf is None or kinds_sf.tree is None:
            return
        kind_defs: dict = {}     # name -> line
        names_map_keys: set = set()
        names_map_line = None
        for node in kinds_sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if not isinstance(t, ast.Name):
                    continue
                if t.id.startswith("KIND_") and t.id != "KIND_NAMES" and (
                    isinstance(node.value, ast.Constant)
                ):
                    kind_defs[t.id] = node.lineno
                elif t.id == "KIND_NAMES" and isinstance(
                    node.value, ast.Dict
                ):
                    names_map_line = node.lineno
                    for k in node.value.keys:
                        nm = dotted_name(k)
                        if nm:
                            names_map_keys.add(terminal_name(nm))
        if not kind_defs:
            return
        if names_map_line is not None:
            for name, line in sorted(kind_defs.items()):
                if name not in names_map_keys:
                    yield self.finding(
                        RULE_WAL_KIND,
                        kinds_sf.path,
                        line,
                        f"WAL record kind {name} is not mapped in "
                        "KIND_NAMES — encode_record() will reject it "
                        "and readers cannot label it",
                        symbol=name,
                    )
        for sf in index.files.values():
            if sf.tree is None or not any(
                sf.path.endswith(sfx) for sfx in self.handler_module_suffixes
            ):
                continue
            referenced = {
                node.id
                for node in ast.walk(sf.tree)
                if isinstance(node, ast.Name) and node.id.startswith("KIND_")
            }
            referenced |= {
                node.attr
                for node in ast.walk(sf.tree)
                if isinstance(node, ast.Attribute)
                and node.attr.startswith("KIND_")
            }
            for name, line in sorted(kind_defs.items()):
                if name not in referenced:
                    yield self.finding(
                        RULE_WAL_KIND,
                        sf.path,
                        1,
                        f"WAL record kind {name} "
                        f"({kinds_sf.path}:{line}) is never referenced "
                        "in this handler module — recovery would "
                        "silently skip or misfile records of this kind",
                        symbol=name,
                    )
