"""retrace-hazard: call sites that feed a jitted kernel shapes (or
static argument values) that vary per call — each distinct shape/value
compiles a fresh XLA executable, the retrace storm the profiler
only detects dynamically (``retrace_events``), after the stall already
happened.

Two statically checkable patterns:

- **RTR-shape**: an array constructed inline with a data-dependent
  length (``np.zeros(len(xs))``, ``jnp.empty(n_structs)`` where the
  size expression contains ``len(…)`` / ``….shape``) passed straight to
  a jitted callable without flowing through a bucketing helper
  (``_bucket`` / ``_bucket_lanes`` / ``shape_bucket`` / ``*pow2*`` —
  anything whose name says it quantizes).
- **RTR-static**: a ``len(…)`` / ``….shape``-derived expression passed
  at a ``static_argnums`` position — every distinct value is a separate
  compile cache entry.

The checker is deliberately under-approximate (a size that travels
through a variable is not chased); the profiler remains the dynamic
backstop — this catches the inline cases a reader keeps missing."""

from __future__ import annotations

import ast

from .base import Checker, iter_functions
from .project import ProjectIndex, call_func_name, terminal_name

RULE = "retrace-hazard"

ARRAY_CTORS = frozenset(
    {"zeros", "ones", "empty", "full", "arange", "asarray", "array"}
)


def _is_bucket_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = terminal_name(call_func_name(node)) or ""
    low = name.lower()
    return "bucket" in low or "pow2" in low or "round_up" in low.lstrip("_")


def _dynamic_size_inside(expr) -> ast.AST | None:
    """A ``len(…)`` call or ``….shape`` attribute inside ``expr`` that is
    NOT wrapped by a bucketing helper; returns the offending node."""
    def scan(node):
        if _is_bucket_call(node):
            return None  # quantized: don't descend
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "len":
            return node
        if isinstance(node, ast.Attribute) and node.attr == "shape":
            return node
        for child in ast.iter_child_nodes(node):
            hit = scan(child)
            if hit is not None:
                return hit
        return None

    return scan(expr)


class RetraceChecker(Checker):
    name = "retrace"
    rules = {RULE: "warning"}

    def check(self, index: ProjectIndex):
        registry = index.jit_registry
        if not registry:
            return
        for sf in index.files.values():
            if sf.tree is None:
                continue
            for symbol, _cls, fn in iter_functions(sf):
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    callee = terminal_name(call_func_name(node))
                    info = registry.get(callee)
                    if info is None or (
                        info.path == sf.path and info.line == node.lineno
                    ):
                        continue
                    yield from self._check_call(sf, symbol, node, info)

    def _check_call(self, sf, symbol, call, info):
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break  # positions beyond a splat are unknowable
            if i in info.static_argnums:
                hit = _dynamic_size_inside(arg)
                if hit is not None:
                    yield self.finding(
                        RULE,
                        sf.path,
                        hit.lineno,
                        f"dynamic value at static_argnums position {i} "
                        f"of {info.name}() — every distinct value "
                        "compiles a new executable; round it through a "
                        "bucketing helper (_bucket/_bucket_lanes) first",
                        symbol=symbol,
                        col=hit.col_offset,
                    )
                continue
            # traced position: flag inline array ctors sized by len/.shape
            for sub in ast.walk(arg):
                if not isinstance(sub, ast.Call):
                    continue
                cname = terminal_name(call_func_name(sub))
                if cname not in ARRAY_CTORS or not sub.args:
                    continue
                hit = _dynamic_size_inside(sub.args[0])
                if hit is not None:
                    yield self.finding(
                        RULE,
                        sf.path,
                        hit.lineno,
                        f"unbucketed dynamic shape fed to jitted "
                        f"{info.name}(): {cname}(…) is sized by a "
                        "per-call length — pad to a power-of-two "
                        "bucket or the kernel retraces on every "
                        "distinct size",
                        symbol=symbol,
                        col=hit.col_offset,
                    )
