"""Checker base class + the function-scope walking helpers most
checkers share (enclosing-symbol naming, ordered name-event streams,
under-lock block tracking)."""

from __future__ import annotations

import ast
from dataclasses import dataclass

from .model import Finding
from .project import ProjectIndex, SourceFile, dotted_name


class Checker:
    """One lint rule family.  Subclasses set ``rules`` (id -> severity)
    and implement :meth:`check` yielding findings."""

    name = "checker"
    rules: dict = {}

    def check(self, index: ProjectIndex):  # pragma: no cover - interface
        raise NotImplementedError

    def finding(
        self, rule: str, path: str, line: int, message: str,
        symbol: str = "", col: int = 0,
    ) -> Finding:
        return Finding(
            rule=rule,
            severity=self.rules[rule],
            path=path,
            line=line,
            message=message,
            symbol=symbol,
            col=col,
        )


def iter_functions(sf: SourceFile):
    """Yield ``(symbol, class_name_or_None, fn_node)`` for every def in
    the file, nested defs included (symbol = "Class.method" / "fn" /
    "fn.<inner>")."""
    if sf.tree is None:
        return

    def visit(node, prefix, cls):
        for item in ast.iter_child_nodes(node):
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sym = f"{prefix}{item.name}"
                yield sym, cls, item
                yield from visit(item, f"{sym}.", cls)
            elif isinstance(item, ast.ClassDef):
                yield from visit(item, f"{item.name}.", item.name)

    yield from visit(sf.tree, "", None)


@dataclass
class NameEvent:
    """One Load/Store/Del of a dotted name inside a function."""

    name: str
    line: int
    col: int
    is_store: bool


# method names that mutate their receiver in place — a call like
# ``self._ring.append(x)`` counts as a WRITE of ``self._ring``
MUTATING_METHODS = frozenset(
    {
        "append", "appendleft", "extend", "extendleft", "insert", "pop",
        "popleft", "popitem", "clear", "remove", "discard", "add",
        "update", "setdefault", "sort", "reverse", "move_to_end",
        "rotate",
    }
)


def name_events(fn, own_body_only: bool = True) -> list[NameEvent]:
    """Ordered Load/Store events of every dotted name in ``fn``.

    Subscript stores (``self._t[k] = v``) and mutating method calls
    (``self._ring.append(x)``) are reported as stores of the container
    name — that's the aliasing/locking granularity the checkers need.
    Nested function defs are skipped when ``own_body_only``."""
    events: list[NameEvent] = []
    skip: set = set()

    for node in ast.walk(fn):
        if own_body_only and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ) and node is not fn:
            for sub in ast.walk(node):
                skip.add(id(sub))

    for node in ast.walk(fn):
        if id(node) in skip:
            continue
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            if node.func.attr in MUTATING_METHODS:
                recv = dotted_name(node.func.value)
                if recv:
                    events.append(
                        NameEvent(recv, node.lineno, node.col_offset, True)
                    )
        elif isinstance(node, ast.Subscript) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            recv = dotted_name(node.value)
            if recv:
                events.append(
                    NameEvent(recv, node.lineno, node.col_offset, True)
                )
        elif isinstance(node, (ast.Attribute, ast.Name)):
            d = dotted_name(node)
            if d is None:
                continue
            # only the OUTERMOST attribute chain: skip if this node is
            # the .value of a parent Attribute (handled via the parent)
            events.append(
                NameEvent(
                    d,
                    node.lineno,
                    node.col_offset,
                    isinstance(node.ctx, (ast.Store, ast.Del)),
                )
            )
    # de-dup inner chain fragments: "self" load inside "self._ring" —
    # keep the longest name at each (line, col)
    best: dict = {}
    for e in events:
        key = (e.line, e.col, e.is_store)
        cur = best.get(key)
        if cur is None or len(e.name) > len(cur.name):
            best[key] = e
    out = sorted(best.values(), key=lambda e: (e.line, e.col))
    return out


def assign_targets(stmt) -> set:
    """Dotted names a statement assigns (tuple targets flattened)."""
    out: set = set()

    def add(t):
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                add(e)
        elif isinstance(t, ast.Starred):
            add(t.value)
        else:
            d = dotted_name(t)
            if d:
                out.add(d)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            add(t)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        add(stmt.target)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        add(stmt.target)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            if item.optional_vars is not None:
                add(item.optional_vars)
    return out


def enclosing_statement(fn, target) -> ast.stmt | None:
    """The direct statement inside ``fn`` (at any nesting depth) whose
    subtree contains ``target``."""
    result = None

    def visit(node):
        nonlocal result
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                if any(sub is target for sub in ast.walk(child)):
                    result = child
                    visit(child)
                    return
            else:
                visit(child)

    visit(fn)
    return result
