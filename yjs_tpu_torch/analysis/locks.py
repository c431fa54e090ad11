"""lock-discipline + lock-ordering: the race family the profiler work caught
dynamically (torn scrapes of ``FlushHistory`` / SLO deques mutating
under a concurrent flush) turned into a static contract.

- **lock-discipline** — an attribute that is ever *written* while
  holding a ``threading.Lock`` attribute of the same class is GUARDED:
  every other access (read or write) must also hold the lock.  The
  checker tracks ``with self._lock:`` blocks syntactically, counts
  in-place mutators (``.append``/``.pop``/subscript stores) as writes,
  and exempts ``__init__`` (pre-publication).  Module-level globals
  written under a module-level lock inside ``global``-declaring
  functions get the same treatment (the double-checked-locking fast
  path needs an explicit suppression with its justification).
- **lock-ordering** — syntactic lock nesting builds a directed graph
  (``with a: … with b:`` ⇒ a→b) over the whole project; any cycle is an
  ABBA deadlock waiting for the right interleaving and is reported on
  one of its edges.
"""

from __future__ import annotations

import ast

from .base import MUTATING_METHODS, Checker
from .project import ProjectIndex, SourceFile, dotted_name

RULE_DISCIPLINE = "lock-discipline"
RULE_ORDERING = "lock-ordering"

EXEMPT_METHODS = frozenset({"__init__", "__new__", "__post_init__"})


class _Access:
    __slots__ = ("attr", "line", "col", "is_write", "held", "method")

    def __init__(self, attr, line, col, is_write, held, method):
        self.attr = attr
        self.line = line
        self.col = col
        self.is_write = is_write
        self.held = held
        self.method = method


class LockChecker(Checker):
    name = "locks"
    rules = {RULE_DISCIPLINE: "warning", RULE_ORDERING: "error"}

    def check(self, index: ProjectIndex):
        self._edges: dict = {}  # (src, dst) -> (path, line)
        for sf in index.files.values():
            if sf.tree is None:
                continue
            for ci in sf.classes.values():
                if ci.lock_attrs:
                    yield from self._check_class(sf, ci)
            if sf.module_locks:
                yield from self._check_module(sf)
        yield from self._check_cycles()

    # -- class-attribute discipline ---------------------------------------

    def _check_class(self, sf: SourceFile, ci):
        accesses: list[_Access] = []
        for mname, fn in ci.methods.items():
            walker = _HeldWalker(
                owner="self.",
                lock_names={f"self.{a}" for a in ci.lock_attrs},
                lock_key=lambda nm, c=ci.name: f"{c}.{nm.split('.', 1)[1]}",
                edges=self._edges,
                path=sf.path,
            )
            walker.visit(fn, ())
            for attr, line, col, is_write, held in walker.accesses:
                if attr in ci.lock_attrs:
                    continue
                accesses.append(
                    _Access(attr, line, col, is_write, held, mname)
                )
        guarded = {
            a.attr for a in accesses if a.is_write and a.held
        }
        seen: set = set()
        for a in accesses:
            if a.attr not in guarded or a.held:
                continue
            if a.method in EXEMPT_METHODS:
                continue
            key = (a.attr, a.line)
            if key in seen:
                continue
            seen.add(key)
            yield self.finding(
                RULE_DISCIPLINE,
                sf.path,
                a.line,
                f"'{a.attr}' is written under a lock elsewhere in "
                f"{ci.name} but {'written' if a.is_write else 'read'} "
                "lock-free here — take the lock or snapshot under it",
                symbol=f"{ci.name}.{a.method}",
                col=a.col,
            )

    # -- module-global discipline ------------------------------------------

    def _check_module(self, sf: SourceFile):
        accesses: list[_Access] = []
        modkey = sf.path.rsplit("/", 1)[-1]
        for fname, fn in sf.functions.items():
            declared_global = {
                n
                for node in ast.walk(fn)
                if isinstance(node, ast.Global)
                for n in node.names
            }
            local_names = _assigned_locals(fn) - declared_global
            walker = _HeldWalker(
                owner=None,
                lock_names=set(sf.module_locks),
                lock_key=lambda nm, m=modkey: f"{m}:{nm}",
                edges=self._edges,
                path=sf.path,
            )
            walker.visit(fn, ())
            for attr, line, col, is_write, held in walker.accesses:
                if attr in sf.module_locks or attr in local_names:
                    continue
                if is_write and attr not in declared_global:
                    continue
                accesses.append(
                    _Access(attr, line, col, is_write, held, fname)
                )
        guarded = {a.attr for a in accesses if a.is_write and a.held}
        seen: set = set()
        for a in accesses:
            if a.attr not in guarded or a.held:
                continue
            key = (a.attr, a.line)
            if key in seen:
                continue
            seen.add(key)
            yield self.finding(
                RULE_DISCIPLINE,
                sf.path,
                a.line,
                f"module global '{a.attr}' is written under a lock "
                f"elsewhere but {'written' if a.is_write else 'read'} "
                "lock-free here — take the lock or justify the "
                "double-checked fast path with a suppression",
                symbol=a.method,
                col=a.col,
            )

    # -- ordering cycles ---------------------------------------------------

    def _check_cycles(self):
        graph: dict = {}
        for (src, dst) in self._edges:
            graph.setdefault(src, set()).add(dst)
        reported: set = set()
        for start in sorted(graph):
            cycle = _find_cycle(graph, start)
            if not cycle:
                continue
            key = frozenset(cycle)
            if key in reported:
                continue
            reported.add(key)
            # anchor the finding on the edge closing the cycle
            src, dst = cycle[-1], cycle[0]
            path, line = self._edges.get(
                (src, dst), next(iter(self._edges.values()))
            )
            yield self.finding(
                RULE_ORDERING,
                path,
                line,
                "lock-ordering cycle: "
                + " -> ".join(cycle + [cycle[0]])
                + " — two threads taking these in opposite order "
                "deadlock; pick one global order",
                symbol="",
            )


class _HeldWalker:
    """Recursive AST walk tracking which locks are syntactically held,
    collecting attribute/global accesses with their held-set, and
    recording lock-nesting edges."""

    def __init__(self, owner, lock_names, lock_key, edges, path):
        self.owner = owner              # "self." for classes, None=globals
        self.lock_names = lock_names    # {"self._lock"} / {"_LOCK"}
        self.lock_key = lock_key
        self.edges = edges
        self.path = path
        self.accesses: list = []        # (attr, line, col, is_write, held)

    def visit(self, node, held):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in node.items:
                d = dotted_name(item.context_expr)
                if d in self.lock_names:
                    key = self.lock_key(d)
                    for prev in new_held:
                        self.edges.setdefault(
                            (prev, key), (self.path, node.lineno)
                        )
                    new_held = new_held + (key,)
                else:
                    self.visit(item.context_expr, held)
            for child in node.body:
                self.visit(child, new_held)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            getattr(self, "_entered", False)
        ):
            return  # nested defs escape the lock scope — skip
        self._entered = True
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ) and node.func.attr in MUTATING_METHODS:
            recv = dotted_name(node.func.value)
            attr = self._attr_of(recv)
            if attr is not None:
                self.accesses.append(
                    (attr, node.lineno, node.col_offset, True, held)
                )
                for a in node.args:
                    self.visit(a, held)
                for kw in node.keywords:
                    self.visit(kw.value, held)
                return
        if isinstance(node, ast.Subscript) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            recv = dotted_name(node.value)
            attr = self._attr_of(recv)
            if attr is not None:
                self.accesses.append(
                    (attr, node.lineno, node.col_offset, True, held)
                )
                self.visit(node.slice, held)
                return
        if isinstance(node, (ast.Attribute, ast.Name)):
            d = dotted_name(node)
            attr = self._attr_of(d)
            if attr is not None:
                self.accesses.append(
                    (
                        attr,
                        node.lineno,
                        node.col_offset,
                        isinstance(node.ctx, (ast.Store, ast.Del)),
                        held,
                    )
                )
                return  # don't descend into chain fragments
            if d is not None:
                return
        for child in ast.iter_child_nodes(node):
            self.visit(child, held)

    def _attr_of(self, dotted: str | None):
        if dotted is None:
            return None
        if self.owner is None:
            return dotted if "." not in dotted else None
        if dotted.startswith(self.owner):
            return dotted[len(self.owner):].split(".", 1)[0]
        return None


def _assigned_locals(fn) -> set:
    out: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            out.add(node.id)
    out |= {a.arg for a in fn.args.args}
    return out


def _find_cycle(graph, start):
    """A cycle reachable from ``start`` (list of nodes), or None."""
    stack: list = []
    on_stack: set = set()
    visited: set = set()

    def dfs(n):
        visited.add(n)
        stack.append(n)
        on_stack.add(n)
        for m in sorted(graph.get(n, ())):
            if m in on_stack:
                return stack[stack.index(m):]
            if m not in visited:
                got = dfs(m)
                if got:
                    return got
        stack.pop()
        on_stack.discard(n)
        return None

    return dfs(start)
