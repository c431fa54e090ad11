"""donation-aliasing: a buffer passed at a ``donate_argnums`` position
of a jitted kernel is DEAD after the call — XLA may reuse its memory for
the output in place.  Reading, returning, or caching it afterwards is
the exact bug class the plan-cache ``_NativeEntry`` audit closed
by hand: the value observed is whatever the donated buffer was
overwritten with.

The checker resolves call sites against the project-wide jit registry
(decorated defs AND ``name = jax.jit(fn, donate_argnums=…)``
assignments), then runs a light intra-function dataflow walk: for every
name/attribute passed at a donated position, the FIRST subsequent event
on that name must be a (re)assignment.  The canonical safe idiom —
``dyn = step(statics, dyn, …)`` — rebinds the name in the same
statement and is recognized as such; ``*args`` splats are tracked
through the splatted name."""

from __future__ import annotations

import ast

from .base import (
    Checker,
    assign_targets,
    enclosing_statement,
    iter_functions,
    name_events,
)
from .project import ProjectIndex, call_func_name, dotted_name, terminal_name

RULE = "donation-aliasing"


class DonationChecker(Checker):
    name = "donation"
    rules = {RULE: "error"}

    def check(self, index: ProjectIndex):
        donating = index.donating()
        if not donating:
            return
        for sf in index.files.values():
            if sf.tree is None:
                continue
            for symbol, _cls, fn in iter_functions(sf):
                yield from self._check_function(
                    index, donating, sf, symbol, fn
                )

    def _check_function(self, index, donating, sf, symbol, fn):
        events = None  # built lazily, only when a donating call appears
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = terminal_name(call_func_name(node))
            info = donating.get(callee)
            if info is None or info.line == node.lineno and (
                info.path == sf.path
            ):
                # skip the def site itself (decorator line)
                continue
            tracked = self._donated_arg_names(node, info)
            if not tracked:
                continue
            stmt = enclosing_statement(fn, node)
            rebound = assign_targets(stmt) if stmt is not None else set()
            if events is None:
                events = name_events(fn)
            for argname in tracked:
                if argname in rebound:
                    continue
                hit = self._first_use_after(events, argname, node.lineno)
                if hit is not None:
                    yield self.finding(
                        RULE,
                        sf.path,
                        hit.line,
                        f"'{argname}' was donated to {callee}() at line "
                        f"{node.lineno} (donate_argnums, defined at "
                        f"{info.path}:{info.line}) and is read here "
                        "afterwards — the buffer may have been reused "
                        "in place; rebind it to the call's result or "
                        "copy before donating",
                        symbol=symbol,
                        col=hit.col,
                    )

    @staticmethod
    def _donated_arg_names(call: ast.Call, info) -> set:
        """Dotted names passed at the call's donated positions.  A
        ``*splat`` covering a donated position tracks the splatted name;
        inline tuples track each element."""
        names: set = set()
        star_at = None
        star_name = None
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                star_at = i
                star_name = dotted_name(a.value)
                break
        for pos in info.donate_argnums:
            expr = None
            if star_at is not None and pos >= star_at:
                if star_name:
                    names.add(star_name)
                continue
            if pos < len(call.args):
                expr = call.args[pos]
            elif info.params and pos < len(info.params):
                want = info.params[pos]
                for kw in call.keywords:
                    if kw.arg == want:
                        expr = kw.value
                        break
            if expr is None:
                continue
            if isinstance(expr, (ast.Tuple, ast.List)):
                for e in expr.elts:
                    d = dotted_name(e)
                    if d:
                        names.add(d)
            else:
                d = dotted_name(expr)
                if d:
                    names.add(d)
        return names

    @staticmethod
    def _first_use_after(events, name, call_line):
        """The first event on ``name`` (or an attribute of it) strictly
        after ``call_line``; returns it when it is a READ, else None."""
        dotprefix = name + "."
        for e in events:
            if e.line <= call_line:
                continue
            if e.name == name or e.name.startswith(dotprefix):
                return None if e.is_store else e
        return None
