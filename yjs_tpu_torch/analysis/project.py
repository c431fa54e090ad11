"""Project index shared by every ytpu-lint checker.

Parses each target file once, then builds the cross-file registries the
checkers consume:

- **jit registry** — every function jitted with ``jax.jit`` (decorator,
  ``functools.partial(jax.jit, …)``, or ``name = jax.jit(fn, …)``
  assignment), with its ``donate_argnums`` / ``static_argnums`` and the
  parameter names when the def is visible.  This is what lets the
  donation-aliasing and retrace checkers resolve call sites by name.
- **lock registry** — per (module, class) the attribute names bound to
  ``threading.Lock()`` / ``threading.RLock()``, plus module-level lock
  globals, for the lock-discipline checker.

Everything here is plain :mod:`ast` — no imports of the analyzed code,
so fixtures (and the repo itself) lint without JAX present.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from .model import Finding, RULE_PARSE_ERROR


def dotted_name(node) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_func_name(call: ast.Call) -> str | None:
    """Terminal dotted name of a call's callee (``kernels.batch_step``)."""
    return dotted_name(call.func)


def terminal_name(dotted: str | None) -> str | None:
    return dotted.rsplit(".", 1)[-1] if dotted else None


def literal_int_tuple(node) -> tuple | None:
    """A literal int, or tuple/list of literal ints, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if not (
                isinstance(elt, ast.Constant) and isinstance(elt.value, int)
            ):
                return None
            out.append(elt.value)
        return tuple(out)
    return None


@dataclass
class JitInfo:
    """One jitted callable the project defines."""

    name: str                    # resolvable call-site name (terminal)
    path: str
    line: int
    donate_argnums: tuple = ()
    static_argnums: tuple = ()
    params: tuple = ()           # positional parameter names when known
    kind: str = "decorator"      # decorator | assignment | factory

    def donated_params(self) -> tuple:
        return tuple(
            self.params[i] for i in self.donate_argnums
            if i < len(self.params)
        )


@dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    lock_attrs: set = field(default_factory=set)     # e.g. {"_lock"}
    methods: dict = field(default_factory=dict)      # name -> FunctionDef


@dataclass
class SourceFile:
    path: str                    # repo-relative, forward slashes
    abspath: Path
    text: str
    tree: ast.AST | None
    lines: list = field(default_factory=list)
    classes: dict = field(default_factory=dict)      # name -> ClassInfo
    module_locks: set = field(default_factory=set)   # module-level lock names
    functions: dict = field(default_factory=dict)    # top-level name -> def


def _jit_spec_from_call(call: ast.Call) -> dict | None:
    """donate/static argnums when ``call`` is a jax.jit(...) or
    functools.partial(jax.jit, ...) expression, else None."""
    fname = call_func_name(call)
    term = terminal_name(fname)
    inner_is_jit = False
    if term == "jit" or fname in ("jax.jit",):
        inner_is_jit = True
    elif term == "partial" and call.args:
        first = call.args[0]
        if terminal_name(dotted_name(first)) == "jit" or (
            dotted_name(first) == "jax.jit"
        ):
            inner_is_jit = True
    if not inner_is_jit:
        return None
    spec = {"donate": (), "static": ()}
    for kw in call.keywords:
        vals = literal_int_tuple(kw.value)
        if kw.arg == "donate_argnums" and vals is not None:
            spec["donate"] = vals
        elif kw.arg == "static_argnums" and vals is not None:
            spec["static"] = vals
    return spec


def _decorator_jit_spec(dec) -> dict | None:
    """A decorator that jits the function it wraps (possibly through
    other decorators like ``@profiled(...)`` stacked above it)."""
    if isinstance(dec, ast.Call):
        return _jit_spec_from_call(dec)
    if dotted_name(dec) in ("jax.jit",) or terminal_name(
        dotted_name(dec)
    ) == "jit":
        return {"donate": (), "static": ()}
    return None


class ProjectIndex:
    """Parsed files + cross-file registries, built once per lint run."""

    def __init__(self, root: Path, paths: list[Path]):
        self.root = Path(root)
        self.files: dict[str, SourceFile] = {}
        self.parse_findings: list[Finding] = []
        self.jit_registry: dict[str, JitInfo] = {}
        # factory functions that RETURN a donated jit (call sites are
        # dynamic — recorded so checkers/docs can reason about them)
        self.jit_factories: dict[str, JitInfo] = {}
        for p in sorted(set(paths)):
            self._load(Path(p))
        for sf in self.files.values():
            self._index_file(sf)

    # -- loading -----------------------------------------------------------

    def relpath(self, p: Path) -> str:
        try:
            return p.resolve().relative_to(self.root.resolve()).as_posix()
        except ValueError:
            return p.as_posix()

    def _load(self, p: Path) -> None:
        rel = self.relpath(p)
        text = p.read_text(encoding="utf-8", errors="replace")
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError as e:
            tree = None
            self.parse_findings.append(
                Finding(
                    rule=RULE_PARSE_ERROR,
                    severity="error",
                    path=rel,
                    line=e.lineno or 1,
                    message=f"file does not parse: {e.msg}",
                )
            )
        self.files[rel] = SourceFile(
            path=rel,
            abspath=p,
            text=text,
            tree=tree,
            lines=text.splitlines(),
        )

    # -- indexing ----------------------------------------------------------

    def _index_file(self, sf: SourceFile) -> None:
        if sf.tree is None:
            return
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                ci = ClassInfo(name=node.name, node=node)
                for item in node.body:
                    if isinstance(
                        item, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        ci.methods[item.name] = item
                for sub in ast.walk(node):
                    tgt = _lock_assign_target(sub)
                    if tgt and tgt.startswith("self."):
                        ci.lock_attrs.add(tgt.split(".", 1)[1])
                sf.classes[node.name] = ci
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._index_function(sf, node)
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sf.functions[node.name] = node
            tgt = _lock_assign_target(node)
            if tgt and "." not in tgt:
                sf.module_locks.add(tgt)
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                spec = _jit_spec_from_call(node.value)
                if spec and (spec["donate"] or spec["static"]):
                    for t in node.targets:
                        name = terminal_name(dotted_name(t))
                        if name:
                            self.jit_registry[name] = JitInfo(
                                name=name,
                                path=sf.path,
                                line=node.lineno,
                                donate_argnums=spec["donate"],
                                static_argnums=spec["static"],
                                kind="assignment",
                            )

    def _index_function(self, sf: SourceFile, fn) -> None:
        spec = None
        for dec in fn.decorator_list:
            spec = _decorator_jit_spec(dec)
            if spec is not None:
                break
        if spec is not None:
            params = tuple(a.arg for a in fn.args.args)
            self.jit_registry[fn.name] = JitInfo(
                name=fn.name,
                path=sf.path,
                line=fn.lineno,
                donate_argnums=spec["donate"],
                static_argnums=spec["static"],
                params=params,
                kind="decorator",
            )
            return
        # factory shape: the function RETURNS jax.jit(..., donate_argnums=…)
        # (possibly wrapped, e.g. profiled("x")(jax.jit(...)))
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                for call in ast.walk(node.value):
                    if isinstance(call, ast.Call):
                        s = _jit_spec_from_call(call)
                        if s and s["donate"]:
                            self.jit_factories[fn.name] = JitInfo(
                                name=fn.name,
                                path=sf.path,
                                line=fn.lineno,
                                donate_argnums=s["donate"],
                                static_argnums=s["static"],
                                kind="factory",
                            )
                            break

    # -- queries -----------------------------------------------------------

    def read_adjacent(self, relpath: str) -> str | None:
        """Text of a non-Python project file (README.md, …) relative to
        the project root, or None when absent."""
        p = self.root / relpath
        if not p.is_file():
            return None
        return p.read_text(encoding="utf-8", errors="replace")

    def donating(self) -> dict[str, JitInfo]:
        return {
            n: j for n, j in self.jit_registry.items() if j.donate_argnums
        }


def _lock_assign_target(node) -> str | None:
    """``self._lock`` / ``_LOCK`` when node assigns a threading lock."""
    if not isinstance(node, ast.Assign):
        return None
    if not isinstance(node.value, ast.Call):
        return None
    callee = dotted_name(node.value.func)
    if terminal_name(callee) not in ("Lock", "RLock"):
        return None
    for t in node.targets:
        d = dotted_name(t)
        if d:
            return d
    return None


def iter_python_files(paths: list[Path], exclude: tuple = ()) -> list[Path]:
    """Expand files/dirs into .py files, skipping excluded path parts."""
    out = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if any(part in exclude for part in f.parts):
                    continue
                out.append(f)
        elif p.suffix == ".py":
            out.append(p)
    return out
