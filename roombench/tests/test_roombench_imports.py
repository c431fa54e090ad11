"""What the harness may import: nothing of JAX or the JAX package, and in
the reference nothing of the program under test."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "yjs_tpu"}
# the reference and the yardstick: they judge the program, so they import none of it
REFERENCE = {"ycodec.py", "ytext.py", "bases.py", "walread.py", "check.py",
             "traffic.py", "devtrace.py", "manifest.py", "peaks.py", "host.py"}


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_reference_imports_nothing_of_the_program(name):
    mods = set(_imports(os.path.join(HERE, name)))
    assert "yjs_tpu_torch" not in mods and "torch" not in mods
