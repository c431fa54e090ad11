"""The PyTorch port stands alone: no JAX and nothing of the JAX package.

``yjs_tpu_torch`` keeps its own copies of the JAX-free modules it needs,
so a machine with only PyTorch can run it.  Two checks hold it there:
an import of the port's entry modules in a fresh interpreter whose
import system refuses ``jax`` and ``yjs_tpu``, and a scan of every
import statement in the package's source.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

import yjs_tpu  # noqa: F401  (both packages import side by side)
import yjs_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = Path(yjs_tpu_torch.__file__).resolve().parent
BANNED = ("jax", "jaxlib", "yjs_tpu")

BLOCKER = """
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import yjs_tpu_torch, yjs_tpu_torch.ops, yjs_tpu_torch.ops.kernels
import yjs_tpu_torch.ops.carry, yjs_tpu_torch.ops._cuda
import yjs_tpu_torch.obs.prof, yjs_tpu_torch.obs.capacity
import yjs_tpu_torch.persistence, yjs_tpu_torch.sync, yjs_tpu_torch.tiering
import yjs_tpu_torch.parallel, yjs_tpu_torch.parallel.mesh
import yjs_tpu_torch.fleet, yjs_tpu_torch.geo, yjs_tpu_torch.loadgen
from yjs_tpu_torch.fleet import FleetRouter
from yjs_tpu_torch.ops import BatchEngine
from yjs_tpu_torch.parallel import doc_mesh
from yjs_tpu_torch.provider import TpuProvider
eng = BatchEngine(2, device="cpu")
meshed = BatchEngine(2, mesh=doc_mesh(2, backend="cpu"))
meshed.queue_update(1, yjs_tpu_torch.encode_state_as_update(yjs_tpu_torch.Doc()))
meshed.flush()
prov = TpuProvider(2, device="cpu")
prov.receive_update("r", yjs_tpu_torch.encode_state_as_update(yjs_tpu_torch.Doc()))
prov.flush()
fleet = FleetRouter(2, 2, device="cpu")
fleet.receive_update("r", yjs_tpu_torch.encode_state_as_update(yjs_tpu_torch.Doc()))
fleet.flush()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {banned!r})
assert not leaked, leaked
print("ok")
"""


def test_port_imports_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(banned=BANNED)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_no_import_statement_names_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(m, ln) for m, ln in _imported_roots(tree) if m in BANNED]
    assert not bad, f"{path}: {bad}"
