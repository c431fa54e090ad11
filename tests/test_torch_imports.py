"""The PyTorch port stands alone: no JAX and nothing of the JAX package.

``yjs_tpu_torch`` keeps its own copies of the JAX-free modules it needs,
so a machine with only PyTorch can run it.  Two checks hold it there:
an import of the port's entry modules in a fresh interpreter whose
import system refuses ``jax`` and ``yjs_tpu``, and a scan of every
import statement in the package's source, ``chip_smoke.py``, the port's
scripts (``scripts/torch_*.py``) and its examples.  The port's operator scripts and examples
(``scripts/torch_ytpu_stats.py``, ``scripts/torch_ytpu_top.py``,
``examples/torch_server_demo.py``, ``examples/torch_socket_connector.py``)
run under the same finder with ``--device cpu``, and without it, on a
host with no CUDA device, each raises instead of running on the CPU.
"""

import ast
import os
import subprocess
import sys
import time
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
import yjs_tpu_torch.cluster, yjs_tpu_torch.cluster.shard
import yjs_tpu_torch.analysis
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


SOURCES = (
    sorted(PORT.rglob("*.py"))
    + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "scripts").glob("torch_*.py"))
    + sorted((ROOT / "examples").glob("torch_*.py"))
)


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_no_import_statement_names_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(m, ln) for m, ln in _imported_roots(tree) if m in BANNED]
    assert not bad, f"{path}: {bad}"


# a shard child of the port's cluster, started as the supervisor starts
# it, under the same finder: it must reach its ready line on the CPU
SHARD_CHILD = """
import importlib.abc, runpy, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = ["shard", "--id", "0", "--wal-dir", {wal!r}, "--docs", "4",
            "--device", "cpu", "--backend", "auto", "--admin-port", "0"]
runpy.run_module("yjs_tpu_torch.cluster.shard", run_name="__main__")
"""


def test_shard_child_runs_with_jax_blocked(tmp_path):
    import json

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    code = SHARD_CHILD.format(banned=BANNED, wal=str(tmp_path / "wal"))
    proc = subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT),
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("YTPU_SHARD_READY "), (
            line + proc.stderr.read()[-2000:] if proc.poll() is not None
            else line
        )
        ready = json.loads(line[len("YTPU_SHARD_READY "):])
        assert ready["device"] == "cpu"
        assert ready["recovery"] == {"outcome": "fresh"}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    # SIGTERM is the graceful stop: a closing checkpoint, exit 0
    assert proc.returncode == 0, proc.stderr.read()[-2000:]


# the port's operator scripts and examples, run as a user runs them,
# under the finder: ``--device cpu`` runs them on the plain kernels
ENTRY = """
import importlib.abc, runpy, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = {argv!r}
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {banned!r})
assert not leaked, leaked
"""

ENTRY_POINTS = {
    "torch_ytpu_stats": (["scripts/torch_ytpu_stats.py", "--demo", "--json"],
                         '"counters"'),
    "torch_ytpu_top": (["scripts/torch_ytpu_top.py", "--demo", "--once",
                        "--plain"], "fleet verdict"),
    "torch_server_demo": (["examples/torch_server_demo.py"], "demo OK"),
}


def _run_entry(argv, timeout=300, **popen):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    code = ENTRY.format(banned=BANNED, argv=[str(ROOT / argv[0])] + argv[1:])
    if popen:
        return subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=timeout,
    )


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_with_jax_blocked(name):
    argv, want = ENTRY_POINTS[name]
    proc = _run_entry(argv + ["--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert want in proc.stdout


def test_socket_connector_provider_side_runs_with_jax_blocked():
    """``server PORT --provider --device cpu`` and ``client PORT --room``,
    each under the finder: both print the same converged text."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = "examples/torch_socket_connector.py"
    server = _run_entry([script, "server", port, "--provider", "--device",
                         "cpu", "--room", "demo"], popen=True)
    try:
        client = None
        deadline = time.time() + 120
        while time.time() < deadline:
            client = _run_entry([script, "client", port, "--room", "demo"])
            if client.returncode == 0:
                break
            time.sleep(0.5)  # the listener is not up yet
        assert client is not None and client.returncode == 0, client.stderr
        out, err = server.communicate(timeout=120)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    assert server.returncode == 0, err[-2000:]

    def text_of(stdout, role):
        line = next(ln for ln in stdout.splitlines()
                    if ln.startswith(f"{role}: '"))
        return line.split(": ", 1)[1]

    assert text_of(out, "provider") == text_of(client.stdout, "client")
    assert "device=cpu" in out


@pytest.mark.parametrize(
    "argv",
    [ENTRY_POINTS[name][0] for name in sorted(ENTRY_POINTS)]
    + [["examples/torch_socket_connector.py", "server", "0", "--provider"]],
    ids=sorted(ENTRY_POINTS) + ["torch_socket_connector"],
)
def test_entry_point_without_a_card_raises(argv):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point runs on it")
    proc = _run_entry(argv)
    assert proc.returncode != 0
    assert "KernelError" in proc.stderr and "needs a CUDA device" in proc.stderr
