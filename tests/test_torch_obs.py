"""The port's observability layer and native build cache.

``obs/prof.py`` keeps the JAX package's ``ytpu_prof_*`` families and
its ``profiled`` / ``kernel_profiler`` API, with call signatures built
from tensor shape, dtype and device; ``obs/capacity.py`` counts CUDA
devices.  ``buildlib`` builds each native library once, even when
several processes ask for it at the same moment.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import yjs_tpu as Y
from yjs_tpu.geo.replicator import GeoMetrics
from yjs_tpu.obs import global_registry as jax_global_registry
from yjs_tpu.obs.prof import kernel_profiler as jax_kernel_profiler
from yjs_tpu.obs.tsdb import tsdb_metrics as jax_tsdb_metrics
from yjs_tpu_torch.obs import capacity
from yjs_tpu_torch.obs.prof import (
    KernelProfiler,
    call_signature,
    kernel_profiler,
    profiled,
    shape_bucket,
)
from yjs_tpu_torch.obs.registry import MetricsRegistry
from yjs_tpu_torch.obs.trace import Tracer
from yjs_tpu_torch.ops import BatchEngine

ROOT = Path(__file__).resolve().parent.parent

# The JAX package's README-schema test (test_obs.py) reads the
# process-global registry, where the ytpu_geo_* and ytpu_tsdb_* families
# appear only once something in the same process has created them.  Run
# alone it fails; in a full run it passes only when a geo and a tsdb test
# happened to run earlier on the same worker.  Creating both bundles here,
# at collection (which every worker does before running any test), keeps
# that check independent of how the files are spread over the workers.
GeoMetrics()
jax_tsdb_metrics()


def _fresh():
    return KernelProfiler(registry=MetricsRegistry(), tracer=Tracer(enabled=True))


def test_prof_families_match_the_jax_package():
    def families(p):
        return sorted(
            name for name in p.registry.names()
            if name.startswith("ytpu_prof_")
        )

    assert families(kernel_profiler()) == families(jax_kernel_profiler())


def test_copied_tsdb_registers_the_jax_package_families():
    from yjs_tpu_torch.obs import global_registry
    from yjs_tpu_torch.obs.tsdb import tsdb_metrics

    tsdb_metrics()

    def families(reg):
        return sorted(n for n in reg.names() if n.startswith("ytpu_tsdb_"))

    assert families(global_registry()) == families(jax_global_registry())
    assert families(global_registry())


def test_call_signature_reads_shape_dtype_device_and_statics():
    a8 = torch.zeros(8, dtype=torch.int32)
    a16 = torch.zeros(16, dtype=torch.int32)
    f8 = torch.zeros(8, dtype=torch.float32)
    assert call_signature((a8,), {}) != call_signature((a16,), {})
    assert call_signature((a8,), {}) != call_signature((f8,), {})
    assert call_signature(((a8, a8), 3), {}) == call_signature(((a8, a8), 3), {})
    assert call_signature((a8, 3), {}) != call_signature((a8, 4), {})
    (sig,) = call_signature((a8,), {})
    assert sig == ((8,), "torch.int32@cpu")
    nested = call_signature(({"b": a8, "a": f8}, [a16]), {})
    assert [s[1] for s in nested] == [
        "torch.float32@cpu", "torch.int32@cpu", "torch.int32@cpu"
    ]
    assert shape_bucket(call_signature((torch.zeros(3, 3),), {})) == "le_16"
    assert shape_bucket(call_signature((np.zeros(70),), {})) == "le_128"


def test_first_signature_compiles_then_hits_then_retraces():
    p = _fresh()

    def fn(x):
        return x + 1

    x = torch.zeros(4, dtype=torch.int32)
    for _ in range(3):
        out = p.call("k", fn, (x,), {})
    assert int(out[0]) == 1
    p.call("k", fn, (torch.zeros(32, dtype=torch.int32),), {})
    snap = p.snapshot()
    rec = snap["kernels"]["k"]
    assert (rec["compiles"], rec["hits"], rec["retraces"]) == (2, 2, 1)
    (event,) = snap["retrace_events"]
    assert "torch.int32@cpu[32]" in event["signature"]


def test_device_mode_routes_through_the_timed_path(monkeypatch):
    p = _fresh()
    x = torch.zeros(4)
    p.call("dev", torch.neg, (x,), {})
    monkeypatch.setenv("YTPU_PROF_DEVICE", "1")
    p.call("dev", torch.neg, (x,), {})
    fam = p.registry.get("ytpu_prof_device_seconds")
    counts = {lab["kernel"]: s.count for lab, s in fam.samples()}
    assert counts.get("dev") == 1


def test_profiled_is_transparent_when_disabled(monkeypatch):
    @profiled("nope")
    def fn(x):
        return x + 1

    monkeypatch.setenv("YTPU_OBS_DISABLED", "1")
    before = dict(kernel_profiler().snapshot()["kernels"])
    assert fn(1) == 2
    assert kernel_profiler().snapshot()["kernels"] == before


def test_engine_flush_attributes_the_apply_kernel():
    d = Y.Doc(gc=False)
    d.get_text("text").insert(0, "hello")
    eng = BatchEngine(2, device="cpu")
    eng.queue_update(0, Y.encode_state_as_update(d))
    eng.flush()
    assert eng.text(0) == "hello"
    snap = kernel_profiler().snapshot()["kernels"]
    assert snap["apply_plan2"]["compiles"] + snap["apply_plan2"]["hits"] >= 1
    assert "list_ranks" in snap
    assert "ytpu_prof_compiles_total" in eng.metrics_text()
    table = eng.obs.registry.get("ytpu_prof_device_table_bytes")
    sizes = {lab["table"]: s.value for lab, s in table.samples()}
    assert sizes["right_link"] == eng._right.nbytes


def test_capacity_counts_cuda_devices():
    out = capacity.sessions_per_device({"sessions_at_slo": 96})
    n = max(1, torch.cuda.device_count())
    assert out["n_devices"] == n
    assert out["sessions_per_device"] == round(96 / n, 2)
    with pytest.raises(NotImplementedError, match="loadgen"):
        capacity.ramp_capacity(lambda n: None)


BUILD_SCRIPT = textwrap.dedent("""
    import sys
    from yjs_tpu_torch.buildlib import build_shared
    src = sys.argv[1]
    path, built, _out = build_shared(
        "probe", [src],
        lambda out: ["g++", "-O1", "-shared", "-fPIC", "-o", out, src],
    )
    print(path, int(built))
""")


def test_build_once_under_concurrent_processes(tmp_path):
    """Four processes ask for the same library at once: exactly one
    compiles it, all load the same complete file, and no temporary
    file is left behind."""
    src = tmp_path / f"probe_{os.getpid()}.c"
    src.write_text("int probe(void) { return %d; }\n" % os.getpid())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", BUILD_SCRIPT, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for _ in range(4)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        results.append(out.split())
    paths = {r[0] for r in results}
    assert len(paths) == 1
    assert sum(int(r[1]) for r in results) == 1
    path = Path(paths.pop())
    assert path.exists()
    assert not list(path.parent.glob(path.name + ".tmp*"))
    path.unlink()
