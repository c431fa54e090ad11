"""Whole runs of the harness at small sizes, the chip's look skipped
(``--device cpu``): a sound run is correct, and each fault planted under
the window's calls makes it incorrect.  The card test runs the control,
an acknowledged edit that is lost, and a device step that writes nothing,
on the card."""

import json
import os
import subprocess
import sys

import pytest

from roombench import harness, manifest

SMALL = {"rooms12k.typing": ["--rooms", "12", "--sized-for", "80"],
         "b4docs256.join": ["--rooms", "2", "--sized-for", "80"]}
# BENCHMARK.json with the join cell, which the benchmark does not hold yet,
# and the join's end-to-end metrics: a later manifest that adds the cell
JOIN = {
    "configs": [{"name": "b4docs256", "source": "crdt-benchmarks B4",
                 "file": "roombench/configs/b4docs256.json",
                 "reduced": ["rooms"], "why": "B4-scale rooms"}],
    "workloads": [{"name": "b4docs256.join", "config": "b4docs256",
                   "traffic": "join", "chips": 1, "why": "joins"}],
    "end_to_end": [
        {"name": "joins_per_s", "unit": "joins/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["b4docs256.join"]},
        {"name": "join_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["b4docs256.join"]}],
}
MAIN = ("import json, sys, time; t0 = time.perf_counter(); "
        "sys.path.insert(0, {root!r}); from roombench import harness; "
        "sys.exit(harness.main(sys.argv[2:], t0, json.load(open(sys.argv[1]))))")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The manifest, with the join cell added, as a file."""
    m = manifest.load(harness.ROOT)
    for k, v in JOIN.items():
        m[k] = m[k] + v
    manifest.validate(m)
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(m))
    return str(path)


def _run(workload, seed, *extra, device="cpu", seconds="1.0", bench=None):
    args = ["--workload", workload, "--seed", str(seed), "--seconds", seconds,
            "--trace", "0", "--device", device, *extra]
    if bench is None:
        cmd = [sys.executable, os.path.join(harness.HERE, "run.py"), *args]
    else:
        cmd = [sys.executable, "-c", MAIN.format(root=harness.ROOT), bench, *args]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    checks = [ln for ln in p.stderr.splitlines() if ln.startswith("check ")]
    assert [ln.split()[1] for ln in checks] == list(out["checks"])
    return out


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload, bench):
    out = _run(workload, 2**31 + 7, *SMALL[workload], bench=bench)
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]
    if workload == "b4docs256.join":
        assert {"joins_per_s", "join_p95_ms"} <= set(out["metrics"])


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in sorted(SMALL) for f in harness.FAULTS])
def test_fault_makes_the_run_incorrect(workload, fault, bench):
    out = _run(workload, 31, *SMALL[workload], "--fault", fault, bench=bench)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.fixture()
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control runs on the card only")


@pytest.mark.cuda
def test_control_on_the_card(card):
    ok = _run("rooms12k.typing", 2**31 + 99, "--rooms", "512", device="cuda", seconds="3")
    assert ok["correct"] is True
    for fault in ("lost_ack", "k1_noop"):
        bad = _run("rooms12k.typing", 2**31 + 99, "--rooms", "512", "--fault", fault,
                   device="cuda", seconds="3")
        assert bad["correct"] is False
