"""The port's CI gate against the JAX package's.

``scripts/torch_check_trace.py``, ``scripts/torch_check_metrics_schema.py``
and ``scripts/torch_ci_check.sh`` are the port's counterparts of the JAX
package's trace check, metrics-schema check and gate.  Here, on the CPU:
the port's trace validator gives the JAX validator's verdicts on a seeded
corpus of traces; the selftest passes under both provider backends and
its merged trace samples the same traces and lands the same replication
arrows as the JAX fleet's on the same updates; the schema check passes
and finds the JAX script's knob set; the gate script parses and names
nothing of the JAX package.
"""

import random
import re
import subprocess
from pathlib import Path

import pytest

from torch_service import load_script

ROOT = Path(__file__).resolve().parent.parent
PORT_TRACE = load_script("torch_check_trace")
JAX_TRACE = load_script("check_trace")
PORT_SCHEMA = load_script("torch_check_metrics_schema")
JAX_SCHEMA = load_script("check_metrics_schema")


# -- validate_events: the same verdicts on a seeded corpus --------------------


def _clean_trace(gen: random.Random) -> list[dict]:
    """A seeded trace whose every arrow lands and whose every sampled
    ingress chain reaches a convergence flow-finish."""
    events = [{"name": "process_name", "ph": "M", "ts": 0.0,
               "args": {"name": "ytpu"}}]
    ts = 1.0
    for _ in range(gen.randint(1, 12)):
        trace = "%032x" % gen.getrandbits(128)
        flow = gen.getrandbits(48) or 1
        events.append({"name": "ytpu.provider.receive_update", "ph": "X",
                       "ts": ts, "dur": 2.0, "args": {"trace": trace}})
        events.append({"name": "ytpu.convergence", "ph": "s", "ts": ts,
                       "id": flow, "args": {"trace": trace}})
        if gen.random() < 0.5:
            fan = gen.getrandbits(48) or 1
            events.append({"name": "ytpu.repl.fanout", "ph": "s",
                           "ts": ts + 0.5, "id": fan})
            events.append({"name": "ytpu.repl.fanout", "ph": "f",
                           "ts": ts + 3.0, "id": fan, "bp": "e"})
        events.append({"name": "ytpu.flush", "ph": "X", "ts": ts + 1.0,
                       "dur": gen.uniform(0.1, 5.0)})
        events.append({"name": "ytpu.convergence", "ph": "f",
                       "ts": ts + 4.0, "id": flow, "bp": "e",
                       "args": {"trace": trace}})
        ts += gen.uniform(5.0, 20.0)
    gen.shuffle(events)
    return events


def _drop_one(gen, events, pred):
    picks = [i for i, e in enumerate(events) if pred(e)]
    i = gen.choice(picks)
    return events[:i] + events[i + 1:]


def _lone_start(gen, events):
    return _drop_one(gen, events, lambda e: e.get("ph") == "f")


def _lone_finish(gen, events):
    return _drop_one(gen, events, lambda e: e.get("ph") == "s")


def _no_id(gen, events):
    picks = [i for i, e in enumerate(events) if e.get("ph") in ("s", "f")]
    i = gen.choice(picks)
    out = [dict(e) for e in events]
    del out[i]["id"]
    return out


def _never_visible(gen, events):
    """Drop every convergence flow of one sampled chain: its ingress span
    stays, nothing of it reaches visibility."""
    traces = sorted({(e.get("args") or {}).get("trace") for e in events
                     if e.get("name") == "ytpu.provider.receive_update"})
    lost = gen.choice(traces)
    return [e for e in events
            if not (e.get("name") == "ytpu.convergence"
                    and (e.get("args") or {}).get("trace") == lost)]


BREAKS = {
    "clean": None,
    "lone_flow_start": _lone_start,
    "lone_flow_finish": _lone_finish,
    "flow_without_id": _no_id,
    "chain_never_visible": _never_visible,
}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", sorted(BREAKS))
def test_validate_events_agrees_with_the_jax_check(kind, seed):
    gen = random.Random(1000 * seed + sorted(BREAKS).index(kind))
    events = _clean_trace(gen)
    if BREAKS[kind] is not None:
        events = BREAKS[kind](gen, events)
    got = PORT_TRACE.validate_events(events)
    assert got == JAX_TRACE.validate_events(events)
    assert (got == []) == (kind == "clean"), got


@pytest.mark.parametrize("events", [[], [{"name": "thread_name", "ph": "M"}]],
                         ids=["empty", "metadata_only"])
def test_empty_trace_agrees_with_the_jax_check(events):
    got = PORT_TRACE.validate_events(events)
    assert got == JAX_TRACE.validate_events(events) == ["trace has no events"]


def test_load_and_check_file_agree_with_the_jax_check(tmp_path):
    import json

    events = _clean_trace(random.Random(7))
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"traceEvents": events}))
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2")
    for path in (good, bad, tmp_path / "missing.json"):
        assert PORT_TRACE.check_file(str(path)) == JAX_TRACE.check_file(
            str(path))
    assert PORT_TRACE.load_events({"traceEvents": events}) == \
        JAX_TRACE.load_events({"traceEvents": events})
    assert PORT_TRACE.INGRESS_NAMES == JAX_TRACE.INGRESS_NAMES
    assert PORT_TRACE.TERMINAL_NAMES == JAX_TRACE.TERMINAL_NAMES


# -- the selftest, beside the JAX fleet's trace --------------------------------


def _jax_selftest_events(backend):
    """The JAX selftest's fleet and updates, with ``backend``."""
    import os

    prior = os.environ.get("YTPU_TRACE_SAMPLE")
    os.environ["YTPU_TRACE_SAMPLE"] = "1"
    try:
        from yjs_tpu.core import Doc
        from yjs_tpu.fleet import FleetRouter
        from yjs_tpu.updates import encode_state_as_update

        fleet = FleetRouter(3, 4, backend=backend)
        docs = {}
        for k in range(4):
            d = Doc(gc=False)
            d.client_id = 100 + k
            docs[f"room-{k}"] = d
        for i in range(3):
            for g, d in sorted(docs.items()):
                d.get_text("text").insert(0, f"{g} edit {i} ")
                fleet.receive_update(g, encode_state_as_update(d))
            fleet.flush()
            fleet.tick()
        fleet.repl.repair_all()
        fleet.flush()
        events = []
        for p in fleet.shards:
            events.extend(p.engine.obs.tracer.trace_events())
    finally:
        if prior is None:
            del os.environ["YTPU_TRACE_SAMPLE"]
        else:
            os.environ["YTPU_TRACE_SAMPLE"] = prior
    return events


@pytest.mark.tracing
@pytest.mark.parametrize("backend", ["auto", "cpu"])
def test_selftest_passes_and_matches_the_jax_fleet(backend, capsys):
    assert PORT_TRACE.selftest(device="cpu", backend=backend) == 0
    assert "selftest ok" in capsys.readouterr().out
    port = PORT_TRACE.selftest_events(device="cpu", backend=backend)
    ref = _jax_selftest_events(backend)
    assert PORT_TRACE.validate_events(port) == []
    # trace ids are keyed hashes of the update bytes: both fleets sample
    # the same twelve updates and land one fan-out arrow for each
    assert PORT_TRACE.ingress_traces(port) == PORT_TRACE.ingress_traces(ref)
    assert len(PORT_TRACE.ingress_traces(port)) == 12
    assert PORT_TRACE.fanout_arrows(port) == PORT_TRACE.fanout_arrows(ref) > 0


def test_selftest_leaves_the_sampling_knob_as_it_was(monkeypatch):
    monkeypatch.setenv("YTPU_TRACE_SAMPLE", "64")
    PORT_TRACE.selftest_events(device="cpu", backend="cpu")
    import os

    assert os.environ["YTPU_TRACE_SAMPLE"] == "64"


def test_trace_cli_checks_files(tmp_path, capsys):
    import json

    good = tmp_path / "good.json"
    good.write_text(json.dumps(_clean_trace(random.Random(3))))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(_lone_start(random.Random(3),
                                          _clean_trace(random.Random(3)))))
    assert PORT_TRACE.main([str(good)]) == 0
    assert PORT_TRACE.main([str(good), str(bad)]) == 1
    out = capsys.readouterr().out
    assert f"{good}: ok" in out and f"{bad}: INVALID" in out


# -- the metrics-schema check ---------------------------------------------------


def test_metrics_schema_check_passes_on_the_cpu(capsys):
    assert PORT_SCHEMA.main(["--device", "cpu"]) == 0
    assert "ok: live metric families and env knobs agree with README" in (
        capsys.readouterr().out)


def test_knobs_in_the_port_are_the_jax_packages():
    port = PORT_SCHEMA.resilience_knobs_in_code()
    assert port == JAX_SCHEMA.resilience_knobs_in_code()
    assert len(port) >= 135


def test_registered_and_documented_names_agree():
    readme = (ROOT / "README.md").read_text()
    documented = PORT_SCHEMA.documented_names(readme)
    assert documented == JAX_SCHEMA.documented_names(readme)
    assert PORT_SCHEMA.registered_names(device="cpu") == documented


# -- the gate script -------------------------------------------------------------

GATE = ROOT / "scripts" / "torch_ci_check.sh"


def test_gate_script_parses():
    proc = subprocess.run(["bash", "-n", str(GATE)], capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr


def test_gate_script_names_only_the_port():
    text = GATE.read_text()
    assert "yjs_tpu/" not in text
    assert not re.search(r"\byjs_tpu\b(?!_torch)", text)
    # no JAX script: every script it runs is a port script
    for name in re.findall(r"scripts/([\w.]+)", text):
        assert name.startswith("torch_"), name
    assert not re.search(r"(?<!torch_)(ci_check\.sh|check_trace|"
                         r"check_metrics_schema|ytpu_lint)", text)
    # no test file but the port's
    for name in re.findall(r"tests/([\w*.]+)", text):
        assert name.startswith("test_torch_"), name
    assert "JAX_PLATFORMS" not in text
    assert "set -euo pipefail" in text


def test_gate_script_rejects_an_unknown_device():
    proc = subprocess.run(["bash", str(GATE), "--device", "tpu"],
                          capture_output=True, text=True, cwd=str(ROOT))
    assert proc.returncode == 2
    assert "cpu or cuda" in proc.stderr
