#!/usr/bin/env python
"""Validate a PyTorch-port Perfetto/Chrome trace for causal completeness.

The port's copy of ``scripts/check_trace.py``.  Loads one or more
Chrome-trace JSON files (``{"traceEvents": [...]}`` as written by
``Tracer.save`` / ``YTPU_TRACE_PATH`` / the engine's
``export_chrome_trace``) and fails when the causal structure is broken:

- **flow arrows resolve**: every flow-finish event (``ph="f"``) has a
  matching flow-start (``ph="s"``) with the same id under the same
  name, and vice versa — an arrow with only one end means a producer
  and consumer disagreed on the hash-derived flow id, or an event was
  lost to ring truncation;
- **no orphan spans**: a flow-start whose arrow never lands is a
  pipeline stage that swallowed the update;
- **sampled chains complete**: every trace id stamped on an ingress
  span (``ytpu.provider.receive_update``) also reaches visibility (a
  ``ytpu.convergence`` flow-finish carrying the same trace id) —
  origin → visible, across however many providers' tracers were merged
  into the file.

    python scripts/torch_check_trace.py TRACE.json [...]
    python scripts/torch_check_trace.py --selftest [--device cpu]
                                        [--backend cpu]

``--selftest`` builds a 3-shard replicated in-process port fleet with
``YTPU_TRACE_SAMPLE=1``, pushes edits through the full ingress →
admission → shard flush → replication fan-out pipeline, merges every
shard tracer into ONE trace, and validates it — the proof that a sampled
update at one peer stitches into a single resolvable trace.  Its fleet
runs on the CUDA device unless ``--device cpu`` is given, with the
``auto`` backend (rooms reach the engine) unless ``--backend cpu`` keeps
them on the CPU core.

Chaos runs that kill shards mid-flight legitimately strand arrows;
validate only traces from runs that were allowed to finish.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# span/instant names that mark a trace's ingress into the stack
INGRESS_NAMES = ("ytpu.provider.receive_update",)
# flow-finish names that mark a trace reaching visibility
TERMINAL_NAMES = ("ytpu.convergence",)


def load_events(path_or_obj) -> list[dict]:
    if isinstance(path_or_obj, (list, dict)):
        obj = path_or_obj
    else:
        with open(path_or_obj) as f:
            obj = json.load(f)
    if isinstance(obj, dict):
        obj = obj.get("traceEvents", [])
    if not isinstance(obj, list):
        raise ValueError("not a Chrome trace (no traceEvents list)")
    return [e for e in obj if isinstance(e, dict)]


def validate_events(events: list[dict]) -> list[str]:
    """All violated invariants, as human-readable strings (empty =
    valid)."""
    errors: list[str] = []
    if not any(e.get("ph") not in ("M",) for e in events):
        return ["trace has no events"]

    # -- flow arrows resolve both ways, per name --------------------------
    starts: dict[str, set] = defaultdict(set)
    ends: dict[str, set] = defaultdict(set)
    for e in events:
        ph = e.get("ph")
        if ph not in ("s", "f"):
            continue
        name = str(e.get("name", "?"))
        if "id" not in e:
            errors.append(f"flow event {name!r} ph={ph} has no id")
            continue
        (starts if ph == "s" else ends)[name].add(e["id"])
    for name in sorted(set(starts) | set(ends)):
        dangling = sorted(starts[name] - ends[name])[:5]
        unsourced = sorted(ends[name] - starts[name])[:5]
        if dangling:
            errors.append(
                f"{len(starts[name] - ends[name])} flow arrow(s) for "
                f"{name!r} never land (orphan spans), e.g. ids "
                f"{dangling}"
            )
        if unsourced:
            errors.append(
                f"{len(ends[name] - starts[name])} flow arrow(s) for "
                f"{name!r} have no origin, e.g. ids {unsourced}"
            )

    # -- sampled chains complete: ingress trace id -> visible -------------
    ingress_traces: set[str] = set()
    terminal_traces: set[str] = set()
    for e in events:
        t = (e.get("args") or {}).get("trace")
        if not t:
            continue
        name = str(e.get("name", ""))
        if name.startswith(INGRESS_NAMES):
            ingress_traces.add(t)
        if name.startswith(TERMINAL_NAMES) and e.get("ph") == "f":
            terminal_traces.add(t)
    incomplete = sorted(ingress_traces - terminal_traces)
    if incomplete:
        errors.append(
            f"{len(incomplete)} sampled trace(s) never reached "
            f"visibility, e.g. {incomplete[:3]}"
        )
    return errors


def check_file(path: str) -> list[str]:
    try:
        events = load_events(path)
    except (OSError, ValueError) as e:
        return [f"unreadable: {e}"]
    return validate_events(events)


# -- selftest -----------------------------------------------------------------


def selftest_events(device=None, backend: str = "auto") -> list[dict]:
    """The selftest's merged trace: a 3-shard replicated port fleet on
    ``device`` with ``backend``, everything sampled, four rooms edited
    in three rounds, every shard tracer's events sorted by time."""
    prior = os.environ.get("YTPU_TRACE_SAMPLE")
    os.environ["YTPU_TRACE_SAMPLE"] = "1"
    try:
        from yjs_tpu_torch.core import Doc
        from yjs_tpu_torch.fleet import FleetRouter
        from yjs_tpu_torch.updates import encode_state_as_update

        fleet = FleetRouter(3, 4, backend=backend, device=device)
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

        events: list[dict] = []
        for p in fleet.shards:
            events.extend(p.engine.obs.tracer.trace_events())
        events.sort(key=lambda e: e.get("ts", 0.0))
    finally:
        if prior is None:
            del os.environ["YTPU_TRACE_SAMPLE"]
        else:
            os.environ["YTPU_TRACE_SAMPLE"] = prior
    return events


def ingress_traces(events: list[dict]) -> set:
    """The trace ids stamped on the trace's ingress spans."""
    return {
        (e.get("args") or {}).get("trace")
        for e in events
        if str(e.get("name", "")).startswith(INGRESS_NAMES)
        and (e.get("args") or {}).get("trace")
    }


def fanout_arrows(events: list[dict]) -> int:
    """The replication fan-out arrows that landed."""
    return sum(
        1 for e in events
        if e.get("name") == "ytpu.repl.fanout" and e.get("ph") == "f"
    )


def selftest(device=None, backend: str = "auto") -> int:
    """3-shard replicated fleet, everything sampled, every shard tracer
    merged into one trace — must validate clean AND contain at least
    one complete cross-stage chain.  Returns the exit code."""
    events = selftest_events(device=device, backend=backend)
    errors = validate_events(events)
    ingress = ingress_traces(events)
    repl_arrows = fanout_arrows(events)
    if not ingress:
        errors.append("selftest produced no sampled ingress spans")
    if not repl_arrows:
        errors.append("selftest produced no replication fan-out arrows")
    if errors:
        print("selftest FAILED:")
        for msg in errors:
            print(f"  {msg}")
        return 1
    print(
        f"selftest ok: {len(events)} events, {len(ingress)} sampled "
        f"traces origin->visible, {repl_arrows} replication arrows "
        f"resolved across 3 shards (backend={backend}, "
        f"device={device or 'cuda'})"
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_check_trace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("traces", nargs="*", help="Chrome-trace JSON files")
    ap.add_argument("--selftest", action="store_true",
                    help="build a replicated in-process port fleet and "
                         "validate its merged trace")
    ap.add_argument("--device", default=None,
                    help="the selftest fleet's device (default: the CUDA "
                         "device; 'cpu' runs the plain kernels)")
    ap.add_argument("--backend", default="auto",
                    help="the selftest fleet's backend (default 'auto': "
                         "rooms on the engine; 'cpu' keeps them on the "
                         "CPU core)")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest(device=args.device, backend=args.backend)
    if not args.traces:
        ap.error("either trace files or --selftest is required")
    rc = 0
    for path in args.traces:
        errors = check_file(path)
        if errors:
            rc = 1
            print(f"{path}: INVALID")
            for msg in errors:
                print(f"  {msg}")
        else:
            print(f"{path}: ok")
    return rc


if __name__ == "__main__":
    sys.exit(main())
