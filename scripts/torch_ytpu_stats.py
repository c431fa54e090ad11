#!/usr/bin/env python
"""ytpu_stats on the PyTorch port: human-readable view of observability
snapshots.

The port's copy of ``scripts/ytpu_stats.py``: the same modes and
rendering (given the same snapshot the two scripts print the same text),
over the port's ``obs.federate``; ``--demo`` drives port providers, on
the CUDA device unless ``--device cpu`` is given (no card is then an
error).  The file, ``--merge`` and ``--url`` modes only read snapshots
and touch no device.

Modes:

    python scripts/torch_ytpu_stats.py <snapshot.json>
        Pretty-print a metrics snapshot written by
        ``engine.metrics_snapshot()`` / ``provider.metrics_snapshot()``
        (e.g. bench.py's BENCH_obs_metrics.json artifact).

    python scripts/torch_ytpu_stats.py --merge shard0.json shard1.json ...
    python scripts/torch_ytpu_stats.py --merge /path/to/snapshot-dir/
        Federate several per-shard snapshots (``yjs_tpu_torch.obs.federate``:
        counters sum, gauges keep per-shard series plus an aggregate,
        histograms merge) and render the fleet view.

    python scripts/torch_ytpu_stats.py --url http://127.0.0.1:9464 [--url ...]
        Scrape a live process's admin-plane ``/metrics.json`` and render
        it; several ``--url`` flags federate first.

    python scripts/torch_ytpu_stats.py --demo [--prom|--json]
        Exercise a tiny in-process provider (a few rooms, a sync
        handshake, one undo, a WAL append, one dead letter) and dump its
        metrics: the rendered view by default, raw Prometheus text with
        --prom, the JSON snapshot with --json.  The zero-to-metrics
        smoke test for the obs subsystem.

``--watch SECONDS`` re-reads and re-renders the snapshot file (or
re-runs the demo workload) at that interval until interrupted.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# rendered section -> metric-name prefixes it collects; names matching
# no group land in "other" (a new family renders without a code change)
GROUPS = (
    # "flush" must precede "engine": first prefix match wins and the
    # flush pipeline families share the ytpu_flush_ stem
    ("flush", ("ytpu_flush_",)),
    ("engine", ("ytpu_engine_",)),
    ("native planner", ("ytpu_native_",)),
    ("planner", ("ytpu_plan_",)),
    ("provider", ("ytpu_provider_",)),
    ("sync", ("ytpu_sync_",)),
    ("network (sessions)", ("ytpu_net_",)),
    ("resilience", ("ytpu_resilience_", "ytpu_doc_", "ytpu_dead_letter",
                    "ytpu_dlq_", "ytpu_chaos_")),
    ("durability (WAL)", ("ytpu_wal_",)),
    ("cost attribution (prof)", ("ytpu_prof_",)),
    ("convergence SLO", ("ytpu_convergence_", "ytpu_slo_")),
    ("tiering", ("ytpu_tier_",)),
    ("replication", ("ytpu_repl_", "ytpu_failover_")),
    ("admission", ("ytpu_adm_",)),
    ("admin plane", ("ytpu_admin_",)),
    ("tracing", ("ytpu_trace_",)),
    ("blackbox", ("ytpu_blackbox_",)),
    ("federation", ("ytpu_fed_",)),
)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _group_of(name: str) -> str:
    for title, prefixes in GROUPS:
        if name.startswith(prefixes):
            return title
    return "other"


def render_snapshot(snap: dict) -> str:
    """Per-subsystem sections, each mixing that subsystem's counters,
    gauges, and histogram summaries (one reading order per failure
    domain instead of one per metric kind)."""
    by_group: dict[str, list[tuple[str, str]]] = {}

    def add(name, labels_key, val):
        label = f"{name}{{{labels_key}}}" if labels_key else name
        by_group.setdefault(_group_of(name), []).append((label, val))

    for name in sorted(snap.get("counters", {})):
        for labels_key, v in sorted(snap["counters"][name].items()):
            add(name, labels_key, _fmt(v))
    for name in sorted(snap.get("gauges", {})):
        for labels_key, v in sorted(snap["gauges"][name].items()):
            add(name, labels_key, _fmt(v))
    for name in sorted(snap.get("histograms", {})):
        for labels_key, s in sorted(snap["histograms"][name].items()):
            add(
                name, labels_key,
                f"n={s['count']} p50={_fmt(s['p50'])} p95={_fmt(s['p95'])} "
                f"p99={_fmt(s['p99'])} max={_fmt(s['max'])}",
            )

    lines: list[str] = []

    def section(title, rows):
        if not rows:
            return
        lines.append(title)
        w = max(len(r[0]) for r in rows)
        for name, val in rows:
            lines.append(f"  {name:<{w}}  {val}")
        lines.append("")

    for title, _ in GROUPS:
        section(title, by_group.get(title, []))
    section("other", by_group.get("other", []))

    fed = snap.get("federation")
    if fed:
        roles = fed.get("roles") or {}
        section(
            "federation",
            [
                ("sources", _fmt(fed.get("sources", 0))),
                ("roles",
                 ", ".join(f"{k}={v or '-'}"
                           for k, v in sorted(roles.items())) or "-"),
            ],
        )
    slo = snap.get("slo")
    if slo:
        section(
            "slo verdict",
            [
                ("state", slo.get("state", "?")),
                ("target_ms", _fmt(slo.get("target_ms", 0))),
                ("burn short/long",
                 f"{_fmt(slo.get('burn_rates', {}).get('short', 0))} / "
                 f"{_fmt(slo.get('burn_rates', {}).get('long', 0))}"),
                ("completed", _fmt(slo.get("completed", 0))),
                ("pending", _fmt(slo.get("pending", 0))),
            ],
        )
    flush = snap.get("flush")
    if flush:
        section(
            f"last flush (1 of {snap.get('n_flushes_recorded', '?')} "
            f"recorded, {len(snap.get('flush_history', []))} in ring)",
            [(k, _fmt(flush[k])) for k in sorted(flush)],
        )
    return "\n".join(lines).rstrip() + "\n"


def demo_snapshot(device: str | None = None):
    """A tiny provider workload touching every instrumented seam:
    flushes, a sync handshake, an undo, WAL appends, and one damaged
    frame routed to the dead-letter queue — so the durability and
    resilience sections render non-empty."""
    import tempfile

    from yjs_tpu_torch import Doc
    from yjs_tpu_torch.provider import TpuProvider
    from yjs_tpu_torch.updates import encode_state_as_update

    prov = TpuProvider(
        4, wal_dir=tempfile.mkdtemp(prefix="ytpu-stats-"), device=device
    )
    for k in range(3):
        d = Doc(gc=False)
        d.get_text("text").insert(0, f"room {k} says hello")
        prov.receive_update(f"room{k}", encode_state_as_update(d))
    prov.flush()
    prov.handle_sync_message("room0", prov.sync_step1("room0"))
    # a transport-damaged frame: counted + dead-lettered, room survives
    prov.handle_sync_message("room2", b"\x02\xff\xff\xff")
    prov.enable_undo("room1")
    d = Doc(gc=False)
    d.get_text("text").insert(0, "undo me. ")
    prov.receive_update("room1", encode_state_as_update(d), undoable=True)
    prov.flush()
    prov.undo("room1")
    # one peer session over an in-memory pipe so the network section
    # renders live counters (handshake + a delivered update)
    from yjs_tpu_torch.sync import PipeNetwork

    peer = TpuProvider(1, device=device)
    net = PipeNetwork()
    t1, t2 = net.pair()
    prov.session("room0", "demo-peer").connect(t1)
    peer.session("room0", "demo-host").connect(t2)
    net.settle((prov.tick_sessions, peer.tick_sessions))
    return prov


def _watch(render_once, interval: float, iterations: int | None = None,
           out=None) -> None:
    """Re-render every ``interval`` seconds (forever when ``iterations``
    is None; bounded for tests).  Each frame is separated by a ruled
    timestamp line rather than a screen clear, so output pipes well."""
    out = out or sys.stdout
    n = 0
    while iterations is None or n < iterations:
        if n:
            time.sleep(interval)
        stamp = time.strftime("%H:%M:%S")
        out.write(f"--- {stamp} ---\n")
        out.write(render_once())
        out.flush()
        n += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ytpu_stats", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("snapshot", nargs="*",
                    help="metrics snapshot JSON file(s); with --merge, "
                         "several per-shard files or one directory")
    ap.add_argument("--merge", action="store_true",
                    help="federate several per-shard snapshot files (or "
                         "a directory of them) into one labeled view "
                         "before rendering")
    ap.add_argument("--demo", action="store_true",
                    help="run a tiny provider workload instead of reading a file")
    ap.add_argument("--device", default=None,
                    help="with --demo: 'cpu' runs the kernels' plain "
                         "versions; by default the CUDA device, and no "
                         "card is an error")
    ap.add_argument("--url", action="append", default=[],
                    metavar="URL",
                    help="scrape a live admin endpoint's /metrics.json "
                         "instead of reading a file (repeatable; "
                         "several URLs federate)")
    ap.add_argument("--scrape-timeout", type=float, default=2.0,
                    help="per-endpoint HTTP deadline for --url "
                         "(default 2s)")
    ap.add_argument("--prom", action="store_true",
                    help="with --demo: print Prometheus text instead")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="with --demo: print the raw JSON snapshot instead")
    ap.add_argument("--watch", type=float, metavar="SECONDS", default=None,
                    help="re-render at this interval until interrupted")
    args = ap.parse_args(argv)

    if args.demo:
        if args.watch is not None:
            _watch(
                lambda: render_snapshot(
                    demo_snapshot(args.device).metrics_snapshot()
                ),
                args.watch,
            )
            return 0
        prov = demo_snapshot(args.device)
        if args.prom:
            sys.stdout.write(prov.metrics_text())
        elif args.as_json:
            json.dump(prov.metrics_snapshot(), sys.stdout, indent=2)
            sys.stdout.write("\n")
        else:
            sys.stdout.write(render_snapshot(prov.metrics_snapshot()))
        return 0
    if args.url:
        if args.snapshot:
            ap.error("--url and snapshot files are mutually exclusive")
        from yjs_tpu_torch.obs.federate import (
            federate_snapshots,
            scrape_endpoints,
        )

        def render_url():
            sources = scrape_endpoints(
                args.url, timeout_s=args.scrape_timeout
            )
            if len(sources) == 1:
                return render_snapshot(sources[0]["snapshot"] or {})
            return render_snapshot(federate_snapshots(sources))

        if args.watch is not None:
            _watch(render_url, args.watch)
            return 0
        sys.stdout.write(render_url())
        return 0
    if not args.snapshot:
        ap.error("either a snapshot file, --url, or --demo is required")

    if args.merge:
        from yjs_tpu_torch.obs.federate import (
            federate_snapshots,
            read_snapshot_dir,
        )

        def render_file():
            paths = args.snapshot
            if len(paths) == 1 and Path(paths[0]).is_dir():
                sources = read_snapshot_dir(paths[0])
            else:
                sources = []
                for p in paths:
                    try:
                        with open(p) as f:
                            snap = json.load(f)
                    except (OSError, ValueError):
                        snap = {}
                    if not isinstance(snap, dict):
                        snap = {}
                    sources.append({
                        "label": Path(p).stem,
                        "role": str(snap.get("role", "") or ""),
                        "snapshot": snap,
                    })
            return render_snapshot(federate_snapshots(sources))
    elif len(args.snapshot) > 1:
        ap.error("multiple snapshot files require --merge")
    else:

        def render_file():
            with open(args.snapshot[0]) as f:
                return render_snapshot(json.load(f))

    if args.watch is not None:
        _watch(render_file, args.watch)
        return 0
    sys.stdout.write(render_file())
    return 0


if __name__ == "__main__":
    sys.exit(main())
