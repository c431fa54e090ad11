"""Exposition: Prometheus-style text dump and JSON snapshot.

Both accept any number of registries (the engine's own plus the
process-global one serving module-level consumers like the sync
protocol) and merge them into one view.  Histograms are rendered as
Prometheus summaries (quantile series + ``_count``/``_sum``) because the
log-bucketed storage maps to quantiles, not to fixed ``le`` rails.
"""

from __future__ import annotations


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in labels.items()
    )
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return repr(v)
    return str(v)


def prometheus_text(*registries) -> str:
    """Prometheus exposition-format text for every metric family."""
    lines: list[str] = []
    seen: set[str] = set()
    for reg in registries:
        for m in reg.collect():
            if m.name in seen:
                continue  # first registry wins on a name collision
            seen.add(m.name)
            help_text = m.help
            if m.unit:
                help_text = f"{help_text} [{m.unit}]" if help_text else f"[{m.unit}]"
            lines.append(f"# HELP {m.name} {help_text}")
            if m.kind == "histogram":
                lines.append(f"# TYPE {m.name} summary")
                for labels, series in m.samples():
                    s = series.summary()
                    for q, key in (("0.5", "p50"), ("0.95", "p95"),
                                   ("0.99", "p99")):
                        ql = dict(labels)
                        ql["quantile"] = q
                        lines.append(
                            f"{m.name}{_fmt_labels(ql)} {_fmt_value(s[key])}"
                        )
                    ls = _fmt_labels(labels)
                    lines.append(f"{m.name}_count{ls} {s['count']}")
                    lines.append(f"{m.name}_sum{ls} {_fmt_value(s['sum'])}")
                    lines.append(f"{m.name}_min{ls} {_fmt_value(s['min'])}")
                    lines.append(f"{m.name}_max{ls} {_fmt_value(s['max'])}")
            else:
                lines.append(f"# TYPE {m.name} {m.kind}")
                for labels, series in m.samples():
                    lines.append(
                        f"{m.name}{_fmt_labels(labels)} "
                        f"{_fmt_value(series.value)}"
                    )
    return "\n".join(lines) + ("\n" if lines else "")


def _labels_key(labels: dict) -> str:
    if not labels:
        return ""
    return ",".join(f"{k}={v}" for k, v in labels.items())


def registry_snapshot(*registries) -> dict:
    """JSON-able ``{counters, gauges, histograms}`` merged view.

    Each section maps ``name`` -> ``{labels_key: value_or_summary}``
    where ``labels_key`` is ``""`` for unlabeled series and
    ``"k=v,k2=v2"`` otherwise."""
    counters: dict = {}
    gauges: dict = {}
    histograms: dict = {}
    for reg in registries:
        for m in reg.collect():
            if m.kind == "counter":
                dst = counters
            elif m.kind == "gauge":
                dst = gauges
            else:
                dst = histograms
            if m.name in dst:
                continue
            series_map = {}
            for labels, series in m.samples():
                key = _labels_key(labels)
                if m.kind == "histogram":
                    series_map[key] = series.summary()
                else:
                    series_map[key] = series.value
            dst[m.name] = series_map
    return {"counters": counters, "gauges": gauges, "histograms": histograms}
