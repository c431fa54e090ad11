"""``BENCHMARK.json``: read, check its names and units, and find a cell.

The harness finds everything by name: a cell's configuration file and
traffic mix, and each metric's reader (``metrics/<name before the first
dot>.py``).  A later change adds a cell, a mix or a metric as files of its
own plus entries here.
"""

from __future__ import annotations

import json
import os
import re

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")

_TOP = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
_CONFIG = {"name", "source", "file", "reduced", "why"}
_CELL = {"name", "config", "traffic", "chips", "why"}
_E2E = {"name", "unit", "better", "bound", "source"}
_LAYER = {"name", "unit", "better", "source", "layer", "moves"}


class ManifestError(ValueError):
    pass


def _line(s, what: str) -> None:
    if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s or "\t" in s:
        raise ManifestError(f"{what}: 1 to 200 characters on one line")


def _name(s, what: str) -> None:
    if not isinstance(s, str) or not NAME_RE.match(s):
        raise ManifestError(f"{what}: {s!r} is not a name")


def validate(m: dict) -> None:
    """Raise :class:`ManifestError` where the manifest breaks the rules on
    keys, names, units, sources and cross references."""
    if set(m) != _TOP:
        raise ManifestError(f"top-level keys {sorted(m)}")
    configs = {}
    for c in m["configs"]:
        if set(c) != _CONFIG:
            raise ManifestError(f"config keys {sorted(c)}")
        _name(c["name"], "config name")
        _line(c["source"], "config source")
        _line(c["why"], "config why")
        for k in c["reduced"]:
            _name(k, "reduced key")
        if c["name"] in configs:
            raise ManifestError(f"config {c['name']} twice")
        configs[c["name"]] = c
    cells = {}
    pairs = set()
    for w in m["workloads"]:
        if set(w) != _CELL:
            raise ManifestError(f"workload keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            _name(w[k], f"workload {k}")
        _line(w["why"], "workload why")
        if w["config"] not in configs:
            raise ManifestError(f"workload {w['name']}: no config {w['config']}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: chips {w['chips']}")
        pair = (w["config"], w["traffic"])
        if w["name"] in cells or pair in pairs:
            raise ManifestError(f"workload {w['name']} twice")
        cells[w["name"]] = w
        pairs.add(pair)
    names = set()
    for group, keys in (("end_to_end", _E2E), ("per_layer", _LAYER)):
        for x in m[group]:
            if not keys <= set(x) <= keys | {"workloads"}:
                raise ManifestError(f"{group} keys {sorted(x)}")
            _name(x["name"], f"{group} name")
            if x["name"] in names:
                raise ManifestError(f"metric {x['name']} twice")
            names.add(x["name"])
            if not isinstance(x["unit"], str) or not UNIT_RE.match(x["unit"]):
                raise ManifestError(f"{x['name']}: unit {x['unit']!r}")
            if x["better"] not in ("lower", "higher"):
                raise ManifestError(f"{x['name']}: better {x['better']!r}")
            if x["source"] not in SOURCES:
                raise ManifestError(f"{x['name']}: source {x['source']!r}")
            for w in x.get("workloads", ()):
                if w not in cells:
                    raise ManifestError(f"{x['name']}: no workload {w}")
    for x in m["end_to_end"]:
        if x["source"] not in ("host_clock", "device_trace"):
            raise ManifestError(f"{x['name']}: end-to-end source")
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        _line(x["layer"], f"{x['name']} layer")
        if x["moves"] not in e2e:
            raise ManifestError(f"{x['name']}: moves {x['moves']!r}")


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    validate(m)
    return m


def cell(m: dict, name: str) -> tuple[dict, dict]:
    """The workload entry called ``name`` and its configuration entry."""
    for w in m["workloads"]:
        if w["name"] == name:
            return w, next(c for c in m["configs"] if c["name"] == w["config"])
    raise ManifestError(f"no workload {name!r}")


def metrics_for(m: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer metrics with it on."""
    group = m["per_layer"] if trace else m["end_to_end"]
    return [x for x in group if workload in x.get("workloads", (workload,))]
