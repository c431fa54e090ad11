"""Metric readers, one module a metric, found by the part of the metric's
name before its first dot: ``ingest_us.typing`` is read by
``ingest_us.py``.  Each has ``read(rec, name)``, which takes the run's
record (see ``harness.window``) and returns the number, or None where the
run holds nothing for it to read; the harness then leaves the metric out.
"""

from __future__ import annotations

import importlib


def read(name: str, rec: dict):
    mod = importlib.import_module(f"{__name__}.{name.split('.', 1)[0]}")
    return mod.read(rec, name)
