#!/usr/bin/env python
"""Diff the PyTorch port's LIVE registered metric names against README's
documented list.

The port's copy of ``scripts/check_metrics_schema.py``: a thin shim over
:func:`yjs_tpu_torch.analysis.drift.live_comparison`.  It builds a port
provider and the smallest port fleet, reads the metric families they
register, and fails when they and the README Observability table
disagree, or when a curated-prefix env knob the port's code mentions
(``yjs_tpu_torch/``) and the README's knobs differ.  The pure-AST half
of the drift check is ``scripts/torch_ytpu_lint.py`` (rules
``knob-drift`` / ``metric-drift``).

    python scripts/torch_check_metrics_schema.py
    python scripts/torch_check_metrics_schema.py --device cpu

``--device`` places the provider and fleet it builds: the CUDA device by
default (no card is then an error), ``cpu`` for the kernels' plain
PyTorch versions.  Exits 1 on any problem.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from yjs_tpu_torch.analysis.drift import (  # noqa: E402
    curated_knobs_in_code,
    documented_metrics,
    live_comparison,
    live_metric_names,
)


def documented_names(readme_text: str) -> set[str]:
    """Backticked ytpu_* names from the Observability metric table."""
    return documented_metrics(readme_text)


def registered_names(device=None) -> set[str]:
    """The families one port provider and fleet on ``device`` register,
    with every lazily-registered process-global family touched."""
    return live_metric_names(device)


def resilience_knobs_in_code() -> set[str]:
    """Curated-prefix env names the port's package actually mentions."""
    return curated_knobs_in_code(ROOT / "yjs_tpu_torch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_check_metrics_schema", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--device", default=None,
                    help="the device of the provider and fleet it builds "
                         "(default: the CUDA device; 'cpu' runs the "
                         "plain kernels)")
    args = ap.parse_args(argv)
    problems = live_comparison(ROOT, device=args.device)
    for p in problems:
        print(p)
    if problems:
        return 1
    print("ok: live metric families and env knobs agree with README")
    return 0


if __name__ == "__main__":
    sys.exit(main())
