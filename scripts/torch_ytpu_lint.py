#!/usr/bin/env python
"""ytpu-lint of the PyTorch port — the same static analysis, run by the
port's own copy of it.

Runs the :mod:`yjs_tpu_torch.analysis` checker suite (donation-aliasing,
retrace-hazard, lock-discipline/-ordering, seam-completeness, knob/
metric drift) over ``yjs_tpu_torch/``, ``chip_smoke.py`` and the port's
scripts (``scripts/torch_*.py``) and reports findings not covered by an
inline ``# ytpu-lint: disable…`` suppression or the port's committed
baseline (``.ytpu-lint-torch-baseline.json``; every entry says why in
its ``note``).  It imports nothing of torch: the checkers parse, they
never import.

    python scripts/torch_ytpu_lint.py              # human-readable report
    python scripts/torch_ytpu_lint.py --ci         # exit 1 on any finding
    python scripts/torch_ytpu_lint.py --json       # machine-readable dump
    python scripts/torch_ytpu_lint.py --list-rules # rule id -> severity
    python scripts/torch_ytpu_lint.py --write-baseline  # grandfather current

Exit codes: 0 clean (or findings in non-CI mode with only advice), 1
findings/stale baseline entries present, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from yjs_tpu_torch.analysis import (  # noqa: E402
    Baseline,
    all_rules,
    render_report,
    run_lint,
)

DEFAULT_BASELINE = ROOT / ".ytpu-lint-torch-baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_ytpu_lint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "targets",
        nargs="*",
        help="files/dirs to lint (default: yjs_tpu_torch/ chip_smoke.py "
        "scripts/torch_*.py)",
    )
    ap.add_argument(
        "--ci",
        action="store_true",
        help="gate mode: nonzero exit on any unsuppressed finding",
    )
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument(
        "--verbose",
        "-v",
        action="store_true",
        help="also list suppressed + baselined findings",
    )
    ap.add_argument(
        "--baseline",
        default=str(DEFAULT_BASELINE),
        help="baseline file (default: .ytpu-lint-torch-baseline.json)",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore the baseline (report grandfathered findings too)",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="rewrite the baseline to cover every current finding",
    )
    ap.add_argument(
        "--list-rules",
        action="store_true",
        help="print every rule id with its severity and exit",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, sev in sorted(all_rules().items()):
            print(f"{rule:24s} {sev}")
        return 0

    baseline = (
        Baseline([])
        if args.no_baseline or args.write_baseline
        else Baseline.load(args.baseline)
    )
    targets = [Path(t) for t in args.targets] if args.targets else None
    result = run_lint(ROOT, targets=targets, baseline=baseline)

    if args.write_baseline:
        entries = [
            Baseline.entry_for(f, note="grandfathered by --write-baseline")
            for f in result.findings
            if f.rule
            not in ("useless-suppression", "bare-suppression")
        ]
        Baseline(entries).save(args.baseline)
        print(
            f"wrote {len(entries)} entr"
            f"{'y' if len(entries) == 1 else 'ies'} to {args.baseline}"
        )
        return 0

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [f.as_dict() for f in result.findings],
                    "suppressed": [
                        f.as_dict() for f in result.suppressed
                    ],
                    "baselined": [f.as_dict() for f in result.baselined],
                    "stale_baseline": result.stale_baseline,
                },
                indent=1,
            )
        )
    else:
        print(render_report(result, verbose=args.verbose))

    if result.failed:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
