"""Run one cell of the benchmark once and print its result line.

    python3 roombench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; see ``harness.py`` for what a run does.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from roombench.harness import main

    sys.exit(main(sys.argv[1:], T0))
