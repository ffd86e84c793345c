#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout; see benchmark/harness.py.
"""

import time

T0 = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, not this directory, heads the import path: the
# benchmark is the package `benchmark`, beside the program it measures.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
