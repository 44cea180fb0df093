"""Run one cell of the port's benchmark once.

    python3 vilbench/run.py --workload kitti_vil.city --seed 7 --seconds 20 --trace 0

The cell, its configuration and traffic files, and its metrics are named
in BENCHMARK.json at the checkout's root. The last line of standard output
is the run's JSON result; the numbers that decide `correct` are the last
lines of standard error. See vilbench/harness.py.
"""
import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from vilbench import harness

    sys.exit(harness.main(sys.argv[1:], PROCESS_START, ROOT))
