#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared against the reference and their
limits are the last lines of standard error.
"""
import sys
from pathlib import Path

# the checkout's root, not this folder, heads the import path: the
# harness's module names must not shadow the standard library's
sys.path[0] = str(Path(__file__).resolve().parents[1])

from gpubench.harness import main, process_start  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=process_start()))
