#!/usr/bin/env python3
"""Run one cell of the benchmark of ``metrics_tpu_torch`` and print its result.

From the root of a checkout, on a machine with the cards the cell asks for::

    python3 portbench/run.py --workload keyed_tenants.cohorts --seed 7 --seconds 10 --trace 0

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs the
same window with the program's telemetry and the benchmark's spans on, a
profiler over a short steady part of it, and prints the per-layer metrics.
The run re-executes itself once with ``PYTHONHASHSEED=0``. The last line of
standard output is one JSON object; the numbers that
decided ``correct`` are the last lines of standard error. Without CUDA, or
with fewer cards than the cell asks for, the run prints no result and exits
with 2.
"""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    # one string hash for every run, so that the layout of the program's dicts
    # and sets, and with it the host's dispatch time, does not change from
    # process to process; the set-up time still counts from this process's start
    os.execve(sys.executable, [sys.executable] + sys.argv,
              dict(os.environ, PYTHONHASHSEED="0", PORTBENCH_T_START=repr(T_START)))
T_START = float(os.environ.get("PORTBENCH_T_START", T_START))

import argparse  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    common.set_cache_dirs()
    try:
        cell = common.find_cell(args.workload)
        common.require_cards(cell.chips)
        record = cell.driver().run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                                   t_start=T_START, device="cuda")
    except common.BenchmarkError as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    return common.emit(record, bool(args.trace), record.extras.get("breakdown"))


if __name__ == "__main__":
    sys.exit(main())
