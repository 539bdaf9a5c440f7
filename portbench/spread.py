#!/usr/bin/env python3
"""The spread of a set of runs, as the bounds of ``BENCHMARK.json`` are set
from it.

    python3 portbench/spread.py chiprun_out/set1_*.out -- chiprun_out/set2_*.out

Each file holds one run's standard output; its last line is the result. For
each set (files before and after ``--``) and each metric: the median and the
spread, the distance between the first and the third quartile as Python's
``statistics.quantiles(values, n=4)`` gives them, as a share of the median;
then the wider of the two sets' spreads and five times it, the bound it
suggests (never under 1%).
"""
import json
import statistics
import sys


def results(paths):
    out = []
    for path in paths:
        with open(path) as f:
            lines = [line for line in f.read().splitlines() if line.strip()]
        out.append(json.loads(lines[-1]))
    return out


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return med, (q3 - q1) / abs(med)


def main(argv):
    sets = [[]]
    for arg in argv:
        if arg == "--":
            sets.append([])
        else:
            sets[-1].append(arg)
    widest = {}
    for i, paths in enumerate(s for s in sets if s):
        runs = results(paths)
        names = sorted({k for r in runs for k in r["metrics"]})
        for name in names:
            values = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
            med, share = spread(values)
            widest[name] = max(widest.get(name, 0.0), share)
            print(f"set {i + 1} {name}: n {len(values)} median {med!r} spread {share:.4%} "
                  f"(values {', '.join(repr(v) for v in values)})")
    for name, share in widest.items():
        print(f"{name}: widest spread {share:.4%}, five times {max(0.01, 5 * share):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
