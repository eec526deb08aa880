"""The spread of a cell's end-to-end metrics over sets of runs, as its
bounds are set from: per set, the distance between the first and the
third quartile (``statistics.quantiles(values, n=4)``) as a share of the
median.  Not run by ``run.py``.

    python3 portbench/spread.py SET_A_LINES SET_B_LINES ...

Each argument is a file (or several, comma-separated) holding result
lines, the last line of each run's standard output.
"""

import json
import statistics
import sys


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def lines(arg):
    out = []
    for path in arg.split(","):
        with open(path) as f:
            out += [json.loads(x) for x in f if x.startswith("{")]
    return out


def main(argv):
    for i, arg in enumerate(argv):
        runs = lines(arg)
        names = sorted({k for r in runs for k in r["metrics"]})
        for name in names:
            v = [r["metrics"][name]["value"] for r in runs
                 if name in r["metrics"]]
            print(f"set {i} {name}: n={len(v)} median={statistics.median(v)}"
                  f" spread={spread(v) if len(v) > 1 else float('nan')}"
                  f" correct={sum(r['correct'] for r in runs)}/{len(runs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
