"""Medians and spreads of the runs `sets.sh` wrote: for each set (a, b)
and metric, the median and the distance between the first and third
quartiles (`statistics.quantiles(values, n=4)`) as a share of the median;
and every run's `correct` and compared numbers.

    python3 portbench/tools/spread.py portbench_out/sets/<workload>
"""
import glob
import json
import os
import statistics
import sys


def main(folder: str) -> None:
    sets = {}
    for path in sorted(glob.glob(os.path.join(folder, "[ab].*.out"))):
        name = os.path.basename(path)
        lines = open(path).read().strip().splitlines()
        if not lines:
            print(name, "no result")
            continue
        d = json.loads(lines[-1])
        sets.setdefault(name[0], []).append(d)
        print(name, d["correct"], d["attempted"],
              {k: v["value"] for k, v in d["metrics"].items()},
              {k: v["value"] for k, v in d["checks"].items()})
    for s, runs in sorted(sets.items()):
        for m in runs[0]["metrics"]:
            vals = [r["metrics"][m]["value"] for r in runs]
            med = statistics.median(vals)
            q = statistics.quantiles(vals, n=4)
            print(f"set {s} {m}: median {med!r} spread "
                  f"{(q[2] - q[0]) / med!r} n {len(vals)} "
                  f"min {min(vals)!r} max {max(vals)!r}")


if __name__ == "__main__":
    main(sys.argv[1])
