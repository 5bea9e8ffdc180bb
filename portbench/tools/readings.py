"""The two readings behind each limit of a cell, from the outputs that
`calibrate_all.sh`, `sets.sh` and `traced.sh` wrote: the lower, the
largest reading of the program's sound runs over every seed; the upper,
the smallest reading of the control and of each planted fault.

    python3 portbench/tools/readings.py portbench_out <workload>
"""
import glob
import json
import os
import sys


def main(root: str, workload: str) -> None:
    sound, other = {}, {}
    cal = os.path.join(root, "cal", workload + ".jsonl")
    for line in open(cal) if os.path.exists(cal) else []:
        d = json.loads(line)
        if "kind" not in d:
            continue
        into = sound if d["kind"] == "sound" else other.setdefault(
            d["kind"], {})
        into[("cal", str(d["seed"]))] = d["numbers"]
    for path in glob.glob(os.path.join(root, "sets", workload, "[ab].*.out")
                          ) + glob.glob(os.path.join(root, "traced",
                                                     workload, "*.out")):
        lines = open(path).read().strip().splitlines()
        if lines:
            d = json.loads(lines[-1])
            seed = os.path.basename(path).split(".")[-2]
            sound[(os.path.basename(os.path.dirname(path)), seed)] = {
                k: v["value"] for k, v in d["checks"].items()}
    seeds = sorted({s for _, s in sound})
    print(f"{workload}: {len(sound)} sound runs on {len(seeds)} seeds")
    names = sorted({k for nums in sound.values() for k in nums})
    for k in names:
        vals = [nums[k] for nums in sound.values() if k in nums]
        uppers = {kind: min(n[k] for n in runs.values())
                  for kind, runs in other.items()}
        print(f"  {k}: lower {max(vals)!r} upper {uppers}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
