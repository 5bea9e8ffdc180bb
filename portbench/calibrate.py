"""Readings that the limits of a cell's compared numbers are set from: in
one process on the card, the program's sound runs on many seeds, the
control (the program in the precision below the configuration's: TF32
products and a bfloat16 env) and each planted fault (`faults.py`) on a few,
each at the cell's own size.

    python3 portbench/calibrate.py --workload rollout.swarm128 --seeds 12 \
        --control 3 --faults env_unchanged,env_altered --fault_seeds 3

Prints one JSON line a run, then for each number the largest sound reading
and the smallest reading of the control and of each fault.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--fault_seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first_seed", type=int, default=3_000_000_000)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--overrides", default="",
                   help="flags appended to the configuration's, "
                        "space-separated (a small size off the card)")
    a = p.parse_args()
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(
        ROOT, ".portbench_cache", "torch_extensions"))
    sys.path.insert(0, ROOT)
    from portbench.faults import FAULTS
    from portbench.harness import run_cell

    plan = [("sound", s, None) for s in range(a.seeds)]
    plan += [("control", s, None) for s in range(a.control)]
    for f in filter(None, a.faults.split(",")):
        plan += [(f, s, f) for s in range(a.fault_seeds)]
    readings = {}
    overrides = a.overrides.split()
    for kind, i, fault in plan:
        seed = a.first_seed + 7919 * i
        t0 = time.perf_counter()
        if fault:
            with FAULTS[fault]():
                out = run_cell(a.workload, seed, a.seconds, bool(a.trace),
                               overrides=overrides)
        else:
            out = run_cell(a.workload, seed, a.seconds, bool(a.trace),
                           overrides=overrides, control=kind == "control")
        nums = out["details"]["numbers"]
        print(json.dumps({"kind": kind, "seed": seed,
                          "correct": out["correct"], "numbers": nums,
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "memory_peak_bytes":
                              out["device"]["memory_peak_bytes"],
                          "details": {k: v for k, v in out["details"].items()
                                      if k != "numbers"},
                          "seconds": time.perf_counter() - t0}), flush=True)
        for k, v in nums.items():
            readings.setdefault(kind, {}).setdefault(k, []).append(v)
    summary = {"sound_max": {k: max(v) for k, v in
                             readings.get("sound", {}).items()}}
    for kind, nums in readings.items():
        if kind != "sound":
            summary[kind + "_min"] = {k: min(v) for k, v in nums.items()}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
