"""Runs one cell of the benchmark of quadswarm_tpu_torch once, on the card of
this machine, and prints its result as the last line of standard output.

    python3 portbench/run.py --workload rollout.swarm128 --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout.  --trace 1 prints the cell's per-layer metrics
(one more call under the profiler) in place of its end-to-end ones.  The
numbers compared with the reference, each beside its limit, end standard
error and the result line.  Without a CUDA card, or with fewer cards than
the cell asks for, it exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args()

    # every build and kernel cache at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    # one host thread for the CPU's own kernels: the program's host work is
    # its dispatch, and idle worker threads only contend with it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)

    import torch
    torch.set_num_threads(1)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = {w["name"]: w for w in bench["workloads"]}.get(a.workload)
    if entry is None:
        print(f"no workload {a.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        print(f"{a.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2

    from portbench.harness import forbidden_modules, power_limit, run_cell
    print(f"card: {power_limit()}", file=sys.stderr)
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                   device="cuda", t_start=T_START, bench=bench)
    found = forbidden_modules()
    if found:
        print(f"modules that the benchmark may not load were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
