"""How long after its launch each device operation starts, in profiles of
the device alone of the port's `collect_rollout`: how far the profiler's
device times sit off the host's clock, which the spans share.  Because of
what it reads, the card test of `tests/test_torch_tracing.py` checks
launches on the host's clock and compares no device time with the host's.

    python3 portbench/tools/launch_lag.py --workload rollout.swarm128 \\
        --seed 7 --profiles 40 [--full] [--no-spans]

From the root of a checkout, on the card.  It builds the cell's program at
the CPU tests' small size (`portbench/tests/small.py`), or at the cell's
own size with `--full`, runs one call to build the kernels, then
`--profiles` calls, each under its own profile of the device alone (as
`trace.traced` takes one), and prints one JSON line a profile.  With
`--no-spans` the program's spans stay off, so that the profile is taken as
on a commit without them:
- `ops`, and `matched`: those with a CUDA API call of their correlation id
  (`tracing.launch_times`);
- `min_lag_us`: the least time from an operation's launch to its start;
- `early`: each operation that starts before its launch, with the
  innermost span open at its launch, its place among the profile's device
  operations, the previous operation on its stream, every host event of
  its correlation id, and the least lag of the 20 matched operations on
  either side of it;
- `stream_order`: on each stream, operations that start before the one
  before them ends (`overlaps`) and correlation ids out of launch order
  (`inversions`): a stream runs its work one operation after another, in
  the order it was launched;
- `idle_lag_us`: the lags of the operations that start on an idle device
  (20 µs or more after the previous one ended), summed up by
  `idle_summary`: a drift of the device's clock against the host's shows
  as a slope, or as first and last tenths apart;
- `span_lead_us`: the least, over spans, of the first CUDA API call inside
  a span less the span's host start (`time.time_ns` against the
  profiler's clock).
The last line sums the profiles up.  The harness does not read this tool.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
IDLE_NS = 20_000


def idle_summary(idle: list) -> dict | None:
    """The lags (µs) of operations that start on an idle device, against
    ms into the profile: count, least, median, most, the medians of the
    first and last tenth, and the least-squares slope in µs a second."""
    if len(idle) < 2:
        return None
    t = [a for a, _ in idle]
    g = sorted(b for _, b in idle)
    tenth = max(1, len(idle) // 10)

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    mt, mg = sum(t) / len(t), sum(b for _, b in idle) / len(idle)
    var = sum((a - mt) ** 2 for a in t)
    slope = (sum((a - mt) * (b - mg) for a, b in idle) / var * 1e3
             if var else None)
    return {"n": len(idle), "min": g[0], "median": g[len(g) // 2],
            "max": g[-1],
            "first_tenth": median([b for _, b in idle[:tenth]]),
            "last_tenth": median([b for _, b in idle[-tenth:]]),
            "slope_us_per_s": slope}


def read_profile(events: list, spans: list) -> dict:
    """One profile's launch lags, from `kineto_results.events()` and the
    spans of the profiled call."""
    import torch

    from quadswarm_tpu_torch.utils import tracing
    cuda = torch.autograd.DeviceType.CUDA
    device = sorted((e for e in events if e.device_type() == cuda),
                    key=lambda e: e.start_ns())
    host = [e for e in events if e.device_type() != cuda]
    launch = tracing.launch_times(events)
    by_corr = {}
    for e in host:
        by_corr.setdefault(e.correlation_id(), []).append(e)
    t_zero = min(e.start_ns() for e in events)
    span_at = tracing.span_at(spans)

    lags, early, idle = [], [], []
    previous, last_end = {}, None
    overlaps = inversions = 0
    for k, e in enumerate(device):
        stream = (e.device_index(), e.device_resource_id())
        before = previous.get(stream)
        if before is not None:
            overlaps += e.start_ns() < before.end_ns()
            inversions += e.correlation_id() < before.correlation_id()
        previous[stream] = e
        at = launch.get(e.correlation_id())
        if at is not None:
            lag = e.start_ns() - at
            lags.append(lag)
            if last_end is not None and e.start_ns() - last_end >= IDLE_NS:
                idle.append(((e.start_ns() - t_zero) * 1e-6, lag * 1e-3))
            if lag < 0:
                s = span_at(at)
                early.append({
                    "name": e.name()[:80], "corr": e.correlation_id(),
                    "lag_us": lag * 1e-3, "index": k, "of": len(device),
                    "ms_into_profile": (e.start_ns() - t_zero) * 1e-6,
                    "span": s.name if s else None,
                    "lead_over_span_us": (None if s is None else
                                          (s.host_start_ns - e.start_ns())
                                          * 1e-3),
                    "previous_on_stream": None if before is None else {
                        "name": before.name()[:80],
                        "corr": before.correlation_id(),
                        "end_minus_start_us":
                            (before.end_ns() - e.start_ns()) * 1e-3},
                    "host_events": [
                        {"name": h.name()[:60], "start_minus_op_us":
                         (h.start_ns() - e.start_ns()) * 1e-3}
                        for h in by_corr.get(e.correlation_id(), [])],
                    "at": len(lags) - 1,
                })
        last_end = e.end_ns() if last_end is None else max(last_end,
                                                           e.end_ns())
    # the least lag of the 20 matched operations on either side of each
    # early one: a step of the device's clock shifts its neighbours too
    for x in early:
        at = x.pop("at")
        x["min_lag_before_us"] = min(lags[max(0, at - 20):at],
                                     default=0) * 1e-3
        x["min_lag_after_us"] = min(lags[at + 1:at + 21], default=0) * 1e-3
    calls = sorted(launch.values())
    leads = []
    for s in spans:
        i = bisect.bisect_left(calls, s.host_start_ns)
        first = calls[i] if i < len(calls) else None
        if first is not None and first <= s.host_end_ns:
            leads.append((first - s.host_start_ns) * 1e-3)
    return {"ops": len(device), "matched": len(lags),
            "min_lag_us": min(lags) * 1e-3 if lags else None,
            "early": early,
            "stream_order": {"overlaps": overlaps, "inversions": inversions},
            "idle_lag_us": idle_summary(idle),
            "span_lead_us": min(leads) if leads else None}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--profiles", type=int, default=40)
    p.add_argument("--full", action="store_true")
    p.add_argument("--no-spans", action="store_true",
                   help="keep the spans off under the profiler, as on a "
                   "commit without them")
    a = p.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "portbench", "tests"))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from portbench import program
    from portbench.harness import Cell, power_limit
    from quadswarm_tpu_torch.env.multi import env_reset
    from quadswarm_tpu_torch.env.replay import init_replay_state
    from quadswarm_tpu_torch.parallel.ppo import collect_rollout
    from quadswarm_tpu_torch.utils import tracing
    from small import SMALL

    if a.no_spans:
        tracing._profiling = lambda: False
    cell = Cell(a.workload)
    args = program.program_args(cell, [] if a.full else SMALL[a.workload],
                                "cuda", False)
    b = program.Built(args, "cuda")
    model = b.new_model()
    model.load_state_dict(b.weights(a.seed))
    gen = torch.Generator("cuda").manual_seed(a.seed)
    states, obs = env_reset(b.env_cfg, b.dyn, gen, args.num_envs,
                            device="cuda")
    replay = init_replay_state(states)

    def call():
        nonlocal states, obs, replay
        states, obs, replay, *_ = collect_rollout(
            b.env_cfg, b.dyn, model, b.ppo, states, obs, gen, b.rew_coeff,
            replay)

    call()
    torch.cuda.synchronize()
    total = {"profiles": a.profiles, "with_early": 0, "early": 0,
             "min_lag_us": None, "min_lag_us_by_profile": [],
             "overlaps": 0, "inversions": 0,
             "min_span_lead_us": None, "card": power_limit(),
             "full": a.full, "spans": not a.no_spans}
    for k in range(a.profiles):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        out = read_profile(list(prof.profiler.kineto_results.events()),
                           tracing.spans())
        out["profile"] = k
        print(json.dumps(out))
        total["min_lag_us_by_profile"].append(out["min_lag_us"])
        total["with_early"] += bool(out["early"])
        total["early"] += len(out["early"])
        total["overlaps"] += out["stream_order"]["overlaps"]
        total["inversions"] += out["stream_order"]["inversions"]
        for key, got in (("min_lag_us", out["min_lag_us"]),
                         ("min_span_lead_us", out["span_lead_us"])):
            if got is not None:
                total[key] = got if total[key] is None else min(total[key],
                                                                got)
    print(json.dumps(total))
    return 0


if __name__ == "__main__":
    sys.exit(main())
