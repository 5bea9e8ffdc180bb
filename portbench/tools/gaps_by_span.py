"""One traced run of a cell, read by the program's spans
(`quadswarm_tpu_torch/utils/tracing.py`): the device time a tick by span,
and each idle gap of the device named by the innermost span open on the
host where the operation that ends the gap was launched.

    python3 portbench/tools/gaps_by_span.py --workload rollout.swarm128 \
        --seed 7

From the root of a checkout, on the card.  It runs `portbench/run.py
--trace 1` itself, with the `run_seconds` of `BENCHMARK.json`: the same
set-up, the same window and the same traced call as the benchmark's
traced run, and prints that run's result line.  Then it prints one more
JSON line from the traced call's profile and spans:
- `spans`: for each span name, spans a tick, host ms a tick and device ms
  a tick (the device stretch between its two events);
- `gaps`: the idle gaps of the device (as `trace.reduce` finds them) by
  the innermost span open on the host at the launch of the operation that
  ends each gap, `outside` where none is: count a tick and ms a tick.
  The launch is on the host's clock.  The profiler's device times are not
  always: in about half the profiles of this cell on an H100 they sit
  micro- to milliseconds off it (`launch_lag.py`), so a gap is not named
  by the host's span at its start;
- `kernels`: for each span name, the device ms a tick of the operations
  launched while it was the innermost span open on the host
  (`tracing.launch_times`), by kind of operation (`KINDS`);
- `min_lag_us` and `early`: the least time from a device operation's
  launch to its start in the traced call, and the number that start
  before their launch (`launch_lag.read_profile`): how far the profile's
  device times sit off the host's clock;
- `span_cost_us`: a span's host cost with no profiler recording, and with
  one recording the device (its pair of events included), measured after
  the run;
- the traced call's `window_s` and `busy_s`, and the card.
The harness does not read this tool.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def span_cost_us(count_off: int = 200_000, count_on: int = 2_000) -> dict:
    """Host µs of one empty span, with no profiler and under a profile of
    the device alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from quadswarm_tpu_torch.utils.tracing import span
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        for _ in range(count_on):
            with span("cost"):
                pass
        on = (time.perf_counter() - t0) / count_on
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count_off):
        with span("cost"):
            pass
    off = (time.perf_counter() - t0) / count_off
    return {"off": off * 1e6, "on": on * 1e6}


def launch_span(spans: list, launches: dict):
    """A function of a correlation id that names the innermost span open on
    the host at its launch: `outside` where none is, `unmatched` where the
    profile holds no launch of that id."""
    from quadswarm_tpu_torch.utils.tracing import span_at
    at = span_at(spans)

    def where(corr):
        t = launches.get(corr)
        if t is None:
            return "unmatched"
        s = at(t)
        return "outside" if s is None else s.name
    return where


# kinds of device operation, by a piece of the profiler's name; the first
# that matches names the operation
KINDS = (("K1", "dynamics_kernel"), ("K2", "pair_collision"),
         ("K3", "neighbor_topk"), ("gemm", "gemm"), ("gemm", "gemv"),
         ("cat", "CatArrayBatchedCopy"), ("reduce", "reduce_kernel"),
         ("elementwise", "elementwise_kernel"), ("copy", "Memcpy"),
         ("fill", "Memset"))


def kind(name: str) -> str:
    return next((k for k, piece in KINDS if piece in name), "other")


def kernels_by_span(ops: list, launches: dict, spans: list,
                    ticks: int) -> dict:
    """ops: (name, start_ns, end_ns, correlation id) of the device;
    launches: correlation id -> host start ns of the launch."""
    where = launch_span(spans, launches)
    out = {}
    for name, start, end, corr in ops:
        by_kind = out.setdefault(where(corr), {})
        k = kind(name)
        by_kind[k] = by_kind.get(k, 0.0) + (end - start) * 1e-6 / ticks
    return out


def summarize(ops: list, launches: dict, spans: list, ticks: int) -> dict:
    """ops: (name, start_ns, end_ns, correlation id) of the device, sorted
    by start; launches: correlation id -> host start ns of the launch."""
    by_name = {}
    for s in spans:
        d = by_name.setdefault(s.name, [0, 0.0, 0.0])
        d[0] += 1
        d[1] += (s.host_end_ns - s.host_start_ns) * 1e-6
        d[2] += s.device_ms or 0.0
    table = {k: {"per_tick": v[0] / ticks, "host_ms": v[1] / ticks,
                 "device_ms": v[2] / ticks} for k, v in by_name.items()}
    # each gap by where the host launched the operation that ends it: the
    # launch is on the host's clock, the gap's own ends are not
    where = launch_span(spans, launches)
    gaps, cur_end = {}, None
    for _, start, end, corr in ops:
        if cur_end is not None and start > cur_end:
            g = gaps.setdefault(where(corr), [0, 0.0])
            g[0] += 1
            g[1] += (start - cur_end) * 1e-6
        cur_end = end if cur_end is None else max(cur_end, end)
    gaps = {k: {"per_tick": v[0] / ticks, "ms_per_tick": v[1] / ticks}
            for k, v in sorted(gaps.items(), key=lambda kv: -kv[1][1])}
    return {"spans": table, "gaps": gaps}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    a = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    import portbench.trace as trace
    from portbench.harness import load_json, load_module, power_limit
    from quadswarm_tpu_torch.utils import tracing

    # the traced call's profile, as `trace.traced` hands it on
    held = {}
    device_events = trace.device_events

    def keep(prof):
        held["prof"] = prof
        return device_events(prof)

    trace.device_events = keep
    run = load_module(os.path.join(ROOT, "portbench", "run.py"),
                      "portbench_run")
    seconds = load_json(ROOT, "BENCHMARK.json")["run_seconds"]
    sys.argv = [run.__file__, "--workload", a.workload, "--seed",
                str(a.seed), "--seconds", str(seconds), "--trace", "1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main()
    print(out.getvalue(), end="")
    if rc != 0 or "prof" not in held:
        return rc or 1
    result = json.loads(out.getvalue().splitlines()[-1])
    events = list(held["prof"].profiler.kineto_results.events())
    spans = tracing.spans()
    lag = load_module(os.path.join(ROOT, "portbench", "tools",
                                   "launch_lag.py"), "portbench_launch_lag")
    clock = lag.read_profile(events, spans)
    cost = span_cost_us()
    ticks = sum(s.name == tracing.TICK for s in spans)
    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                   e.correlation_id()) for e in events
                  if e.device_type() == cuda), key=lambda op: op[1])
    launches = tracing.launch_times(events)
    line = dict(summarize(ops, launches, spans, ticks),
                kernels=kernels_by_span(ops, launches, spans, ticks),
                workload=a.workload, seed=a.seed, run_seconds=seconds,
                ticks=ticks, window_s=result["device"]["window_s"],
                busy_s=result["device"]["busy_s"], device_ops=len(ops),
                dropped=tracing.dropped(), span_cost_us=cost,
                min_lag_us=clock["min_lag_us"], early=len(clock["early"]),
                card=power_limit())
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
