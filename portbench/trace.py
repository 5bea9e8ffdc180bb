"""The traced slice: one more call of the cell's unit of work under
`torch.profiler` and the sync counter, reduced to what the per-layer
readers and the result's `device` and `breakdown` need.

- busy_s: the union of the device kernels' intervals (kernels, copies and
  fills) over the slice; window_s: the slice's length on the host clock,
  from before the call to after a device sync.
- kernels: {name: [launches, seconds]} by the profiler's kernel name.
- breakdown: the ten device operations that took most time, and the ten
  largest sums of idle gaps, each gap named by the operation the device
  waited for (`host_issuing_<next kernel>`).
"""
from __future__ import annotations

import time

import torch

from portbench.counters import SyncCounter

NAME_CHARS = 64


def _short(name: str) -> str:
    out = "".join(c if c.isalnum() or c in "_.-:" else "_" for c in name)
    return out[:NAME_CHARS]


def device_events(prof) -> list:
    """(name, start_s, end_s) of every device operation, sorted by start:
    the profiler's raw events, read without building its event tree (which
    takes minutes for the half a million operations of an iteration)."""
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != cuda:
            continue
        start = evt.start_ns() * 1e-9
        out.append((evt.name(), start, start + evt.duration_ns() * 1e-9))
    out.sort(key=lambda e: e[1])
    return out


def reduce(events: list, window_s: float) -> dict:
    kernels, gaps = {}, {}
    busy, cur_start, cur_end = 0.0, None, None
    for name, start, end in events:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += end - start
        if cur_end is None:
            cur_start, cur_end = start, end
            continue
        if start > cur_end:
            busy += cur_end - cur_start
            label = "host_issuing_" + _short(name)
            gaps[label] = gaps.get(label, 0.0) + (start - cur_end)
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s, "kernels": kernels,
            "launches": sum(v[0] for v in kernels.values()),
            "breakdown": {"device_ops": [[_short(k), v[1]] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in idle]}}


def traced(call, device) -> dict:
    """Runs `call()` (which returns {'ticks', 'samples'}) under the profiler
    and the sync counter."""
    from torch.profiler import ProfilerActivity, profile
    # the device's activity alone: recording every host operation as well
    # doubles the host's time and so the idle share
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts = [ProfilerActivity.CUDA]
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with SyncCounter(device) as syncs:
            t0 = time.perf_counter()
            work = call()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    out = reduce(device_events(prof), window_s)
    out.update(work)
    out["syncs"] = syncs.implicit
    return out
