"""Spans of the program's layers, recorded only while a torch profiler
records.

    from quadswarm_tpu_torch.utils.tracing import span
    with span("rollout.tick"):
        ...

There is one switch and it is the profiler's: `span(name)` records while
`torch.profiler.profile` (or `utils/debug.py::trace`) is recording, and is
a shared no-op context otherwise, which costs a Python call and one C
call and makes no allocation, no device work and no clock read.

While on, a span records its name, its parent (the span open around it),
the index of its tick (each `rollout.tick` span opens the next one; the
spans inside it carry its index), its host start and end on the
profiler's clock (`time.time_ns()`, the clock of the profiler's
`start_ns()`), and, on the card, a pair of CUDA timing events recorded on
the current stream at open and at close.  The device time between them is
the span's device stretch: from when the stream reaches the span's work to
when it has finished it, a wait for the host to issue that work included.
"On the card" means that the process has initialised CUDA: a span then
records its events on the current CUDA stream whatever device its work
runs on, so its device stretch means something only for work on the
current CUDA device.
A span makes no device-to-host sync: the events are read by `spans()`,
after the caller's own synchronize.

The store holds the newest profiled stretch: a span that finds the
profiler on after the previous span found it off drops what the store
held.  It keeps at most `CAPACITY` spans and counts those it drops.
Inside `debug.trace` each span also enters
`torch.profiler.record_function(name)`, so that the Chrome trace shows it
beside the kernels; elsewhere it adds no event to the profiler's, so a
profile of the device alone reads the same operations with spans as
without.

A counter, `count(name, n)`, adds a host-known integer to the stretch's
total of `name` under the same switch: it never reads the device.
`counts()` returns the newest stretch's totals.

Who reads the spans and counters: `portbench/metrics/*.py` (the
benchmark's `--trace 1` run) and `portbench/tools/gaps_by_span.py`;
`debug.trace` shows the spans.
`launch_times` and `span_at` place a profile's device operations in the
spans that launched them, on the host's clock.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import NamedTuple

import torch

CAPACITY = 1 << 20
TICK = "rollout.tick"

_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    parent: int | None       # index in `spans()` of the span open around it
    tick: int | None         # index of the `rollout.tick` it lies in
    host_start_ns: int
    host_end_ns: int | None  # None while the span is open
    device_ms: float | None  # None off the card or while open


class _Off:
    """The shared context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


class _Store:
    """The newest profiled stretch of spans, and a pool of CUDA events.
    One store a process, as the profiler it follows is one a process."""

    def __init__(self):
        self.on = False          # the previous span found the profiler on
        self.annotate = 0        # depth of `annotated()` blocks
        self.generation = 0
        self.records = []        # [name, parent, tick, t0, t1, ev0, ev1]
        self.stack = []          # indices of the open spans
        self.ticks = 0
        self.dropped = 0
        self.counts = {}         # counter name -> total
        self.pool = []

    def new_stretch(self) -> None:
        for r in self.records:
            self.pool.extend(e for e in r[5:] if e is not None)
        self.records, self.stack = [], []
        self.ticks = self.dropped = 0
        self.counts = {}
        self.generation += 1

    def event(self):
        return self.pool.pop() if self.pool else torch.cuda.Event(
            enable_timing=True)


_STORE = _Store()


class _Live:
    """A span while a profiler records."""

    __slots__ = ("name", "index", "generation", "annotation")

    def __init__(self, name: str):
        self.name = name
        self.index = None

    def __enter__(self):
        s = _STORE
        if len(s.records) >= CAPACITY:
            s.dropped += 1
            return None
        parent = s.stack[-1] if s.stack else None
        if self.name == TICK:
            tick = s.ticks
            s.ticks += 1
        else:
            tick = s.records[parent][2] if parent is not None else None
        self.annotation = None
        if s.annotate:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        rec = [self.name, parent, tick, time.time_ns(), None, None, None]
        if torch.cuda.is_initialized():
            rec[5], rec[6] = s.event(), s.event()
            rec[5].record()
        self.index, self.generation = len(s.records), s.generation
        s.records.append(rec)
        s.stack.append(self.index)
        return None

    def __exit__(self, *exc):
        s = _STORE
        if self.index is None or self.generation != s.generation:
            return False
        rec = s.records[self.index]
        if rec[6] is not None:
            rec[6].record()
        rec[4] = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        s.stack.pop()
        return False


def _recording() -> bool:
    """Whether a profiler records; a first call that finds it on after one
    that found it off starts a new stretch."""
    if _profiling():
        if not _STORE.on:
            _STORE.new_stretch()
            _STORE.on = True
        return True
    _STORE.on = False
    return False


def span(name: str):
    """A context that records the enclosed block as span `name` while a
    torch profiler records, and does nothing otherwise."""
    return _Live(name) if _recording() else _OFF


def count(name: str, n: int) -> None:
    """Adds the host integer `n` to counter `name` while a torch profiler
    records, and does nothing otherwise."""
    if _recording():
        _STORE.counts[name] = _STORE.counts.get(name, 0) + int(n)


def counts() -> dict:
    """The counters of the newest profiled stretch: name -> total."""
    return dict(_STORE.counts)


def spans() -> list:
    """The spans of the newest profiled stretch, in the order they opened,
    as `Span` records.  Reads the device times: call it after the device
    has finished the spans' work (a `torch.cuda.synchronize()`)."""
    out = []
    for name, parent, tick, t0, t1, ev0, ev1 in _STORE.records:
        device_ms = None
        if ev0 is not None and t1 is not None:
            device_ms = ev0.elapsed_time(ev1)
        out.append(Span(name, parent, tick, t0, t1, device_ms))
    return out


def dropped() -> int:
    """Spans of the newest stretch left out because the store was full."""
    return _STORE.dropped


@contextlib.contextmanager
def annotated():
    """While entered, spans also enter `torch.profiler.record_function`,
    so that a profile of the CPU shows them (`debug.trace`)."""
    _STORE.annotate += 1
    try:
        yield
    finally:
        _STORE.annotate -= 1


def launch_times(events) -> dict:
    """Correlation id -> host start (ns, the profiler's clock) of the CUDA
    API call that has it, from a profile's `kineto_results.events()`: for
    a device operation, its launch.  Only CUDA API calls count (names
    starting "cu"): the profiler's own host events, such as "Activity
    Buffer Request", can carry a kernel's correlation id too."""
    cuda = torch.autograd.DeviceType.CUDA
    return {e.correlation_id(): e.start_ns() for e in events
            if e.device_type() != cuda and e.name().startswith("cu")}


def span_at(spans: list):
    """A function of a host time (ns, the profiler's clock) that gives the
    innermost of `spans` open at that time, or None.  With `launch_times`:
    the span in which a device operation was launched."""
    ordered = sorted(spans, key=lambda s: s.host_start_ns)
    starts = [s.host_start_ns for s in ordered]

    def at(t_ns):
        i = bisect.bisect_right(starts, t_ns) - 1
        while i >= 0:
            s = ordered[i]
            if s.host_end_ns is not None and s.host_end_ns >= t_ns:
                return s
            i -= 1
        return None
    return at
