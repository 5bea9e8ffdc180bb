"""The program's spans (`quadswarm_tpu_torch/utils/tracing.py`) as the
per-layer readers take them: the newest profiled stretch, which in a
`--trace 1` run is the traced call.  Each sum is per tick, over the
call's `rollout.tick` spans.  Where the program has no spans (a commit
before them), the traced call recorded none, or a device time is
missing (off the card), the sums are None."""
from __future__ import annotations

TICK = "rollout.tick"


def load(rec) -> list | None:
    """The traced call's spans, or None."""
    if rec.trace is None:
        return None
    try:
        from quadswarm_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    return spans if any(s.name == TICK for s in spans) else None


def ticks(spans: list) -> int:
    return sum(s.name == TICK for s in spans)


def host_ms_per_tick(spans: list, names: tuple) -> float | None:
    """Host time in the spans of `names`, in ms a tick."""
    ns = sum(s.host_end_ns - s.host_start_ns for s in spans
             if s.name in names)
    return ns * 1e-6 / ticks(spans)


def device_ms_per_tick(spans: list, names: tuple) -> float | None:
    """Device stretch of the spans of `names`, in ms a tick."""
    picked = [s for s in spans if s.name in names]
    if not picked or any(s.device_ms is None for s in picked):
        return None
    return sum(s.device_ms for s in picked) / ticks(spans)
