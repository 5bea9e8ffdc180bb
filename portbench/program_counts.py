"""The program's counters (`quadswarm_tpu_torch/utils/tracing.py::count`)
as the per-layer readers take them: the totals of the newest profiled
stretch, which in a `--trace 1` run is the traced call.  Where the program
has no counters (a commit before them) or the traced call recorded none,
None."""
from __future__ import annotations


def load(rec) -> dict | None:
    if rec.trace is None:
        return None
    try:
        from quadswarm_tpu_torch.utils.tracing import counts
    except ImportError:
        return None
    return counts() or None
