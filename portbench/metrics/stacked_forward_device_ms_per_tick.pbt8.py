"""Device stretch a tick of the traced mixed rollout call's `pbt.heads`
spans: the stacked forward of every policy's head over every agent row
(`StackedPolicies.forward_all` under `torch.vmap`), each tick's and the
last value's."""
from portbench import spans as sp


def read(rec):
    spans = sp.load(rec)
    if spans is None:
        return None
    return sp.device_ms_per_tick(spans, ("pbt.heads",))
