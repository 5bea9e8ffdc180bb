"""Device stretch a tick of the traced rollout call's `rollout.policy`
spans: the actor-critic's forward of every tick and the last value's."""
from portbench import spans as sp


def read(rec):
    spans = sp.load(rec)
    if spans is None:
        return None
    return sp.device_ms_per_tick(spans, ("rollout.policy",))
