"""Host time a tick in the traced rollout call's `rollout.tick` spans less
their `env.sync` time: the host's own dispatch of a tick's device
operations, so how far the device can speed up before the host sets the
pace."""
from portbench import spans as sp


def read(rec):
    spans = sp.load(rec)
    if spans is None:
        return None
    return (sp.host_ms_per_tick(spans, (sp.TICK,))
            - sp.host_ms_per_tick(spans, ("env.sync",)))
