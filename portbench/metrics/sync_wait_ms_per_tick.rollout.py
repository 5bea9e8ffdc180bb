"""Host time a tick in the traced rollout call's `env.sync` spans: the
tick's one device-to-host read, so how long the host waits for the
device."""
from portbench import spans as sp


def read(rec):
    spans = sp.load(rec)
    if spans is None:
        return None
    return sp.host_ms_per_tick(spans, ("env.sync",))
