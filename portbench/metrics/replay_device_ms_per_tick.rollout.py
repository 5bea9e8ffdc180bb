"""Device stretch a tick of the traced rollout call's `replay.ring` and
`replay.restore` spans: the collision replay's decisions, its ring writes
and the replayed envs' restore."""
from portbench import spans as sp


def read(rec):
    spans = sp.load(rec)
    if spans is None:
        return None
    return sp.device_ms_per_tick(spans, ("replay.ring", "replay.restore"))
