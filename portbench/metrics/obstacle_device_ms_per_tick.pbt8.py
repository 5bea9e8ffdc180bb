"""Device stretch a tick of the traced mixed rollout call's
`env.obstacle_hits` and `env.obstacle_sdf` spans: the drones' hits on the
obstacle cylinders and their 9-point SDF patch."""
from portbench import spans as sp


def read(rec):
    spans = sp.load(rec)
    if spans is None:
        return None
    return sp.device_ms_per_tick(spans, ("env.obstacle_hits",
                                         "env.obstacle_sdf"))
