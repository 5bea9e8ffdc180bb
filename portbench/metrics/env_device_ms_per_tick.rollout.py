"""Device stretch a tick of the traced rollout call's `env.step` spans:
the env's stages 1-7 (scenario, K1, reward, K2, interactions, K3 and the
observation, stats), without the replay and the read."""
from portbench import spans as sp


def read(rec):
    spans = sp.load(rec)
    if spans is None:
        return None
    return sp.device_ms_per_tick(spans, ("env.step",))
