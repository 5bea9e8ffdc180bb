"""Device stretch a tick of the traced mixed rollout call's `pbt.select`,
`pbt.coeffs` and `pbt.assign` spans: each row's head taken from the
stacked outputs, each agent's reward coefficients pushed from its policy's
column, and the redraw of the envs that ended an episode."""
from portbench import spans as sp


def read(rec):
    spans = sp.load(rec)
    if spans is None:
        return None
    return sp.device_ms_per_tick(spans, ("pbt.select", "pbt.coeffs",
                                         "pbt.assign"))
