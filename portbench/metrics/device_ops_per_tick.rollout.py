"""Device operations (kernels, copies, fills) a tick in the traced rollout
call, by the profiler's count."""


def read(rec):
    t = rec.trace
    if t is None or not t["launches"]:
        return None
    return t["launches"] / t["ticks"]
