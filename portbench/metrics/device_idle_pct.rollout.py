"""The share of the traced call in which no operation ran on the device:
its length minus the union of the kernels' intervals."""


def read(rec):
    t = rec.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
