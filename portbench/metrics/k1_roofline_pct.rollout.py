"""K1's share of its roofline in the traced rollout call: the least time of
its launches (`arith.k1_bound_s` over the fleet's drones) over their
device time by kernel name."""
from portbench.arith import k1_bound_s

KERNEL = "dynamics_kernel"
SIM_STEPS = 2        # the env's 200 Hz physics under 100 Hz control


def read(rec):
    t = rec.trace
    if t is None or rec.card is None:
        return None
    hits = [v for k, v in t["kernels"].items() if KERNEL in k]
    launches = sum(v[0] for v in hits)
    seconds = sum(v[1] for v in hits)
    if not launches or seconds <= 0:
        return None
    drones = rec.flags["num_envs"] * rec.flags["quads_num_agents"]
    return 100.0 * launches * k1_bound_s(drones, SIM_STEPS, rec.card[
        "peaks"]) / seconds
