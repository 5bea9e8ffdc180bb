"""K3's share of its roofline in the traced rollout call: the least time of
its launches (`arith.k3_bound_s`) over their device time by kernel
name."""
from portbench.arith import k3_bound_s

KERNEL = "neighbor_topk_kernel"


def read(rec):
    t = rec.trace
    if t is None or rec.card is None:
        return None
    hits = [v for k, v in t["kernels"].items() if KERNEL in k]
    launches = sum(v[0] for v in hits)
    seconds = sum(v[1] for v in hits)
    if not launches or seconds <= 0:
        return None
    f = rec.flags
    return 100.0 * launches * k3_bound_s(
        f["num_envs"], f["quads_num_agents"], f["quads_neighbor_visible_num"],
        rec.card["peaks"]) / seconds
