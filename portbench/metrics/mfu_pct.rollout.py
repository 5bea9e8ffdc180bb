"""The rollout window's model float operations a second as a share of the
card's float32 peak (TF32 off): each agent-step once through its own
policy's forward (`arith.forward_flops`), over the window's wall time."""
from portbench.arith import forward_flops


def read(rec):
    if rec.card is None or rec.window_s <= 0:
        return None
    flops = rec.agent_steps * forward_flops(rec.flags)
    return 100.0 * flops / rec.window_s / rec.card["peaks"][
        "fp32_flops_per_s"]
