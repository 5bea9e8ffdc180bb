"""The mixture's float operations a second in the window as a share of the
card's float32 peak (TF32 off): each agent row served once under its own
policy (`arith_mixed.served_flops_per_row`, the heads computed and thrown
away not counted), the rows a call from the traced call's
`pbt.agent_rows` counter, times the window's calls, over the window's wall
time."""
from portbench import program_counts
from portbench.arith_mixed import served_flops_per_row


def read(rec):
    rows = program_counts.load(rec)
    if (rec.card is None or rec.window_s <= 0 or not rows
            or not rows.get("pbt.agent_rows")):
        return None
    flops = served_flops_per_row(rec.flags) * rows["pbt.agent_rows"]
    return 100.0 * flops * rec.calls / rec.window_s / rec.card["peaks"][
        "fp32_flops_per_s"]
