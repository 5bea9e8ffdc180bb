"""8-drone mix baseline with the multi-head-attention encoder, 4 seeds
(reference: runs/quad_multi_mix_baseline_attn_8.py).

The port's copy of quadswarm_tpu/runs/quad_multi_mix_baseline_attn_8.py:
the same commands, through quadswarm_tpu_torch.training.train.

The port refuses this command when it builds the model: the run has no
obstacles, so the 'attention' encoder type's obstacle token would embed a
0-wide slice, on which the JAX package's encoder fails at init
(ZeroDivisionError); ROADMAP.md lists the defect.
"""
from quadswarm_tpu_torch.runs.launcher import (
    Experiment, ParamGrid, RunDescription,
)
from quadswarm_tpu_torch.runs.quad_multi_mix_baseline import (
    QUAD_BASELINE_CLI_8,
)

_params = ParamGrid([
    ("seed", [0, 1111, 2222, 3333]),
])

ATTN_CLI = QUAD_BASELINE_CLI_8 + " --quads_encoder_type=attention"

_experiment = Experiment("quad_mix_baseline-8_mixed_attn", ATTN_CLI,
                         _params.generate_params(randomize=False))

RUN_DESCRIPTION = RunDescription("quads_multi_mix_baseline_8a_attn_tpu",
                                 experiments=[_experiment])
