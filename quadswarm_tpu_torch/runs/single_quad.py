"""Single-drone run, 4 seeds (reference: runs/single_quad/single_quad.py).

The port's copy of quadswarm_tpu/runs/single_quad.py:
the same commands, through quadswarm_tpu_torch.training.train.
"""
from quadswarm_tpu_torch.runs.launcher import (
    Experiment, ParamGrid, RunDescription,
)
from quadswarm_tpu_torch.runs.single_quad_baseline import QUAD_BASELINE_CLI

_params = ParamGrid([
    ("seed", [0, 1111, 2222, 3333]),
])

SINGLE_CLI = QUAD_BASELINE_CLI + (
    " --with_wandb=False --wandb_project=Quad-Swarm-RL --wandb_group=single"
)

_experiment = Experiment("single", SINGLE_CLI,
                         _params.generate_params(randomize=False))

RUN_DESCRIPTION = RunDescription("single_quad_4seeds_tpu",
                                 experiments=[_experiment])
