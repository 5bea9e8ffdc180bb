"""Neighbor-encoder architecture search grid (reference:
swarm_rl/runs/obstacles/quads_multi_obstacles_nei_encoder_search.py):
2 seeds x {2,6} visible neighbors x {attention, mean_embed, mlp}.

The port's copy of quadswarm_tpu/runs/obstacles/quads_multi_obstacles_nei_encoder_search.py:
the same commands, through quadswarm_tpu_torch.training.train.

Under --quads_encoder_type=attention the neighbour-encoder axis builds the
same model in both packages: that encoder type embeds the neighbours flat
and ignores --quads_neighbor_encoder_type.
"""
from quadswarm_tpu_torch.runs.launcher import (
    Experiment, ParamGrid, RunDescription,
)
from quadswarm_tpu_torch.runs.obstacles.quad_obstacle_baseline import (
    QUAD_OBSTACLE_BASELINE_CLI_8,
)

_params = ParamGrid([
    ("seed", [0, 3333]),
    ("quads_neighbor_visible_num", [2, 6]),
    ("quads_neighbor_encoder_type", ["attention", "mean_embed", "mlp"]),
])

OBSTACLE_MODEL_CLI = QUAD_OBSTACLE_BASELINE_CLI_8 + (
    " --quads_num_agents=8 --quads_neighbor_obs_type=pos_vel "
    "--quads_encoder_type=attention "
    "--with_wandb=True --wandb_project=Quad-Swarm-RL "
    "--wandb_group=test_neighbor_encoder"
)

_experiment = Experiment("test_neighbor_encoder", OBSTACLE_MODEL_CLI,
                         _params.generate_params(randomize=False))

RUN_DESCRIPTION = RunDescription("obstacles_multi", experiments=[_experiment])
