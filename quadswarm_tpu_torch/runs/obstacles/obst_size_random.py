"""Obstacle-size domain randomization run (reference:
swarm_rl/runs/obstacles/obst_size_random.py).

The port's copy of quadswarm_tpu/runs/obstacles/obst_size_random.py:
the same commands, through quadswarm_tpu_torch.training.train.
"""
from quadswarm_tpu_torch.runs.launcher import (
    Experiment, ParamGrid, RunDescription,
)
from quadswarm_tpu_torch.runs.obstacles.quad_obstacle_baseline import (
    QUAD_OBSTACLE_BASELINE_CLI_8,
)

_params = ParamGrid([
    ("seed", [0, 1111, 2222, 3333]),
])

OBSTACLE_MODEL_CLI = QUAD_OBSTACLE_BASELINE_CLI_8 + (
    " --quads_num_agents=8 --quads_neighbor_visible_num=6 "
    "--quads_neighbor_obs_type=pos_vel --quads_encoder_type=attention "
    "--quads_neighbor_encoder_type=attention "
    "--with_wandb=True --wandb_project=Quad-Swarm-RL "
    "--quads_domain_random=True --quads_obst_size_random=True "
    "--quads_obst_size_min=0.3 --quads_obst_size_max=0.6 "
    "--wandb_group=obst_size_random"
)

_experiment = Experiment("obst_size_random", OBSTACLE_MODEL_CLI,
                         _params.generate_params(randomize=False))

RUN_DESCRIPTION = RunDescription("obstacles_multi", experiments=[_experiment])
