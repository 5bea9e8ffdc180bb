"""Single-drone baseline (reference: runs/single_quad/baseline.py).

The port's copy of quadswarm_tpu/runs/single_quad_baseline.py:
the same commands, through quadswarm_tpu_torch.training.train.
"""
from quadswarm_tpu_torch.runs.launcher import (
    Experiment, ParamGrid, RunDescription,
)

_params = ParamGrid([
    ("seed", [0]),
])

QUAD_BASELINE_CLI = (
    "python -m quadswarm_tpu_torch.training.train --env=quadrotor_multi "
    "--train_for_env_steps=1000000000 --algo=APPO "
    "--num_envs=2048 --learning_rate=0.0001 --ppo_clip_value=5.0 "
    "--nonlinearity=tanh --rnn_size=256 "
    "--gae_lambda=1.00 --max_grad_norm=5.0 --exploration_loss_coeff=0.0 "
    "--rollout=128 --batch_size=1024 "
    "--quads_num_agents=1 --quads_mode=static_same_goal "
    "--quads_episode_duration=15.0 "
    "--quads_neighbor_encoder_type=no_encoder --quads_neighbor_hidden_size=0 "
    "--quads_neighbor_obs_type=none --quads_neighbor_visible_num=0 "
    "--replay_buffer_sample_prob=0.75 --anneal_collision_steps=300000000 "
    "--reward_clip=10.0"
)

_experiment = Experiment("single_quad_baseline", QUAD_BASELINE_CLI,
                         _params.generate_params(randomize=False))

RUN_DESCRIPTION = RunDescription("single_quad_baseline_tpu",
                                 experiments=[_experiment])
