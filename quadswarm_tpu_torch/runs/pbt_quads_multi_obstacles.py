"""8-policy PBT obstacle run (reference: runs/obstacles/
pbt_quads_multi_obstacles.py).

The port's copy of quadswarm_tpu/runs/pbt_quads_multi_obstacles.py:
the same commands, through quadswarm_tpu_torch.training.train.
"""
from quadswarm_tpu_torch.runs.launcher import (
    Experiment, ParamGrid, RunDescription,
)

_params = ParamGrid([
    ("seed", [0]),
])

PBT_CLI = (
    "python -m quadswarm_tpu_torch.training.train --env=quadrotor_multi "
    "--train_for_env_steps=10000000000 --algo=APPO "
    "--num_envs=512 --learning_rate=0.0001 --ppo_clip_value=5.0 "
    "--nonlinearity=tanh --rnn_size=256 "
    "--gae_lambda=1.00 --max_grad_norm=5.0 --rollout=128 --batch_size=1024 "
    "--quads_num_agents=8 --quads_mode=mix --quads_episode_duration=15.0 "
    "--quads_use_obstacles=True --quads_obstacle_obs_type=octomap "
    "--quads_obs_repr=xyz_vxyz_R_omega_wall "
    "--quads_neighbor_encoder_type=attention --quads_neighbor_obs_type=pos_vel "
    "--quads_neighbor_visible_num=6 "
    "--quads_collision_reward=5.0 --quads_obst_collision_reward=5.0 "
    "--quads_collision_hitbox_radius=2.0 --quads_collision_falloff_radius=4.0 "
    "--quads_collision_smooth_max_penalty=10.0 "
    "--replay_buffer_sample_prob=0.75 --anneal_collision_steps=300000000 "
    "--with_pbt=True --num_policies=8 "
    "--pbt_period_env_steps=10000000 --pbt_start_mutation=50000000"
)

_experiment = Experiment("pbt_quads_multi_obstacles", PBT_CLI,
                         _params.generate_params(randomize=False))

RUN_DESCRIPTION = RunDescription("pbt_quads_multi_obstacles_tpu",
                                 experiments=[_experiment])
