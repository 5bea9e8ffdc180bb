"""Shared base CLI for the obstacle experiment family.

Reference: swarm_rl/runs/obstacles/quad_obstacle_baseline.py (the
QUAD_BASELINE_CLI_8 string every obstacle run extends).  SF worker-process
knobs (--num_workers x --num_envs_per_worker = 36x4) become the on-device
env batch; numba/torch-specific flags have no equivalent.

The port's copy of quadswarm_tpu/runs/obstacles/quad_obstacle_baseline.py:
the same commands, through quadswarm_tpu_torch.training.train.
"""

QUAD_OBSTACLE_BASELINE_CLI_8 = (
    "python -m quadswarm_tpu_torch.training.train --env=quadrotor_multi "
    "--train_for_env_steps=1000000000 --algo=APPO "
    "--num_envs=1024 --learning_rate=0.0001 --ppo_clip_value=5.0 "
    "--nonlinearity=tanh --with_vtrace=False --rnn_size=256 "
    "--gae_lambda=1.00 --max_grad_norm=5.0 --exploration_loss_coeff=0.0 "
    "--rollout=128 --batch_size=1024 --with_pbt=False --reward_clip=10 "
    "--save_every_sec=300 --anneal_collision_steps=300000000 "
    "--replay_buffer_sample_prob=0.75 "
    # Scenarios
    "--quads_mode=mix --quads_episode_duration=15.0 "
    # Self
    "--quads_obs_repr=xyz_vxyz_R_omega_floor "
    # Neighbor (base: disabled; derived runs override)
    "--quads_neighbor_hidden_size=256 --quads_neighbor_obs_type=none "
    "--quads_collision_hitbox_radius=2.0 --quads_collision_falloff_radius=4.0 "
    "--quads_collision_reward=5.0 --quads_collision_smooth_max_penalty=4.0 "
    "--quads_neighbor_encoder_type=no_encoder --quads_neighbor_visible_num=2 "
    # Obstacles
    "--quads_use_obstacles=True --quads_obst_spawn_area 8 8 "
    "--quads_obst_density=0.2 --quads_obst_size=0.6 "
    "--quads_obst_collision_reward=5.0 --quads_obstacle_obs_type=octomap "
    "--quads_use_downwash=True"
)
