"""8-drone mix baseline (reference: runs/quad_multi_mix_baseline.py).

Same training hyperparameters; the 36 workers x 4 envs CPU grid becomes a
1024-env on-device batch.

The port's copy of quadswarm_tpu/runs/quad_multi_mix_baseline.py:
the same commands, through quadswarm_tpu_torch.training.train.
"""
from quadswarm_tpu_torch.runs.launcher import (
    Experiment, ParamGrid, RunDescription,
)

_params = ParamGrid([
    ("quads_collision_reward", [5.0]),
])

QUAD_BASELINE_CLI_8 = (
    "python -m quadswarm_tpu_torch.training.train --env=quadrotor_multi "
    "--train_for_env_steps=1000000000 --algo=APPO "
    "--num_envs=1024 --learning_rate=0.0001 --ppo_clip_value=5.0 "
    "--nonlinearity=tanh --rnn_size=256 "
    "--gae_lambda=1.00 --max_grad_norm=5.0 --exploration_loss_coeff=0.0 "
    "--rollout=128 --batch_size=1024 "
    "--quads_num_agents=8 --quads_mode=mix --quads_episode_duration=15.0 "
    "--quads_neighbor_encoder_type=attention --quads_neighbor_hidden_size=256 "
    "--quads_neighbor_obs_type=pos_vel "
    "--quads_collision_reward=5.0 --quads_collision_hitbox_radius=2.0 "
    "--quads_collision_falloff_radius=4.0 "
    "--quads_collision_smooth_max_penalty=10.0 --quads_neighbor_visible_num=6 "
    "--replay_buffer_sample_prob=0.75 --anneal_collision_steps=300000000 "
    "--reward_clip=10.0"
)

_experiment = Experiment(
    "quad_mix_baseline-8_mixed",
    QUAD_BASELINE_CLI_8,
    _params.generate_params(randomize=False),
)

RUN_DESCRIPTION = RunDescription("quads_multi_mix_baseline_8a_tpu",
                                 experiments=[_experiment])
