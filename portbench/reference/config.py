"""The reference's env, model and rollout settings, worked out from the
run's flags (a plain dict of flag values) with the frozen code in `qs/`.

These mirror what the port's CLI builds from the same flags
(`training/config.py`'s `env_config_from_args`, `model_from_args`,
`ppo_config_from_args`, `base_rew_coeff_from_args`), written here again so
that the reference depends on nothing of the program.
"""
from __future__ import annotations

import torch

from portbench.reference.qs.env.multi import EnvConfig
from portbench.reference.qs.env.params import make_dynamics_params
from portbench.reference.qs.env.reward import RewardCoeffs
from portbench.reference.qs.models.actor_critic import ActorCritic

SELF_OBS = {"xyz_vxyz_R_omega": 18, "xyz_vxyz_R_omega_floor": 19,
            "xyz_vxyz_R_omega_wall": 24}
NEIGHBOR_OBS = {"none": 0, "pos_vel": 6}
SDF_OBS = 9


def env_config(f: dict) -> EnvConfig:
    """The env the flags describe, in float32 (the configurations' stated
    precision)."""
    return EnvConfig(
        num_agents=f["quads_num_agents"],
        ep_time=f["quads_episode_duration"],
        room_dims=tuple(f["quads_room_dims"]),
        obs_repr=f["quads_obs_repr"],
        neighbor_obs_type=f["quads_neighbor_obs_type"],
        neighbor_visible_num=f["quads_neighbor_visible_num"],
        collision_hitbox_radius=f["quads_collision_hitbox_radius"],
        collision_falloff_radius=f["quads_collision_falloff_radius"],
        use_obstacles=f["quads_use_obstacles"],
        obst_density=f["quads_obst_density"],
        obst_size=f["quads_obst_size"],
        obst_spawn_area=tuple(f["quads_obst_spawn_area"]),
        obst_density_random=(f["quads_domain_random"]
                             and f["quads_obst_density_random"]),
        obst_density_min=f["quads_obst_density_min"],
        obst_density_max=f["quads_obst_density_max"],
        obst_size_random=(f["quads_domain_random"]
                          and f["quads_obst_size_random"]),
        obst_size_min=f["quads_obst_size_min"],
        obst_size_max=f["quads_obst_size_max"],
        use_downwash=f["quads_use_downwash"],
        quads_mode=f["quads_mode"],
        use_pallas_pairs=f["quads_use_pallas_pairs"] == "true",
        use_pallas_dynamics=True,
        dtype=torch.float32,
    )


def dynamics_params(cfg: EnvConfig):
    return make_dynamics_params(dt=cfg.dt)


def base_coeffs(f: dict) -> dict:
    """The collision coefficients the flags set (their final values)."""
    return dict(quadcol_bin=f["quads_collision_reward"],
                quadcol_bin_smooth_max=f["quads_collision_smooth_max_penalty"],
                quadcol_bin_obst=f["quads_obst_collision_reward"])


def reward_coeffs(f: dict) -> RewardCoeffs:
    return RewardCoeffs(**base_coeffs(f))


def model(f: dict, cfg: EnvConfig, weights: dict, device) -> ActorCritic:
    """A float32 actor-critic of the flags' widths holding `weights`."""
    m = ActorCritic(
        action_dim=4,
        self_obs_dim=SELF_OBS[f["quads_obs_repr"]],
        neighbor_obs_dim=NEIGHBOR_OBS[f["quads_neighbor_obs_type"]],
        num_neighbors=cfg.num_use_neighbor_obs,
        encoder_type=f["quads_encoder_type"],
        neighbor_encoder_type=f["quads_neighbor_encoder_type"],
        neighbor_hidden=f["quads_neighbor_hidden_size"],
        use_obstacles=f["quads_obstacle_obs_type"] == "octomap",
        obstacle_hidden=f["quads_obst_hidden_size"],
        rnn_size=f["rnn_size"], act=f["nonlinearity"],
        sim2real=f["quads_sim2real"], initial_stddev=f["initial_stddev"],
        dtype=torch.float32,
        obstacle_obs_dim=SDF_OBS if cfg.use_obstacles else 0,
        device=device)
    m.load_state_dict(weights)
    return m


def rollout_params(f: dict) -> dict:
    """The PPO settings a rollout reads."""
    keys = ("rollout", "reward_clip", "replay_buffer_sample_prob")
    return {k: f[k] for k in keys}
