"""Rollout collection for synchronous PPO.

Port of the rollout half of quadswarm_tpu/parallel/ppo.py: `Transition`
and `collect_rollout`.  The JAX `lax.scan` over ticks becomes a Python
loop; each tick runs the policy forward and `batched_env_step` (whose
dynamics go through the fused kernel K1 on CUDA).  The collision-replay
wrapper, normalizers, GAE and the PPO update come in a later slice, and
asking for replay or a normalizer raises.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from quadswarm_tpu_torch.env.multi import EnvConfig, EnvState, batched_env_step
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.models.actor_critic import (
    ActorCritic, apply_fused, gaussian_log_prob, sample_actions,
)
from quadswarm_tpu_torch.utils.struct import map_fields


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The fields of the JAX PPOConfig that the rollout reads, with the
    same defaults; the training fields come with the PPO update."""

    rollout: int = 128
    reward_clip: float = 10.0
    replay_sample_prob: float = 0.0
    normalize_input: bool = False
    normalize_returns: bool = False


class Transition(NamedTuple):
    obs: torch.Tensor        # (T, E, N, obs_dim)
    actions: torch.Tensor    # (T, E, N, A)
    log_prob: torch.Tensor   # (T, E, N)
    value: torch.Tensor      # (T, E, N)
    reward: torch.Tensor     # (T, E, N)
    done: torch.Tensor       # (T, E, N) bool


@torch.no_grad()
def collect_rollout(env_cfg: EnvConfig, dyn_params, model: ActorCritic,
                    ppo_cfg: PPOConfig, env_states: EnvState,
                    obs: torch.Tensor, gen: torch.Generator,
                    rew_coeff: RewardCoeffs, replay_states=None, norm=None):
    """ppo_cfg.rollout ticks of policy + env.  Returns (env_states', obs',
    replay_states, Transition stacked over T, last_value (E, N), infos
    stacked over T)."""
    if ppo_cfg.replay_sample_prob > 0.0 and replay_states is not None:
        raise NotImplementedError("collision replay is not ported yet")
    if norm is not None or ppo_cfg.normalize_input \
            or ppo_cfg.normalize_returns:
        raise NotImplementedError("normalizers are not ported yet")
    e, n = obs.shape[:2]
    dev = obs.device
    env_states = env_states.replace(rew_coeff=map_fields(
        lambda x: torch.as_tensor(x, dtype=env_cfg.dtype, device=dev)
        .expand(e).clone(), rew_coeff))

    steps, infos = [], []
    for _ in range(ppo_cfg.rollout):
        mean, log_std, value = apply_fused(model, obs.reshape(e * n, -1))
        actions = sample_actions(gen, mean, log_std)
        log_prob = gaussian_log_prob(mean, log_std, actions)
        actions_e = actions.reshape(e, n, -1)
        env_states, next_obs, rew, dones, info = batched_env_step(
            env_cfg, dyn_params, env_states, actions_e, gen)
        steps.append(Transition(
            obs=obs, actions=actions_e, log_prob=log_prob.reshape(e, n),
            value=value.reshape(e, n),
            reward=torch.clamp(rew, -ppo_cfg.reward_clip,
                               ppo_cfg.reward_clip),
            done=dones))
        infos.append(info)
        obs = next_obs
    _, _, last_value = apply_fused(model, obs.reshape(e * n, -1))
    traj = Transition(*(torch.stack(x) for x in zip(*steps)))
    info = {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
    return env_states, obs, replay_states, traj, last_value.reshape(e, n), info
