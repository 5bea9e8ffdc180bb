"""Per-drone reward terms and the swarm proximity penalty.

Port of quadswarm_tpu/env/reward.py.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.qs.utils.struct import Struct


@dataclasses.dataclass
class RewardCoeffs(Struct):
    """Reward weights: Python floats, or tensors inside an EnvState: (E,)
    per env (annealed by the training wrapper), or (E, N) per agent (mixed-
    policy PBT: each agent takes its policy's coefficients)."""

    pos: float = 1.0
    effort: float = 0.05
    crash: float = 1.0
    orient: float = 1.0
    spin: float = 0.1
    quadcol_bin: float = 0.0
    quadcol_bin_smooth_max: float = 0.0
    quadcol_bin_obst: float = 0.0
    action_change: float = 0.0
    yaw: float = 0.0
    rot: float = 0.0
    attitude: float = 0.0
    vel: float = 0.0


class RewardInfo(NamedTuple):
    rew_pos: torch.Tensor
    rew_action: torch.Tensor
    rew_crash: torch.Tensor
    rew_orient: torch.Tensor
    rew_spin: torch.Tensor
    rewraw_pos: torch.Tensor
    rewraw_action: torch.Tensor
    rewraw_crash: torch.Tensor
    rewraw_orient: torch.Tensor
    rewraw_spin: torch.Tensor


def compute_reward(coeffs: RewardCoeffs, pos, goal, action, rot, omega,
                   on_floor, dt: float):
    """Weighted single-drone reward and its raw components.  A per-env
    coefficient (E,) broadcasts over the agent axis of `pos`, a per-agent
    one (E, N) applies drone by drone."""
    dist = torch.linalg.vector_norm(goal - pos, dim=-1)
    cost_effort = torch.linalg.vector_norm(action, dim=-1)
    cost_orient = torch.where(on_floor, torch.ones_like(dist), -rot[..., 2, 2])
    cost_spin = torch.linalg.vector_norm(omega, dim=-1)
    cost_crash = on_floor.to(pos.dtype)
    c = {f: agent_coeff(getattr(coeffs, f)) for f in
         ("pos", "effort", "crash", "orient", "spin")}
    reward = -dt * (c["pos"] * dist + c["effort"] * cost_effort
                    + c["crash"] * cost_crash + c["orient"] * cost_orient
                    + c["spin"] * cost_spin)
    info = RewardInfo(
        rew_pos=-dt * c["pos"] * dist,
        rew_action=-dt * c["effort"] * cost_effort,
        rew_crash=-dt * c["crash"] * cost_crash,
        rew_orient=-dt * c["orient"] * cost_orient,
        rew_spin=-dt * c["spin"] * cost_spin,
        rewraw_pos=-dt * dist, rewraw_action=-dt * cost_effort,
        rewraw_crash=-dt * cost_crash, rewraw_orient=-dt * cost_orient,
        rewraw_spin=-dt * cost_spin)
    return reward, info


def agent_coeff(x):
    """A coefficient as it broadcasts against (E, N) per-drone terms: a
    per-env one (E,) as (E, 1); a per-agent one (E, N) or a float as it
    is."""
    return x[:, None] if torch.is_tensor(x) and x.dim() == 1 else x


def proximity_penalties(dist_matrix, pair_mask, falloff_threshold,
                        max_penalty, dt: float):
    """Smooth proximity penalty summed per drone.  dist_matrix, pair_mask:
    (..., N, N); max_penalty: scalar, (E,) per env or (E, N) per agent.
    A per-agent max_penalty broadcasts along the partner axis, as the JAX
    package's (N,) leaf meets its (N, N) matrix: drone i's penalty sums
    its partners' coefficients, not its own (ROADMAP.md lists it)."""
    if torch.is_tensor(max_penalty) and max_penalty.dim() == 1:
        max_penalty = max_penalty[:, None, None]
    elif torch.is_tensor(max_penalty) and max_penalty.dim() == 2:
        max_penalty = max_penalty[:, None, :]
    penalty = (-max_penalty / falloff_threshold) * dist_matrix + max_penalty
    n = dist_matrix.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=dist_matrix.device)
    penalty = torch.where(pair_mask & ~eye, penalty,
                          torch.zeros_like(penalty))
    return dt * torch.sum(penalty, -1)
