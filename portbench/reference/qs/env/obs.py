"""Self-observation construction.

Port of quadswarm_tpu/env/obs.py.
"""
from __future__ import annotations

import functools

import torch

OBS_REPR_SIZES = {
    "xyz_vxyz_R_omega": 18,
    "xyz_vxyz_R_omega_floor": 19,
    "xyz_vxyz_R_omega_wall": 24,
}
NEIGHBOR_OBS_SIZES = {"none": 0, "pos_vel": 6}
OBSTACLE_OBS_SIZES = {"none": 0, "octomap": 9}


def self_obs(obs_repr: str, pos, vel, rot, omega, goal, room_box):
    """[pos - goal, vel, R.flatten(), omega] plus the repr's extras."""
    base = [pos - goal, vel, rot.reshape(rot.shape[:-2] + (9,)), omega]
    if obs_repr == "xyz_vxyz_R_omega":
        parts = base
    elif obs_repr == "xyz_vxyz_R_omega_floor":
        parts = base + [pos[..., 2:3]]
    elif obs_repr == "xyz_vxyz_R_omega_wall":
        lo, hi = _room_bounds(tuple(map(tuple, room_box)), pos.dtype,
                              pos.device)
        parts = base + [torch.clamp(pos - lo, 0.0, 5.0),
                        torch.clamp(hi - pos, 0.0, 5.0)]
    else:
        raise ValueError(f"unknown obs_repr: {obs_repr}")
    return torch.cat(parts, -1)


@functools.lru_cache(maxsize=None)
def _room_bounds(room_box: tuple, dtype, device) -> tuple:
    """The room's corners as tensors, made once per (box, dtype, device):
    a host-to-device copy on every tick would synchronise the host with
    the device.  The tensors are shared and must not be written to."""
    return tuple(torch.tensor(c, dtype=dtype, device=device)
                 for c in room_box)


def obs_size(obs_repr: str, neighbor_obs_type: str, num_use_neighbor_obs: int,
             use_obstacles: bool) -> int:
    size = OBS_REPR_SIZES[obs_repr]
    size += NEIGHBOR_OBS_SIZES[neighbor_obs_type] * num_use_neighbor_obs
    if use_obstacles:
        size += OBSTACLE_OBS_SIZES["octomap"]
    return size
