"""Neighbor observation: k-nearest selection by the reference's
distance + radial-velocity metric.

Port of quadswarm_tpu/env/neighbors.py.  Functions take (..., N, 3) inputs.
"""
from __future__ import annotations

import functools

import torch


def neighbor_indices(pos: torch.Tensor, vel: torch.Tensor,
                     k: int) -> torch.Tensor:
    """(..., N, k) int64: which agent fills each neighbor slot of each drone.

    With k >= N - 1 all neighbors in index order, skipping self.  Otherwise
    the k smallest of m(i, j) = max(|p_j - p_i|, 0.01) + unit . (v_j - v_i),
    ties broken by lowest index (a stable ascending sort, the order
    `lax.top_k` gives; `torch.topk` promises no order among ties).
    """
    n = pos.shape[-2]
    if k >= n - 1:
        idx = torch.tensor([[j for j in range(n) if j != i] for i in range(n)],
                           dtype=torch.int64, device=pos.device)
        return idx.expand(pos.shape[:-2] + idx.shape)
    rel_pos = pos[..., None, :, :] - pos[..., :, None, :]
    rel_vel = vel[..., None, :, :] - vel[..., :, None, :]
    dist = torch.linalg.vector_norm(rel_pos, dim=-1)
    dist_safe = torch.clamp(dist, min=0.01)
    unit = rel_pos / dist_safe[..., None]
    metric = dist_safe + torch.sum(unit * rel_vel, -1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    metric = torch.where(eye, torch.full_like(metric, float("inf")), metric)
    return torch.sort(metric, dim=-1, stable=True).indices[..., :k]


def neighbor_obs(pos: torch.Tensor, vel: torch.Tensor,
                 num_use_neighbor_obs: int, clip_lo=None,
                 clip_hi=None) -> torch.Tensor:
    """(..., N, 3) x 2 -> (..., N, k * 6) relative [pos, vel] of the k
    selected neighbors, optionally clipped to the observation box."""
    rel = torch.cat([pos[..., None, :, :] - pos[..., :, None, :],
                     vel[..., None, :, :] - vel[..., :, None, :]], -1)
    idx = neighbor_indices(pos, vel, num_use_neighbor_obs)
    obs = torch.gather(rel, -2, idx[..., None].expand(idx.shape + (6,)))
    obs = obs.reshape(obs.shape[:-2] + (-1,))
    if clip_lo is not None:
        obs = torch.minimum(torch.maximum(obs, clip_lo), clip_hi)
    return obs


@functools.lru_cache(maxsize=None)
def neighbor_clip_bounds(num_use_neighbor_obs: int, room_dims: tuple,
                         vxyz_max: float, dtype=torch.float32, device="cpu"):
    """Clip box for neighbor obs: rel pos in +-room, rel vel in
    +-2 * vxyz_max.  Built once per argument set, because a host-to-device
    copy on every env step would synchronise the host with the device; the
    returned tensors are shared and must not be written to."""
    one = torch.tensor(list(room_dims) + [2.0 * vxyz_max] * 3, dtype=dtype,
                       device=device)
    full = one.repeat(num_use_neighbor_obs)
    return -full, full
