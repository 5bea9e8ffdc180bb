"""Static cylinder obstacles: grid generation, SDF observation, collision
detection, batched over envs.

Port of quadswarm_tpu/env/obstacles.py.  Every env holds one obstacle slot
per grid cell, (E, C), with an active mask: a change of density between
episodes changes no shape, and an inactive cell is at +inf distance.
Obstacles are vertical cylinders, so only xy positions matter.
"""
from __future__ import annotations

import numpy as np
import torch

SDF_RESOLUTION = 0.1
EMPTY_DISTANCE = 100.0


def cell_centers(length: int, width: int, grid_size: float = 1.0):
    """Obstacle grid cell centers, (C, 2), in the reference's order: x outer,
    y inner and descending."""
    xs = np.arange(0, length, grid_size)
    ys = np.arange(width - grid_size, -grid_size, -grid_size)
    return np.array([[i + grid_size / 2 - length // 2,
                      j + grid_size / 2 - width // 2] for i in xs for j in ys])


def obstacle_count(density: torch.Tensor, num_cells: int) -> torch.Tensor:
    """int(density * C) in float32, per env: the JAX package truncates the
    float32 product, so the same product is taken here."""
    return (density.to(torch.float32) * num_cells).to(torch.int32)


def generate_obstacle_grid(gen: torch.Generator, density: torch.Tensor,
                           centers: torch.Tensor, room_height: float):
    """Place int(density * C) obstacles on distinct random cells of every
    env.  density (E,); centers (C, 2).  Returns (active (E, C) bool,
    obst_pos (E, C, 3) at half the room's height)."""
    e, c = density.shape[0], centers.shape[0]
    scores = torch.rand((e, c), generator=gen, device=centers.device)
    # rank of each cell among the env's scores, highest first
    rank = torch.argsort(torch.argsort(scores, dim=-1, descending=True), -1)
    active = rank < obstacle_count(density, c)[:, None]
    return active, grid_positions(centers, room_height).expand(e, c,
                                                               3).clone()


def grid_positions(centers: torch.Tensor, room_height: float):
    """(C, 3): the cell centres at half the room's height."""
    return torch.cat([centers, torch.full(
        (centers.shape[0], 1), room_height / 2.0, dtype=centers.dtype,
        device=centers.device)], -1)


def _sdf_offsets(dtype, device):
    """The 9 (dx, dy) grid offsets in the reference's order (x offset
    outer), made on the device so that no host copy is needed."""
    i = torch.arange(9, device=device)
    step = lambda k: (k.to(dtype) - 1.0) * SDF_RESOLUTION
    return step(torch.div(i, 3, rounding_mode="floor")), step(i % 3)


def surround_sdf_obs(quad_xy: torch.Tensor, obst_xy: torch.Tensor,
                     active: torch.Tensor, obst_radius) -> torch.Tensor:
    """9-point SDF patch around every drone: the distance from each point
    of a 3 x 3 grid (spacing 0.1) to the nearest active obstacle's axis,
    capped at 100, minus the obstacle radius.

    quad_xy (E, N, 2); obst_xy (E, C, 2); active (E, C); obst_radius (E,).
    Returns (E, N, 9); with no active obstacle every entry is 100 - r."""
    ox, oy = _sdf_offsets(quad_xy.dtype, quad_xy.device)
    dx = ((quad_xy[..., 0:1] + ox)[..., None]
          - obst_xy[:, None, None, :, 0])                 # (E, N, 9, C)
    dy = ((quad_xy[..., 1:2] + oy)[..., None]
          - obst_xy[:, None, None, :, 1])
    d2 = dx * dx + dy * dy
    d2 = torch.where(active[:, None, None, :], d2,
                     torch.full_like(d2, float("inf")))
    # sqrt is monotone, so the root of the least square is the least root
    min_dist = torch.clamp(torch.sqrt(torch.amin(d2, -1)), max=EMPTY_DISTANCE)
    return min_dist - obst_radius[:, None, None]


def obstacle_collisions(quad_xy: torch.Tensor, obst_xy: torch.Tensor,
                        active: torch.Tensor, obst_radius, quad_radius):
    """Per drone: (hit (E, N) bool, nearest active obstacle (E, N) int64).
    A drone hits when the nearest active axis is within quad_radius +
    obst_radius; grid obstacles do not overlap, so the nearest is the one
    hit."""
    dx = quad_xy[..., 0:1] - obst_xy[:, None, :, 0]       # (E, N, C)
    dy = quad_xy[..., 1:2] - obst_xy[:, None, :, 1]
    d = torch.sqrt(dx * dx + dy * dy)
    d = torch.where(active[:, None, :], d, torch.full_like(d, float("inf")))
    min_d, nearest = torch.min(d, -1)
    hit = min_d <= (quad_radius + obst_radius)[:, None]
    return hit, nearest
