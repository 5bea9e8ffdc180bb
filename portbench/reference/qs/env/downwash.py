"""Downwash between stacked drones (cylinder force model).

Port of quadswarm_tpu/env/downwash.py.  Inputs are (..., N, 3).

Randomness seam: `draws` may hold the raw unit uniforms of one call,
"acc" (..., N, 1), "omega" (..., N, 1), "axis" (..., N, 3) and
"dir" (..., N, 3), one row per source drone; missing ones are drawn from
the caller's generator.
"""
from __future__ import annotations

import torch

XY_DOWNWASH = 0.1
Z_DOWNWASH = 0.7
EPS = 1e-6


def apply_downwash(pos, vel, omega, rot, dt: float,
                   gen: torch.Generator | None = None,
                   draws: dict | None = None):
    """Add downwash velocity/omega deltas; returns (vel, omega, applied)."""
    draws = {} if draws is None else draws

    def uniform(name, width, lo, hi):
        u = draws[name] if name in draws else torch.rand(
            pos.shape[:-1] + (width,), generator=gen, dtype=pos.dtype,
            device=pos.device)
        return u * (hi - lo) + lo

    z_axis = rot[..., :, 2]                               # source body z
    rel = pos[..., None, :, :] - pos[..., :, None, :]     # pos_j - pos_i
    dist = torch.linalg.vector_norm(rel, dim=-1)

    acc_noise = uniform("acc", 1, -0.1, 0.1)
    om_noise = uniform("omega", 1, -0.01, 0.01)
    acc = torch.clamp((6.0 / 17.0) * (-10.0 * dist + 7.0) + acc_noise, min=1e-6)
    om_mag = torch.clamp(0.3 * (dist - 1.0) ** 2 + om_noise, min=1e-6)

    rel_z = torch.sum(rel * z_axis[..., :, None, :], -1)
    rel_xy = torch.sqrt(torch.clamp(dist**2 - rel_z**2, min=0.0))
    n = pos.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    in_cyl = (rel_z > -Z_DOWNWASH) & (rel_z < 0.0) & (rel_xy < XY_DOWNWASH) \
        & ~eye

    noisy_axis = z_axis + uniform("axis", 3, -0.1, 0.1)
    mag = torch.linalg.vector_norm(noisy_axis, dim=-1, keepdim=True)
    down_axis = -noisy_axis / torch.where(mag == 0.0, mag + EPS, mag)
    dir_om = uniform("dir", 3, -1.0, 1.0)
    dmag = torch.linalg.vector_norm(dir_om, dim=-1, keepdim=True)
    dir_om = dir_om / torch.where(dmag == 0.0, dmag + EPS, dmag)

    w = in_cyl.to(pos.dtype)                              # (sources, victims)
    dvel = torch.einsum("...ij,...ij,...ik->...jk", w, acc, down_axis) * dt
    domega = torch.einsum("...ij,...ij,...ik->...jk", w, om_mag, dir_om) * dt
    return vel + dvel, omega + domega, torch.any(in_cyl, -2)
