"""Goal formations.

Port of quadswarm_tpu/env/formations.py.  `generate_goals` evaluates one
formation id (a Python int) at batched centers and sizes; the hot path uses
`generate_goals_affine`, which exploits that every formation is jointly
affine in (size, layer_dist) with fixed per-formation tables, so a batch of
envs with different formation ids costs one table gather and one FMA.
"""
from __future__ import annotations

import functools
import math

import torch

FORMATIONS = (
    "circle_horizontal", "circle_vertical_xz", "circle_vertical_yz",
    "sphere", "grid_horizontal", "grid_vertical_xz", "grid_vertical_yz",
    "cube",
)
NUM_FORMATIONS = len(FORMATIONS)


def is_circle(fid):
    return fid <= 2


def is_grid(fid):
    return (fid >= 4) & (fid <= 6)


def npl_for_formation(fid):
    """Agents per layer: 50 for grids, 8 otherwise."""
    return torch.where(is_grid(fid), 50, 8).to(torch.int32)


def grid_dims(n: int) -> tuple:
    """Largest divisor pair (d1, d2) of n with d1 <= sqrt(n)."""
    n = max(int(n), 1)
    d1 = max(c for c in range(1, 64) if c * c <= n and n % c == 0)
    return d1, n // d1


def grid_dims_t(n: torch.Tensor):
    """grid_dims for an integer tensor (divisor search over 1..63)."""
    n = torch.clamp(n.to(torch.int64), min=1)
    cand = torch.arange(1, 64, device=n.device)
    ok = (cand * cand <= n[..., None]) & (n[..., None] % cand == 0)
    d1 = torch.max(torch.where(ok, cand, torch.ones_like(cand)), -1).values
    return d1, n // d1


def sphere_radius(num, dist):
    a, b, c, d = (1.75388487222762, 0.860487305801679, 10.3632729642351,
                  0.0920858134405214)
    return dist / ((a - d) / (1.0 + (num / c) ** b) + d)


def fibonacci_sphere(n: int, dtype=torch.float32) -> torch.Tensor:
    """Unit fibonacci-spiral points (n clamped up to 3, as the reference)."""
    m = max(n, 3)
    x = 0.1 + 1.2 * m
    j = torch.arange(m, dtype=dtype)
    s = (-1.0 + 1.0 / (m - 1.0)) + j * ((2.0 - 2.0 / (m - 1.0)) / (m - 1.0))
    ang_a = s * x
    ang_b = math.pi / 2.0 * torch.sign(s) * (1.0 - torch.sqrt(1.0 - s.abs()))
    pts = torch.stack([torch.cos(ang_a) * torch.cos(ang_b),
                       torch.sin(ang_a) * torch.cos(ang_b),
                       torch.sin(ang_b)], -1)
    return pts[:n]


def _place_in_plane(fid: int, p0, p1, layer):
    if fid in (0, 4):
        return torch.stack([p0, p1, layer], -1)
    if fid in (1, 5):
        return torch.stack([p0, layer, p1], -1)
    return torch.stack([layer, p0, p1], -1)


def generate_goals(num_agents: int, fid: int, center, size, layer_dist,
                   npl: int, dtype=torch.float32) -> torch.Tensor:
    """(..., N, 3) goals of formation `fid` (a Python int) for batched
    center (..., 3), size (...) and layer_dist (...), on the CPU (it builds
    the affine tables and serves as their reference)."""
    n = num_agents
    center = torch.as_tensor(center, dtype=dtype)
    size = torch.as_tensor(size, dtype=dtype)[..., None]
    ld = torch.as_tensor(layer_dist, dtype=dtype)[..., None]
    i = torch.arange(n)
    npl = max(int(npl), 1)
    layer = i // npl
    cur = (torch.full((n,), n) if n <= npl
           else torch.where(layer < n // npl, npl, n % npl))
    cur = torch.clamp(cur, min=1)
    layer_pos = layer.to(dtype) * ld
    if fid <= 2:
        degree = 2.0 * math.pi * (i % cur).to(dtype) / cur.to(dtype)
        goals = _place_in_plane(fid, size * torch.cos(degree),
                                size * torch.sin(degree), layer_pos)
        return goals + center[..., None, :]
    if fid == 3:
        return size[..., None] * fibonacci_sphere(n, dtype) + center[..., None, :]
    if fid <= 6:
        dims = [grid_dims(int(c)) for c in cur]
        d1 = torch.tensor([d[0] for d in dims])
        d2 = torch.tensor([d[1] for d in dims])
        goals = _place_in_plane(fid, size * (i % d2).to(dtype),
                                size * ((i // d2) % d1).to(dtype), layer_pos)
        return goals - goals.mean(-2, keepdim=True) + center[..., None, :]
    fdim = max(int(n ** (1.0 / 3.0)), 1)
    x = center[..., 2:3] + size * (i // (fdim * fdim)).to(dtype)
    goals = torch.stack([x.expand(x.shape[:-1] + (n,)),
                         (size * ((i // fdim) % fdim).to(dtype)).expand(
                             x.shape[:-1] + (n,)),
                         (size * (i % fdim).to(dtype)).expand(
                             x.shape[:-1] + (n,))], -1)
    return goals - goals.mean(-2, keepdim=True) + center[..., None, :]


@functools.lru_cache(maxsize=None)
def goal_affine_tables(num_agents: int) -> tuple:
    """(A, B), each (8, N, 3) float32 numpy: goals(fid, c, size, ld) ==
    c + size * A[fid] + ld * B[fid], with agents per layer implied by fid."""
    a_rows, b_rows = [], []
    zero3 = torch.zeros(3)
    for fid in range(NUM_FORMATIONS):
        npl = 50 if 4 <= fid <= 6 else 8
        a_rows.append(generate_goals(num_agents, fid, zero3, 1.0, 0.0, npl))
        b_rows.append(generate_goals(num_agents, fid, zero3, 0.0, 1.0, npl))
    return (torch.stack(a_rows).numpy(), torch.stack(b_rows).numpy())


def generate_goals_affine(num_agents: int, fid, center, size, layer_dist
                          ) -> torch.Tensor:
    """(..., N, 3) goals for batched fid (...) int, center (..., 3), size
    (...) and layer_dist (...) tensors or floats."""
    center = torch.as_tensor(center)
    a_tab, b_tab = goal_affine_tables(num_agents)
    dev, dtype = center.device, center.dtype
    fid = torch.as_tensor(fid, device=dev).to(torch.int64).clamp(0, 7)
    a = torch.as_tensor(a_tab, dtype=dtype, device=dev)[fid]
    b = torch.as_tensor(b_tab, dtype=dtype, device=dev)[fid]
    size = torch.as_tensor(size, dtype=dtype, device=dev)[..., None, None]
    ld = torch.as_tensor(layer_dist, dtype=dtype, device=dev)[..., None, None]
    return center[..., None, :] + size * a + ld * b


def formation_size_range(mode_is_svs, fid, num_agents: int, low, high, npl):
    """Formation-size bounds from inter-drone distance bounds; swarm_vs_swarm
    halves the per-swarm agent count."""
    n = torch.where(mode_is_svs, num_agents // 2, num_agents).to(low.dtype)
    npl = npl.to(low.dtype)
    circ_lo = (0.5 * low) / torch.sin(math.pi / npl)
    circ_hi = (0.5 * high) / torch.sin(math.pi / npl)
    lo = torch.where(is_circle(fid), circ_lo,
                     torch.where(fid == 3, sphere_radius(n, low), low))
    hi = torch.where(is_circle(fid), circ_hi,
                     torch.where(fid == 3, sphere_radius(n, high), high))
    return lo, hi


def get_z_value(u, fid, num_agents: int, npl, box_size, formation_size):
    """Goal-center z with a formation-dependent floor; u is a unit uniform."""
    z = u * box_size - 0.5 * box_size + 2.0
    d1, _ = grid_dims_t(torch.clamp(npl, max=num_agents))
    z_lb = torch.where((fid == 3) | (fid == 1) | (fid == 2),
                       formation_size + 0.25,
                       torch.where((fid == 5) | (fid == 6),
                                   d1.to(z.dtype) * formation_size + 0.25,
                                   torch.full_like(z, 0.25)))
    return torch.maximum(z_lb, z)

