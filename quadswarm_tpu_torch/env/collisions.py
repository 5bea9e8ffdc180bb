"""Drone-drone and room collision detection and response.

Port of quadswarm_tpu/env/collisions.py.  Functions take (..., N, 3)
inputs with any leading env axes.
`drone_collision_response` derives each drone's response partner from the
dense new-pair mask; `drone_collision_response_indexed` takes it as the
pair kernel emits it (ops/kernels/swarm_interactions.py::pair_collisions).

Randomness seam: every response takes its raw draws as optional tensors and
draws them from the caller's generator when they are absent.
  drone response: `normals` (..., N, 3, 3, 3) standard normals and
    `uniforms` (..., N, 6) unit uniforms, one row per drone.  The draws a
    pair shares (the reference draws once per pair) come from the row of the
    pair's lower index.  The JAX package derives them from the pair id, so a
    drone with two new partners in one tick can share its row with another
    pair here; each pair's momentum pairing still holds.
  obstacle response: `normals` (..., N, 3, 2, 3) standard normals (three
    noise attempts of two terms) and `uniforms` (..., N, 5).
  wall response: `uniforms` (..., N, 11); ceiling response (..., N, 10).
`set_response_tape` installs recorded drone- and obstacle-response draws,
like the JAX package's seam of the same name.
"""
from __future__ import annotations

import math

import torch

EPS = 1e-5
OMEGA_MAX_SCALE = 20.0 * math.pi

_RESPONSE_TAPE: dict | None = None


def set_response_tape(tape: dict | None) -> None:
    """Install (or clear) recorded response draws: 'drone_normals'
    (..., N, 3, 3, 3) and 'drone_uniforms' (..., N, 6); 'obst_normals'
    (..., N, 3, 2, 3) and 'obst_uniforms' (..., N, 5).  Only tests set
    it."""
    global _RESPONSE_TAPE
    _RESPONSE_TAPE = tape


def pairwise_distances(pos: torch.Tensor) -> torch.Tensor:
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    return torch.sqrt(torch.sum(diff**2, -1) + 0.0)


def collision_matrix(pos: torch.Tensor, collision_threshold):
    """(dist (..., N, N), collide (..., N, N) bool, diagonal False)."""
    dist = pairwise_distances(pos)
    n = pos.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    return dist, (dist <= collision_threshold) & ~eye


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _safe_unit(x):
    """x / |x|, with EPS added only where |x| is exactly zero."""
    mag = _norm(x)
    return x / torch.where(mag == 0.0, mag + EPS, mag)


def drone_collision_response(pos, vel, omega, new_pair_mask,
                             gen: torch.Generator | None = None,
                             normals=None, uniforms=None):
    """Elastic-with-noise response for NEW colliding pairs.  Each drone
    resolves against its first partner in the reference's pair order: first
    new j > d, else first new i < d."""
    n = pos.shape[-2]
    idx = torch.arange(n, device=pos.device)
    upper = new_pair_mask & (idx[:, None] < idx[None, :])
    any_row = torch.any(upper, -1)
    first_col = torch.argmax(upper.to(torch.uint8), -1)
    any_col = torch.any(upper, -2)
    first_row = torch.argmax(upper.to(torch.uint8), -2)
    active = any_row | any_col
    partner = torch.where(any_row, first_col, first_row)
    return drone_collision_response_indexed(pos, vel, omega, active, partner,
                                            gen, normals, uniforms)


def drone_collision_response_indexed(pos, vel, omega, active, partner,
                                     gen: torch.Generator | None = None,
                                     normals=None, uniforms=None):
    """Collision response given per-drone `active` (..., N) bool and
    `partner` (..., N) int64."""
    n = pos.shape[-2]
    dtype = vel.dtype
    idx = torch.arange(n, device=pos.device)
    take = lambda x: torch.gather(x, -2, partner[..., None].expand(x.shape))
    p_pos, p_vel = take(pos), take(vel)

    is_a = (partner > idx)[..., None]          # this drone is the pair's i
    pos_a = torch.where(is_a, pos, p_pos)
    pos_b = torch.where(is_a, p_pos, pos)
    vel_a = torch.where(is_a, vel, p_vel)
    vel_b = torch.where(is_a, p_vel, vel)
    coll_norm = _safe_unit(pos_a - pos_b)
    vn_a = torch.sum(vel_a * coll_norm, -1)
    vn_b = torch.sum(vel_b * coll_norm, -1)
    vel_change = (vn_b - vn_a)[..., None] * coll_norm

    if normals is None:
        normals = _taped("drone_normals", vel)
        uniforms = _taped("drone_uniforms", vel)
    if normals is None:
        # One row per drone; a pair reads the row of its lower index.
        lo = torch.minimum(idx.expand(partner.shape), partner)
        rows_n = torch.randn(pos.shape[:-1] + (27,), generator=gen,
                             dtype=dtype, device=pos.device)
        rows_u = torch.rand(pos.shape[:-1] + (6,), generator=gen,
                            dtype=dtype, device=pos.device)
        normals = torch.gather(rows_n, -2, lo[..., None].expand(rows_n.shape))
        normals = normals.reshape(pos.shape[:-1] + (3, 3, 3))
        uniforms = torch.gather(rows_u, -2, lo[..., None].expand(rows_u.shape))

    # Three noise attempts: take the first whose post-collision normal
    # velocities separate, else the last.
    # normals (..., N, attempt, [conserved, small_a, small_b], xyz)
    cons = 0.8 * normals[..., 0, :]
    small_a = 0.15 * normals[..., 1, :]
    small_b = 0.15 * normals[..., 2, :]
    cand_a = vel_change[..., None, :] + cons + small_a       # (..., N, 3, 3)
    cand_b = -vel_change[..., None, :] - cons + small_b
    d_a = torch.sum((vel_a[..., None, :] + cand_a) * coll_norm[..., None, :], -1)
    d_b = torch.sum((vel_b[..., None, :] + cand_b) * coll_norm[..., None, :], -1)
    valid = (d_a > 0) & (d_b < 0)
    pick = torch.where(torch.any(valid, -1),
                       torch.argmax(valid.to(torch.uint8), -1),
                       torch.full_like(partner, 2))
    sel = lambda c: torch.gather(
        c, -2, pick[..., None, None].expand(c.shape[:-2] + (1, 3)))[..., 0, :]
    shift = torch.where(is_a, sel(cand_a), sel(cand_b))

    max_vel = torch.maximum(torch.linalg.vector_norm(vel_a, dim=-1),
                            torch.linalg.vector_norm(vel_b, dim=-1))
    decay = 0.2 + 0.6 * torch.where(is_a[..., 0], uniforms[..., 0],
                                    uniforms[..., 1])
    vel_hit = vel + shift
    hit_mag = _norm(vel_hit)
    direction = vel_hit / torch.where(hit_mag == 0.0, hit_mag + EPS, hit_mag)
    new_speed = torch.minimum(hit_mag[..., 0] * decay, max_vel)
    new_vel = direction * new_speed[..., None]

    kick_dir = _safe_unit(2.0 * uniforms[..., 2:5] - 1.0)
    kick = kick_dir * (OMEGA_MAX_SCALE * (0.5 + 0.5 * uniforms[..., 5]))[..., None]
    omega_new = omega + torch.where(is_a, kick, -kick)
    act = active[..., None]
    return (torch.where(act, new_vel, vel), torch.where(act, omega_new, omega))


def _taped(name: str, like: torch.Tensor):
    if _RESPONSE_TAPE is None or name not in _RESPONSE_TAPE:
        return None
    return torch.as_tensor(_RESPONSE_TAPE[name], dtype=like.dtype,
                           device=like.device)


def obstacle_collision_response(pos, vel, omega, obstacle_pos, obstacle_size,
                                hit_mask, gen: torch.Generator | None = None,
                                normals=None, uniforms=None):
    """Reflect the velocity of each hitting drone off the vertical cylinder
    it hit, with directional noise and a random omega kick.

    obstacle_pos (..., N, 3): the position of the obstacle each drone hit;
    obstacle_size broadcasts to (..., N); hit_mask (..., N) bool."""
    if normals is None:
        normals = _taped("obst_normals", vel)
        uniforms = _taped("obst_uniforms", vel)
    if normals is None:
        normals = torch.randn(pos.shape[:-1] + (3, 2, 3), generator=gen,
                              dtype=vel.dtype, device=vel.device)
    if uniforms is None:
        uniforms = torch.rand(pos.shape[:-1] + (5,), generator=gen,
                              dtype=vel.dtype, device=vel.device)
    rel = pos - obstacle_pos
    coll_norm = _safe_unit(torch.cat([rel[..., :2],
                                      torch.zeros_like(rel[..., 2:])], -1))
    vel_magn = _norm(vel)
    new_vel = vel_magn * coll_norm
    # Three noise attempts: the first that leaves the obstacle, else none.
    # normals (..., N, attempt, [large, small], xyz)
    cand = 0.1 * normals[..., 0, :] + 0.05 * normals[..., 1, :]
    valid = torch.sum((new_vel[..., None, :] + cand)
                      * coll_norm[..., None, :], -1) > 0
    pick = torch.argmax(valid.to(torch.uint8), -1)
    first = torch.gather(cand, -2, pick[..., None, None].expand(
        cand.shape[:-2] + (1, 3)))[..., 0, :]
    noise = torch.where(torch.any(valid, -1)[..., None], first,
                        torch.zeros_like(first))

    # Inside the cylinder the speed does not decay.
    inside = torch.linalg.vector_norm(rel, dim=-1) < obstacle_size / 2
    shift = new_vel - vel + noise
    decay = 0.2 + 0.6 * uniforms[..., 0]
    vel_hit = vel + shift
    hit_mag = _norm(vel_hit)
    direction = vel_hit / torch.where(hit_mag == 0.0, hit_mag + EPS, hit_mag)
    speed = torch.where(inside, hit_mag[..., 0], hit_mag[..., 0] * decay)
    vel_new = direction * torch.minimum(speed, vel_magn[..., 0])[..., None]
    kick_dir = _safe_unit(2.0 * uniforms[..., 1:4] - 1.0)
    omega_new = omega + kick_dir * (
        math.pi * (0.5 + 0.5 * uniforms[..., 4]))[..., None]
    hit = hit_mask[..., None]
    return (torch.where(hit, vel_new, vel), torch.where(hit, omega_new, omega))


def _room_kick(omega, u, hit):
    kick_dir = 2.0 * u[..., :3] - 1.0
    kick_dir = kick_dir / (_norm(kick_dir) + EPS)
    omega_new = omega + kick_dir * (OMEGA_MAX_SCALE * (0.5 + 0.5 * u[..., 3]))[..., None]
    return torch.where(hit, omega_new, omega)


def wall_collision_response(pos, vel, omega, room_box, hit_mask,
                            gen: torch.Generator | None = None, uniforms=None):
    """Randomized damped bounce off the walls; uniforms (..., N, 11)."""
    u = uniforms if uniforms is not None else torch.rand(
        vel.shape[:-1] + (11,), generator=gen, dtype=vel.dtype,
        device=vel.device)
    lo, hi = room_box
    speed = torch.linalg.vector_norm(vel, dim=-1)
    real_speed = torch.clamp((0.2 + 0.6 * u[..., 0]) * speed, 0.1, 6.0)
    direction = 2.0 * u[..., 1:4] - 1.0
    dx_pos = 0.1 + 0.9 * u[..., 4]
    dy_pos = 0.1 + 0.9 * u[..., 5]
    dirx = torch.where(pos[..., 0] == lo[0], dx_pos, torch.where(
        pos[..., 0] == hi[0], -dx_pos, direction[..., 0]))
    diry = torch.where(pos[..., 1] == lo[1], dy_pos, torch.where(
        pos[..., 1] == hi[1], -dy_pos, direction[..., 1]))
    dirz = -1.0 + 0.5 * u[..., 6]
    direction = torch.stack([dirx, diry, dirz], -1)
    direction = direction / (_norm(direction) + EPS)
    hit = hit_mask[..., None]
    vel_out = torch.where(hit, real_speed[..., None] * direction, vel)
    return vel_out, _room_kick(omega, u[..., 7:11], hit)


def ceiling_collision_response(vel, omega, hit_mask,
                               gen: torch.Generator | None = None,
                               uniforms=None):
    """Randomized damped bounce off the ceiling; uniforms (..., N, 10)."""
    u = uniforms if uniforms is not None else torch.rand(
        vel.shape[:-1] + (10,), generator=gen, dtype=vel.dtype,
        device=vel.device)
    speed = torch.linalg.vector_norm(vel, dim=-1)
    real_speed = torch.clamp((0.2 + 0.6 * u[..., 0]) * speed, 0.1, 6.0)
    direction = torch.cat([2.0 * u[..., 1:3] - 1.0,
                           (-1.0 + 0.5 * u[..., 4])[..., None]], -1)
    direction = direction / (_norm(direction) + EPS)
    hit = hit_mask[..., None]
    vel_out = torch.where(hit, real_speed[..., None] * direction, vel)
    return vel_out, _room_kick(omega, u[..., 5:9], hit)
