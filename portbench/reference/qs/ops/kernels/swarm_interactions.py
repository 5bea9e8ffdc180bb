"""The plain versions of the pair kernels K2 and K3, frozen: the port's
`ops/kernels/swarm_interactions.py` as it stood when the benchmark was
written, without the CUDA launches.  `pair_collisions` and
`neighbor_topk_obs` take the plain route on every device.

Packed pair history (`pack_pairs` / `unpack_pairs`), the JAX package's
layout: row d of an (..., N, PACK_LANES) int32 tensor holds N bits, bit b of
word w being column 16*w + b; the upper 16 bits of every word and all words
from ceil(N / 16) on are zero.
"""
from __future__ import annotations

import numpy as np
import torch

PACK_BITS = 16
PACK_LANES = 128          # N <= 16 * 128 = 2048 drones
MAX_AGENTS = PACK_BITS * PACK_LANES
MAX_NEIGHBORS = 16


def _f32(x) -> float:
    """A host scalar rounded to float32, as the kernels receive it."""
    return float(np.float32(x))


def _slope(falloff: float, max_penalty: float) -> float:
    """-max_penalty / falloff, divided in float32."""
    return float(np.float32(-max_penalty) / np.float32(falloff))


def _n_words(n: int) -> int:
    if n > MAX_AGENTS:
        raise ValueError(f"packed pair history supports N <= {MAX_AGENTS}, "
                         f"got {n}")
    return -(-n // PACK_BITS)


def pack_pairs(pairs: torch.Tensor) -> torch.Tensor:
    """(..., N, N) bool -> (..., N, PACK_LANES) int32 packed bits."""
    n = pairs.shape[-1]
    words = _n_words(n)
    p = torch.nn.functional.pad(pairs.to(torch.int32),
                                (0, words * PACK_BITS - n))
    p = p.reshape(p.shape[:-1] + (words, PACK_BITS))
    shifts = torch.arange(PACK_BITS, dtype=torch.int32, device=pairs.device)
    packed = torch.sum(p << shifts, -1).to(torch.int32)
    return torch.nn.functional.pad(packed, (0, PACK_LANES - words))


def unpack_pairs(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(..., N, PACK_LANES) int32 -> (..., N, N) bool."""
    words = packed[..., :_n_words(n), None]
    shifts = torch.arange(PACK_BITS, dtype=torch.int32, device=packed.device)
    bits = (words >> shifts) & 1
    return bits.reshape(bits.shape[:-2] + (-1,))[..., :n].to(torch.bool)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _pair_deltas(x: torch.Tensor) -> torch.Tensor:
    """(E, N, 3) -> (E, N, N, 3): entry [e, i, j] is x[e, j] - x[e, i]."""
    return x[:, None, :, :] - x[:, :, None, :]


def _norm3(d: torch.Tensor) -> torch.Tensor:
    sq = d * d
    return torch.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])


def _first_true(mask: torch.Tensor):
    """Along the last axis: (any, index of the first True or 0)."""
    return torch.any(mask, -1), torch.argmax(mask.to(torch.uint8), -1)


def pair_collisions_plain(pos, prev_packed, hitbox, falloff, max_penalty):
    """`pair_collisions` from dense (E, N, N) tensors."""
    n = pos.shape[1]
    hitbox, falloff = _f32(hitbox), _f32(falloff)
    max_penalty = _f32(max_penalty)
    dist = _norm3(_pair_deltas(pos))
    idx = torch.arange(n, device=pos.device)
    other = idx[:, None] != idx[None, :]
    curr = (dist <= hitbox) & other
    pen = _slope(falloff, max_penalty) * dist + max_penalty
    pen = torch.where((dist <= falloff) & other, pen, torch.zeros_like(pen))
    new = curr & ~unpack_pairs(prev_packed, n)
    any_above, first_above = _first_true(new & (idx[None, :] > idx[:, None]))
    any_below, first_below = _first_true(new & (idx[None, :] < idx[:, None]))
    resp_any = any_above | any_below
    partner = torch.where(any_above, first_above, first_below)
    partner = torch.where(resp_any, partner, torch.zeros_like(partner))
    return (torch.any(curr, -1), torch.sum(pen, -1), resp_any,
            partner.to(torch.int32), pack_pairs(curr))


def neighbor_topk_metric(pos, vel):
    """(E, N, N) selection metric m[e, i, j] = max(d, 0.01) + (dp . dv) /
    max(d, 0.01), +inf on the diagonal, in the kernel's operation order."""
    dp, dv = _pair_deltas(pos), _pair_deltas(vel)
    ds = torch.clamp(_norm3(dp), min=0.01)
    pv = dp * dv
    metric = ds + ((pv[..., 0] + pv[..., 1]) + pv[..., 2]) / ds
    eye = torch.eye(pos.shape[1], dtype=torch.bool, device=pos.device)
    return torch.where(eye, torch.full_like(metric, float("inf")), metric)


def neighbor_topk_obs_plain(pos, vel, k: int):
    """`neighbor_topk_obs` from dense tensors; ties go to the lowest index
    (a stable ascending sort)."""
    metric = neighbor_topk_metric(pos, vel)
    idx = torch.sort(metric, dim=-1, stable=True).indices[..., :k]
    rel = torch.cat([_pair_deltas(pos), _pair_deltas(vel)], -1)
    obs = torch.gather(rel, 2, idx[..., None].expand(idx.shape + (6,)))
    return obs.reshape(obs.shape[:2] + (k * 6,))


def swarm_interactions_plain(pos, hitbox, falloff, max_penalty):
    """`swarm_interactions` from dense tensors, pos (E, N, 3)."""
    n = pos.shape[1]
    hitbox, falloff = _f32(hitbox), _f32(falloff)
    max_penalty = _f32(max_penalty)
    dist = _norm3(_pair_deltas(pos))
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    pen = _slope(falloff, max_penalty) * dist + max_penalty
    pen = torch.where((dist <= falloff) & ~eye, pen, torch.zeros_like(pen))
    masked = torch.where(eye, torch.full_like(dist, 1e30), dist)
    min_dist, partner = torch.min(masked, -1)       # first minimum
    # Partner 0 where no distance of the row is below 1e30 (every other
    # squared distance overflowing), as the kernel, which starts from
    # (0, 1e30) and takes a strictly smaller distance only.
    partner = torch.where(min_dist < 1e30, partner, torch.zeros_like(partner))
    return (torch.any((dist <= hitbox) & ~eye, -1), partner.to(torch.int32),
            torch.sum(pen, -1), min_dist)


# --------------------------------------------------------------------------
# The wrappers' signatures, on the plain route
# --------------------------------------------------------------------------

def _float32_env(x: torch.Tensor) -> torch.Tensor:
    """A bfloat16 env's positions or velocities in float32."""
    return x.float() if x.dtype == torch.bfloat16 else x


def pair_collisions(pos, prev_packed, hitbox, falloff, max_penalty):
    """K2's outputs from the plain version."""
    return pair_collisions_plain(_float32_env(pos), prev_packed, hitbox,
                                 falloff, max_penalty)


def neighbor_topk_obs(pos, vel, k: int):
    """K3's output from the plain version."""
    return neighbor_topk_obs_plain(_float32_env(pos), _float32_env(vel), k)
