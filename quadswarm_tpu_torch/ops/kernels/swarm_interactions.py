"""K2, K3, K4: the pairwise swarm kernels for Hopper, and their wrappers.

Replaces quadswarm_tpu/ops/pallas/swarm_interactions.py: the Pallas TPU
kernels `_pair_collision_kernel` (K2, wrapper `pair_collisions`),
`_neighbor_topk_kernel` (K3, `neighbor_topk_obs`) and `_interaction_kernel`
(K4, `swarm_interactions`).  Source: csrc/swarm_interactions.cu (one warp
per row drone; K3 computes a row's metrics once and keeps them on chip for
its k picks; see the note there on the design and on what bounds it).

They are the large-swarm path of the env step (`EnvConfig.use_pallas_pairs`):
K2 is the collision stage with an exact new-pair history kept as packed
bits, K3 the k-nearest neighbour observation; neither stores an (N, N)
tensor.  K4 is the standalone reduction (nothing in the env calls it).

Beside each wrapper stands its plain PyTorch version, which works from
dense (E, N, N) tensors with the kernel's own arithmetic: distances in the
difference form, sqrt((dx*dx + dy*dy) + dz*dz), summed in that order.  A
CPU tensor takes the plain version and a CUDA tensor the kernel; there is
no fallback from one to the other.  Each wrapper counts its launches.

Packed pair history (`pack_pairs` / `unpack_pairs`), the JAX package's
layout: row d of an (..., N, PACK_LANES) int32 tensor holds N bits, bit b of
word w being column 16*w + b; the upper 16 bits of every word and all words
from ceil(N / 16) on are zero.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from quadswarm_tpu_torch.ops.kernels import build

SOURCE = "swarm_interactions.cu"
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
    return (torch.any((dist <= hitbox) & ~eye, -1), partner.to(torch.int32),
            torch.sum(pen, -1), min_dist)


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

def _load():
    lib = build.load(SOURCE)
    if getattr(lib, "ready", False):
        return lib
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.qs_pair_collisions.argtypes = [ptr, ptr, i32, i32, f32, f32, f32, f32,
                                       ptr, ptr, ptr, ptr, ptr, ptr]
    lib.qs_swarm_interactions.argtypes = [ptr, i32, i32, f32, f32, f32, f32,
                                          ptr, ptr, ptr, ptr, ptr]
    lib.qs_neighbor_topk.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr,
                                     ptr]
    for fn in (lib.qs_pair_collisions, lib.qs_swarm_interactions,
               lib.qs_neighbor_topk):
        fn.restype = ctypes.c_int
    lib.qs_error_string.argtypes = [ctypes.c_int]
    lib.qs_error_string.restype = ctypes.c_char_p
    lib.ready = True
    return lib


def _launch(name: str, fn_name: str, device, *args) -> None:
    """Call one entry point on the current stream; raise on a launch error."""
    lib = _load()
    rc = getattr(lib, fn_name)(*args, build.current_stream(device))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.qs_error_string(rc).decode())


def _fleet_shape(name: str, pos: torch.Tensor) -> tuple:
    if pos.dim() != 3 or pos.shape[-1] != 3:
        raise ValueError(f"{name} has shape {tuple(pos.shape)}, expected "
                         "(E, N, 3)")
    if pos.shape[1] > MAX_AGENTS:
        raise ValueError(f"the pair kernels support N <= {MAX_AGENTS}, got "
                         f"{pos.shape[1]}")
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pos.device}")
    return pos.shape[0], pos.shape[1]


def pair_collisions(pos: torch.Tensor, prev_packed: torch.Tensor, hitbox,
                    falloff, max_penalty):
    """Collision stage for large swarms, O(N) memory (K2).

    pos (E, N, 3) float32; prev_packed (E, N, PACK_LANES) int32, the pair
    bits of the previous tick (zeros after a reset); hitbox, falloff,
    max_penalty host scalars.  Returns
      col_any (E, N) bool: within hitbox of anyone;
      penalty (E, N) float32: sum over pairs within falloff of
        (-max_penalty / falloff) * d + max_penalty (the caller applies dt);
      resp_any (E, N) bool: has a NEW pair this tick (set now, clear in
        prev_packed);
      resp_partner (E, N) int32: the lowest new j > d if any, else the
        lowest new i < d, else 0 (the reference's pair iteration order);
      curr_packed (E, N, PACK_LANES) int32: this tick's pair bits."""
    e, n = _fleet_shape("pos", pos)
    device = pos.device
    build.check_tensor("pos", pos, (e, n, 3), torch.float32, device)
    build.check_tensor("prev_packed", prev_packed, (e, n, PACK_LANES),
                       torch.int32, device)
    if device.type == "cpu":
        return pair_collisions_plain(pos, prev_packed, hitbox, falloff,
                                     max_penalty)
    new = lambda dtype, *s: torch.empty((e, n) + s, dtype=dtype, device=device)
    col_any, penalty = new(torch.bool), new(torch.float32)
    resp_any, partner = new(torch.bool), new(torch.int32)
    packed = new(torch.int32, PACK_LANES)
    _launch("pair_collisions", "qs_pair_collisions", device,
            pos.data_ptr(), prev_packed.data_ptr(), e, n, _f32(hitbox),
            _f32(falloff), _slope(falloff, max_penalty),
            _f32(max_penalty), col_any.data_ptr(), penalty.data_ptr(),
            resp_any.data_ptr(), partner.data_ptr(), packed.data_ptr())
    pair_collisions.launches += 1
    return col_any, penalty, resp_any, partner, packed


def topk_launch_shape(n: int) -> tuple:
    """How K3 launches for N drones an env: (keys per lane, rows per block).
    A row's N metrics stay in registers, 4 or 8 a lane, up to N = 128 and
    N = 256 (keys per lane 0: in shared memory above that); a block holds
    8 rows (warps) up to N = 128 and 16 above, so that fewer blocks stage
    the planes of a large env.  A block's shared memory is the six planes
    of N floats plus, on the shared-memory route, 32 * ceil(N / 32) keys a
    row: 176 KB at N = 2048, which the launch opts into above 48 KB."""
    if n <= 128:
        return 4, 8
    if n <= 256:
        return 8, 16
    return 0, 16


def neighbor_topk_obs(pos: torch.Tensor, vel: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Fused k-nearest neighbour observation (K3).  pos, vel (E, N, 3)
    float32 -> (E, N, k * 6) float32: per pick [p_j - p_i, v_j - v_i],
    unclipped.  The k smallest of m = max(d, 0.01) + (dp . dv) / max(d,
    0.01) over the other drones, exact ties to the lowest index.  Needs
    1 <= k <= 16 and k <= N - 1."""
    e, n = _fleet_shape("pos", pos)
    if not 1 <= k <= MAX_NEIGHBORS:
        raise ValueError(f"k must be in 1..{MAX_NEIGHBORS}, got {k}")
    if k > n - 1:
        raise ValueError(f"k = {k} neighbours of N = {n} drones")
    device = pos.device
    build.check_tensor("pos", pos, (e, n, 3), torch.float32, device)
    build.check_tensor("vel", vel, (e, n, 3), torch.float32, device)
    if device.type == "cpu":
        return neighbor_topk_obs_plain(pos, vel, k)
    obs = torch.empty((e, n, k * 6), dtype=torch.float32, device=device)
    _launch("neighbor_topk_obs", "qs_neighbor_topk", device, pos.data_ptr(),
            vel.data_ptr(), e, n, k, *topk_launch_shape(n), obs.data_ptr())
    neighbor_topk_obs.launches += 1
    return obs


def swarm_interactions(pos: torch.Tensor, hitbox, falloff, max_penalty):
    """Fused pairwise reduction (K4).  pos (N, 3) or (E, N, 3) float32.
    Returns (col_any bool, partner int32: the nearest other drone, first
    minimum; penalty float32: the sum as in `pair_collisions`; min_dist
    float32), each (N,) / (E, N)."""
    if pos.dim() == 2:
        return tuple(x[0] for x in swarm_interactions(
            pos[None], hitbox, falloff, max_penalty))
    e, n = _fleet_shape("pos", pos)
    device = pos.device
    build.check_tensor("pos", pos, (e, n, 3), torch.float32, device)
    if device.type == "cpu":
        return swarm_interactions_plain(pos, hitbox, falloff, max_penalty)
    new = lambda dtype: torch.empty((e, n), dtype=dtype, device=device)
    col_any, partner = new(torch.bool), new(torch.int32)
    penalty, min_dist = new(torch.float32), new(torch.float32)
    _launch("swarm_interactions", "qs_swarm_interactions", device,
            pos.data_ptr(), e, n, _f32(hitbox), _f32(falloff),
            _slope(falloff, max_penalty), _f32(max_penalty),
            col_any.data_ptr(), partner.data_ptr(), penalty.data_ptr(),
            min_dist.data_ptr())
    swarm_interactions.launches += 1
    return col_any, partner, penalty, min_dist


pair_collisions.launches = 0
neighbor_topk_obs.launches = 0
swarm_interactions.launches = 0
