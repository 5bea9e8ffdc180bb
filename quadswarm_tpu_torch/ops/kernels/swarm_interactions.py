"""K2, K3, K4: the pairwise swarm kernels for Hopper, and their wrappers.

Replaces quadswarm_tpu/ops/pallas/swarm_interactions.py: the Pallas TPU
kernels `_pair_collision_kernel` (K2, wrapper `pair_collisions`),
`_neighbor_topk_kernel` (K3, `neighbor_topk_obs`) and `_interaction_kernel`
(K4, `swarm_interactions`).  Source: csrc/swarm_interactions.cu, where the
note at the top gives the designs and what bounds each kernel.  K2 and K4:
a thread per (row drone, slice of columns), blocks of whole envs or of row
tiles of one env (`pair_launch_shape`), each env's positions staged once a
block, thresholds tested on the squared distance (`square_within`), K2's
history rows read and written whole by the block.  K3: a warp per row drone
that computes the row's metrics once and keeps them on chip for its k
picks (`topk_launch_shape`).

They are the large-swarm path of the env step (`EnvConfig.use_pallas_pairs`):
K2 is the collision stage with an exact new-pair history kept as packed
bits, K3 the k-nearest neighbour observation; neither stores an (N, N)
tensor.  K4 is the standalone reduction (nothing in the env calls it).

Beside each wrapper stands its plain PyTorch version, which works from
dense (E, N, N) tensors with the kernel's own arithmetic: distances in the
difference form, sqrt((dx*dx + dy*dy) + dz*dz), summed in that order.  A
CPU tensor takes the plain version and a CUDA tensor the kernel; there is
no fallback from one to the other.  Each wrapper counts its launches.
Every output equals the plain version's bit for bit except K2's and K4's
penalty sums, which the kernels add in another order (each 16-column word
in column order, then the row's words in word order: the same bits on
every run, for every launch shape and every count of envs); the callers'
PEN_TOL (rtol 1e-4, atol 1e-5: chip_smoke.py, the card tests) covers that
order, since the terms are the plain version's bits and only their sum is
rounded differently.  What bounds K2 and K4 (the note in the source): the
pair loop's instructions, issued for every pair from both of its rows, and
K2's history write, 512 B a drone; at the small fleets the launch and one
block's chain: a global round trip, one thread's word and the combine of
the row's slices behind a barrier.

Packed pair history (`pack_pairs` / `unpack_pairs`), the JAX package's
layout: row d of an (..., N, PACK_LANES) int32 tensor holds N bits, bit b of
word w being column 16*w + b; the upper 16 bits of every word and all words
from ceil(N / 16) on are zero.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

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
    # Partner 0 where no distance of the row is below 1e30 (every other
    # squared distance overflowing), as the kernel, which starts from
    # (0, 1e30) and takes a strictly smaller distance only.
    partner = torch.where(min_dist < 1e30, partner, torch.zeros_like(partner))
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
    lib.qs_pair_collisions.argtypes = [ptr, ptr, i32, i32, i32, i32, f32, f32,
                                       f32, f32, ptr, ptr, ptr, ptr, ptr, i32,
                                       ptr]
    lib.qs_swarm_interactions.argtypes = [ptr, i32, i32, i32, i32, f32, f32,
                                          f32, f32, ptr, ptr, ptr, ptr, i32,
                                          ptr]
    lib.qs_pair_shared_bytes.argtypes = [i32, i32, i32, i32, i32]
    lib.qs_pair_shared_bytes.restype = ctypes.c_longlong
    lib.qs_neighbor_topk.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr,
                                     i32, ptr]
    for fn in (lib.qs_pair_collisions, lib.qs_swarm_interactions,
               lib.qs_neighbor_topk):
        fn.restype = ctypes.c_int
    lib.qs_error_string.argtypes = [ctypes.c_int]
    lib.qs_error_string.restype = ctypes.c_char_p
    lib.ready = True
    return lib


def _launch(name: str, fn_name: str, device, *args) -> None:
    """Call one entry point on `device`'s current stream; raise on a launch
    error."""
    lib = _load()
    rc = getattr(lib, fn_name)(*args, build.device_index(device),
                               build.current_stream(device))
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


# K2 and K4 launch in blocks of `rows` consecutive rows of the flattened
# (E * N) fleet, `slices` threads a row.  A thread takes at most
# PAIR_WORDS_PER_THREAD words (16 columns each) of its row, and rows are
# split further, down to a word a thread, until the fleet has
# PAIR_MIN_THREADS threads (enough warps to hide the pair loop's latency on
# an H100's 132 SMs), into at most PAIR_MAX_SLICES slices.  A block has 32
# rows, or 16 or 8 where fewer blocks would leave SMs idle (a warp then
# holds 2 or 4 slices), doubled while it stays within PAIR_MAX_THREADS
# threads (the kernels' bound is 512) and the grid at PAIR_MIN_BLOCKS
# blocks or more.  A fleet split into more than 16 slices has fewer than
# 2,112 rows, so 8 rows a block: 256 threads at most.
PAIR_WORDS_PER_THREAD = 8
PAIR_MAX_SLICES = 32
PAIR_MIN_THREADS = 132 * 256
PAIR_MAX_THREADS = 256
PAIR_MIN_BLOCKS = 264
PAIR_SMS = 132
SHARED_BYTES_MAX = 232448            # what an H100 block can opt into


class PairLaunch(NamedTuple):
    """How K2 or K4 launches: `blocks` of `threads` = rows * slices; a block
    covers `rows` consecutive rows (env * N + i) and stages the positions of
    the at most `span` envs they touch; `shared_bytes` of dynamic shared
    memory (csrc/swarm_interactions.cu::pair_shared_bytes)."""
    blocks: int
    threads: int
    rows: int
    slices: int
    span: int
    shared_bytes: int


def pair_shape(e: int, n: int, rows: int, slices: int,
               history: bool = True) -> PairLaunch:
    """The launch of `rows` rows a block, `slices` threads a row, for K2
    (`history`) or K4: the kernel's own count of blocks and shared bytes.
    Planes of 16 * ceil(N / 16) floats for each env a block touches (a
    block starts a multiple of gcd(rows, N) into an env), K2's staged
    history words (ceil(N / 16) a row, padded to an odd count), and with
    several slices each word's penalty sum and, from the next 16-byte
    boundary, four words a row for each slice past the first."""
    live = -(-n // PACK_BITS)
    span = min(e, (n - math.gcd(rows, n) + rows + n - 1) // n)
    row_words = rows * (live | 1)
    words = 3 * span * PACK_BITS * live + (row_words if history else 0)
    if slices > 1:
        words = -(-(words + row_words) // 4) * 4 + 4 * (slices - 1) * rows
    shared = 4 * words
    return PairLaunch(-(-e * n // rows), rows * slices, rows, slices, span,
                      shared)


@functools.lru_cache(maxsize=256)
def pair_launch_shape(e: int, n: int, history: bool = True) -> PairLaunch:
    """How K2 (`history`) or K4 launches for E envs of N drones.  Slices:
    as many as PAIR_MIN_THREADS asks for, or PAIR_WORDS_PER_THREAD words a
    thread does, at most PAIR_MAX_SLICES and at most the row's words, then
    evened out so that every slice has words.  Rows: 32, halved down to 8
    while the grid has fewer blocks than PAIR_SMS, else doubled while the
    block stays within PAIR_MAX_THREADS threads and the grid at
    PAIR_MIN_BLOCKS blocks or more."""
    words = -(-n // PACK_BITS)
    want = max(-(-words // PAIR_WORDS_PER_THREAD),
               -(-PAIR_MIN_THREADS // (e * n)))
    per = -(-words // min(want, words, PAIR_MAX_SLICES))
    slices = -(-words // per)
    rows = 32
    while rows > 8 and -(-e * n // rows) < PAIR_SMS:
        rows //= 2
    while rows >= 32 and 2 * rows * slices <= PAIR_MAX_THREADS \
            and -(-e * n // (2 * rows)) >= PAIR_MIN_BLOCKS:
        rows *= 2
    return pair_shape(e, n, rows, slices, history)


@functools.lru_cache(maxsize=64)
def square_within(radius: float) -> float:
    """The largest float32 s whose correctly rounded float32 square root is
    at most float32(radius), so that sqrt(s) <= radius exactly when s <= it
    (the root is monotone); -1.0 when no s >= 0 qualifies (a negative or NaN
    radius).  The kernels test their thresholds on squared distances with
    it.  A binary search over the bit patterns of the floats in [0, inf]."""
    r = np.float32(radius)
    if not r >= 0:
        return -1.0
    as_float = lambda bits: np.array(bits, np.uint32).view(np.float32)[()]
    lo, hi = 0, 0x7F800000
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if np.sqrt(as_float(mid)) <= r:
            lo = mid
        else:
            hi = mid - 1
    return float(as_float(lo))


def pair_outputs(e: int, n: int, device) -> tuple:
    """K2's five outputs, uninitialised: col_any, penalty, resp_any,
    resp_partner (E, N) and curr_packed (E, N, PACK_LANES)."""
    new = lambda dtype, *s: torch.empty((e, n) + s, dtype=dtype, device=device)
    return (new(torch.bool), new(torch.float32), new(torch.bool),
            new(torch.int32), new(torch.int32, PACK_LANES))


def _float32_env(x: torch.Tensor) -> torch.Tensor:
    """A bfloat16 env's positions or velocities in float32, as the JAX
    wrappers cast them; any other dtype is left for the checks to judge."""
    return x.float() if x.dtype == torch.bfloat16 else x


def pair_collisions(pos: torch.Tensor, prev_packed: torch.Tensor, hitbox,
                    falloff, max_penalty):
    """Collision stage for large swarms, O(N) memory (K2).

    pos (E, N, 3) float32 (a bfloat16 env's is cast to it, as the JAX
    wrapper casts); prev_packed (E, N, PACK_LANES) int32, the pair
    bits of the previous tick (zeros after a reset); hitbox, falloff,
    max_penalty host scalars.  Returns
      col_any (E, N) bool: within hitbox of anyone;
      penalty (E, N) float32: sum over pairs within falloff of
        (-max_penalty / falloff) * d + max_penalty (the caller applies dt);
      resp_any (E, N) bool: has a NEW pair this tick (set now, clear in
        prev_packed);
      resp_partner (E, N) int32: the lowest new j > d if any, else the
        lowest new i < d, else 0 (the reference's pair iteration order);
      curr_packed (E, N, PACK_LANES) int32: this tick's pair bits, a new
        tensor (prev_packed is only read)."""
    e, n = _fleet_shape("pos", pos)
    device = pos.device
    pos = _float32_env(pos)
    build.check_tensor("pos", pos, (e, n, 3), torch.float32, device)
    build.check_tensor("prev_packed", prev_packed, (e, n, PACK_LANES),
                       torch.int32, device)
    if device.type == "cpu":
        return pair_collisions_plain(pos, prev_packed, hitbox, falloff,
                                     max_penalty)
    shape = pair_launch_shape(e, n)
    out = pair_outputs(e, n, device)
    _launch("pair_collisions", "qs_pair_collisions", device, pos.data_ptr(),
            prev_packed.data_ptr(), e, n, shape.rows, shape.slices,
            square_within(hitbox), square_within(falloff),
            _slope(falloff, max_penalty), _f32(max_penalty),
            *(t.data_ptr() for t in out))
    pair_collisions.launches += 1
    return out


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
    pos, vel = _float32_env(pos), _float32_env(vel)
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
    pos = _float32_env(pos)
    build.check_tensor("pos", pos, (e, n, 3), torch.float32, device)
    if device.type == "cpu":
        return swarm_interactions_plain(pos, hitbox, falloff, max_penalty)
    shape = pair_launch_shape(e, n, history=False)
    new = lambda dtype: torch.empty((e, n), dtype=dtype, device=device)
    out = (new(torch.bool), new(torch.int32), new(torch.float32),
           new(torch.float32))
    _launch("swarm_interactions", "qs_swarm_interactions", device,
            pos.data_ptr(), e, n, shape.rows, shape.slices,
            square_within(hitbox), square_within(falloff),
            _slope(falloff, max_penalty), _f32(max_penalty),
            *(t.data_ptr() for t in out))
    swarm_interactions.launches += 1
    return out


def kernel_shared_bytes(e: int, n: int, rows: int, slices: int,
                        history: bool) -> int:
    """The shared bytes the built kernel reserves for this launch (to hold
    `pair_shape` to the source on the card)."""
    return _load().qs_pair_shared_bytes(e, n, rows, slices, int(history))


pair_collisions.launches = 0
neighbor_topk_obs.launches = 0
swarm_interactions.launches = 0
