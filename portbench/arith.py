"""The yardstick's arithmetic: the model's float operations per sample and
the bytes and operations of the kernels, as functions of a configuration's
widths, and the card's peaks (`peaks.json`).

A matrix product of an (m, k) input with a (k, n) weight counts 2·m·k·n
float operations; activations, LayerNorm, softmax and the elementwise
work of the losses are not counted, so a share of the peak computed from
these counts is a lower bound of the card's real work.
"""
from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")

# Observation widths by representation (the reference's `--quads_obs_repr`),
# a neighbour's observation and the obstacle SDF.
SELF_OBS = {"xyz_vxyz_R_omega": 18, "xyz_vxyz_R_omega_floor": 19,
            "xyz_vxyz_R_omega_wall": 24}
NEIGHBOR_OBS = {"none": 0, "pos_vel": 6}
SDF_OBS = 9
ACTION_DIM = 4

# Bytes one drone moves through K1 a tick: it reads 26 float32 of state, a
# bool, an int32, 4 commands, 4 OU values and a yaw (145 B) and writes 38
# float32, 4 bools and an int32 (160 B).  Float operations a drone a
# sub-step, without the branches that depend on the data.
K1_BYTES_PER_DRONE = 305
K1_FLOPS_PER_SUBSTEP = 315
# K3 reads a drone's position and velocity (24 B) and writes 6 floats for
# each of its k neighbours; it computes about 25 operations a pair.
K3_BYTES_PER_DRONE = 24
K3_BYTES_PER_NEIGHBOR = 24
K3_FLOPS_PER_PAIR = 25


def peaks(kind: str) -> dict:
    """{'hbm_bytes_per_s', 'fp32_flops_per_s'} of the card named `kind`
    (`torch.cuda.get_device_name()`), matched by the table's keys."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    for key, row in table.items():
        if key in kind:
            return row
    raise KeyError(f"no peaks for the card {kind!r} in {PEAKS_FILE}")


def mlp_macs(in_dim: int, sizes: tuple) -> int:
    dims = (in_dim,) + tuple(sizes)
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def encoder_macs(flags: dict) -> int:
    """Multiply-adds of one encoder (actor or critic) for one sample."""
    s = SELF_OBS[flags["quads_obs_repr"]]
    nd = NEIGHBOR_OBS[flags["quads_neighbor_obs_type"]]
    k = max(flags["quads_neighbor_visible_num"], 0) if nd else 0
    r = flags["rnn_size"]
    h = flags["quads_neighbor_hidden_size"]
    obstacles = bool(flags["quads_use_obstacles"])
    if flags["quads_encoder_type"] == "attention":
        depth = (r,) if flags["quads_sim2real"] else (r, r)
        heads = 1 if flags["quads_sim2real"] else 4
        out = r if flags["quads_sim2real"] else 2 * r
        obst = SDF_OBS if obstacles else 0
        embed = (mlp_macs(s, depth) + mlp_macs(nd * k, depth)
                 + mlp_macs(obst, depth))
        # two tokens: q, k, v projections and the output projection, the
        # scores and the weighted sum of every head
        attn = 2 * 3 * r * heads * r + 2 * heads * r * r + heads * 2 * (
            2 * 2 * r)
        return embed + attn + 3 * r * out
    width = r
    macs = mlp_macs(s, (r, r))
    kind = flags["quads_neighbor_encoder_type"]
    if k > 0 and kind != "no_encoder":
        width += h
        if kind == "attention":
            macs += k * (mlp_macs(s + nd, (h, h)) + mlp_macs(h, (h, h))
                         + mlp_macs(2 * h, (h, h, 1)))
        elif kind == "mean_embed":
            macs += k * mlp_macs(nd, (h, h))
        elif kind == "mlp":
            macs += mlp_macs(nd * k, (h, h, h))
        else:
            raise ValueError(f"unknown neighbour encoder {kind!r}")
    if obstacles and flags["quads_obstacle_obs_type"] == "octomap":
        oh = flags["quads_obst_hidden_size"]
        width += oh
        macs += mlp_macs(SDF_OBS, (oh, oh))
    return macs + width * 2 * r


def forward_flops(flags: dict) -> int:
    """Float operations of one actor-critic forward for one sample: both
    encoders, the action head and the value head."""
    r = flags["rnn_size"]
    out = r if (flags["quads_encoder_type"] == "attention"
                and flags["quads_sim2real"]) else 2 * r
    return 2 * (2 * encoder_macs(flags) + out * (ACTION_DIM + 1))


def k1_bound_s(drones: int, sim_steps: int, card: dict) -> float:
    """Least time of one K1 launch over `drones` drones: the larger of its
    bytes over the memory bandwidth and its operations over the float32
    peak."""
    return max(drones * K1_BYTES_PER_DRONE / card["hbm_bytes_per_s"],
               drones * sim_steps * K1_FLOPS_PER_SUBSTEP
               / card["fp32_flops_per_s"])


def k3_bound_s(envs: int, agents: int, k: int, card: dict) -> float:
    """Least time of one K3 launch: (E, N) drones, k neighbours each."""
    drones = envs * agents
    return max(drones * (K3_BYTES_PER_DRONE + K3_BYTES_PER_NEIGHBOR * k)
               / card["hbm_bytes_per_s"],
               envs * agents * (agents - 1) * K3_FLOPS_PER_PAIR
               / card["fp32_flops_per_s"])
