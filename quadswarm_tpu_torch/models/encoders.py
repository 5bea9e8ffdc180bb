"""Policy/value encoders.

Port of quadswarm_tpu/models/encoders.py, limited to the 'corl' encoder
with the attention neighbor encoder (the flagship run's).  The observation
layout is [self | k * (rel_pos, rel_vel)].  Submodule names follow the flax
modules', so `utils/convert.py` maps a flax parameter tree one to one
(a flax `Dense_i` inside an MLP is `layers.i` here).
"""
from __future__ import annotations

import torch
from torch import nn

_ACTS = {"tanh": torch.tanh, "relu": torch.relu,
         "elu": nn.functional.elu}


def _dense(in_dim: int, out_dim: int, bias: bool = True) -> nn.Linear:
    """flax Dense with xavier_uniform kernel and zero bias."""
    layer = nn.Linear(in_dim, out_dim, bias=bias)
    nn.init.xavier_uniform_(layer.weight)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class MLP(nn.Module):
    def __init__(self, in_dim: int, sizes: tuple, act: str = "tanh",
                 act_last: bool = True):
        super().__init__()
        dims = (in_dim,) + tuple(sizes)
        self.layers = nn.ModuleList(_dense(a, b) for a, b in zip(dims[:-1],
                                                                  dims[1:]))
        self.act = _ACTS[act]
        self.act_last = act_last

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.act_last or i < len(self.layers) - 1:
                x = self.act(x)
        return x


class NeighborEncoderAttention(nn.Module):
    """CoRL-2021 attention over neighbors: per-neighbor embeddings e_i from
    (self obs, neighbor obs), values h_i, scalar scores from (e_i, mean e),
    softmax-weighted sum of the values."""

    def __init__(self, self_obs_dim: int, neighbor_obs_dim: int, hidden: int,
                 num_neighbors: int, act: str = "tanh"):
        super().__init__()
        self.neighbor_obs_dim = neighbor_obs_dim
        self.num_neighbors = num_neighbors
        self.embedding_mlp = MLP(self_obs_dim + neighbor_obs_dim,
                                 (hidden, hidden), act)
        self.neighbor_value_mlp = MLP(hidden, (hidden, hidden), act)
        self.attention_mlp = MLP(2 * hidden, (hidden, hidden, 1), act,
                                 act_last=False)

    def forward(self, self_obs, neighbor_obs):
        b, k = neighbor_obs.shape[0], self.num_neighbors
        nb = neighbor_obs.reshape(b, k, self.neighbor_obs_dim)
        self_rep = self_obs[:, None, :].expand(b, k, self_obs.shape[-1])
        e = self.embedding_mlp(torch.cat([self_rep, nb], -1))
        h = self.neighbor_value_mlp(e)
        e_mean = e.mean(1, keepdim=True).expand_as(e)
        scores = self.attention_mlp(torch.cat([e, e_mean], -1))[..., 0]
        alpha = torch.softmax(scores, 1)
        return torch.sum(alpha[..., None] * h, 1)


class QuadMultiEncoder(nn.Module):
    """'corl' encoder: self MLP + neighbor encoder, fused by a tanh
    feed-forward layer to 2 * rnn_size features."""

    def __init__(self, self_obs_dim: int, neighbor_obs_dim: int,
                 num_neighbors: int, neighbor_encoder_type: str = "attention",
                 neighbor_hidden: int = 256, use_obstacles: bool = False,
                 rnn_size: int = 256, act: str = "tanh"):
        super().__init__()
        if use_obstacles:
            raise NotImplementedError("the obstacle encoder is not ported yet")
        self.self_obs_dim = self_obs_dim
        self.nb_total = neighbor_obs_dim * num_neighbors
        self.self_encoder = MLP(self_obs_dim, (rnn_size, rnn_size), act)
        width = rnn_size
        self.neighbor_encoder = None
        if num_neighbors > 0 and neighbor_encoder_type != "no_encoder":
            if neighbor_encoder_type != "attention":
                raise NotImplementedError(
                    f"neighbor encoder {neighbor_encoder_type!r} is not "
                    "ported yet")
            self.neighbor_encoder = NeighborEncoderAttention(
                self_obs_dim, neighbor_obs_dim, neighbor_hidden,
                num_neighbors, act)
            width += neighbor_hidden
        self.feed_forward = _dense(width, 2 * rnn_size)
        self.out_size = 2 * rnn_size

    def forward(self, obs):
        s = self.self_obs_dim
        self_obs = obs[..., :s]
        parts = [self.self_encoder(self_obs)]
        if self.neighbor_encoder is not None:
            parts.append(self.neighbor_encoder(
                self_obs, obs[..., s:s + self.nb_total]))
        return torch.tanh(self.feed_forward(torch.cat(parts, -1)))


def make_encoder(encoder_type: str, **kwargs) -> nn.Module:
    if encoder_type != "corl":
        raise NotImplementedError(f"encoder {encoder_type!r} is not ported")
    for key in ("obstacle_hidden", "sim2real"):
        kwargs.pop(key, None)
    return QuadMultiEncoder(**kwargs)
