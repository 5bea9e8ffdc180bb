"""Policy/value encoders.

Port of quadswarm_tpu/models/encoders.py: the 'corl' encoder with any of
its neighbour encoders (attention, mean_embed, mlp, no_encoder) and the
obstacle MLP over the SDF patch, and the 'attention' encoder type (the
multi-head encoder, with its single-head sim2real variant).  The
observation layout is [self | k * (rel_pos, rel_vel) | SDF].  Submodule
names follow the flax modules' where flax names them; `utils/convert.py`
renames the ones flax numbers (`Dense_i` -> `layers.i`, `MLP_0` -> `mlp`,
`LayerNorm_0` -> `layer_norm`).

Compute dtype.  The parameters are float32 always; a model built with
`dtype=torch.bfloat16` computes in bfloat16 with flax's promotions
(`nn.Dense(dtype=...)`, `nn.LayerNorm(dtype=...)`): a dense layer casts its
input, weight and bias to the compute dtype and returns it; LayerNorm
computes its statistics and its affine map in float32 (flax promotes its
reductions to float32) and returns the compute dtype; attention scores
are scaled by 1/sqrt(d) rounded to the compute dtype.  The casts are
explicit (`Dense`, `LayerNorm` below, set by `set_compute_dtype`) rather
than `torch.autocast`, because autocast runs LayerNorm and softmax in
float32 and returns float32 from them, where flax returns the compute
dtype.  A float32 model on float32 inputs runs the plain layers, with no
cast to dispatch.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

_ACTS = {"tanh": torch.tanh, "relu": torch.relu,
         "elu": nn.functional.elu}


class Dense(nn.Linear):
    """flax `nn.Dense(dtype=compute_dtype)`: the input, the weight and the
    bias are cast to the compute dtype, which the output keeps."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if x.dtype == dt == self.weight.dtype:
            return super().forward(x)     # no cast to dispatch
        return nn.functional.linear(
            x.to(dt), self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=compute_dtype)`: statistics, scale and
    bias in float32, the result in the compute dtype."""

    compute_dtype = torch.float32

    def forward(self, x):
        if x.dtype == self.compute_dtype == torch.float32:
            return super().forward(x)
        return super().forward(x.float()).to(self.compute_dtype)


def set_compute_dtype(module: nn.Module, dtype) -> None:
    """Every dense layer, LayerNorm and attention block of `module`
    computes in `dtype` from now on; its parameters keep theirs."""
    for m in module.modules():
        if isinstance(m, (Dense, LayerNorm, MultiHeadAttention)):
            m.compute_dtype = dtype


def _dense(in_dim: int, out_dim: int, bias: bool = True) -> Dense:
    """flax Dense with xavier_uniform kernel and zero bias."""
    layer = Dense(in_dim, out_dim, bias=bias)
    nn.init.xavier_uniform_(layer.weight)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _lecun_dense(in_dim: int, out_dim: int) -> Dense:
    """flax Dense without bias and with its default kernel init,
    lecun_normal (a normal truncated at two deviations, rescaled to
    variance 1 / fan_in)."""
    layer = Dense(in_dim, out_dim, bias=False)
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
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


@functools.lru_cache(maxsize=None)
def _rounded_sqrt(d: int, dtype) -> float:
    """sqrt(d) cast to `dtype`, as flax scales attention scores."""
    return float(torch.tensor(math.sqrt(d)).to(dtype))


class MultiHeadAttention(nn.Module):
    """Transformer attention block with residual and LayerNorm: every head
    is d_model wide (d_k = d_model), the projections have no bias, the
    scores are scaled by 1/sqrt(d_model), LayerNorm's eps is 1e-6.
    `torch.nn.MultiheadAttention` splits d_model across the heads and adds
    biases, so it computes something else.  With one head it is the JAX
    package's OneHeadAttention (the sim2real block): the same parameters
    and the same products.  Returns (out, attention)."""

    compute_dtype = torch.float32

    def __init__(self, n_head: int, d_model: int):
        super().__init__()
        self.n_head, self.d_model = n_head, d_model
        self.w_qs = _lecun_dense(d_model, n_head * d_model)
        self.w_ks = _lecun_dense(d_model, n_head * d_model)
        self.w_vs = _lecun_dense(d_model, n_head * d_model)
        self.fc = _lecun_dense(n_head * d_model, d_model)
        self.layer_norm = LayerNorm(d_model, eps=1e-6)

    def forward(self, q, k, v):
        h, d = self.n_head, self.d_model
        b, lq = q.shape[:2]
        qh = self.w_qs(q).reshape(b, lq, h, d).transpose(1, 2)
        kh = self.w_ks(k).reshape(b, k.shape[1], h, d).transpose(1, 2)
        vh = self.w_vs(v).reshape(b, v.shape[1], h, d).transpose(1, 2)
        attn = torch.softmax(
            (qh / _rounded_sqrt(d, self.compute_dtype))
            @ kh.transpose(-1, -2), -1)
        out = (attn @ vh).transpose(1, 2).reshape(b, lq, h * d)
        return self.layer_norm(self.fc(out) + q), attn


class NeighborEncoderDeepsets(nn.Module):
    """mean_embed: one MLP over each neighbour's observation, averaged over
    the neighbours."""

    def __init__(self, self_obs_dim: int, neighbor_obs_dim: int, hidden: int,
                 num_neighbors: int, act: str = "tanh"):
        super().__init__()
        self.neighbor_obs_dim = neighbor_obs_dim
        self.num_neighbors = num_neighbors
        self.mlp = MLP(neighbor_obs_dim, (hidden, hidden), act)

    def forward(self, self_obs, neighbor_obs):
        b = neighbor_obs.shape[0]
        x = neighbor_obs.reshape(b, self.num_neighbors, self.neighbor_obs_dim)
        return self.mlp(x).mean(1)


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


class NeighborEncoderMlp(nn.Module):
    """mlp: one 3-layer MLP over all neighbours' observations, flat."""

    def __init__(self, self_obs_dim: int, neighbor_obs_dim: int, hidden: int,
                 num_neighbors: int, act: str = "tanh"):
        super().__init__()
        self.mlp = MLP(neighbor_obs_dim * num_neighbors,
                       (hidden, hidden, hidden), act)

    def forward(self, self_obs, neighbor_obs):
        return self.mlp(neighbor_obs)


_NEIGHBOR_ENCODERS = {"attention": NeighborEncoderAttention,
                      "mean_embed": NeighborEncoderDeepsets,
                      "mlp": NeighborEncoderMlp}


class QuadMultiEncoder(nn.Module):
    """'corl' encoder: self MLP + optional neighbor encoder + optional
    obstacle MLP, fused by a tanh feed-forward layer to 2 * rnn_size
    features."""

    def __init__(self, self_obs_dim: int, neighbor_obs_dim: int,
                 num_neighbors: int, neighbor_encoder_type: str = "attention",
                 neighbor_hidden: int = 256, use_obstacles: bool = False,
                 obstacle_obs_dim: int = 9, obstacle_hidden: int = 256,
                 rnn_size: int = 256, act: str = "tanh"):
        super().__init__()
        self.self_obs_dim = self_obs_dim
        self.nb_total = neighbor_obs_dim * num_neighbors
        self.self_encoder = MLP(self_obs_dim, (rnn_size, rnn_size), act)
        width = rnn_size
        self.neighbor_encoder = None
        if num_neighbors > 0 and neighbor_encoder_type != "no_encoder":
            self.neighbor_encoder = _NEIGHBOR_ENCODERS[neighbor_encoder_type](
                self_obs_dim, neighbor_obs_dim, neighbor_hidden,
                num_neighbors, act)
            width += neighbor_hidden
        self.obstacle_encoder = None
        if use_obstacles:
            self.obstacle_encoder = MLP(obstacle_obs_dim,
                                        (obstacle_hidden, obstacle_hidden), act)
            width += obstacle_hidden
        self.feed_forward = _dense(width, 2 * rnn_size)
        self.out_size = 2 * rnn_size

    def forward(self, obs):
        s = self.self_obs_dim
        self_obs = obs[..., :s]
        parts = [self.self_encoder(self_obs)]
        if self.neighbor_encoder is not None:
            parts.append(self.neighbor_encoder(
                self_obs, obs[..., s:s + self.nb_total]))
        if self.obstacle_encoder is not None:
            parts.append(self.obstacle_encoder(obs[..., s + self.nb_total:]))
        return torch.tanh(self.feed_forward(torch.cat(parts, -1)))


class QuadMultiHeadAttentionEncoder(nn.Module):
    """'attention' encoder type: self, neighbour and obstacle embeddings
    (MLPs of depth 2, or 1 under sim2real), attention over the two tokens
    [neighbour, obstacle] (4 heads, or the single head under sim2real), a
    tanh feed-forward layer to 2 * rnn_size features (rnn_size under
    sim2real).  The neighbours enter flat, as one token; the obstacle token
    embeds whatever follows the neighbour slice, `obstacle_obs_dim` wide,
    whether or not the model's `use_obstacles` is set, as the JAX module
    does."""

    def __init__(self, self_obs_dim: int, neighbor_obs_dim: int,
                 num_neighbors: int, obstacle_obs_dim: int = 9,
                 rnn_size: int = 256, act: str = "tanh",
                 sim2real: bool = False):
        super().__init__()
        self.self_obs_dim = self_obs_dim
        self.nb_total = neighbor_obs_dim * num_neighbors
        for what, width in (("neighbour", self.nb_total),
                            ("obstacle", obstacle_obs_dim)):
            if width == 0:
                # JAX encoders.py:227-232 embeds the empty slice, and flax's
                # xavier init of a (0, rnn_size) kernel divides by zero.
                raise ValueError(
                    f"the 'attention' encoder type embeds the {what} slice "
                    "of the observation, which is 0 wide here; the JAX "
                    "package's QuadMultiHeadAttentionEncoder fails on such a "
                    "slice at init (ZeroDivisionError in xavier_uniform), a "
                    "reference-side defect (ROADMAP.md); use "
                    "--quads_encoder_type=corl, or turn the obstacles on")
        depth = (rnn_size,) if sim2real else (rnn_size, rnn_size)
        self.self_embed = MLP(self_obs_dim, depth, act)
        self.neighbor_embed = MLP(self.nb_total, depth, act)
        self.obstacle_embed = MLP(obstacle_obs_dim, depth, act)
        self.attention = MultiHeadAttention(1 if sim2real else 4, rnn_size)
        self.out_size = rnn_size if sim2real else 2 * rnn_size
        self.feed_forward = _dense(3 * rnn_size, self.out_size)

    def forward(self, obs):
        s = self.self_obs_dim
        nb_embed = self.neighbor_embed(obs[..., s:s + self.nb_total])
        ob_embed = self.obstacle_embed(obs[..., s + self.nb_total:])
        tokens = torch.stack([nb_embed, ob_embed], 1)          # (b, 2, d)
        attn_out, _ = self.attention(tokens, tokens, tokens)
        x = torch.cat([self.self_embed(obs[..., :s]),
                       attn_out.reshape(obs.shape[0], -1)], -1)
        return torch.tanh(self.feed_forward(x))


def make_encoder(encoder_type: str, *, self_obs_dim: int,
                 neighbor_obs_dim: int, num_neighbors: int,
                 neighbor_encoder_type: str = "attention",
                 neighbor_hidden: int = 256, use_obstacles: bool = False,
                 obstacle_obs_dim: int = 9, obstacle_hidden: int = 256,
                 rnn_size: int = 256, act: str = "tanh",
                 sim2real: bool = False) -> nn.Module:
    """'attention' builds the multi-head encoder; any other type the 'corl'
    encoder, which ignores sim2real (JAX `make_encoder`)."""
    if encoder_type == "attention":
        return QuadMultiHeadAttentionEncoder(
            self_obs_dim, neighbor_obs_dim, num_neighbors, obstacle_obs_dim,
            rnn_size, act, sim2real)
    return QuadMultiEncoder(
        self_obs_dim, neighbor_obs_dim, num_neighbors, neighbor_encoder_type,
        neighbor_hidden, use_obstacles, obstacle_obs_dim, obstacle_hidden,
        rnn_size, act)
