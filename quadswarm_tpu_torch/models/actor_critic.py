"""Actor-critic with separate actor and critic encoders.

Port of quadswarm_tpu/models/actor_critic.py: diagonal-Gaussian policy with
a state-independent log std.  `dtype` is the compute dtype, float32 or
bfloat16, with flax's promotions (`models/encoders.py`): the parameters and
the optimizer state stay float32; the action mean and the value come out
in the compute dtype, the log std in float32 (a float32 parameter, as in
flax), and the callers cast them to float32 before any loss, GAE or
sampling.  In float32 the port turns TF32 off for its products (see
`set_float32_precision`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from quadswarm_tpu_torch.models.encoders import (
    _dense, make_encoder, set_compute_dtype,
)
from quadswarm_tpu_torch.utils.struct import require_float_dtype, resolve_device


def set_float32_precision() -> None:
    """Full-float32 matrix products and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class ActorCritic(nn.Module):
    """forward(obs) -> (action_mean, log_std, value).  `obstacle_obs_dim`
    is the width of the observation after the neighbour slice (the SDF's 9,
    or 0 without obstacles); the 'attention' encoder type embeds it."""

    def __init__(self, action_dim: int = 4, self_obs_dim: int = 18,
                 neighbor_obs_dim: int = 6, num_neighbors: int = 6,
                 encoder_type: str = "corl",
                 neighbor_encoder_type: str = "attention",
                 neighbor_hidden: int = 256, use_obstacles: bool = False,
                 obstacle_obs_dim: int = 9,
                 obstacle_hidden: int = 256, rnn_size: int = 256,
                 act: str = "tanh", sim2real: bool = False,
                 initial_stddev: float = 1.0, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        require_float_dtype(dtype)
        device = resolve_device(device)
        set_float32_precision()
        enc = dict(self_obs_dim=self_obs_dim,
                   neighbor_obs_dim=neighbor_obs_dim,
                   num_neighbors=num_neighbors,
                   neighbor_encoder_type=neighbor_encoder_type,
                   neighbor_hidden=neighbor_hidden,
                   use_obstacles=use_obstacles,
                   obstacle_obs_dim=obstacle_obs_dim,
                   obstacle_hidden=obstacle_hidden, rnn_size=rnn_size,
                   act=act, sim2real=sim2real)
        self.actor_encoder = make_encoder(encoder_type, **enc)
        self.critic_encoder = make_encoder(encoder_type, **enc)
        # the heads' width is the encoder's, as flax's Dense infers it
        self.action_head = _dense(self.actor_encoder.out_size, action_dim)
        self.value_head = _dense(self.critic_encoder.out_size, 1)
        self.log_std = nn.Parameter(
            torch.full((action_dim,), math.log(initial_stddev)))
        self.dtype = dtype
        set_compute_dtype(self, dtype)
        self.to(device)

    def forward(self, obs):
        mean = self.action_head(self.actor_encoder(obs))
        value = self.value_head(self.critic_encoder(obs))[..., 0]
        # a new float32 tensor, not a view of the parameter, so that it
        # carries no grad under torch.no_grad() and sums its gradient when
        # it does
        return (mean, torch.zeros_like(mean, dtype=self.log_std.dtype)
                + self.log_std, value)


def apply_fused(model: ActorCritic, obs):
    """(mean, log_std, value) for a (B, obs_dim) batch.  The JAX package
    evaluates the two encoders as one batched product; here they run back
    to back, with the same result."""
    return model(obs)


def gaussian_log_prob(mean, log_std, actions):
    var = torch.exp(2 * log_std)
    return torch.sum(-0.5 * ((actions - mean) ** 2 / var + 2 * log_std
                             + math.log(2 * math.pi)), -1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), -1)


def sample_actions(gen: torch.Generator | None, mean, log_std, normal=None):
    """mean + std * N(0, 1); `normal` injects the standard normal draw."""
    if normal is None:
        normal = torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                             device=mean.device)
    return mean + torch.exp(log_std) * normal
