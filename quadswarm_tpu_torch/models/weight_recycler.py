"""Dormant-neuron scoring and recycling (ReDo).

Port of quadswarm_tpu/models/weight_recycler.py: the mean |activation| score
of each neuron, the dormant mask, and the recycle step of Sokar et al.,
"The Dormant Neuron Phenomenon in Deep RL" (ICML 2023), as functions of
tensors.
"""
from __future__ import annotations

import math

import torch

# flax's lecun_normal draws a normal truncated at two deviations; this is
# the std of the unit normal so truncated, which its std is divided by.
_TRUNCATED_STD = 0.87962566103423978


def estimate_neuron_score(activation: torch.Tensor,
                          normalize: bool = False) -> torch.Tensor:
    """Mean |activation| over every leading (batch) axis: one score per
    neuron of the last axis; divided by the mean score when normalized."""
    score = activation.abs().mean(tuple(range(activation.ndim - 1)))
    if normalize:
        score = score / (score.mean() + 1e-9)
    return score


def dormant_mask(activation: torch.Tensor, tau: float = 0.025) -> torch.Tensor:
    """The neurons whose normalized score is at most tau (ReDo eq. 1)."""
    return estimate_neuron_score(activation, normalize=True) <= tau


def recycle_dense_pair(gen: torch.Generator | None, w_in: torch.Tensor,
                       b_in: torch.Tensor, w_out: torch.Tensor,
                       mask: torch.Tensor):
    """Re-initialize the dormant units of a dense layer: their incoming
    weights get a fresh LeCun-normal draw from `gen` (flax's
    `lecun_normal`: std sqrt(1 / fan_in), truncated at two deviations),
    their bias and outgoing weights become zero, so the recycled unit
    restarts learning without changing the function.

    The port's layout, `nn.Linear.weight` being (out, in):
    w_in (d_hidden, d_in), b_in (d_hidden,), w_out (d_out, d_hidden),
    mask (d_hidden,) bool, True = recycle.  Returns new tensors.
    """
    std = math.sqrt(1.0 / w_in.shape[1]) / _TRUNCATED_STD
    fresh = torch.nn.init.trunc_normal_(
        torch.empty_like(w_in), std=std, a=-2 * std, b=2 * std,
        generator=gen)
    w_in = torch.where(mask[:, None], fresh, w_in)
    b_in = torch.where(mask, torch.zeros_like(b_in), b_in)
    w_out = torch.where(mask[None, :], torch.zeros_like(w_out), w_out)
    return w_in, b_in, w_out
