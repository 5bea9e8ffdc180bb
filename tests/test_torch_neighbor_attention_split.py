"""The CoRL neighbour attention's first score layer, split by its inputs.

`NeighborEncoderAttention` computes attention_mlp's first layer on
[e_i; mean e] as W_e e_i + (W_m mean e + c), from column views of the one
(hidden, 2 * hidden) weight, so the mean's term runs once an agent.  Here
the encoder is held to the concatenated form written out: forward and the
gradients of a loss of batch means in float32 (within
`test_torch_encoder_zoo.py`'s TOL and GRAD_TOL) and in bfloat16 (within
`test_torch_bf16.py`'s rtol 2e-2 plus 2e-2 of the largest entry, gradients
1e-2), and without autograd, as a rollout runs it; stacked under
`torch.vmap` against each encoder alone.  Its forward creates no
tensor 2 * hidden wide, its parameters keep flax's keys and shapes, and
`recorded_attention` still records the softmax weights.  CPU, small widths.
"""
from __future__ import annotations

import pytest
import torch
from torch.func import functional_call, grad, stack_module_state
from torch.utils._python_dispatch import TorchDispatchMode

from quadswarm_tpu_torch.models import actor_critic as t_ac
from quadswarm_tpu_torch.models.encoders import (
    NeighborEncoderAttention, recorded_attention, set_compute_dtype)
from .test_torch_encoder_zoo import BASE, CASES, GRAD_TOL, TOL

SELF, NB, HIDDEN, K, ROWS = 19, 6, 24, 5, 37
BF16_TOL, BF16_GRAD_TOL = 2e-2, 1e-2          # test_torch_bf16.py's
SPLIT_CASES = {"float32-tanh": (torch.float32, "tanh"),
               "float32-relu": (torch.float32, "relu"),
               "float32-elu": (torch.float32, "elu"),
               "bfloat16-tanh": (torch.bfloat16, "tanh")}


def _encoder(dtype=torch.float32, act="tanh", seed=0):
    torch.manual_seed(seed)
    enc = NeighborEncoderAttention(SELF, NB, HIDDEN, K, act)
    # flax's init leaves the biases zero; nonzero ones exercise the bias
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.1 * torch.randn_like(p))
    set_compute_dtype(enc, dtype)
    return enc


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(ROWS, SELF, generator=g),
            2 * torch.randn(ROWS, NB * K, generator=g))


def _cat_form(enc, self_obs, neighbor_obs):
    """The encoder as the JAX package writes it: the first score layer on
    the concatenation [e_i; mean e]."""
    b, k = neighbor_obs.shape[0], enc.num_neighbors
    nb = neighbor_obs.reshape(b, k, enc.neighbor_obs_dim)
    self_rep = self_obs[:, None, :].expand(b, k, self_obs.shape[-1])
    e = enc.embedding_mlp(torch.cat([self_rep, nb], -1))
    h = enc.neighbor_value_mlp(e)
    e_mean = e.mean(1, keepdim=True).expand_as(e)
    scores = enc.attention_mlp(torch.cat([e, e_mean], -1))[..., 0]
    return torch.sum(torch.softmax(scores, 1)[..., None] * h, 1)


def _value_and_grads(enc, forward, weights):
    enc.zero_grad()
    out = forward(enc, *_inputs())
    torch.mean(out.float() * weights).backward()
    return out.detach(), {n: p.grad.clone() for n, p in enc.named_parameters()}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_layer_matches_the_cat_form(case):
    dtype, act = SPLIT_CASES[case]
    enc = _encoder(dtype, act)
    weights = torch.randn(ROWS, HIDDEN, generator=torch.Generator()
                          .manual_seed(2))
    got, got_grads = _value_and_grads(enc, NeighborEncoderAttention.forward,
                                      weights)
    want, want_grads = _value_and_grads(enc, _cat_form, weights)
    assert got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
        for name, g in got_grads.items():
            torch.testing.assert_close(g, want_grads[name], **GRAD_TOL,
                                       msg=lambda m: f"{case} {name}: {m}")
        return
    torch.testing.assert_close(
        got.float(), want.float(), rtol=BF16_TOL,
        atol=BF16_TOL * float(want.float().abs().max()))
    largest = max(float(w.abs().max()) for w in want_grads.values())
    for name, g in got_grads.items():
        assert g.dtype == torch.float32, name
        torch.testing.assert_close(g, want_grads[name], rtol=BF16_GRAD_TOL,
                                   atol=BF16_GRAD_TOL * largest,
                                   msg=lambda m: f"{case} {name}: {m}")


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_layer_matches_the_cat_form_without_autograd(case):
    dtype, act = SPLIT_CASES[case]
    enc = _encoder(dtype, act)
    x = _inputs()
    with torch.no_grad():
        got, want = enc(*x), _cat_form(enc, *x)
    assert not got.requires_grad and got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
        return
    torch.testing.assert_close(
        got.float(), want.float(), rtol=BF16_TOL,
        atol=BF16_TOL * float(want.float().abs().max()))


@pytest.mark.parametrize("autograd", [False, True], ids=["no_grad", "grad"])
def test_stacked_encoders_under_vmap_match_each_alone(autograd):
    """P = 3 encoders stacked as `parallel/pbt_mixed.py` stacks policies,
    run by `functional_call` under `torch.vmap` on shared inputs: outputs
    without autograd, gradients under `torch.func.grad`."""
    encs = [_encoder(seed=s) for s in range(3)]
    params, buffers = stack_module_state(encs)
    base = _encoder().to("meta")
    x = _inputs()
    weights = torch.randn(ROWS, HIDDEN, generator=torch.Generator()
                          .manual_seed(3))

    def forward(p, b, self_obs, neighbor_obs):
        return functional_call(base, (p, b), (self_obs, neighbor_obs))

    def loss(p, b, self_obs, neighbor_obs):
        return torch.mean(forward(p, b, self_obs, neighbor_obs) * weights)

    if not autograd:
        with torch.no_grad():
            got = torch.vmap(forward, in_dims=(0, 0, None, None))(
                params, buffers, *x)
        for i, enc in enumerate(encs):
            with torch.no_grad():
                torch.testing.assert_close(got[i], enc(*x), **TOL)
        return
    grads = torch.vmap(grad(loss), in_dims=(0, 0, None, None))(
        params, buffers, *x)
    for i, enc in enumerate(encs):
        enc.zero_grad()
        torch.mean(enc(*x) * weights).backward()
        for name, p in enc.named_parameters():
            torch.testing.assert_close(grads[name][i], p.grad, **GRAD_TOL,
                                       msg=lambda m: f"{i} {name}: {m}")


def test_recorded_attention_still_records_the_softmax_weights():
    kw = {**BASE, **CASES["corl-attention"]}
    model = t_ac.ActorCritic(**kw, obstacle_obs_dim=0, device="cpu")
    obs = torch.randn(29, 19 + 6 * kw["num_neighbors"])
    with torch.no_grad(), recorded_attention(model) as found:
        model(obs)
    assert set(found) == {"actor_encoder.neighbor_encoder",
                          "critic_encoder.neighbor_encoder"}
    for name, sink in found.items():
        (alpha,) = sink
        assert alpha.shape == (29, kw["num_neighbors"]), name
        torch.testing.assert_close(alpha.sum(1), torch.ones(29), **TOL)


def test_parameters_keep_their_keys_and_shapes():
    want = {}
    for mlp, dims in (("embedding_mlp", (SELF + NB, HIDDEN, HIDDEN)),
                      ("neighbor_value_mlp", (HIDDEN, HIDDEN, HIDDEN)),
                      ("attention_mlp", (2 * HIDDEN, HIDDEN, HIDDEN, 1))):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            want[f"{mlp}.layers.{i}.weight"] = (b, a)
            want[f"{mlp}.layers.{i}.bias"] = (b,)
    got = {k: tuple(v.shape) for k, v in _encoder().state_dict().items()}
    assert got == want


class _Shapes(TorchDispatchMode):
    """The shape of every tensor an operator returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append((str(func), tuple(t.shape)))
        return out


@pytest.mark.parametrize("case", ["float32-no_grad", "float32-grad",
                                  "bfloat16-no_grad"])
def test_forward_creates_no_tensor_two_hidden_wide(case):
    """Neither the concatenation [e_i; mean e] nor a copy of the first
    layer's whole (hidden, 2 * hidden) weight."""
    dtype, mode = case.split("-")
    enc = _encoder(getattr(torch, dtype))
    x = _inputs()
    with torch.set_grad_enabled(mode == "grad"), _Shapes() as seen:
        enc(*x)
    assert seen.shapes
    wide = [(op, s) for op, s in seen.shapes if s and s[-1] == 2 * HIDDEN]
    assert not wide, wide
