"""Parity of the port's encoder zoo with the JAX package's.

A flax ActorCritic's parameters are made from a numpy seed for each
encoder type the run files use: the 'corl' encoder with the attention,
mean_embed and mlp neighbour encoders, with and without the obstacle
encoder; the 'attention' encoder type and its sim2real variant, with
obstacles.  They are carried over by
`utils/convert.py::actor_critic_from_flax`, and both models run on the same
observations in float32: mean, log std and value agree within rtol 1e-5 /
atol 1e-6, and the gradients of one backward pass (of a loss of batch
means, as the PPO loss is) within rtol 1e-4 / atol 1e-6, the bound
`tests/test_torch_training.py` holds the PPO loss's gradients to.  The
'attention' type without an obstacle slice is refused by the port; the
JAX package fails there at init.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.models import actor_critic as j_ac
from quadswarm_tpu_torch.models import actor_critic as t_ac
from quadswarm_tpu_torch.utils.convert import actor_critic_from_flax
from .flax_params import random_flax_params

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
K = 3                                   # visible neighbours
BASE = dict(action_dim=4, self_obs_dim=19, neighbor_obs_dim=6,
            num_neighbors=K, neighbor_hidden=24, obstacle_hidden=20,
            rnn_size=32)
CASES = {
    "corl-attention": dict(encoder_type="corl",
                           neighbor_encoder_type="attention"),
    "corl-attention-obst": dict(encoder_type="corl", use_obstacles=True,
                                neighbor_encoder_type="attention"),
    "corl-mean_embed": dict(encoder_type="corl",
                            neighbor_encoder_type="mean_embed"),
    "corl-mean_embed-obst": dict(encoder_type="corl", use_obstacles=True,
                                 neighbor_encoder_type="mean_embed"),
    "corl-mlp": dict(encoder_type="corl", neighbor_encoder_type="mlp"),
    "corl-mlp-obst": dict(encoder_type="corl", use_obstacles=True,
                          neighbor_encoder_type="mlp"),
    "attention-obst": dict(encoder_type="attention", use_obstacles=True),
    "attention-sim2real-obst": dict(encoder_type="attention",
                                    use_obstacles=True, sim2real=True),
}


def _obs_dim(kw):
    # the env emits the SDF with obstacles; these cases set both
    return 19 + 6 * K + (9 if kw.get("use_obstacles") else 0)


def _pair(case: str, seed: int = 0):
    kw = {**BASE, **CASES[case]}
    jmodel = j_ac.ActorCritic(**kw, dtype=jnp.float32)
    params = random_flax_params(jmodel, _obs_dim(kw), seed)
    tmodel = t_ac.ActorCritic(
        **kw, obstacle_obs_dim=9 if kw.get("use_obstacles") else 0,
        device="cpu")
    converted = actor_critic_from_flax(params)
    assert set(converted) == set(tmodel.state_dict()), case
    tmodel.load_state_dict(converted)
    return jmodel, jax.tree.map(jnp.asarray, params), tmodel, _obs_dim(kw)


@pytest.mark.parametrize("case", list(CASES))
def test_encoder_forward_and_gradients_match_jax(case):
    jmodel, params, tmodel, obs_dim = _pair(case)
    # the heads take the encoder's width (rnn_size under sim2real's
    # attention encoder, else 2 * rnn_size), as flax's Dense infers it
    width = params["params"]["action_head"]["kernel"].shape[0]
    assert width == (32 if "sim2real" in case else 64)
    assert tmodel.action_head.in_features == width
    rng = np.random.default_rng(len(case))
    obs = rng.normal(0, 2, (29, obs_dim)).astype(np.float32)
    w_mean = rng.normal(size=(29, 4)).astype(np.float32)
    w_value = rng.normal(size=29).astype(np.float32)

    @jax.jit
    def j_forward_and_grads(p, x):
        def loss(q):
            out = jmodel.apply(q, x)
            mean, log_std, value = out
            return (jnp.mean(mean * w_mean) + jnp.mean(value * w_value)
                    + jnp.mean(log_std ** 2)), out
        return jax.grad(loss, has_aux=True)(p)

    grads, want = j_forward_and_grads(params, jnp.asarray(obs))
    got = tmodel(torch.from_numpy(obs))
    for name, g, w in zip(("mean", "log_std", "value"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=f"{case} {name}", **TOL)
    mean, log_std, value = got
    (torch.mean(mean * torch.from_numpy(w_mean))
     + torch.mean(value * torch.from_numpy(w_value))
     + torch.mean(log_std ** 2)).backward()
    j_grads = actor_critic_from_flax(jax.tree.map(np.asarray, grads))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(),
                                   err_msg=f"{case} grad {name}", **GRAD_TOL)


def test_attention_type_without_obstacles_is_refused():
    """With no observation after the neighbour slice the JAX module embeds a
    0-wide slice and its init divides by zero; the port refuses it."""
    kw = {**BASE, **CASES["attention-obst"], "use_obstacles": False}
    with pytest.raises(ValueError, match="ZeroDivisionError"):
        t_ac.ActorCritic(**kw, obstacle_obs_dim=0, device="cpu")
    jmodel = j_ac.ActorCritic(**kw, dtype=jnp.float32)
    with pytest.raises(ZeroDivisionError):
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 19 + 6 * K), jnp.float32))
