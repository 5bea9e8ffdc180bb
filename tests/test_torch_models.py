"""Parity of the port's actor-critic with the JAX package's.

A flax ActorCritic (CoRL attention encoder, separate actor and critic) is
initialised from a seed, its parameters converted with
`utils/convert.py::actor_critic_from_flax`, and both run on the same
observations in float32 (TF32 off): mean, log std, value, log-prob and
entropy agree within atol 2e-5.
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

ATOL = dict(rtol=0.0, atol=2e-5)
KW = dict(action_dim=4, self_obs_dim=18, neighbor_obs_dim=6,
          num_neighbors=6, encoder_type="corl",
          neighbor_encoder_type="attention", neighbor_hidden=32, rnn_size=48)


def _models(seed: int = 0):
    jmodel = j_ac.ActorCritic(**KW, dtype=jnp.float32)
    obs_dim = 18 + 6 * KW["num_neighbors"]
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, obs_dim), jnp.float32))
    params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    # a non-trivial log std, so its loading is checked too
    params["params"]["log_std"] = jnp.asarray([-0.5, 0.1, 0.3, -1.2],
                                              jnp.float32)
    tmodel = t_ac.ActorCritic(**KW, device="cpu")
    tmodel.load_state_dict(actor_critic_from_flax(
        jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel, obs_dim


def test_converted_state_dict_covers_every_parameter():
    _, params, tmodel, _ = _models()
    converted = actor_critic_from_flax(jax.tree.map(np.asarray, params))
    assert set(converted) == set(tmodel.state_dict())
    w = params["params"]["actor_encoder"]["self_encoder"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(
        tmodel.actor_encoder.self_encoder.layers[0].weight.detach().numpy(),
        np.asarray(w).T)


@pytest.mark.parametrize("batch", [1, 37])
def test_apply_fused_matches_jax(batch):
    jmodel, params, tmodel, obs_dim = _models()
    obs = np.random.default_rng(batch).normal(0, 2, (batch, obs_dim)).astype(
        np.float32)
    want = j_ac.apply_fused(jmodel, params, jnp.asarray(obs))
    with torch.no_grad():
        got = t_ac.apply_fused(tmodel, torch.from_numpy(obs))
    for name, g, w in zip(("mean", "log_std", "value"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **ATOL)


def test_log_prob_entropy_and_sampling_match_jax():
    jmodel, params, tmodel, obs_dim = _models(1)
    rng = np.random.default_rng(2)
    obs = rng.normal(0, 2, (16, obs_dim)).astype(np.float32)
    normal = rng.standard_normal((16, 4)).astype(np.float32)
    mean, log_std, _ = j_ac.apply_fused(jmodel, params, jnp.asarray(obs))
    actions = mean + jnp.exp(log_std) * jnp.asarray(normal)
    with torch.no_grad():
        tmean, tlog_std, _ = t_ac.apply_fused(tmodel, torch.from_numpy(obs))
        tactions = t_ac.sample_actions(None, tmean, tlog_std,
                                       torch.from_numpy(normal))
        tlogp = t_ac.gaussian_log_prob(tmean, tlog_std, tactions)
        tent = t_ac.gaussian_entropy(tlog_std)
    np.testing.assert_allclose(tactions.numpy(), np.asarray(actions), **ATOL)
    np.testing.assert_allclose(
        tlogp.numpy(),
        np.asarray(j_ac.gaussian_log_prob(mean, log_std, actions)), **ATOL)
    np.testing.assert_allclose(
        tent.numpy(), np.asarray(j_ac.gaussian_entropy(log_std)), **ATOL)


def test_unported_variants_raise():
    """The 'attention' encoder type without an observation after the
    neighbour slice is refused (the JAX package fails on it at init); a
    bfloat16 model builds with float32 parameters and computes in bfloat16,
    and a float16 one is refused."""
    with pytest.raises(ValueError, match="ZeroDivisionError"):
        t_ac.ActorCritic(**{**KW, "encoder_type": "attention"},
                         obstacle_obs_dim=0, device="cpu")
    model = t_ac.ActorCritic(**KW, dtype=torch.bfloat16, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    mean, log_std, value = model(torch.zeros((2, 54)))
    assert (mean.dtype, log_std.dtype, value.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    with pytest.raises(NotImplementedError):
        t_ac.ActorCritic(**KW, dtype=torch.float16, device="cpu")
