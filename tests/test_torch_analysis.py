"""The port's analysis tools and weight recycler on the CPU, against the
JAX package's.

- `extract_scalars` reads the JAX tool's steps and values from the same
  `metrics.jsonl`; the curves and the SPS chart write PNGs.
- The weight recycler: scores and masks equal the JAX package's on the
  same activations; a recycled unit's bias and outgoing weights are exactly
  zero, the other units' weights unchanged, and the fresh incoming weights
  follow flax's truncated LeCun normal (|x| <= 2 std, sample std within
  10% of sqrt(1 / fan_in) at fan_in 256).
- The attention record: `recorded_attention` gives the softmax the flax
  module sows as "attn" on the same weights and observations; it keeps
  nothing outside its block.  `episode_attention` over 10 ticks at 4
  drones is row-stochastic with a zero diagonal; the heat-map CLI writes
  its PNG.
- `profile_train` prints its three phases.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.analysis import plots as j_plots
from quadswarm_tpu.models import weight_recycler as j_recycler
from quadswarm_tpu.models.actor_critic import ActorCritic as JActorCritic
from quadswarm_tpu_torch.analysis import attention, plots, profile_train
from quadswarm_tpu_torch.env.multi import EnvConfig
from quadswarm_tpu_torch.env.params import make_dynamics_params
from quadswarm_tpu_torch.models import weight_recycler as recycler
from quadswarm_tpu_torch.models.actor_critic import ActorCritic
from quadswarm_tpu_torch.models.encoders import recorded_attention
from quadswarm_tpu_torch.training import config as t_config
from quadswarm_tpu_torch.utils.convert import actor_critic_from_flax

from .flax_params import random_flax_params


def _write_metrics(d, seed, n=20):
    exp = d / f"exp_s{seed}"
    exp.mkdir()
    with open(exp / "metrics.jsonl", "w") as f:
        for i in range(n):
            rec = {"env_steps": i * 1000, "loss": 1.0 / (i + 1),
                   "metric/agent_success_rate": 0.5 + 0.02 * i + 0.01 * seed}
            if i % 3 == 0:
                del rec["loss"]           # a metric missing from some lines
            f.write(json.dumps(rec) + "\n")
    return str(exp)


def test_extract_scalars_and_plots(tmp_path):
    dirs = [_write_metrics(tmp_path, s) for s in range(3)]
    for metric in ("metric/agent_success_rate", "loss"):
        got = plots.extract_scalars(dirs[1], metric)
        want = j_plots.extract_scalars(dirs[1], metric)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    out = tmp_path / "curves.png"
    assert plots.main(["--experiments", str(tmp_path / "exp_s*"),
                       "--metrics", "metric/agent_success_rate", "loss",
                       "--out", str(out)]) == 0
    assert out.stat().st_size > 1000
    fps = tmp_path / "fps.png"
    assert plots.main(["--fps_compare", "--measured", '{"8": 1e6}',
                       "--out", str(fps)]) == 0
    assert fps.stat().st_size > 1000
    assert plots.REFERENCE_SPS == j_plots.REFERENCE_SPS
    assert plots.PYBULLET_SPS == j_plots.PYBULLET_SPS


@pytest.mark.parametrize("normalize", [False, True])
def test_neuron_scores_and_mask_equal_jax(normalize):
    act = np.random.default_rng(0).normal(size=(32, 7, 16)).astype(
        np.float32)
    act[..., 3] *= 1e-3                      # a dormant unit
    got = recycler.estimate_neuron_score(torch.from_numpy(act), normalize)
    want = j_recycler.estimate_neuron_score(jnp.asarray(act), normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    mask = recycler.dormant_mask(torch.from_numpy(act))
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(j_recycler.dormant_mask(jnp.asarray(act))))
    assert mask.tolist() == [i == 3 for i in range(16)]


def test_recycle_dense_pair():
    """The port's layout: w_in (d_hidden, d_in), w_out (d_out, d_hidden)."""
    d_in, d_hidden, d_out = 256, 64, 5
    rng = np.random.default_rng(1)
    w_in = torch.from_numpy(rng.normal(size=(d_hidden, d_in)))
    b_in = torch.from_numpy(rng.normal(size=d_hidden))
    w_out = torch.from_numpy(rng.normal(size=(d_out, d_hidden)))
    mask = torch.zeros(d_hidden, dtype=torch.bool)
    mask[::2] = True
    gen = torch.Generator().manual_seed(0)
    w_in2, b_in2, w_out2 = recycler.recycle_dense_pair(gen, w_in, b_in,
                                                       w_out, mask)
    assert (b_in2[mask] == 0).all() and (w_out2[:, mask] == 0).all()
    assert torch.equal(w_in2[~mask], w_in[~mask])
    assert torch.equal(b_in2[~mask], b_in[~mask])
    assert torch.equal(w_out2[:, ~mask], w_out[:, ~mask])
    fresh = w_in2[mask]
    std = np.sqrt(1.0 / d_in) / 0.87962566103423978
    assert float(fresh.abs().max()) <= 2 * std
    assert abs(float(fresh.std()) / np.sqrt(1.0 / d_in) - 1) < 0.1
    # the JAX package's recycle of the same tensors, in its (in, out)
    # layout, zeroes the same entries and keeps the same ones
    jw_in, jb_in, jw_out = j_recycler.recycle_dense_pair(
        jax.random.PRNGKey(0), jnp.asarray(w_in.numpy().T),
        jnp.asarray(b_in.numpy()), jnp.asarray(w_out.numpy().T),
        jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(np.asarray(jb_in), b_in2.numpy())
    np.testing.assert_array_equal(np.asarray(jw_out).T, w_out2.numpy())
    np.testing.assert_array_equal(np.asarray(jw_in).T[~mask.numpy()],
                                  w_in2[~mask].numpy())


def test_recorded_attention_equals_the_sown_softmax():
    kw = dict(self_obs_dim=18, neighbor_obs_dim=6, num_neighbors=3,
              neighbor_encoder_type="attention", rnn_size=16,
              neighbor_hidden=16)
    jmodel = JActorCritic(**kw)
    tree = random_flax_params(jmodel, 36, 6)
    model = ActorCritic(**kw, device="cpu")
    model.load_state_dict(actor_critic_from_flax(tree))
    obs = np.random.default_rng(2).normal(size=(5, 36)).astype(np.float32)
    _, inter = jmodel.apply(tree, jnp.asarray(obs),
                            mutable=["intermediates"])
    want = inter["intermediates"]["actor_encoder"]["neighbor_encoder"][
        "attn"][0]
    with torch.no_grad(), recorded_attention(model) as sinks:
        model(torch.from_numpy(obs))
    assert sorted(sinks) == ["actor_encoder.neighbor_encoder",
                             "critic_encoder.neighbor_encoder"]
    (got,) = sinks["actor_encoder.neighbor_encoder"]
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    enc = model.actor_encoder.neighbor_encoder
    assert enc.sink is None
    model(torch.from_numpy(obs))                # keeps nothing outside
    assert enc.sink is None


def test_episode_attention_and_the_cli(tmp_path, capsys):
    cfg = EnvConfig(num_agents=4, ep_time=2.0, neighbor_obs_type="pos_vel",
                    neighbor_visible_num=2, quads_mode="static_same_goal")
    model = ActorCritic(self_obs_dim=18, neighbor_obs_dim=6, num_neighbors=2,
                        rnn_size=16, neighbor_hidden=16, device="cpu")
    mat = attention.episode_attention(
        cfg, make_dynamics_params(dt=cfg.dt), model,
        torch.Generator().manual_seed(1), max_ticks=10, device="cpu")
    assert mat.shape == (4, 4)
    np.testing.assert_allclose(mat.sum(axis=1), np.ones(4), rtol=1e-12)
    np.testing.assert_array_equal(np.diag(mat), np.zeros(4))
    assert model.actor_encoder.neighbor_encoder.sink is None
    # the CLI on an experiment's config.json, without a checkpoint
    args = t_config.parse_swarm_cfg([
        "--quads_num_agents=3", "--quads_neighbor_obs_type=pos_vel",
        "--quads_neighbor_visible_num=2", "--rnn_size=16",
        "--quads_neighbor_hidden_size=16", "--device=cpu"])
    t_config.save_cfg(args, str(tmp_path / "exp"))
    out = tmp_path / "attn.png"
    assert attention.main([f"--train_dir={tmp_path}", "--experiment=exp",
                           f"--out={out}", "--max_ticks=5",
                           "--device=cpu"]) == 0
    line = json.loads(next(ln for ln in capsys.readouterr().out.splitlines()
                           if ln.startswith("{")))
    assert line["out"] == str(out) and out.stat().st_size > 1000
    assert line["mean_offdiag"] == pytest.approx(1 / 2)


def test_profile_train_prints_its_three_phases(capsys):
    with pytest.raises(SystemExit):
        profile_train.main(["--sgd_unroll=2", "--device=cpu"])
    results = profile_train.main([
        "--num_envs=2", "--num_agents=2", "--rollout=4", "--batch_size=8",
        "--iters=1", "--device=cpu", "--model_f32"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == results
    assert [r["phase"] for r in lines] == ["rollout", "gae+sgd",
                                           "full_iteration"]
    for r in lines:
        # the delta of two CPU timings at this size may round to 0
        assert r["ms_per_iter"] >= 0 and r["device"] == "cpu"
        assert r["model_dtype"] == "float32" and r["replay"] is True
