"""The port's training path against the JAX package, and on its own.

Against quadswarm_tpu, on inputs made from numpy seeds (float32 on both
sides):
- `compute_gae` (rtol 1e-5, atol 1e-5);
- `ppo_loss` and its gradients from weights carried across by
  `actor_critic_from_flax`, with and without normalizers (loss and metrics
  rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-6);
- two consecutive clip + Adam steps against
  optax.flatten(chain(clip_by_global_norm, adam)), the first above the clip
  norm, the second below (parameters and Adam moments rtol 1e-5, atol 1e-7);
- `shuffled_minibatches` under the JAX package's own permutations, tiled
  and strided, one and two env groups (equal);
- `RunningMeanStd.update` / `update_masked` (rtol 1e-6);
- `episode_stat_sums` + `stats_from_sums` (rtol 1e-6);
- the flags of `train.sh` and `train_local_obst.sh` through both packages'
  `parse_swarm_cfg`.
On the port alone: the minibatch layout the JAX package cannot cut, a
checkpoint round trip, the CLI with a resume, and a Trainer.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shlex
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quadswarm_tpu.models import actor_critic as j_ac
from quadswarm_tpu.parallel import normalize as j_norm
from quadswarm_tpu.parallel import ppo as j_ppo
from quadswarm_tpu.training import config as j_config
from quadswarm_tpu.utils import metrics as j_metrics
from quadswarm_tpu_torch.env.multi import EnvConfig
from quadswarm_tpu_torch.env.params import make_dynamics_params
from quadswarm_tpu_torch.models import actor_critic as t_ac
from quadswarm_tpu_torch.parallel import normalize as t_norm
from quadswarm_tpu_torch.parallel import ppo as t_ppo
from quadswarm_tpu_torch.training import config as t_config
from quadswarm_tpu_torch.utils import checkpoint as t_ckpt
from quadswarm_tpu_torch.utils import metrics as t_metrics
from quadswarm_tpu_torch.utils.convert import (
    actor_critic_from_flax, norm_state_from_numpy,
)

ROOT = Path(__file__).resolve().parents[1]
K = 2                                   # visible neighbours
OBS_DIM = 18 + 6 * K
MODEL_KW = dict(action_dim=4, self_obs_dim=18, neighbor_obs_dim=6,
                num_neighbors=K, neighbor_hidden=32, rnn_size=32)
PPO_KW = dict(ppo_clip_ratio=0.1, ppo_clip_value=0.5, value_loss_coeff=0.5,
              exploration_loss_coeff=0.01, max_entropy_coeff=0.002)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _models(seed=0):
    jmodel = j_ac.ActorCritic(**MODEL_KW, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, OBS_DIM), jnp.float32))
    params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    params["params"]["log_std"] = jnp.asarray([-0.5, 0.1, 0.3, -1.2],
                                              jnp.float32)
    tmodel = t_ac.ActorCritic(**MODEL_KW, device="cpu")
    tmodel.load_state_dict(actor_critic_from_flax(
        jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _assert_tree_close(port_named: dict, flax_tree, **tol):
    want = actor_critic_from_flax(jax.tree.map(np.asarray, flax_tree))
    assert set(port_named) == set(want)
    for name, got in port_named.items():
        np.testing.assert_allclose(got.detach().numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


# --------------------------------------------------------------------------
# GAE, loss, optimizer
# --------------------------------------------------------------------------

def test_compute_gae_matches_jax():
    rng = np.random.default_rng(0)
    t, e, n = 9, 3, 4
    value = rng.normal(0, 1, (t, e, n)).astype(np.float32)
    reward = rng.normal(0, 1, (t, e, n)).astype(np.float32)
    done = rng.uniform(0, 1, (t, e, n)) < 0.2
    last = rng.normal(0, 1, (e, n)).astype(np.float32)
    zeros = np.zeros((t, e, n), np.float32)
    jt = j_ppo.Transition(obs=zeros, actions=zeros, log_prob=zeros,
                          value=jnp.asarray(value), reward=jnp.asarray(reward),
                          done=jnp.asarray(done))
    want = j_ppo.compute_gae(jt, jnp.asarray(last), 0.99, 0.95)
    tt = t_ppo.Transition(obs=_t(zeros), actions=_t(zeros),
                          log_prob=_t(zeros), value=_t(value),
                          reward=_t(reward), done=torch.from_numpy(done))
    got = t_ppo.compute_gae(tt, _t(last), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def _batch(rng, b=64):
    return (rng.normal(0, 1.5, (b, OBS_DIM)).astype(np.float32),
            rng.normal(0, 1, (b, 4)).astype(np.float32),
            rng.normal(-4, 1, (b,)).astype(np.float32),
            rng.normal(0, 1, (b,)).astype(np.float32),
            rng.normal(0.3, 2, (b,)).astype(np.float32),
            rng.normal(0, 1, (b,)).astype(np.float32))


def _norm_pair(rng, on: bool):
    if not on:
        return None, None
    obs = j_norm.RunningMeanStd.create(OBS_DIM).update(
        jnp.asarray(rng.normal(0.5, 2, (50, OBS_DIM)).astype(np.float32)))
    ret = j_norm.RunningMeanStd.create().update(
        jnp.asarray(rng.normal(1.0, 3, (50,)).astype(np.float32)))
    jn = j_norm.NormalizerState(obs=obs, ret=ret)
    tn = norm_state_from_numpy(
        jax.tree.map(np.asarray, {"obs": dataclasses.asdict(obs),
                                  "ret": dataclasses.asdict(ret)}))
    return jn, tn


@pytest.mark.parametrize("normalizers", [False, True])
def test_ppo_loss_and_gradients_match_jax(normalizers):
    jmodel, params, tmodel = _models()
    rng = np.random.default_rng(1)
    batch = _batch(rng)
    jn, tn = _norm_pair(rng, normalizers)
    jcfg = j_ppo.PPOConfig(**PPO_KW)
    tcfg = t_ppo.PPOConfig(**PPO_KW)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b, n: j_ppo.ppo_loss(jmodel, jcfg, p, b, norm=n),
        has_aux=True))
    (jloss, jmetrics), jgrads = grad_fn(
        params, tuple(jnp.asarray(x) for x in batch), jn)
    loss, metrics = t_ppo.ppo_loss(tmodel, tcfg, tuple(_t(x) for x in batch),
                                   tn)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5,
                               atol=1e-6)
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_tree_close({k: p.grad for k, p in tmodel.named_parameters()},
                       jgrads, rtol=1e-4, atol=1e-6)


def test_clip_and_adam_steps_match_optax():
    """max_grad_norm 1.0: the first step's gradients have norm above it,
    the second's below."""
    _, params, tmodel = _models(seed=3)
    lr, max_norm = 1e-3, 1.0
    tx = optax.flatten(optax.chain(optax.clip_by_global_norm(max_norm),
                                   optax.adam(lr)))
    opt_state = tx.init(params)
    topt = t_ppo.make_optimizer(tmodel, t_ppo.PPOConfig(learning_rate=lr))
    rng = np.random.default_rng(4)
    flat, unravel = jax.flatten_util.ravel_pytree(params)
    for above in (True, False):
        scale = (3.0 if above else 0.3) / np.sqrt(flat.size)
        g = rng.normal(0, scale, flat.shape).astype(np.float32)
        jgrads = unravel(jnp.asarray(g))
        assert (float(optax.global_norm(jgrads)) > max_norm) == above
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tg = actor_critic_from_flax(jax.tree.map(np.asarray, jgrads))
        for name, p in tmodel.named_parameters():
            p.grad = tg[name].clone()
        t_ppo.apply_gradients(tmodel, topt, max_norm)
        _assert_tree_close(dict(tmodel.named_parameters()), params,
                           rtol=1e-5, atol=1e-7)
        adam = opt_state[1][0]
        for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            want = actor_critic_from_flax(
                jax.tree.map(np.asarray, unravel(moment)))
            for name, p in tmodel.named_parameters():
                np.testing.assert_allclose(
                    topt.state[p][key].numpy(), want[name].numpy(),
                    rtol=1e-5, atol=1e-9, err_msg=f"{key} {name}")


# --------------------------------------------------------------------------
# Minibatch layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dims,batch,groups,tiled", [
    ((16, 4, 8), 128, 1, True),
    ((16, 4, 8), 128, 2, True),
    ((3, 4, 2), 8, 1, False),
    ((3, 4, 2), 8, 2, False),
])
def test_shuffled_minibatches_match_jax(dims, batch, groups, tiled):
    lay = t_ppo.minibatch_layout(dims, batch, groups)
    assert lay.tiled == tiled
    t, e, n = dims
    x = np.arange(t * e * n * 3, dtype=np.float32).reshape(t, e, n, 3)
    y = np.arange(t * e * n, dtype=np.float32).reshape(t, e, n) * -1
    key = jax.random.PRNGKey(7)
    want = j_ppo.shuffled_minibatches((jnp.asarray(x), jnp.asarray(y)), dims,
                                      batch, key, groups=groups)
    # the JAX package's own permutations (parallel/ppo.py:297-299)
    perms = jax.vmap(lambda k: jax.random.permutation(k, lay.num_chunks))(
        jax.random.split(key, lay.groups))
    got = t_ppo.shuffled_minibatches((_t(x), _t(y)), dims, batch, None,
                                     groups=groups,
                                     perms=torch.tensor(np.asarray(perms)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_shuffled_minibatches_where_tiles_do_not_divide_the_rollout():
    """dims (24, 4, 6), batch 192: 16-step tiles do not divide 24 steps.
    The port falls back to the strided layout; every sample is taken
    once."""
    dims = (24, 4, 6)
    lay = t_ppo.minibatch_layout(dims, 192)
    assert lay.tb == 16 and not lay.tiled
    x = torch.arange(24 * 4 * 6, dtype=torch.float32).reshape(dims)
    (got,) = t_ppo.shuffled_minibatches((x,), dims, 192,
                                        torch.Generator().manual_seed(0))
    assert got.shape == (3, 192)
    assert torch.equal(got.flatten().sort().values, x.flatten())


# --------------------------------------------------------------------------
# Normalizers and episode stats
# --------------------------------------------------------------------------

def test_running_mean_std_matches_jax():
    rng = np.random.default_rng(5)
    x1 = rng.normal(2, 3, (7, 5, 4)).astype(np.float32)
    x2 = rng.normal(-1, 0.5, (30, 4)).astype(np.float32)
    w = (rng.uniform(0, 1, 30) < 0.5).astype(np.float32)
    j = j_norm.RunningMeanStd.create(4).update(jnp.asarray(x1))
    t = t_norm.RunningMeanStd.create(4).update(_t(x1))
    jm, tm = j.update_masked(jnp.asarray(x2), jnp.asarray(w)), \
        t.update_masked(_t(x2), _t(w))
    je = j.update_masked(jnp.asarray(x2), jnp.zeros(30))
    te = t.update_masked(_t(x2), torch.zeros(30))
    for got, want in ((t, j), (tm, jm), (te, je)):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-6, err_msg=f)
    np.testing.assert_allclose(
        tm.normalize(_t(x2)).numpy(), np.asarray(jm.normalize(x2)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tm.denormalize(_t(x2)).numpy(), np.asarray(jm.denormalize(x2)),
        rtol=1e-5, atol=1e-6)


def test_episode_stats_match_jax():
    rng = np.random.default_rng(6)
    t, e, n = 6, 5, 3
    infos = {"episode_done": rng.uniform(0, 1, (t, e)) < 0.3,
             "scenario_mode": rng.choice([0, 1, 6, 8], (t, e)).astype(
                 np.int32),
             "num_collisions_after_settle": rng.integers(0, 4, (t, e)).astype(
                 np.int32),
             "distance_to_goal_1s": rng.uniform(0, 2, (t, e, n)).astype(
                 np.float32),
             "metric/agent_success_rate": rng.uniform(0, 1, (t, e)).astype(
                 np.float32),
             "true_reward": rng.normal(0, 5, (t, e, n)).astype(np.float32),
             "replay/replay_rate": rng.uniform(0, 1, (t, e)).astype(
                 np.float32),
             "rewards/rew_pos": rng.normal(0, 1, (t, e, n)).astype(
                 np.float32)}
    infos["episode_done"][0, 0] = True
    want = j_metrics.stats_from_sums(jax.tree.map(
        np.asarray, j_metrics.episode_stat_sums(
            {k: jnp.asarray(v) for k, v in infos.items()})))
    sums = t_metrics.episode_stat_sums(
        {k: torch.from_numpy(v) for k, v in infos.items()})
    got = t_metrics.stats_from_sums({k: v.numpy() for k, v in sums.items()})
    assert set(got) == set(want) and "static_same_goal/num_collisions" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    host = t_metrics.aggregate_episode_stats(infos)
    for k, v in want.items():
        np.testing.assert_allclose(host[k], v, rtol=1e-5, err_msg=k)


# --------------------------------------------------------------------------
# Config, checkpoints, Trainer, CLI
# --------------------------------------------------------------------------

def _train_sh_flags(script: str = "train.sh") -> list:
    text = (ROOT / script).read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if "quadswarm_tpu.training.train" in ln)
    words = shlex.split(line)
    return [w for w in words[words.index("quadswarm_tpu.training.train") + 1:]
            if w != "$@"]


TINY = ["--num_envs=4", "--rollout=8", "--batch_size=32",
        "--quads_num_agents=4", "--quads_neighbor_visible_num=2",
        "--rnn_size=32", "--quads_neighbor_hidden_size=32",
        "--quads_episode_duration=0.5", "--device=cpu"]


@pytest.mark.parametrize("script", ["train.sh", "train_local_obst.sh"])
def test_train_sh_flags_parse_alike_in_both_packages(script):
    flags = _train_sh_flags(script)
    assert "--replay_buffer_sample_prob=0.75" in flags
    ja, ta = j_config.parse_swarm_cfg(flags), t_config.parse_swarm_cfg(flags)
    assert ta.device == "cuda"
    assert dataclasses.asdict(t_config.ppo_config_from_args(ta)) == {
        f.name: getattr(j_config.ppo_config_from_args(ja), f.name)
        for f in dataclasses.fields(t_ppo.PPOConfig)}
    jenv, tenv = j_config.env_config_from_args(ja), \
        t_config.env_config_from_args(ta)
    backend = ("use_pallas_pairs", "use_pallas_dynamics", "dtype")
    for f in dataclasses.fields(EnvConfig):
        if f.name not in backend:
            assert getattr(tenv, f.name) == getattr(jenv, f.name), f.name
    assert tenv.use_pallas_dynamics and not tenv.use_pallas_pairs
    jmodel = j_config.model_from_args(ja, jenv)
    for k, v in t_config.model_kwargs_from_args(ta, tenv).items():
        assert v == getattr(jmodel, k), k
    assert t_config.anneal_schedules_from_args(ta) == \
        j_config.anneal_schedules_from_args(ja)
    assert t_config.base_rew_coeff_from_args(ta) == \
        j_config.base_rew_coeff_from_args(ja)
    pairs = t_config.parse_swarm_cfg(flags + ["--quads_use_pallas_pairs=true"])
    assert t_config.env_config_from_args(pairs).use_pallas_pairs


@pytest.mark.parametrize("extra,error", [
    (["--quads_use_pallas=false"], ValueError),
    (["--async_rl=True", "--appo_split_devices=2"], ValueError),
])
def test_flags_of_paths_not_ported_are_refused(extra, error):
    with pytest.raises(error, match="plain|R,L"):
        t_config.parse_swarm_cfg(_train_sh_flags() + extra)


@pytest.mark.parametrize("extra", [
    ["--quads_mode=o_swap_goals"], ["--quads_mode=run_away"],
    ["--with_pbt=True", "--num_policies=4",
     "--pbt_mix_policies_in_one_env=True"],
    ["--dtype=bfloat16"], ["--model_dtype=bfloat16"],
    ["--async_rl=True", "--appo_split_devices=1,1"], ["--multi_host=True"]],
    ids=["o_swap_goals", "run_away", "pbt_mixed", "dtype_bf16",
         "model_dtype_bf16", "appo_split", "multi_host"])
def test_flags_of_ported_paths_parse(extra):
    """Flags the CLI refused before their paths were ported parse into an
    env config and a model that run them: scenario modes, mixed-policy
    PBT, the bfloat16 env and the bfloat16 model, APPO's split and the
    multi-rank job."""
    args = t_config.parse_swarm_cfg(_train_sh_flags() + extra)
    assert t_config.appo_split_from_args(args) == (
        (1, 1) if "--appo_split_devices=1,1" in extra else None)
    assert args.multi_host == ("--multi_host=True" in extra)
    env = t_config.env_config_from_args(args)
    env.check_supported()
    if "--quads_mode" in extra[0]:
        assert env.quads_mode == extra[0].split("=")[1]
    assert env.dtype == (torch.bfloat16 if "--dtype=bfloat16" in extra
                         else torch.float32)
    assert t_config.model_dtype_from_args(args) == (
        torch.bfloat16 if "--model_dtype=bfloat16" in extra
        else torch.float32)
    assert args.pbt_mix_policies_in_one_env == ("--num_policies=4" in extra)


def _tiny_trainer(seed=0, replay=0.75):
    cfg = EnvConfig(num_agents=4, quads_mode="mix", neighbor_obs_type="pos_vel",
                    neighbor_visible_num=K, use_downwash=True, ep_time=0.08)
    torch.manual_seed(seed)
    model = t_ac.ActorCritic(**MODEL_KW, device="cpu")
    ppo = t_ppo.PPOConfig(rollout=8, batch_size=32, num_envs=4,
                          replay_sample_prob=replay, normalize_input=True,
                          normalize_returns=True)
    return t_ppo.Trainer(cfg, ppo, model, make_dynamics_params(dt=cfg.dt),
                         seed=seed, anneal_schedules={"quadcol_bin": (5.0,
                                                                      300)},
                         device="cpu")


def test_trainer_three_iterations_update_the_policy():
    tr = _tiny_trainer()
    before = [p.detach().clone() for p in tr.model.parameters()]
    done_seen = False
    for i in range(3):
        metrics, infos = tr.iteration()
        for k in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl",
                  "reward_mean"):
            assert torch.isfinite(metrics[k]), k
        done_seen |= bool(infos["episode_done"].any())
    assert done_seen and tr.episode_stats(infos)["num_episodes"] > 0
    assert tr.env_steps == 3 * 8 * 4 * 4 and tr.step == 3 * 4
    assert all(not torch.equal(a, b) for a, b in zip(
        before, tr.model.parameters()))
    assert float(tr.norm_state.obs.count) > 3 * 8 * 16
    assert tr.current_rew_coeff().quadcol_bin == 5.0     # ramp over 300
    tr.env_steps = 150
    assert tr.current_rew_coeff().quadcol_bin == 2.5


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    tr = _tiny_trainer()
    tr.iteration()
    d = str(tmp_path)
    for i in range(4):
        tr.env_steps += 1
        path = t_ckpt.save_checkpoint(d, tr.model, tr.optimizer, tr.step,
                                      tr.env_steps, keep=3,
                                      extra=tr.norm_state)
    t_ckpt.save_checkpoint(d, tr.model, tr.optimizer, tr.step, tr.env_steps,
                           keep=1, tag="best", extra=tr.norm_state)
    assert len(t_ckpt.get_checkpoints(d)) == 3
    assert len(t_ckpt.get_checkpoints(d, "best")) == 1
    assert t_ckpt.latest_checkpoint(d) == path
    assert t_ckpt.env_steps_of(path) == tr.env_steps

    other = _tiny_trainer(seed=1)
    step, env_steps, norm = t_ckpt.load_checkpoint(
        path, other.model, other.optimizer, extra=other.norm_state)
    assert (step, env_steps) == (tr.step, tr.env_steps)
    for (name, a), b in zip(tr.model.state_dict().items(),
                            other.model.state_dict().values()):
        assert torch.equal(a, b), name
    for p, q in zip(tr.model.parameters(), other.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(tr.optimizer.state[p][key],
                               other.optimizer.state[q][key]), key
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(norm.obs, f), getattr(tr.norm_state.obs, f))
        assert torch.equal(getattr(norm.ret, f), getattr(tr.norm_state.ret, f))


# The CLI as `python -m` runs it, with TensorBoard's package hidden (where
# TensorFlow is installed, importing it loads TensorFlow, seconds of CPU
# time; the logger then writes JSONL only, as where it is absent).
RUN_CLI = ("import runpy, sys; sys.modules['torch.utils.tensorboard'] = None; "
           "runpy.run_module('quadswarm_tpu_torch.training.train', "
           "run_name='__main__')")


def test_train_cli_writes_and_resumes(tmp_path, monkeypatch):
    base = _train_sh_flags() + TINY + [
        f"--train_dir={tmp_path}", "--experiment=cli", "--log_every_iters=1"]
    steps = 8 * 4 * 4                                   # an iteration
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable, "-c", RUN_CLI, *base,
                    f"--train_for_env_steps={2 * steps}"], cwd=ROOT,
                   env=env, check=True, timeout=300)
    exp = tmp_path / "cli"
    cfg = json.loads((exp / "config.json").read_text())
    assert cfg["replay_buffer_sample_prob"] == 0.75 and cfg["device"] == "cpu"
    cps = t_ckpt.get_checkpoints(str(exp / "checkpoint_p0"))
    assert [t_ckpt.env_steps_of(p) for p in cps] == [2 * steps]
    saved = torch.load(cps[-1], weights_only=True)

    from quadswarm_tpu_torch.training import train
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train.main(base + [f"--train_for_env_steps={3 * steps}"]) == 0
    lines = [json.loads(x) for x in (exp / "metrics.jsonl").read_text()
             .splitlines()]
    assert [r["env_steps"] for r in lines] == [steps, 2 * steps, 3 * steps]
    assert all(np.isfinite(r["loss"]) and r["perf/sps"] > 0 for r in lines)
    cps = t_ckpt.get_checkpoints(str(exp / "checkpoint_p0"))
    assert [t_ckpt.env_steps_of(p) for p in cps] == [2 * steps, 3 * steps]
    resumed = torch.load(cps[-1], weights_only=True)
    assert resumed["step"] == saved["step"] + steps // 32
    assert resumed["env_steps"] == 3 * steps
