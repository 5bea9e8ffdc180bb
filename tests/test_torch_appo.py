"""The port's APPO (parallel/appo.py) against the JAX package's.

Against quadswarm_tpu, on inputs made from numpy seeds, in float32:
- `vtrace_advantages` on a random (T=6, E=3, N=2) trajectory with episode
  ends, at clips 0.5, 1.0 and 2.0 (rtol 1e-5, atol 1e-6);
- V-trace on-policy with unit clips against `compute_gae` with lambda 1;
- the learner's targets (values and log-probs recomputed under the
  current weights, then V-trace or GAE) against JAX's `apply_fused` plus
  `vtrace_advantages` / `compute_gae` on the same weights, trajectory and
  normalizers (rtol 1e-5, atol 1e-6);
- the behaviour's weights over 4 iterations at policy lag 0, 1 and 2
  against a `collections.deque` of the same maxlen driven as the JAX
  `APPOTrainer.iteration` drives its queue.
On the port alone: a tiny APPOTrainer for 2 iterations with V-trace.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.models import actor_critic as j_ac
from quadswarm_tpu.parallel import appo as j_appo
from quadswarm_tpu.parallel import normalize as j_norm
from quadswarm_tpu.parallel import ppo as j_ppo
from quadswarm_tpu_torch.env.multi import EnvConfig
from quadswarm_tpu_torch.env.params import make_dynamics_params
from quadswarm_tpu_torch.models import actor_critic as t_ac
from quadswarm_tpu_torch.parallel import appo as t_appo
from quadswarm_tpu_torch.parallel import ppo as t_ppo
from quadswarm_tpu_torch.utils.convert import (
    actor_critic_from_flax, norm_state_from_numpy,
)

from .flax_params import random_flax_params

TOL = dict(rtol=1e-5, atol=1e-6)
T, E, N = 6, 3, 2
K = 2                                   # visible neighbours
OBS_DIM = 18 + 6 * K
MODEL_KW = dict(action_dim=4, self_obs_dim=18, neighbor_obs_dim=6,
                num_neighbors=K, neighbor_hidden=16, rnn_size=16)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _random_steps(rng):
    reward = rng.normal(size=(T, E, N)).astype(np.float32)
    value = rng.normal(size=(T, E, N)).astype(np.float32)
    done = rng.random((T, E, N)) < 0.25
    last_value = rng.normal(size=(E, N)).astype(np.float32)
    return reward, value, done, last_value


@pytest.mark.parametrize("clip", [0.5, 1.0, 2.0])
def test_vtrace_matches_jax(clip):
    rng = np.random.default_rng(int(clip * 10))
    reward, value, done, last_value = _random_steps(rng)
    ratio = np.exp(rng.normal(0, 0.7, (T, E, N))).astype(np.float32)
    want = j_appo.vtrace_advantages(
        jnp.asarray(ratio), jnp.asarray(reward), jnp.asarray(value),
        jnp.asarray(done), jnp.asarray(last_value), 0.97, clip, clip)
    got = t_appo.vtrace_advantages(
        _t(ratio), _t(reward), _t(value), torch.from_numpy(done),
        _t(last_value), 0.97, clip, clip)
    for name, g, w in zip(("pg_adv", "vs"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_vtrace_reduces_to_gae_on_policy():
    """ratio 1 and rho = c = 1: V-trace's targets are GAE(lambda=1)'s
    returns and its advantages GAE's, in the port as in the JAX package."""
    reward, value, done, last_value = _random_steps(np.random.default_rng(3))
    zeros = np.zeros((T, E, N), np.float32)
    traj = t_ppo.Transition(obs=_t(zeros), actions=_t(zeros),
                            log_prob=_t(zeros), value=_t(value),
                            reward=_t(reward), done=torch.from_numpy(done))
    gae_adv, gae_ret = t_ppo.compute_gae(traj, _t(last_value), 0.99, 1.0)
    pg_adv, vs = t_appo.vtrace_advantages(
        torch.ones(T, E, N), traj.reward, traj.value, traj.done,
        _t(last_value), 0.99)
    np.testing.assert_allclose(vs.numpy(), gae_ret.numpy(), **TOL)
    np.testing.assert_allclose(pg_adv.numpy(), gae_adv.numpy(), **TOL)


def _norm_pair(rng):
    obs = j_norm.RunningMeanStd.create(OBS_DIM).update(
        jnp.asarray(rng.normal(0.5, 2, (50, OBS_DIM)).astype(np.float32)))
    ret = j_norm.RunningMeanStd.create().update(
        jnp.asarray(rng.normal(1.0, 3, (50,)).astype(np.float32)))
    tn = norm_state_from_numpy(
        jax.tree.map(np.asarray, {"obs": dataclasses.asdict(obs),
                                  "ret": dataclasses.asdict(ret)}))
    return j_norm.NormalizerState(obs=obs, ret=ret), tn


@functools.partial(jax.jit, static_argnums=0)
def _j_forward(jmodel, params, jn, obs, actions):
    """log-probs of the actions and denormalized values, a row each."""
    flat = j_norm.normalize_obs(jn, obs.reshape(-1, OBS_DIM))
    mean, log_std, value = j_ac.apply_fused(jmodel, params, flat)
    return (j_ac.gaussian_log_prob(mean, log_std, actions.reshape(-1, 4)),
            j_norm.denormalize_value(jn, value))


@pytest.mark.parametrize("with_vtrace,normalizers", [
    (True, False), (True, True), (False, False), (False, True)])
def test_learner_targets_match_jax(with_vtrace, normalizers):
    jmodel = j_ac.ActorCritic(**MODEL_KW, dtype=jnp.float32)
    params = random_flax_params(jmodel, OBS_DIM, seed=5)
    tmodel = t_ac.ActorCritic(**MODEL_KW, device="cpu")
    tmodel.load_state_dict(actor_critic_from_flax(params))
    params = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(6)
    obs = rng.normal(0, 1.5, (T, E, N, OBS_DIM)).astype(np.float32)
    last_obs = rng.normal(0, 1.5, (E, N, OBS_DIM)).astype(np.float32)
    actions = rng.normal(0, 1, (T, E, N, 4)).astype(np.float32)
    # the behaviour's log-probs: near the learner's, as after a lag
    behaviour_log_prob = rng.normal(-6, 1, (T, E, N)).astype(np.float32)
    behaviour_value = rng.normal(size=(T, E, N)).astype(np.float32)
    reward, _, done, _ = _random_steps(rng)
    jn, tn = _norm_pair(rng) if normalizers else (None, None)
    cfg = dict(gamma=0.97, gae_lambda=0.95, with_vtrace=with_vtrace,
               vtrace_rho=1.5, vtrace_c=0.8)

    # the last observation as step T, with no action
    lp, values = _j_forward(
        jmodel, params, jn,
        jnp.asarray(np.concatenate([obs, last_obs[None]])),
        jnp.asarray(np.concatenate([actions, np.zeros_like(actions[:1])])))
    lp = lp.reshape(T + 1, E, N)[:T]
    values = values.reshape(T + 1, E, N)
    values, last_value = values[:T], values[T]
    if with_vtrace:
        want = j_appo.vtrace_advantages(
            jnp.exp(lp - behaviour_log_prob),
            jnp.asarray(reward), values, jnp.asarray(done), last_value,
            cfg["gamma"], cfg["vtrace_rho"], cfg["vtrace_c"])
    else:
        jt = j_ppo.Transition(obs=obs, actions=actions,
                              log_prob=behaviour_log_prob, value=values,
                              reward=jnp.asarray(reward),
                              done=jnp.asarray(done))
        want = j_ppo.compute_gae(jt, last_value, cfg["gamma"],
                                 cfg["gae_lambda"])
    traj = t_ppo.Transition(obs=_t(obs), actions=_t(actions),
                            log_prob=_t(behaviour_log_prob),
                            value=_t(behaviour_value), reward=_t(reward),
                            done=torch.from_numpy(done))
    got = t_appo.learner_targets(tmodel, t_ppo.PPOConfig(**cfg), traj,
                                 _t(last_obs), tn)
    for name, g, w in zip(("advantages", "returns"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def _tiny_appo(policy_lag: int, with_vtrace: bool = True):
    cfg = EnvConfig(num_agents=3, quads_mode="mix", neighbor_obs_type="pos_vel",
                    neighbor_visible_num=K, ep_time=0.08)
    torch.manual_seed(0)
    model = t_ac.ActorCritic(**MODEL_KW, device="cpu")
    ppo = t_ppo.PPOConfig(rollout=4, batch_size=8, num_envs=4,
                          with_vtrace=with_vtrace, normalize_input=True)
    return t_appo.APPOTrainer(cfg, ppo, model,
                              make_dynamics_params(dt=cfg.dt), seed=0,
                              policy_lag=policy_lag, device="cpu")


@pytest.mark.parametrize("policy_lag", [0, 1, 2])
def test_behaviour_weights_follow_the_jax_queue(policy_lag):
    """JAX's queue: deque([init], maxlen=lag + 1); an iteration rolls out
    with queue[0] and appends the learner's output.  The port's behaviour
    model holds exactly the weights that deque names."""
    tr = _tiny_appo(policy_lag, with_vtrace=False)
    weights = [{k: v.clone() for k, v in tr.model.state_dict().items()}]
    queue = deque([0], maxlen=policy_lag + 1)
    for _ in range(4):
        want = queue[0]
        tr.iteration()
        assert tr.behavior_version == want
        for k, v in tr.behavior.state_dict().items():
            assert torch.equal(v, weights[want][k]), k
        weights.append({k: v.clone() for k, v in tr.model.state_dict().items()})
        queue.append(len(weights) - 1)
    assert [v for v, _ in tr._param_queue] == list(queue)


def test_appo_trainer_trains():
    tr = _tiny_appo(policy_lag=1)
    before = [p.detach().clone() for p in tr.model.parameters()]
    for _ in range(2):
        metrics, _ = tr.iteration()
        for k in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl",
                  "reward_mean"):
            assert torch.isfinite(metrics[k]), k
        assert tr.seconds["recompute"] >= 0
    assert all(not torch.equal(a, b) for a, b in zip(
        before, tr.model.parameters()))
    assert tr.env_steps == 2 * 4 * 4 * 3 and tr.step == 2 * 6


def test_train_cli_appo_branch_trains_and_resumes(tmp_path, monkeypatch):
    """train.sh's flags plus --async_rl, tiny: two iterations, then a
    resume for a third, whose behaviour queue restarts from the loaded
    weights."""
    import json
    import shlex
    import sys
    from pathlib import Path

    from quadswarm_tpu_torch.training import train
    from quadswarm_tpu_torch.utils import checkpoint as t_ckpt

    text = (Path(__file__).resolve().parents[1] / "train.sh").read_text()
    line = next(ln for ln in text.replace("\\\n", " ").splitlines()
                if "quadswarm_tpu.training.train" in ln)
    words = shlex.split(line)
    flags = [w for w in words[words.index("quadswarm_tpu.training.train")
                              + 1:] if w != "$@"]
    steps = 4 * 4 * 3                                    # an iteration
    base = flags + [
        "--async_rl=True", "--policy_lag=1", "--with_vtrace=True",
        "--num_envs=4", "--rollout=4", "--batch_size=16",
        "--quads_num_agents=3", "--quads_neighbor_visible_num=2",
        "--rnn_size=16", "--quads_neighbor_hidden_size=16",
        "--quads_episode_duration=0.5", "--device=cpu",
        f"--train_dir={tmp_path}", "--experiment=appo", "--log_every_iters=1"]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train.main(base + [f"--train_for_env_steps={2 * steps}"]) == 0
    assert train.main(base + [f"--train_for_env_steps={3 * steps}"]) == 0
    exp = tmp_path / "appo"
    lines = [json.loads(x) for x in (exp / "metrics.jsonl").read_text()
             .splitlines()]
    assert [r["env_steps"] for r in lines] == [steps, 2 * steps, 3 * steps]
    assert all(np.isfinite(r["loss"]) and r["perf/recompute_s"] >= 0
               for r in lines)
    cps = t_ckpt.get_checkpoints(str(exp / "checkpoint_p0"))
    assert [t_ckpt.env_steps_of(p) for p in cps] == [2 * steps, 3 * steps]
