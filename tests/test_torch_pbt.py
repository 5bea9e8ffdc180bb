"""The port's PBT (parallel/pbt.py) against the JAX package's.

The decisions: the JAX `PBTRunner._pbt_round` and `_mutate_coeffs` run on
an instance made with `object.__new__` over stub slots (no Trainer, so no
env compile), the port's on stub port slots, both with the same seed and
the same objectives over several rounds, `-inf` and ties among them.
Who adopts whom, the mutated coefficients and the mutated discount are
equal, draw for draw.  On the port alone: a round on two tiny Trainers
copies weights and Adam state bit for bit without aliasing, and the CLI's
PBT branch writes one checkpoint and one metrics file a policy.
"""
from __future__ import annotations

import json
import shlex
import sys

import numpy as np
import pytest
import torch

from quadswarm_tpu.parallel import pbt as j_pbt
from quadswarm_tpu.parallel import ppo as j_ppo
from quadswarm_tpu_torch.env.multi import EnvConfig
from quadswarm_tpu_torch.env.params import make_dynamics_params
from quadswarm_tpu_torch.models import actor_critic as t_ac
from quadswarm_tpu_torch.parallel import pbt as t_pbt
from quadswarm_tpu_torch.parallel import ppo as t_ppo
from quadswarm_tpu_torch.utils import checkpoint as t_ckpt

NUM = 8
COEFFS = dict(quadcol_bin=5.0, quadcol_bin_smooth_max=10.0,
              quadcol_bin_obst=5.0)
INF = -np.inf
ROUNDS = [
    [float(p) for p in range(NUM)],
    [INF, 3.0, 3.0, 1.0, INF, 7.0, 7.0, 0.0],
    [2.0] * NUM,
    [INF] * NUM,
    [0.3, -5.0, 12.0, 11.9, -5.0, 4.0, 100.0, -2.0],
    [1.0, 1.0, 50.0, 50.0, 50.0, INF, -1.0, 1.0],
]


class _JaxState:
    def __init__(self, params, opt_state):
        self.params, self.opt_state = params, opt_state

    def replace(self, **kw):
        return _JaxState(kw.get("params", self.params),
                         kw.get("opt_state", self.opt_state))


class _JaxTrainer:
    def __init__(self, p):
        self.train_state = _JaxState({"w": np.full(1, float(p))},
                                     {"mu": np.full(1, float(p))})
        self.base_rew_coeff = dict(COEFFS)
        self.ppo_cfg = j_ppo.PPOConfig(gamma=0.99)

    def set_ppo_cfg(self, cfg):
        self.ppo_cfg = cfg


class _PortTrainer:
    def __init__(self, p):
        self.model = torch.nn.Linear(1, 1, bias=False)
        with torch.no_grad():
            self.model.weight.fill_(float(p))
        self.optimizer = torch.optim.Adam(self.model.parameters())
        self.base_rew_coeff = dict(COEFFS)
        self.ppo_cfg = t_ppo.PPOConfig(gamma=0.99)

    def set_ppo_cfg(self, cfg):
        self.ppo_cfg = cfg


def _runner(package, trainer_cls, seed):
    runner = object.__new__(package.PBTRunner)
    runner.pbt_cfg = package.PBTConfig(
        num_policies=NUM, replace_fraction=0.3, mutation_rate=0.5,
        replace_reward_gap=0.1, optimize_gamma=True)
    runner.rng = np.random.default_rng(seed)
    runner.policies = [package.PolicySlot(trainer_cls(p)) for p in range(NUM)]
    return runner


def _set_objectives(runner, objectives):
    for slot, obj in zip(runner.policies, objectives):
        slot.recent_true_rewards = [] if obj == INF else [obj, obj]


@pytest.mark.parametrize("seed", [0, 7])
def test_pbt_decisions_match_jax_draw_for_draw(seed, capsys):
    jr = _runner(j_pbt, _JaxTrainer, seed)
    tr = _runner(t_pbt, _PortTrainer, seed)
    adoptions = 0
    for objectives in ROUNDS:
        _set_objectives(jr, objectives)
        _set_objectives(tr, objectives)
        jr._pbt_round()
        tr._pbt_round()
        for p, (js, ts) in enumerate(zip(jr.policies, tr.policies)):
            src = float(js.trainer.train_state.params["w"][0])
            assert float(ts.trainer.model.weight) == src, p
            adoptions += src != p
            assert ts.trainer.base_rew_coeff == js.trainer.base_rew_coeff, p
            assert ts.trainer.ppo_cfg.gamma == js.trainer.ppo_cfg.gamma, p
            assert ts.recent_true_rewards == js.recent_true_rewards, p
    # the rounds exercise adoption, mutation and the discount's mutation
    assert adoptions >= 2
    assert any(s.trainer.ppo_cfg.gamma != 0.99 for s in tr.policies)
    assert any(s.trainer.base_rew_coeff != COEFFS for s in tr.policies)
    out = capsys.readouterr().out
    assert out.count("PBT: policy") >= 2 * 2
    # the mutation alone, on a fresh generator
    jr.rng, tr.rng = (np.random.default_rng(seed + 1) for _ in range(2))
    for _ in range(5):
        assert tr._mutate_coeffs(COEFFS) == jr._mutate_coeffs(COEFFS)


def _tiny_make_model():
    return t_ac.ActorCritic(action_dim=4, self_obs_dim=18, neighbor_obs_dim=6,
                            num_neighbors=2, neighbor_hidden=16, rnn_size=16,
                            device="cpu")


def test_pbt_round_copies_weights_and_adam_state(tmp_path):
    cfg = EnvConfig(num_agents=3, quads_mode="mix", neighbor_obs_type="pos_vel",
                    neighbor_visible_num=2, ep_time=0.08)
    runner = t_pbt.PBTRunner(
        cfg, t_ppo.PPOConfig(rollout=4, batch_size=12, num_envs=2),
        _tiny_make_model, make_dynamics_params(dt=cfg.dt),
        t_pbt.PBTConfig(num_policies=2, replace_fraction=0.5),
        seed=3, exp_dir=str(tmp_path), device="cpu")
    src, dst = (s.trainer for s in runner.policies)
    # policy p's weights come from seed + 1000 p
    assert not torch.equal(src.model.action_head.weight,
                           dst.model.action_head.weight)
    for tr in (src, dst):
        tr.iteration()
    runner.policies[0].recent_true_rewards = [10.0]
    runner.policies[1].recent_true_rewards = [-10.0]
    dst_env = dst.env_states.tick.clone()
    runner._pbt_round()
    assert runner.policies[1].recent_true_rewards == []

    def state(tr):
        params = list(tr.model.parameters())
        return params, [tr.optimizer.state[p] for p in params]

    (sp, so), (dp, do) = state(src), state(dst)
    for a, b, sa, sb in zip(sp, dp, so, do):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), key
            assert sa[key].data_ptr() != sb[key].data_ptr(), key
    assert torch.equal(dst.env_states.tick, dst_env)      # its own env
    assert dst.gen is not src.gen
    for tr in (src, dst):
        tr.iteration()
    (sp, so), (dp, do) = state(src), state(dst)
    assert not all(torch.equal(a, b) for a, b in zip(sp, dp))
    assert not all(torch.equal(a["exp_avg"], b["exp_avg"])
                   for a, b in zip(so, do))


def test_train_cli_pbt_branch_writes_every_policy(tmp_path, monkeypatch):
    from quadswarm_tpu_torch.runs import pbt_quads_multi_obstacles as run
    from quadswarm_tpu_torch.training import train

    (_, cmd), = run.RUN_DESCRIPTION.commands(str(tmp_path))
    tiny = ["--num_policies=2", "--num_envs=2", "--rollout=4",
            "--batch_size=32", "--quads_num_agents=4",
            "--quads_neighbor_visible_num=2", "--rnn_size=16",
            "--quads_neighbor_hidden_size=16", "--quads_obst_hidden_size=16",
            "--quads_episode_duration=0.5", "--device=cpu",
            f"--train_for_env_steps={2 * 4 * 2 * 4}"]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train.main(shlex.split(cmd)[3:] + tiny) == 0
    exp = tmp_path / "pbt_quads_multi_obstacles_seed0"
    for p in range(2):
        cps = t_ckpt.get_checkpoints(str(exp / f"checkpoint_p{p}"))
        assert [t_ckpt.env_steps_of(c) for c in cps] == [4 * 2 * 4]
        rec = json.loads((exp / f"p{p}" / "metrics.jsonl").read_text()
                         .splitlines()[0])
        assert np.isfinite(rec["loss"]) and "pbt/objective" in rec
