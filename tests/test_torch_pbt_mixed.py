"""Mixed-policy PBT (parallel/pbt_mixed.py) against the JAX package's.

No test runs JAX's `mixed_rollout` or `MixedPBTRunner.__init__` (they
compile the whole env); each JAX reference is the piece itself, jitted:
- the stacked heads with selection, P = 3 with per-policy normalizers,
  against `jax.vmap(head)` and `_select_policy` (rtol 1e-5 / atol 1e-6);
- `masked_ppo_loss` and its gradients against JAX's, with one policy's
  mask empty and log-ratios beyond +-20 (loss rtol 1e-5, gradients rtol
  1e-4 plus 1e-6 of the largest entry, the PPO loss's tolerance in
  tests/test_torch_training.py);
- one stacked masked minibatch step (per-policy clip, one Adam over the
  stacked tensors) against JAX's `value_and_grad` and
  `optax.flatten(chain(clip_by_global_norm, adam))` under `vmap`: losses
  and global norms rtol 1e-5, the updated weights within the learning
  rate (Adam's first step moves an entry by about lr whatever its
  gradient's size, so a gradient near zero may take either sign);
- the stacked `update_masked` normalizers against JAX's `vmap` (rtol 1e-5);
- `pbt_round`'s decisions and mutated coefficients against JAX's
  `MixedPBTRunner.pbt_round` on `object.__new__` instances over stub
  arrays, draw for draw;
- the env step with per-agent (E, N) coefficients against JAX's env with
  (N,)-leaved coefficients (3 ticks, the slice's tolerance);
and on the port alone: each head on its own rows (`forward_routed` and
`select_grouped`) against every head on every row (`forward_all` and
`select_policy`, rtol 1e-5 / atol 1e-6), with groups under one GEMM tile,
one policy holding every row and a policy with none; the rollout's
grouping is rebuilt on the ticks some episode ended and follows each
redraw, and the rollout equals one whose heads run densely; assignments are redrawn only for envs that ended an episode and
stay in range; the CLI's mixed branch writes P checkpoints and
`pbt_state.json`, resumes, and the eval CLI loads `checkpoint_p1`.
"""
from __future__ import annotations

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quadswarm_tpu.env import multi as j_multi
from quadswarm_tpu.env.params import make_dynamics_params as j_make_params
from quadswarm_tpu.models import actor_critic as j_ac
from quadswarm_tpu.parallel import normalize as j_norm
from quadswarm_tpu.parallel import pbt_mixed as j_mixed
from quadswarm_tpu.parallel import ppo as j_ppo
from quadswarm_tpu_torch.env import multi as t_multi
from quadswarm_tpu_torch.env import scenarios as t_scen
from quadswarm_tpu_torch.env.params import make_dynamics_params as t_make_params
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.models import actor_critic as t_ac
from quadswarm_tpu_torch.parallel import pbt_mixed as t_mixed
from quadswarm_tpu_torch.parallel.normalize import (
    NormalizerState, RunningMeanStd,
)
from quadswarm_tpu_torch.parallel.pbt import PBTConfig
from quadswarm_tpu_torch.parallel.ppo import PPOConfig
from quadswarm_tpu_torch.utils.convert import stacked_actor_critic_from_flax

from .flax_params import random_flax_params
from .test_torch_bf16 import _jax_kernel_tick
from .test_torch_env_parts import _jax_state
from .test_torch_obstacle_env import _port_draws
from .test_torch_replay import _draws as _replay_draws
from .test_torch_training import MODEL_KW, OBS_DIM, PPO_KW, _batch

P = 3
TOL = dict(rtol=1e-5, atol=1e-6)


def _stacked(seed=0):
    """P flax parameter trees stacked on [P], and the port's stacked heads
    carrying the same weights."""
    jmodel = j_ac.ActorCritic(**MODEL_KW, dtype=jnp.float32)
    trees = [random_flax_params(jmodel, OBS_DIM, seed + p) for p in range(P)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    heads = t_mixed.StackedPolicies([
        t_ac.ActorCritic(**MODEL_KW, device="cpu") for _ in range(P)])
    with torch.no_grad():
        for k, v in stacked_actor_critic_from_flax(stacked).items():
            heads.params[k].copy_(v)
    return jmodel, jax.tree.map(jnp.asarray, stacked), heads


def _norms(rng):
    """Per-policy obs and return normalizers: JAX's stacked on [P] and the
    port's."""
    def one():
        obs = j_norm.RunningMeanStd.create(OBS_DIM).update(jnp.asarray(
            rng.normal(0.5, 2, (50, OBS_DIM)).astype(np.float32)))
        ret = j_norm.RunningMeanStd.create().update(jnp.asarray(
            rng.normal(1.0, 3, (50,)).astype(np.float32)))
        return j_norm.NormalizerState(obs=obs, ret=ret)
    jn = jax.tree.map(lambda *xs: jnp.stack(xs), *[one() for _ in range(P)])
    to_port = lambda r: RunningMeanStd(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in
           dataclasses.asdict(r).items()})
    return jn, NormalizerState(obs=to_port(jn.obs), ret=to_port(jn.ret))


def test_stacked_heads_with_selection_match_jax_vmap():
    jmodel, params, heads = _stacked()
    rng = np.random.default_rng(0)
    jn, tn = _norms(rng)
    obs = rng.normal(0, 1.5, (40, OBS_DIM)).astype(np.float32)
    assign = rng.integers(0, P, 40)

    @jax.jit
    def jax_heads(params, norm, obs, assign):
        def head(p, nrm):
            mean, log_std, value = jmodel.apply(
                p, j_norm.normalize_obs(nrm, obs))
            return (mean, log_std,
                    j_norm.denormalize_value(nrm, value))
        mean, log_std, value = jax.vmap(head)(params, norm)
        return tuple(j_mixed._select_policy(x, assign, P)
                     for x in (mean, log_std, value))

    want = jax_heads(params, jn, jnp.asarray(obs), jnp.asarray(assign))
    with torch.no_grad():
        outs = heads.forward_all(torch.from_numpy(obs), tn)
    sel = torch.from_numpy(assign)
    for g, w in zip(outs, want):
        np.testing.assert_allclose(t_mixed.select_policy(g, sel).numpy(),
                                   np.asarray(w), **TOL)


@pytest.mark.parametrize("case", ["mixed_mask", "empty_mask",
                                  "extreme_log_ratio"])
def test_masked_ppo_loss_and_gradients_match_jax(case):
    jmodel = j_ac.ActorCritic(**MODEL_KW, dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray,
                          random_flax_params(jmodel, OBS_DIM, seed=4))
    model = t_ac.ActorCritic(**MODEL_KW, device="cpu")
    from quadswarm_tpu_torch.utils.convert import actor_critic_from_flax
    model.load_state_dict(actor_critic_from_flax(
        jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(5)
    batch = list(_batch(rng))
    mask = (rng.uniform(0, 1, 64) < 0.4).astype(np.float32)
    if case == "empty_mask":
        mask[:] = 0.0
    if case == "extreme_log_ratio":
        batch[2][::3] = -80.0            # the policy's log-prob >> old
        batch[2][1::3] = 60.0            # << old
    jcfg, tcfg = j_ppo.PPOConfig(**PPO_KW), PPOConfig(**PPO_KW)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b, m: j_mixed.masked_ppo_loss(jmodel, jcfg, p, b, m)))(
        params, tuple(jnp.asarray(x) for x in batch), jnp.asarray(mask))
    loss = t_mixed.masked_ppo_loss(
        model, tcfg, tuple(torch.from_numpy(x) for x in batch),
        torch.from_numpy(mask))
    loss.backward()
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = actor_critic_from_flax(jax.tree.map(np.asarray, jgrads))
    largest = max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6 * max(largest, 1e-30),
                                   err_msg=name)
    if case == "empty_mask":
        assert float(loss) == 0.0 and largest == 0.0


def test_stacked_minibatch_step_matches_vmapped_optax():
    jmodel, params, heads = _stacked(seed=10)
    lr, max_norm = 1e-3, 0.1
    cfg = dict(PPO_KW, learning_rate=lr, max_grad_norm=max_norm)
    jcfg, tcfg = j_ppo.PPOConfig(**cfg), PPOConfig(**cfg)
    rng = np.random.default_rng(6)
    batch = _batch(rng)
    assign = rng.integers(0, P, 64)
    assign[assign == 2] = 1              # policy 2 has no sample here
    jn, tn = _norms(rng)
    tx = optax.flatten(optax.chain(optax.clip_by_global_norm(max_norm),
                                   optax.adam(lr)))

    @jax.jit
    def jax_step(params, norm, batch, assign):
        opt = jax.vmap(tx.init)(params)

        def one(pid, p, o, nrm):
            mask = (assign == pid).astype(jnp.float32)
            loss, g = jax.value_and_grad(
                lambda q: j_mixed.masked_ppo_loss(jmodel, jcfg, q, batch,
                                                  mask, norm=nrm))(p)
            updates, _ = tx.update(g, o, p)
            return optax.apply_updates(p, updates), loss, \
                optax.global_norm(g)

        return jax.vmap(one)(jnp.arange(P), params, opt, norm)

    jparams, jloss, jnorm = jax_step(params, jn,
                                     tuple(jnp.asarray(x) for x in batch),
                                     jnp.asarray(assign))
    opt = t_mixed.make_stacked_optimizer(heads, tcfg)
    losses = t_mixed.stacked_sgd_step(
        heads, opt, tcfg, tuple(torch.from_numpy(x) for x in batch),
        torch.from_numpy(assign), tn)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jloss), **TOL)
    assert float(losses[2]) == 0.0
    want = stacked_actor_critic_from_flax(jax.tree.map(np.asarray, jparams))
    grads = [p.grad for p in heads.params.values()]
    # the clip left each policy's norm at min(g_norm, max_norm)
    g_norm = torch.sqrt(sum(torch.sum(g.reshape(P, -1) ** 2, 1)
                            for g in grads))
    np.testing.assert_allclose(
        g_norm.numpy(), np.minimum(np.asarray(jnorm), max_norm), rtol=1e-5)
    assert float(g_norm[2]) == 0.0 and float(jnorm[0]) > max_norm
    for name, p in heads.params.items():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=lr, err_msg=name)
        moved = (p.detach() - want[name]).abs() > 0.1 * lr
        assert moved.float().mean() < 0.01, name


def test_stacked_update_masked_matches_jax_vmap():
    rng = np.random.default_rng(8)
    jn, tn = _norms(rng)
    obs = rng.normal(0.3, 1.7, (90, OBS_DIM)).astype(np.float32)
    ret = rng.normal(-1.0, 2.0, (90,)).astype(np.float32)
    assign = rng.integers(0, P, 90)
    assign[assign == 1] = 0              # policy 1 sees nothing
    pids = jnp.arange(P)
    jo = jax.vmap(lambda st, pid: st.update_masked(
        jnp.asarray(obs), jnp.asarray(assign) == pid))(jn.obs, pids)
    jr = jax.vmap(lambda st, pid: st.update_masked(
        jnp.asarray(ret), jnp.asarray(assign) == pid))(jn.ret, pids)
    got = t_mixed.update_masked_stacked(tn, torch.from_numpy(obs),
                                        torch.from_numpy(ret),
                                        torch.from_numpy(assign))
    for g, w in ((got.obs, jo), (got.ret, jr)):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(g, f).numpy(),
                                       np.asarray(getattr(w, f)), **TOL)
    np.testing.assert_array_equal(got.obs.mean[1].numpy(),
                                  tn.obs.mean[1].numpy())


# --------------------------------------------------------------------------
# PBT decisions
# --------------------------------------------------------------------------

INF = -np.inf
ROUNDS = [
    [[0.0, 1.0], [5.0], [], [2.0, 2.0], [9.0], [-1.0], [3.0], [7.0]],
    [[], [3.0], [3.0], [1.0], [], [7.0], [7.0], [0.0]],
    [[2.0]] * 8,
    [[]] * 8,
    [[0.3], [-5.0], [12.0], [11.9], [-5.0], [4.0], [100.0], [-2.0]],
    [[1.0], [1.0], [50.0], [50.0], [50.0], [], [-1.0], [1.0] * 30],
]


def _mixed_runner(package, seed):
    runner = object.__new__(package.MixedPBTRunner)
    runner.pbt_cfg = PBTConfig(num_policies=8, replace_fraction=0.3,
                               mutation_rate=0.5, replace_reward_gap=0.1)
    runner.num_policies = 8
    runner.rng = np.random.default_rng(seed)
    runner.coeffs = [dict(quadcol_bin=5.0, quadcol_bin_smooth_max=10.0,
                          quadcol_bin_obst=5.0) for _ in range(8)]
    runner.norm_state = None
    return runner


@pytest.mark.parametrize("seed", [0, 7])
def test_pbt_round_decisions_match_jax_draw_for_draw(seed):
    jr = _mixed_runner(j_mixed, seed)
    jr.params = jnp.arange(8.0)
    jr.opt_state = (jnp.arange(8.0) * 10,)
    tr = _mixed_runner(t_mixed, seed)
    source = list(range(8))

    def copy_slice(src, dst):
        source[dst] = source[src]
    tr.copy_slice = copy_slice
    adoptions = 0
    for hist in ROUNDS:
        jr.objective_hist = [list(h) for h in hist]
        tr.objective_hist = [list(h) for h in hist]
        jr.pbt_round()
        tr.pbt_round()
        assert [float(x) for x in jr.params] == [float(s) for s in source]
        assert [float(x) for x in jr.opt_state[0]] == [10.0 * s
                                                       for s in source]
        assert tr.coeffs == jr.coeffs
        assert tr.objective_hist == jr.objective_hist
        adoptions += sum(s != p for p, s in enumerate(source))
    assert adoptions > 0


def test_copy_slice_copies_weights_moments_and_normalizer():
    _, _, heads = _stacked(seed=20)
    runner = object.__new__(t_mixed.MixedPBTRunner)
    runner.heads = heads
    runner.optimizer = t_mixed.make_stacked_optimizer(heads, PPOConfig())
    _, runner.norm_state = _norms(np.random.default_rng(9))
    for p in heads.params.values():
        st = runner.optimizer.state[p]
        st["exp_avg"].normal_()
        st["exp_avg_sq"].uniform_()
    runner.copy_slice(0, 2)
    for p in heads.params.values():
        assert torch.equal(p[2], p[0]) and not torch.equal(p[1], p[0])
        st = runner.optimizer.state[p]
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k][2], st[k][0])
    assert torch.equal(runner.norm_state.obs.mean[2],
                       runner.norm_state.obs.mean[0])
    # slices of one tensor: writing policy 0 leaves its copy as it was
    first = next(iter(heads.params.values()))
    before = first[2].clone()
    with torch.no_grad():
        first[0] += 1.0
    assert torch.equal(first[2], before)


# --------------------------------------------------------------------------
# The env with per-agent coefficients, assignments
# --------------------------------------------------------------------------

ENV_KW = dict(num_agents=8, quads_mode="mix", neighbor_obs_type="pos_vel",
              neighbor_visible_num=6, collision_hitbox_radius=2.0,
              collision_falloff_radius=4.0, use_downwash=True)


def test_env_step_with_per_agent_coefficients_matches_jax():
    """(E, N) coefficients, each agent its own (as a policy's would be):
    the port's env against JAX's env with (N,)-leaved `rew_coeff` over 3
    ticks with drones colliding, at the slice's tolerance."""
    tcfg = t_multi.EnvConfig(**ENV_KW)
    modes = torch.tensor([t_scen.MODE_IDS["static_same_goal"]] * 2,
                         dtype=torch.int32)
    tstate, _ = t_multi.env_reset(tcfg, t_make_params(),
                                  torch.Generator().manual_seed(5), 2,
                                  device="cpu", mode=modes)
    rng = np.random.default_rng(3)
    coeff = lambda lo, hi: torch.from_numpy(
        rng.uniform(lo, hi, (2, 8)).astype(np.float32))
    per_agent = {f: torch.full((2, 8), v, dtype=torch.float32)
                 for f, v in RewardCoeffs().__dict__.items()}
    per_agent.update(quadcol_bin=coeff(2, 8), quadcol_bin_smooth_max=coeff(
        5, 15), quadcol_bin_obst=coeff(2, 8), pos=coeff(0.5, 1.5))
    pos, vel = tstate.dyn.pos.clone(), tstate.dyn.vel.clone()
    pos[:, 1] = pos[:, 0] + torch.tensor([0.05, 0.0, 0.0])
    pos[:, 2] = pos[:, 0] + torch.tensor([0.0, 0.12, 0.0])
    vel[:, 0] = torch.tensor([1.0, 0.0, 0.0])
    vel[:, 1] = torch.tensor([-1.0, 0.0, 0.0])
    tstate = tstate.replace(dyn=tstate.dyn.replace(pos=pos, vel=vel),
                            rew_coeff=RewardCoeffs(**per_agent))
    jstate = _jax_state(tstate)
    assert jstate.rew_coeff.quadcol_bin.shape == (2, 8)
    tick = _jax_kernel_tick(j_multi.EnvConfig(**ENV_KW), j_make_params())
    tparams = t_make_params()
    collided = False
    for _ in range(3):
        actions = rng.uniform(-1, 1, (2, 8, 4)).astype(np.float32)
        draws = _replay_draws(rng, 2, 8)
        jstate, jobs, jrew, _, jinfo = tick(
            jstate, jnp.asarray(actions), jax.tree.map(jnp.asarray, draws))
        tstate, tobs, trew, _, tinfo = t_multi.batched_env_step(
            tcfg, tparams, tstate, torch.from_numpy(actions), None,
            _port_draws(draws))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew),
                                   rtol=2e-4, atol=2e-5)
        for key in ("rewards/rew_quadcol", "rewards/rew_proximity",
                    "rewards/rew_pos", "true_reward"):
            np.testing.assert_allclose(tinfo[key].numpy(),
                                       np.asarray(jinfo[key]), rtol=2e-4,
                                       atol=2e-5, err_msg=key)
        collided |= bool(tinfo["rewards/rew_quadcol"].any())
        assert tstate.rew_coeff.quadcol_bin.shape == (2, 8)
    assert collided


def _tiny_model():
    return t_ac.ActorCritic(
        action_dim=4, self_obs_dim=18, neighbor_obs_dim=6, num_neighbors=2,
        neighbor_hidden=16, rnn_size=16, device="cpu")


def _tiny_runner(tmp_path=None, seed=0, **ppo):
    cfg = t_multi.EnvConfig(num_agents=4, quads_mode="mix",
                            neighbor_obs_type="pos_vel",
                            neighbor_visible_num=2, ep_time=0.06)
    kw = dict(rollout=8, batch_size=32, num_envs=6, replay_sample_prob=0.5)
    kw.update(ppo)
    return t_mixed.MixedPBTRunner(
        cfg, PPOConfig(**kw), _tiny_model, t_make_params(dt=cfg.dt),
        PBTConfig(num_policies=P), seed=seed, device="cpu")


def test_assignments_redrawn_only_for_envs_that_ended():
    runner = _tiny_runner()
    first = runner.assignment.clone()
    (states, _, _, assignment, traj, _, infos) = t_mixed.mixed_rollout(
        runner.env_cfg, runner.dyn_params, runner.heads, runner.ppo_cfg,
        runner.env_states, runner.obs, runner.assignment,
        runner.coeff_table(), runner.gen, runner.replay_states)
    seq = torch.cat([traj.assignment, assignment[None]])
    assert torch.equal(seq[0], first)
    ended = infos["episode_done"]                     # (T, E)
    assert ended.any(), "episodes of 6 ticks end within 8"
    changed = (seq[1:] != seq[:-1]).any(-1)           # (T, E)
    assert not (changed & ~ended).any()
    assert changed[ended].any()
    assert int(seq.min()) >= 0 and int(seq.max()) < P
    # every agent's coefficients are its policy's
    table = runner.coeff_table()
    names = list(RewardCoeffs().__dict__)
    got = states.rew_coeff
    assert got.quadcol_bin.shape == (6, 4)
    np.testing.assert_array_equal(
        got.quadcol_bin.numpy(),
        table[names.index("quadcol_bin")][assignment].numpy())


def _random_stacked_norm(p_count, obs_dim, gen):
    """Per-policy obs and return normalizers with random statistics."""
    rand = lambda *shape: torch.rand(shape, generator=gen)
    return NormalizerState(
        obs=RunningMeanStd(mean=rand(p_count, obs_dim) - 0.5,
                           var=rand(p_count, obs_dim) + 0.5,
                           count=rand(p_count) * 100 + 1),
        ret=RunningMeanStd(mean=rand(p_count), var=rand(p_count) + 0.5,
                           count=rand(p_count) * 100 + 1))


@pytest.mark.parametrize("case,rows,cap", [
    ("uniform", 512, 128),          # 8 groups near 64: routing engages
    ("one_policy", 512, 512),       # one group holds every row
    ("one_policy_empty", 512, 128), # policy 7 serves no row
    ("under_one_tile", 40, 40),     # fewer rows than a tile
])
def test_routed_heads_with_selection_match_the_dense_heads(case, rows, cap):
    p_count = 8
    torch.manual_seed(0)
    heads = t_mixed.StackedPolicies([_tiny_model()
                                     for _ in range(p_count)])
    gen = torch.Generator().manual_seed(1)
    obs_dim = 18 + 2 * 6
    obs = torch.randn((rows, obs_dim), generator=gen) * 1.5
    if case == "one_policy":
        assign = torch.full((rows,), 5)
    else:
        top = p_count - 1 if case == "one_policy_empty" else p_count
        assign = torch.randint(0, top, (rows,), generator=gen)
    norm = _random_stacked_norm(p_count, obs_dim, gen)
    groups = t_mixed.group_rows(assign, p_count)
    assert groups.cap == cap
    assert list(groups.counts) == torch.bincount(
        assign, minlength=p_count).tolist()
    with torch.no_grad():
        routed = heads.forward_routed(obs, groups, norm)
        dense = heads.forward_all(obs, norm)
    assert routed[0].shape == (p_count, cap, 4)
    for r, d in zip(routed, dense):
        np.testing.assert_allclose(
            t_mixed.select_grouped(r, groups),
            t_mixed.select_policy(d, assign), **TOL)


def test_the_grouping_follows_each_redraw_and_draws_nothing(monkeypatch):
    routed = t_mixed.StackedPolicies.forward_routed
    used = []

    def watched(self, obs_flat, groups, norm=None):
        used.append((groups.counts, groups.assignment.clone()))
        return routed(self, obs_flat, groups, norm)

    def rollout():
        runner = _tiny_runner()
        return t_mixed.mixed_rollout(
            runner.env_cfg, runner.dyn_params, runner.heads, runner.ppo_cfg,
            runner.env_states, runner.obs, runner.assignment,
            runner.coeff_table(), runner.gen, runner.replay_states)

    group = t_mixed.group_rows
    built = []

    def counted(assignment_flat, p_count):
        built.append(assignment_flat.clone())
        return group(assignment_flat, p_count)

    monkeypatch.setattr(t_mixed.StackedPolicies, "forward_routed", watched)
    monkeypatch.setattr(t_mixed, "group_rows", counted)
    got = rollout()
    traj, infos, final = got[4], got[6], got[3]
    ends = int(infos["episode_done"].any(-1).sum())
    assert 0 < ends < traj.done.shape[0], "episodes of 6 ticks end within 8"
    # at the start, then once after each tick on which some episode ended
    assert len(built) == 1 + ends
    seq = torch.cat([traj.assignment, final[None]])     # (T + 1, E, N)
    assert len(used) == seq.shape[0]
    for (counts, assign), want in zip(used, seq):
        assert torch.equal(assign, want.reshape(-1))
        assert list(counts) == torch.bincount(want.reshape(-1),
                                              minlength=P).tolist()

    def dense(self, obs_flat, groups, norm=None):
        """Every head on every row, then each group's rows picked out."""
        heads = torch.arange(self.num_policies)[:, None]
        return tuple(x[heads, groups.gather]
                     for x in self.forward_all(obs_flat, norm))

    monkeypatch.setattr(t_mixed.StackedPolicies, "forward_routed", dense)
    want = rollout()
    assert torch.equal(got[3], want[3])
    for g, w in zip(got[4], want[4]):
        np.testing.assert_allclose(g.float(), w.float(), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(got[5], want[5], rtol=1e-6, atol=1e-6)


def test_restore_refuses_a_checkpoint_without_normalizer(tmp_path):
    runner = _tiny_runner(normalize_input=True)
    (tmp_path / "x").mkdir()
    runner.save(str(tmp_path), "x")
    again = _tiny_runner(seed=1, normalize_input=True)
    assert again.restore(str(tmp_path), "x")
    for k, v in runner.heads.params.items():
        assert torch.equal(v, again.heads.params[k])
    assert torch.equal(again.norm_state.obs.var, runner.norm_state.obs.var)
    path = sorted((tmp_path / "x" / "checkpoint_p1").glob("*.pt"))[-1]
    payload = torch.load(path, weights_only=True)
    payload["extra"] = None
    torch.save(payload, path)
    with pytest.raises(ValueError, match="normalizer"):
        _tiny_runner(normalize_input=True).restore(str(tmp_path), "x")


def test_cli_mixed_branch_trains_saves_resumes_and_evaluates(
        tmp_path, monkeypatch, capsys):
    from quadswarm_tpu_torch.training import enjoy, train
    from .test_torch_training import TINY, _train_sh_flags
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    flags = (_train_sh_flags() + TINY + [
        "--with_pbt=True", "--num_policies=3",
        "--pbt_mix_policies_in_one_env=True", "--model_dtype=bfloat16",
        "--log_every_iters=1", f"--train_dir={tmp_path}",
        "--experiment=mixed"])
    with pytest.warns(UserWarning, match="anneal_collision_steps"):
        assert train.main(flags + ["--train_for_env_steps=256"]) == 0
    exp = tmp_path / "mixed"
    for p in range(3):
        assert len(list((exp / f"checkpoint_p{p}").glob("*.pt"))) == 1
    meta = json.loads((exp / "pbt_state.json").read_text())
    assert meta["env_steps"] == 256 and len(meta["coeffs"]) == 3
    lines = [json.loads(x) for x in
             (exp / "metrics.jsonl").read_text().splitlines()]
    assert {"policy0/loss", "policy2/loss", "reward_mean"} <= set(lines[0])
    with pytest.warns(UserWarning):
        assert train.main(flags + ["--train_for_env_steps=512"]) == 0
    assert "resumed mixed PBT at 256 env steps" in capsys.readouterr().out
    assert json.loads((exp / "pbt_state.json").read_text())["env_steps"] \
        == 512
    # policy 1's checkpoint is a single-policy checkpoint: the eval CLI
    # loads it as an experiment's checkpoint_p0
    (tmp_path / "p1").mkdir()
    shutil.copy(exp / "config.json", tmp_path / "p1" / "config.json")
    shutil.copytree(exp / "checkpoint_p1", tmp_path / "p1" / "checkpoint_p0")
    stats = enjoy.run_eval(enjoy.load_args([
        f"--train_dir={tmp_path}", "--experiment=p1", "--device=cpu",
        "--eval_envs=2", "--max_num_episodes=2", "--render_mode=none"]))
    assert "loaded" in capsys.readouterr().out
    assert np.isfinite(stats["true_reward"])
