"""Mixed-policy PBT: P policies sharing ONE env batch, assigned per agent.

Port of quadswarm_tpu/parallel/pbt_mixed.py (Sample Factory's
`--pbt_mix_policies_in_one_env=True`, the reference's published PBT run):
the agents of one episode act under different policies, each policy's
reward shaping applies to its own agents, and the PBT objective of a
policy is the mean `true_reward` of its agents at episode ends.

Form on one device:
- the P policies are held stacked (`torch.func.stack_module_state`: every
  parameter a (P, ...) tensor) and run with `functional_call` under
  `torch.vmap`, so a tick's forward over all E * N agents and P heads
  launches about one policy's operation count (the JAX package's
  `jax.vmap(head)`); each agent takes its assigned head's outputs;
- per-agent reward coefficients reach the env as (E, N) `RewardCoeffs`
  leaves, the stacked (P,) coefficients gathered by assignment;
- the learner runs the P masked PPO steps of a minibatch as one vmapped
  `grad` over the same minibatch order for every policy, each policy's
  loss averaging its own agents' samples; each policy's gradient is
  clipped by its own global norm, then one Adam steps the stacked
  tensors (Adam is elementwise, so it equals P Adams: the JAX package's
  `optax.flatten(chain(clip_by_global_norm, adam))` under `vmap`);
- assignments are redrawn for the envs whose episode ended, from the
  runner's generator (the JAX package draws from threefry keys, which the
  port cannot match: assignments agree by their invariants, not draws);
- collision replay composes as in sync PPO; a replayed env takes the
  env's current coefficients, which the post-step push then overwrites
  from the assignment, as in the JAX package;
- normalizers are per policy (a stacked `NormalizerState`, each policy's
  statistics fed only by its agents' samples through `update_masked`).

On a mesh of D ranks (`parallel/mesh.py`) each rank holds E / D envs of the
shared batch and draws its own envs' assignments from its own generator;
the learner takes its rows of the global minibatch layout (as
`parallel/ppo.py`), each policy's masked advantage statistics and loss
denominator are over the global minibatch (all-reduced before the vmapped
step), the stacked gradients are summed in one flat all-reduce, and the
normalizers and the objectives fold in every rank's samples.  The JAX
package keeps one env group on a mesh (its stacked learner replicates);
here a rank holds only its envs, so `sgd_shuffle_groups` resolves as the
Trainer's does (32 on a mesh).

`MixedPBTRunner` takes no annealing schedule, as the JAX package's does
not (the training CLI warns when `--anneal_collision_steps` is set).
A round copies the [P] slice of weights, Adam moments and normalizer of a
top policy into a bottom one, with mutated coefficients; its host
decisions draw from `np.random.default_rng(seed)` in the JAX package's
order.  Each policy is checkpointed as `checkpoint_p{i}` (a `.pt` file
loadable like any single-policy checkpoint) beside `pbt_state.json`.
"""
from __future__ import annotations

import copy
import json
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, stack_module_state

from quadswarm_tpu_torch.env.multi import (
    EnvConfig, batched_env_step, env_reset,
)
from quadswarm_tpu_torch.env.replay import (
    batched_replay_step, init_replay_state,
)
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.models.actor_critic import (
    gaussian_entropy, gaussian_log_prob, sample_actions,
)
from quadswarm_tpu_torch.parallel.mesh import (
    DataMesh, all_mean, all_reduce_grads_, all_sum, all_sum_dict, env_range,
    make_mesh, replicate,
)
from quadswarm_tpu_torch.parallel.normalize import (
    NormalizerState, RunningMeanStd, denormalize_value, make_norm_state,
    normalize_obs,
)
from quadswarm_tpu_torch.parallel.pbt import MUTABLE_COEFFS, PBTConfig
from quadswarm_tpu_torch.parallel.ppo import (
    PPOConfig, _sync, check_layout, compute_gae, learner_seed, rank_seed,
    resolve_groups, shuffled_minibatches,
)
from quadswarm_tpu_torch.utils.checkpoint import (
    checkpoint_dir, latest_checkpoint, load_checkpoint, save_checkpoint,
)
from quadswarm_tpu_torch.utils.struct import map_fields, resolve_device


class MixedTransition(NamedTuple):
    obs: torch.Tensor         # (T, E, N, obs)
    actions: torch.Tensor     # (T, E, N, A)
    log_prob: torch.Tensor    # (T, E, N)
    value: torch.Tensor       # (T, E, N)
    reward: torch.Tensor      # (T, E, N)
    done: torch.Tensor        # (T, E, N)
    assignment: torch.Tensor  # (T, E, N) int64: the policy that acted


def select_policy(outs: torch.Tensor, assignment_flat: torch.Tensor):
    """(P, B, ...) -> (B, ...): each row's assigned head."""
    rows = torch.arange(outs.shape[1], device=outs.device)
    return outs[assignment_flat, rows]


# --------------------------------------------------------------------------
# Stacked normalizers: a NormalizerState whose leaves carry [P] in front,
# passed to vmapped code as a dict of tensors.
# --------------------------------------------------------------------------

def _norm_dict(norm: NormalizerState | None) -> dict:
    if norm is None:
        return {}
    out = {}
    for name in ("obs", "ret"):
        r = getattr(norm, name)
        if r is not None:
            out.update({f"{name}_mean": r.mean, f"{name}_var": r.var,
                        f"{name}_count": r.count})
    return out


def _norm_of(d: dict) -> NormalizerState | None:
    if not d:
        return None
    field = lambda name: RunningMeanStd(
        mean=d[f"{name}_mean"], var=d[f"{name}_var"],
        count=d[f"{name}_count"]) if f"{name}_mean" in d else None
    return NormalizerState(obs=field("obs"), ret=field("ret"))


def norm_slice(norm: NormalizerState | None, p: int):
    """Policy p's normalizer of a stacked one."""
    return None if norm is None else map_fields(
        lambda x: None if x is None else x[p], norm)


class StackedPolicies:
    """P models of one architecture held as stacked (P, ...) parameter
    tensors; `base` is a copy on the meta device that `functional_call`
    runs with each policy's slice."""

    def __init__(self, models: list):
        self.num_policies = len(models)
        self.params, self.buffers = stack_module_state(models)
        self.base = copy.deepcopy(models[0]).to("meta")

    def _one(self, params, buffers, norm: dict, obs):
        """One policy's (mean, log_std, value) in float32, the value
        denormalized by its own return statistics."""
        nrm = _norm_of(norm)
        mean, log_std, value = functional_call(
            self.base, (params, buffers), (normalize_obs(nrm, obs),))
        return (mean.float(), log_std.float(),
                denormalize_value(nrm, value.float()))

    def forward_all(self, obs_flat, norm: NormalizerState | None = None):
        """Every head on every row: ((P, B, A), (P, B, A), (P, B))."""
        return torch.vmap(self._one, in_dims=(0, 0, 0, None))(
            self.params, self.buffers, _norm_dict(norm), obs_flat)

    def state_dict(self, p: int) -> dict:
        """Policy p's weights as the single model's state_dict."""
        out = {k: v[p].detach().clone() for k, v in self.params.items()}
        out.update({k: v[p].clone() for k, v in self.buffers.items()})
        return out


# --------------------------------------------------------------------------
# Rollout
# --------------------------------------------------------------------------

def _coeff_table(coeff_stack: dict, p_count: int, dtype, device):
    """Every RewardCoeffs field as a row of a (fields, P) table: the
    mutated ones from `coeff_stack` (name -> P floats), the others their
    defaults broadcast."""
    rows = []
    for name, default in RewardCoeffs().__dict__.items():
        vals = coeff_stack.get(name, [default] * p_count)
        rows.append(torch.as_tensor(np.asarray(vals, np.float64)
                                    .reshape(p_count)))
    return torch.stack(rows).to(dtype=dtype, device=device)


def push_coeffs(env_states, table: torch.Tensor, assignment: torch.Tensor):
    """Each agent's coefficients from its policy's column: (E, N) leaves."""
    per_agent = table[:, assignment]                    # (fields, E, N)
    names = list(RewardCoeffs().__dict__)
    return env_states.replace(rew_coeff=RewardCoeffs(
        **dict(zip(names, per_agent.unbind(0)))))


@torch.no_grad()
def mixed_rollout(env_cfg: EnvConfig, dyn_params, heads: StackedPolicies,
                  ppo_cfg: PPOConfig, env_states, obs, assignment,
                  coeff_table: torch.Tensor, gen: torch.Generator,
                  replay_states=None, norm: NormalizerState | None = None):
    """`ppo_cfg.rollout` ticks of one shared env batch under P policies.
    Returns (env_states', replay_states', obs', assignment', MixedTransition
    stacked over T, last_value (E, N), infos stacked over T)."""
    e, n = assignment.shape
    p_count = heads.num_policies
    use_replay = ppo_cfg.replay_sample_prob > 0.0 and replay_states is not None
    env_states = push_coeffs(env_states, coeff_table, assignment)
    steps, infos = [], []
    for _ in range(ppo_cfg.rollout):
        sel = assignment.reshape(e * n)
        mean, log_std, value = heads.forward_all(obs.reshape(e * n, -1), norm)
        mean = select_policy(mean, sel)
        log_std = select_policy(log_std, sel)
        value = select_policy(value, sel)
        actions = sample_actions(gen, mean, log_std)
        log_prob = gaussian_log_prob(mean, log_std, actions)
        actions_e = actions.reshape(e, n, -1)
        if use_replay:
            env_states, replay_states, next_obs, rew, dones, info = \
                batched_replay_step(env_cfg, dyn_params,
                                    ppo_cfg.replay_sample_prob, env_states,
                                    replay_states, actions_e, gen)
        else:
            env_states, next_obs, rew, dones, info = batched_env_step(
                env_cfg, dyn_params, env_states, actions_e, gen)
        steps.append(MixedTransition(
            obs=obs, actions=actions_e, log_prob=log_prob.reshape(e, n),
            value=value.reshape(e, n),
            reward=torch.clamp(rew, -ppo_cfg.reward_clip,
                               ppo_cfg.reward_clip),
            done=dones, assignment=assignment))
        infos.append(info)
        # the envs that ended an episode draw new assignments
        fresh = torch.randint(0, p_count, (e, n), generator=gen,
                              device=obs.device)
        assignment = torch.where(dones.any(-1)[:, None], fresh, assignment)
        env_states = push_coeffs(env_states, coeff_table, assignment)
        obs = next_obs
    _, _, values = heads.forward_all(obs.reshape(e * n, -1), norm)
    last_value = select_policy(values, assignment.reshape(e * n))
    traj = MixedTransition(*(torch.stack(x) for x in zip(*steps)))
    info = {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
    return (env_states, replay_states, obs, assignment, traj,
            last_value.reshape(e, n), info)


# --------------------------------------------------------------------------
# Learner
# --------------------------------------------------------------------------

def masked_ppo_loss(forward: Callable, ppo_cfg: PPOConfig, batch, mask,
                    norm: NormalizerState | None = None, stats=None):
    """PPO loss averaged over one policy's samples only (mask in {0, 1}).
    `forward(obs)` is that policy's model; `norm` its normalizer.  The
    log-ratio is clamped to +-20: samples of other policies can overflow
    exp, and inf * 0 would poison the sum.  The denominator is
    max(sum(mask), 1).  `stats` (mean, std, denominator) of the policy's
    advantages replace the minibatch's own (on a mesh, the global
    minibatch's: `masked_advantage_stats`)."""
    obs, actions, old_log_prob, old_value, advantages, returns = batch
    mean, log_std, value = forward(normalize_obs(norm, obs))
    mean, log_std, value = mean.float(), log_std.float(), value.float()
    if norm is not None and norm.ret is not None:
        returns = norm.ret.normalize(returns, clip=None)
        old_value = norm.ret.normalize(old_value, clip=None)
    log_prob = gaussian_log_prob(mean, log_std, actions)
    ratio = torch.exp(torch.clamp(log_prob - old_log_prob, -20.0, 20.0))
    if stats is None:
        denom = torch.clamp(torch.sum(mask), min=1.0)
        mmean = torch.sum(advantages * mask) / denom
        mstd = torch.sqrt(torch.sum(mask * (advantages - mmean) ** 2)
                          / denom)
    else:
        mmean, mstd, denom = stats
    adv = (advantages - mmean) / (mstd + 1e-8)
    clip = ppo_cfg.ppo_clip_ratio
    pg = -torch.minimum(ratio * adv,
                        torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
    v_clipped = old_value + torch.clamp(value - old_value,
                                        -ppo_cfg.ppo_clip_value,
                                        ppo_cfg.ppo_clip_value)
    v_err = torch.maximum((value - returns) ** 2, (v_clipped - returns) ** 2)
    entropy = gaussian_entropy(log_std)
    per_sample = (pg + 0.5 * ppo_cfg.value_loss_coeff * v_err
                  - (ppo_cfg.exploration_loss_coeff
                     + ppo_cfg.max_entropy_coeff) * entropy)
    return torch.sum(per_sample * mask) / denom


def clip_by_global_norm_stacked_(grads: list, max_norm: float):
    """`clip_by_global_norm_` for each policy of stacked (P, ...)
    gradients, in place: policy p's gradients times max_norm / g_norm[p]
    where g_norm[p] >= max_norm (optax's order).  Returns g_norm (P,)."""
    sq = sum(torch.sum(g.reshape(g.shape[0], -1) ** 2, 1) for g in grads)
    g_norm = torch.sqrt(sq)
    clip = g_norm >= max_norm
    one = torch.ones_like(g_norm)
    div = torch.where(clip, g_norm, one)
    mul = torch.where(clip, one * max_norm, one)
    for g in grads:
        shape = (-1,) + (1,) * (g.dim() - 1)
        g.div_(div.reshape(shape)).mul_(mul.reshape(shape))
    return g_norm


def make_stacked_optimizer(heads: StackedPolicies, ppo_cfg: PPOConfig):
    """One Adam (optax's defaults) over the stacked tensors, its state made
    at once so a round or a restore can copy slices before the first step."""
    params = list(heads.params.values())
    fused = params[0].device.type == "cuda"
    opt = torch.optim.Adam(params, lr=ppo_cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8, fused=fused)
    for p in params:
        opt.state[p] = {
            "step": (torch.zeros((), dtype=torch.float32, device=p.device)
                     if fused else torch.tensor(0.0)),
            "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)}
    return opt


def masked_advantage_stats(advantages, assign, p_count: int,
                           mesh: DataMesh | None = None):
    """Each policy's (mean, population std, denominator max(count, 1)) of
    its samples' advantages over the minibatch of every rank of `mesh`:
    the counts and sums in one all-reduce, then the sums of squares about
    the global means in a second.  Each (P,)."""
    hot = torch.nn.functional.one_hot(assign, p_count).to(advantages.dtype)
    first = all_sum(mesh, torch.cat([hot.sum(0),
                                     (hot * advantages[:, None]).sum(0)]))
    denom = torch.clamp(first[:p_count], min=1.0)
    mean = first[p_count:] / denom
    sq = all_sum(mesh, (hot * (advantages[:, None] - mean) ** 2).sum(0))
    return mean, torch.sqrt(sq / denom), denom


def stacked_sgd_step(heads: StackedPolicies, optimizer, ppo_cfg: PPOConfig,
                     batch: tuple, assign: torch.Tensor,
                     norm: NormalizerState | None = None,
                     mesh: DataMesh | None = None) -> torch.Tensor:
    """One minibatch for all P policies: each policy's masked loss and its
    gradient in one vmapped `grad`, each clipped by its own global norm,
    one Adam step over the stacked tensors.  Returns the losses (P,).  On
    a `mesh` the minibatch is every rank's rows: the advantage statistics
    and denominators are global, each rank's loss is its part of the
    global one, and the gradients and losses are summed over the mesh."""
    p_count = heads.num_policies
    stats = masked_advantage_stats(batch[4], assign, p_count, mesh)

    def loss_fn(params, buffers, nrm, pid, st):
        forward = lambda x: functional_call(heads.base, (params, buffers),
                                            (x,))
        mask = (assign == pid).to(torch.float32)
        return masked_ppo_loss(forward, ppo_cfg, batch, mask, _norm_of(nrm),
                               stats=st)

    pids = torch.arange(p_count, device=assign.device)
    # detached: the gradients are torch.func's, no outer graph is built
    params = {k: v.detach() for k, v in heads.params.items()}
    grads, losses = torch.vmap(grad_and_value(loss_fn),
                               in_dims=(0, 0, 0, 0, 0))(
        params, heads.buffers, _norm_dict(norm), pids, stats)
    grads = [grads[k] for k in heads.params]
    all_reduce_grads_(mesh, grads, average=False)
    losses = all_sum(mesh, losses)
    clip_by_global_norm_stacked_(grads, ppo_cfg.max_grad_norm)
    for p, g in zip(heads.params.values(), grads):
        p.grad = g
    optimizer.step()
    return losses


def update_masked_stacked(norm: NormalizerState, obs_flat, ret_flat,
                          assign_flat,
                          mesh: DataMesh | None = None) -> NormalizerState:
    """Each policy's normalizers fold in its own agents' samples
    (`update_masked`, every rank's on a `mesh`), a loop over the P
    policies (the JAX package's vmap): one (rows, obs_dim) deviation at a
    time, not P at once."""
    def update(stacked: RunningMeanStd, x):
        outs = [RunningMeanStd(stacked.mean[p], stacked.var[p],
                               stacked.count[p]).update_masked(
                                   x, assign_flat == p, mesh)
                for p in range(stacked.mean.shape[0])]
        return map_fields(lambda *xs: torch.stack(xs), *outs)
    if norm.obs is not None:
        norm = norm.replace(obs=update(norm.obs, obs_flat))
    if norm.ret is not None:
        norm = norm.replace(ret=update(norm.ret, ret_flat))
    return norm


def policy_objectives(infos: dict, assignment: torch.Tensor, p_count: int,
                      mesh: DataMesh | None = None):
    """(objective (P,), episodes (P,)): the mean true_reward of each
    policy's agents at episode ends this rollout (every rank's envs on a
    `mesh`), and their count."""
    done = infos["episode_done"]                          # (T, E)
    hot = torch.nn.functional.one_hot(assignment, p_count).to(torch.float32)
    w = done[:, :, None, None].to(torch.float32) * hot    # (T, E, N, P)
    tr = infos["true_reward"].to(torch.float32)
    sums = {"episodes": w.sum((0, 1, 2)),
            "reward": torch.einsum("tenp,ten->p", w, tr)}
    sums = all_sum_dict(mesh, sums)
    episodes = sums["episodes"]
    return sums["reward"] / torch.clamp(episodes, min=1.0), episodes


def mixed_train_iteration(env_cfg: EnvConfig, dyn_params,
                          heads: StackedPolicies, optimizer,
                          ppo_cfg: PPOConfig, env_states, obs, assignment,
                          replay_states, norm, coeff_table, gen,
                          mesh: DataMesh | None = None,
                          learner_gen: torch.Generator | None = None):
    """One shared rollout, GAE, the per-policy normalizer updates, then
    minibatch SGD with the same minibatch order for every policy (drawn
    from `learner_gen`, `gen` by default).  On a `mesh` the rank's envs
    and the mesh's learner.  Returns (env_states', obs', assignment',
    replay_states', norm', metrics, infos, seconds)."""
    t0 = time.perf_counter()
    (env_states, replay_states, obs, assignment, traj, last_value,
     infos) = mixed_rollout(env_cfg, dyn_params, heads, ppo_cfg, env_states,
                            obs, assignment, coeff_table, gen,
                            replay_states=replay_states, norm=norm)
    _sync(obs.device)
    t1 = time.perf_counter()
    with torch.no_grad():
        advantages, returns = compute_gae(traj, last_value, ppo_cfg.gamma,
                                          ppo_cfg.gae_lambda)
        if norm is not None and (norm.obs is not None
                                 or norm.ret is not None):
            norm = update_masked_stacked(
                norm, traj.obs.reshape(-1, traj.obs.shape[-1]),
                returns.reshape(-1), traj.assignment.reshape(-1), mesh)
    t_dim, e_dim, n_dim = traj.reward.shape
    world, rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)
    dims = (t_dim, e_dim * world, n_dim)
    tree = (traj.obs, traj.actions, traj.log_prob, traj.value, advantages,
            returns, traj.assignment)
    losses = None
    for _ in range(ppo_cfg.num_epochs):
        batched = shuffled_minibatches(
            tree, dims, ppo_cfg.batch_size, learner_gen or gen,
            groups=max(ppo_cfg.sgd_shuffle_groups, 1), shard=(rank, world))
        for i in range(batched[0].shape[0]):
            mb = tuple(x[i] for x in batched)
            losses = stacked_sgd_step(heads, optimizer, ppo_cfg, mb[:6],
                                      mb[6], norm, mesh)
    obj, episodes = policy_objectives(infos, traj.assignment,
                                      heads.num_policies, mesh)
    metrics = {"loss": losses,
               "reward_mean": all_mean(mesh, torch.mean(traj.reward.float())),
               "pbt/objective": obj, "pbt/episodes": episodes}
    _sync(obs.device)
    seconds = {"rollout": t1 - t0, "learner": time.perf_counter() - t1}
    return (env_states, obs, assignment, replay_states, norm, metrics, infos,
            seconds)


# --------------------------------------------------------------------------
# Runner
# --------------------------------------------------------------------------

class MixedPBTRunner:
    """P policies in one env batch; periodic rank-replace-mutate.
    `make_model()` builds one policy's model with fresh weights; it is
    called under `torch.manual_seed(seed + 1000 p)` for policy p.  On a
    `mesh` (the job's whole world by default) each rank holds E / D envs;
    every rank takes the same decisions, and the caller saves on rank 0
    alone."""

    def __init__(self, env_cfg: EnvConfig, ppo_cfg: PPOConfig,
                 make_model: Callable, dyn_params, pbt_cfg: PBTConfig,
                 seed: int = 0, exp_dir: str = "train_dir/pbt_mixed",
                 base_rew_coeff: dict | None = None, device="cuda",
                 mesh: DataMesh | None = None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            device=self.device)
        world = self.mesh.world
        ppo_cfg = resolve_groups(ppo_cfg, world)
        check_layout((ppo_cfg.rollout, ppo_cfg.num_envs, env_cfg.num_agents),
                     ppo_cfg.batch_size, ppo_cfg.sgd_shuffle_groups, world)
        lo, hi = env_range(self.mesh, ppo_cfg.num_envs)
        self.env_cfg, self.ppo_cfg, self.dyn_params = env_cfg, ppo_cfg, \
            dyn_params
        self.pbt_cfg, self.exp_dir = pbt_cfg, exp_dir
        self.rng = np.random.default_rng(seed)
        p_count = pbt_cfg.num_policies
        self.num_policies = p_count
        models = []
        for p in range(p_count):
            torch.manual_seed(seed + 1000 * p)
            models.append(make_model())
        self.heads = StackedPolicies(models)
        replicate(self.mesh, list(self.heads.params.values())
                  + list(self.heads.buffers.values()))
        self.optimizer = make_stacked_optimizer(self.heads, ppo_cfg)
        self.gen = torch.Generator(self.device).manual_seed(
            rank_seed(seed, self.mesh.rank))
        self.learner_gen = (self.gen if world == 1 else torch.Generator(
            self.device).manual_seed(learner_seed(seed)))
        self.env_states, self.obs = env_reset(
            env_cfg, dyn_params, self.gen, hi - lo, device=self.device)
        self.assignment = torch.randint(
            0, p_count, (hi - lo, env_cfg.num_agents),
            generator=self.gen, device=self.device)
        base = dict(base_rew_coeff) if base_rew_coeff else dict(
            quadcol_bin=5.0, quadcol_bin_smooth_max=10.0, quadcol_bin_obst=5.0)
        self.coeffs = [dict(base) for _ in range(p_count)]
        if ppo_cfg.replay_sample_prob > 0.0:
            # rings of per-agent (E, N) coefficient leaves, as the rollout
            # pushes them
            self.replay_states = init_replay_state(push_coeffs(
                self.env_states, self.coeff_table(), self.assignment))
        else:
            self.replay_states = None
        if ppo_cfg.normalize_input or ppo_cfg.normalize_returns:
            one = make_norm_state(ppo_cfg.normalize_input,
                                  ppo_cfg.normalize_returns,
                                  env_cfg.obs_dim, device=self.device)
            self.norm_state = map_fields(
                lambda x: None if x is None else torch.stack(
                    [x] * p_count), one)
        else:
            self.norm_state = None
        self.env_steps = 0
        self.objective_hist = [[] for _ in range(p_count)]
        self.seconds = {}

    def coeff_table(self) -> torch.Tensor:
        """The (fields, P) coefficient table of the current coefficients,
        copied to the device only when they change (a host-to-device copy
        synchronises)."""
        stack = {k: [c.get(k, 0.0) for c in self.coeffs]
                 for k in MUTABLE_COEFFS}
        key = json.dumps(stack)
        if getattr(self, "_table_key", None) != key:
            self._table = _coeff_table(stack, self.num_policies,
                                       self.env_cfg.dtype, self.device)
            self._table_key = key
        return self._table

    def iteration(self):
        """One shared rollout and the P policies' updates.  Returns
        (metrics, infos); `self.seconds` holds the rollout/learner split."""
        (self.env_states, self.obs, self.assignment, self.replay_states,
         self.norm_state, metrics, infos, self.seconds) = \
            mixed_train_iteration(
                self.env_cfg, self.dyn_params, self.heads, self.optimizer,
                self.ppo_cfg, self.env_states, self.obs, self.assignment,
                self.replay_states, self.norm_state, self.coeff_table(),
                self.gen, self.mesh, self.learner_gen)
        self.env_steps += (self.ppo_cfg.rollout * self.ppo_cfg.num_envs
                           * self.env_cfg.num_agents)
        obj, eps = torch.stack([metrics["pbt/objective"],
                                metrics["pbt/episodes"]]).cpu().numpy()
        for p in range(self.num_policies):
            if eps[p] > 0:
                self.objective_hist[p].append(float(obj[p]))
        return metrics, infos

    def copy_slice(self, src: int, dst: int) -> None:
        """Policy dst takes policy src's weights, Adam moments and
        normalizer: the [P] slices are copied in place, so nothing of dst
        aliases src."""
        with torch.no_grad():
            for p in self.heads.params.values():
                p[dst] = p[src]
                st = self.optimizer.state[p]
                for k in ("exp_avg", "exp_avg_sq"):
                    st[k][dst] = st[k][src]
            if self.norm_state is not None:
                for _, x in _norm_dict(self.norm_state).items():
                    x[dst] = x[src]

    def pbt_round(self) -> None:
        """Rank by recent objective; each of the bottom fraction adopts a
        top policy's slices with mutated reward shaping (the JAX package's
        decisions, draw for draw)."""
        objectives = np.array([
            np.mean(h[-20:]) if h else -np.inf for h in self.objective_hist])
        order = np.argsort(-objectives)
        k = max(int(round(self.pbt_cfg.replace_fraction
                          * self.num_policies)), 1)
        top, bottom = order[:k], order[-k:]
        for b in bottom:
            t = int(self.rng.choice(top))
            if t == b or not np.isfinite(objectives[t]):
                continue
            gap = objectives[t] - objectives[b]
            threshold = max(
                abs(objectives[t]) * self.pbt_cfg.replace_reward_gap,
                self.pbt_cfg.replace_reward_gap_absolute)
            if gap <= threshold:
                continue
            self.copy_slice(t, int(b))
            mutated = dict(self.coeffs[t])
            for name in mutated:
                if self.rng.random() < self.pbt_cfg.mutation_rate:
                    lo, hi = self.pbt_cfg.perturb_range
                    mutated[name] = float(mutated[name]) * self.rng.uniform(
                        lo, hi)
            self.coeffs[b] = mutated
            self.objective_hist[b] = []
            print(f"PBT (mixed): policy {b} <- policy {t} "
                  f"(obj {objectives[b]:.1f} <- {objectives[t]:.1f}), "
                  f"coeffs {mutated}", flush=True)

    # --- checkpointing ----------------------------------------------------

    def _policy_optimizer_state(self, p: int) -> dict:
        """Policy p's Adam state in a single model's `state_dict` layout."""
        full = self.optimizer.state_dict()
        state = {}
        for i, param in enumerate(self.heads.params.values()):
            st = self.optimizer.state[param]
            state[i] = {"step": st["step"].detach().clone().cpu(),
                        "exp_avg": st["exp_avg"][p].detach().clone(),
                        "exp_avg_sq": st["exp_avg_sq"][p].detach().clone()}
        return {"state": state, "param_groups": full["param_groups"]}

    def save(self, train_dir: str, experiment: str, keep: int = 3) -> None:
        """Each policy as `checkpoint_p{i}/checkpoint_<steps>.pt` (weights,
        Adam state and normalizer like a single-policy checkpoint); the
        coefficients and objective history in `pbt_state.json`."""
        from types import SimpleNamespace
        for p in range(self.num_policies):
            model = SimpleNamespace(
                state_dict=lambda p=p: self.heads.state_dict(p))
            opt = SimpleNamespace(
                state_dict=lambda p=p: self._policy_optimizer_state(p))
            save_checkpoint(checkpoint_dir(train_dir, experiment, p), model,
                            opt, 0, self.env_steps, keep=keep,
                            extra=norm_slice(self.norm_state, p))
        meta = {"coeffs": self.coeffs, "env_steps": self.env_steps,
                "objective_hist": [h[-50:] for h in self.objective_hist]}
        with open(os.path.join(train_dir, experiment, "pbt_state.json"),
                  "w") as f:
            json.dump(meta, f)

    def restore(self, train_dir: str, experiment: str) -> bool:
        """Load the latest checkpoint of every policy (all P must exist).
        With normalizers on, a policy's checkpoint without its normalizer
        raises: the JAX package silently keeps fresh statistics there."""
        paths = [latest_checkpoint(checkpoint_dir(train_dir, experiment, p))
                 for p in range(self.num_policies)]
        if any(path is None for path in paths):
            return False
        with torch.no_grad():
            for p, path in enumerate(paths):
                payload = load_checkpoint(path, device=self.device)
                for i, (name, param) in enumerate(self.heads.params.items()):
                    param[p] = payload["model"][name]
                    st = self.optimizer.state[param]
                    saved = payload["optimizer"]["state"][i]
                    st["exp_avg"][p] = saved["exp_avg"]
                    st["exp_avg_sq"][p] = saved["exp_avg_sq"]
                    st["step"].copy_(saved["step"])
                if self.norm_state is not None:
                    if payload.get("extra") is None:
                        raise ValueError(
                            f"{path} holds no normalizer state, but this "
                            "run normalizes its inputs or returns; resuming "
                            f"would reset policy {p}'s statistics")
                    for key, x in _norm_dict(self.norm_state).items():
                        which, stat = key.split("_")
                        x[p] = payload["extra"][which][stat]
                self.env_steps = int(payload["env_steps"])
        meta_path = os.path.join(train_dir, experiment, "pbt_state.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.coeffs = [dict(c) for c in meta["coeffs"]]
            self.env_steps = int(meta["env_steps"])
            self.objective_hist = [list(h) for h in meta["objective_hist"]]
        return True
