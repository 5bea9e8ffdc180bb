"""APPO on one device: policy lag and the V-trace correction.

Port of quadswarm_tpu/parallel/appo.py (the stand-in for Sample Factory's
APPO, which the reference trains with).  An iteration is a rollout under a
behaviour copy of the model, whose weights are the learner's output
`policy_lag` iterations back, then the learner: it recomputes values (and,
with V-trace, log-probs) under the current weights over the behaviour's
trajectory, one rollout step at a time without gradients, builds the
advantages and targets (V-trace, or GAE on the learner's values), folds the
rollout into the normalizers and runs the shared minibatch SGD on the
original trajectory: the PPO ratio and the value clip read the behaviour's
log-probs and values.

As on one TPU chip, the rollout and the learner do not overlap on the card:
they run one after the other, so on one device APPO is a semantic choice
(staleness tolerance and V-trace), not a throughput one.  `policy_lag=0` is
synchronous PPO with the learner-side advantages.  The JAX package's
`split_mesh` (rollout and learner on disjoint devices) is ROADMAP.md item
14 and not ported.

V-trace (Espeholt et al., 2018): with clipped importance weights
rho_t = min(pi/mu, rho_clip), c_t = min(pi/mu, c_clip),
    vs_t - V_t = delta_t + gamma * c_t * (vs_{t+1} - V_{t+1}),
    delta_t    = rho_t * (r_t + gamma * V_{t+1} - V_t),
and the policy-gradient advantage rho_t * (r_t + gamma * vs_{t+1} - V_t).
On-policy with rho = c = 1 it is GAE(lambda=1).
"""
from __future__ import annotations

import copy
import time
from collections import deque

import torch

from quadswarm_tpu_torch.models.actor_critic import gaussian_log_prob
from quadswarm_tpu_torch.parallel.normalize import NormalizerState
from quadswarm_tpu_torch.parallel.ppo import (
    PPOConfig, Trainer, Transition, _sync, collect_rollout, compute_gae,
    minibatch_layout, policy_heads, sgd_epochs,
)


def vtrace_advantages(ratio, reward, value, done, last_value, gamma: float,
                      rho_clip: float = 1.0, c_clip: float = 1.0):
    """V-trace over a (T, E, N) trajectory: (policy-gradient advantages,
    value targets vs).  `ratio` is exp(log pi_learner - log mu_behaviour)
    a step, `value` the learner's values of the visited states and
    `last_value` its bootstrap after the last step.  An episode end cuts
    the recursion and the bootstrap, as in GAE."""
    dtype = value.dtype
    rho = torch.clamp(ratio, max=rho_clip).to(dtype)
    c = torch.clamp(ratio, max=c_clip).to(dtype)
    not_done = 1.0 - done.to(dtype)
    next_values = torch.cat([value[1:], last_value[None]], 0)
    delta = rho * (reward + gamma * next_values * not_done - value)
    vs_minus_v = torch.empty_like(value)
    acc = torch.zeros_like(last_value)
    for t in reversed(range(value.shape[0])):
        acc = delta[t] + gamma * c[t] * not_done[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + value
    vs_next = torch.cat([vs[1:], last_value[None]], 0)
    return rho * (reward + gamma * vs_next * not_done - value), vs


@torch.no_grad()
def learner_targets(model, ppo_cfg: PPOConfig, traj: Transition, last_obs,
                    norm_state: NormalizerState | None = None):
    """(advantages, returns) of the behaviour's trajectory under the
    learner's current weights.  The values (and, with V-trace, the
    log-probs of the taken actions) are recomputed one rollout step of
    E * N rows at a time: one forward over all T * E * N rows would hold
    (T * E * N, 6, hidden) activations, 1M rows at 128 x 1024 x 8."""
    e_dim, n_dim = traj.reward.shape[1:]

    def forward(obs):
        return policy_heads(model, obs.reshape(e_dim * n_dim, -1),
                            norm_state)

    values = torch.empty_like(traj.value)
    target_log_prob = (torch.empty_like(traj.log_prob) if ppo_cfg.with_vtrace
                       else None)
    for t in range(traj.reward.shape[0]):
        mean, log_std, value = forward(traj.obs[t])
        values[t] = value.reshape(e_dim, n_dim)
        if ppo_cfg.with_vtrace:
            target_log_prob[t] = gaussian_log_prob(
                mean, log_std, traj.actions[t].reshape(e_dim * n_dim, -1)
            ).reshape(e_dim, n_dim)
    last_value = forward(last_obs)[2].reshape(e_dim, n_dim)
    if ppo_cfg.with_vtrace:
        return vtrace_advantages(
            torch.exp(target_log_prob - traj.log_prob), traj.reward, values,
            traj.done, last_value, ppo_cfg.gamma, ppo_cfg.vtrace_rho,
            ppo_cfg.vtrace_c)
    # GAE under the learner's value function; the PPO ratio still corrects
    # the policy lag.
    return compute_gae(traj._replace(value=values), last_value,
                       ppo_cfg.gamma, ppo_cfg.gae_lambda)


def appo_learn(model, optimizer, ppo_cfg: PPOConfig, traj: Transition,
               last_obs, gen: torch.Generator | None,
               norm_state: NormalizerState | None = None):
    """The learner half: targets under the current weights, the
    normalizers' update, minibatch SGD on the original trajectory.
    Returns (metrics, norm_state', seconds of the recompute, which ends in
    a device sync)."""
    t0 = time.perf_counter()
    advantages, returns = learner_targets(model, ppo_cfg, traj, last_obs,
                                          norm_state)
    _sync(last_obs.device)
    recompute = time.perf_counter() - t0
    with torch.no_grad():
        if norm_state is not None and norm_state.obs is not None:
            norm_state = norm_state.replace(obs=norm_state.obs.update(
                traj.obs.reshape(-1, traj.obs.shape[-1])))
        if norm_state is not None and norm_state.ret is not None:
            norm_state = norm_state.replace(ret=norm_state.ret.update(returns))
    metrics = sgd_epochs(model, optimizer, ppo_cfg, traj, advantages,
                         returns, gen, norm=norm_state)
    metrics["reward_mean"] = torch.mean(traj.reward)
    return metrics, norm_state, recompute


class APPOTrainer(Trainer):
    """The Trainer with a behaviour copy of the model and a queue of the
    learner's weights: the rollout of an iteration takes `queue[0]`, and
    the learner's output is appended after it (maxlen policy_lag + 1), so
    with lag L the rollout of iteration i uses the weights after iteration
    i - L (those at init while i <= L, counting from 1).  The behaviour
    reads the current normalizer stats; they are not lagged."""

    def __init__(self, env_cfg, ppo_cfg: PPOConfig, model, dyn_params,
                 seed: int = 0, anneal_schedules: dict | None = None,
                 policy_lag: int = 1, base_rew_coeff: dict | None = None,
                 device="cuda"):
        super().__init__(env_cfg, ppo_cfg, model, dyn_params, seed=seed,
                         anneal_schedules=anneal_schedules,
                         base_rew_coeff=base_rew_coeff, device=device)
        if policy_lag < 0:
            raise ValueError(f"policy_lag must be >= 0, got {policy_lag}")
        self.policy_lag = policy_lag
        self.behavior = copy.deepcopy(model).requires_grad_(False)
        # (learner version, weights): version v is the output of the v-th
        # learner call, 0 the initial weights
        self.version = 0
        self._param_queue = deque([(0, self._snapshot())],
                                  maxlen=policy_lag + 1)
        self.behavior_version = 0

    def restart_behavior_queue(self) -> None:
        """The queue holds the current weights alone (after a checkpoint
        was loaded into the model)."""
        self._param_queue.clear()
        self._param_queue.append((self.version, self._snapshot()))

    def _snapshot(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def iteration(self):
        """One rollout under the lagged weights and one learner pass.
        Returns (metrics, infos); `self.seconds` holds the rollout and
        learner split and the learner's recompute."""
        self.behavior_version, weights = self._param_queue[0]
        self.behavior.load_state_dict(weights)
        t0 = time.perf_counter()
        (self.env_states, self.obs, self.replay_states, traj, _,
         infos) = collect_rollout(
            self.env_cfg, self.dyn_params, self.behavior, self.ppo_cfg,
            self.env_states, self.obs, self.gen, self.current_rew_coeff(),
            self.replay_states, norm=self.norm_state)
        _sync(self.device)
        t1 = time.perf_counter()
        metrics, self.norm_state, recompute = appo_learn(
            self.model, self.optimizer, self.ppo_cfg, traj, self.obs,
            self.gen, self.norm_state)
        _sync(self.device)
        self.seconds = {"rollout": t1 - t0,
                        "learner": time.perf_counter() - t1,
                        "recompute": recompute}
        self.version += 1
        self._param_queue.append((self.version, self._snapshot()))
        lay = minibatch_layout(
            (self.ppo_cfg.rollout, self.ppo_cfg.num_envs,
             self.env_cfg.num_agents), self.ppo_cfg.batch_size)
        self.step += lay.num_minibatches * self.ppo_cfg.num_epochs
        self.env_steps += (self.ppo_cfg.rollout * self.ppo_cfg.num_envs
                           * self.env_cfg.num_agents)
        return metrics, infos
