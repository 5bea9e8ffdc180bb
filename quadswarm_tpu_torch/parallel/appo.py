"""APPO: policy lag and the V-trace correction, on one card or a mesh.

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
synchronous PPO with the learner-side advantages.  On a mesh of ranks the
learner is the data-parallel one of `parallel/ppo.py`.

`split_mesh=(R, L)` (the CLI's `--appo_split_devices=R,L`, the JAX
package's disjoint submeshes) runs on a world of exactly R + L ranks: ranks
0..R-1 hold the env batch (E / R envs each), the replay state and the
behaviour queue; ranks R..R+L-1 hold the optimizer and the learner's
normalizer, each E / L envs of the trajectory, and all-reduce among
themselves.  Each iteration, in the JAX package's order: the rollout
ranks roll out under queue[0], send the trajectory and the bootstrap
observation to the learner ranks by env-range intersections (point to
point), the learner ranks learn, and rank R broadcasts the fresh weights
(appended to the behaviour queue), the normalizer and the metrics to every
rank.  The halves wait on each other: no overlap is claimed, and none is
measured.

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

import torch.distributed as dist

from quadswarm_tpu_torch.models.actor_critic import gaussian_log_prob
from quadswarm_tpu_torch.parallel import mesh as mesh_lib
from quadswarm_tpu_torch.parallel.mesh import DataMesh
from quadswarm_tpu_torch.parallel.normalize import NormalizerState
from quadswarm_tpu_torch.parallel.ppo import (
    METRIC_KEYS, PPOConfig, Trainer, Transition, _sync, collect_rollout,
    compute_gae, minibatch_layout, policy_heads, resolve_groups, sgd_epochs,
    update_normalizers,
)
from quadswarm_tpu_torch.utils.struct import leaves, resolve_device


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
               norm_state: NormalizerState | None = None,
               mesh: DataMesh | None = None):
    """The learner half: targets under the current weights, the
    normalizers' update, minibatch SGD on the original trajectory (the
    rank's envs of it on a `mesh`).  Returns (metrics, norm_state',
    seconds of the recompute, which ends in a device sync)."""
    t0 = time.perf_counter()
    advantages, returns = learner_targets(model, ppo_cfg, traj, last_obs,
                                          norm_state)
    _sync(last_obs.device)
    recompute = time.perf_counter() - t0
    with torch.no_grad():
        norm_state = update_normalizers(norm_state, traj, returns, mesh)
    metrics = sgd_epochs(model, optimizer, ppo_cfg, traj, advantages,
                         returns, gen, norm=norm_state, mesh=mesh)
    metrics["reward_mean"] = mesh_lib.all_mean(mesh, torch.mean(traj.reward))
    return metrics, norm_state, recompute


def _pack(traj: Transition, last_obs) -> tuple:
    """A trajectory and its bootstrap observation as float32 tensors (done
    as 0/1, every other field exact): ((T, E, N, W), (E, N, obs))."""
    f = lambda x: x.to(torch.float32)
    scalars = [f(x)[..., None] for x in (traj.log_prob, traj.value,
                                         traj.reward, traj.done)]
    return torch.cat([f(traj.obs), f(traj.actions), *scalars], -1), \
        f(last_obs)


def _unpack(packed, last_obs, obs_dim: int, dtype) -> tuple:
    """`_pack`'s inverse; observations and rewards in the env's dtype."""
    a = packed.shape[-1] - obs_dim - 4
    cut = lambda lo, hi: packed[..., lo:hi]
    head = obs_dim + a
    return Transition(
        obs=cut(0, obs_dim).to(dtype), actions=cut(obs_dim, head).contiguous(),
        log_prob=packed[..., head].contiguous(),
        value=packed[..., head + 1].contiguous(),
        reward=packed[..., head + 2].to(dtype),
        done=packed[..., head + 3] > 0.5), last_obs.to(dtype)


def _intersections(num_envs: int, senders: int, receivers: int):
    """(sender i, receiver j, lo, hi): the envs [lo, hi) that sender i of
    `senders` equal ranges holds and receiver j of `receivers` needs."""
    s, r = num_envs // senders, num_envs // receivers
    for i in range(senders):
        for j in range(receivers):
            lo, hi = max(i * s, j * r), min((i + 1) * s, (j + 1) * r)
            if lo < hi:
                yield i, j, lo, hi


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
                 device="cuda", mesh: DataMesh | None = None,
                 split_mesh: tuple | None = None):
        if policy_lag < 0:
            raise ValueError(f"policy_lag must be >= 0, got {policy_lag}")
        self.split = None
        holds = ("env", "learner")
        if split_mesh is not None:
            world = mesh if mesh is not None else mesh_lib.make_mesh(
                device=resolve_device(device))
            r, l = split_mesh
            if r + l != world.world:
                raise ValueError(f"split_mesh={split_mesh} needs {r + l} "
                                 f"devices, have {world.world}")
            # the groups follow the learner's ranks, over which the
            # trajectory is sharded
            ppo_cfg = resolve_groups(ppo_cfg, l)
            mesh_lib.replicate(world, model)
            roll, learn = mesh_lib.split_mesh(world, (r, l))
            self.split, self.world = (r, l), world
            mesh = roll if roll is not None else learn
            holds = ("env",) if roll is not None else ("learner",)
        super().__init__(env_cfg, ppo_cfg, model, dyn_params, seed=seed,
                         anneal_schedules=anneal_schedules,
                         base_rew_coeff=base_rew_coeff, device=device,
                         mesh=mesh, holds=holds)
        self.policy_lag = policy_lag
        # (learner version, weights): version v is the output of the v-th
        # learner call, 0 the initial weights.  Only ranks that roll out
        # hold the behaviour and its queue.
        self.version = 0
        self.behavior_version = 0
        self.behavior = self._param_queue = None
        if "env" in holds:
            self.behavior = copy.deepcopy(model).requires_grad_(False)
            self._param_queue = deque([(0, self._snapshot())],
                                      maxlen=policy_lag + 1)

    def restart_behavior_queue(self) -> None:
        """The queue holds the current weights alone (after a checkpoint
        was loaded into the model)."""
        if self._param_queue is not None:
            self._param_queue.clear()
            self._param_queue.append((self.version, self._snapshot()))

    def _snapshot(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def iteration(self):
        """One rollout under the lagged weights and one learner pass.
        Returns (metrics, infos); `self.seconds` holds the rollout and
        learner split and the learner's recompute.  On a split, infos are
        None on the learner ranks."""
        if self.split is not None:
            return self._split_iteration()
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
            self.learner_gen, self.norm_state, self.mesh)
        _sync(self.device)
        self.seconds = {"rollout": t1 - t0,
                        "learner": time.perf_counter() - t1,
                        "recompute": recompute}
        self.version += 1
        self._param_queue.append((self.version, self._snapshot()))
        self._count_steps()
        return metrics, infos

    def _count_steps(self) -> None:
        lay = minibatch_layout(
            (self.ppo_cfg.rollout, self.ppo_cfg.num_envs,
             self.env_cfg.num_agents), self.ppo_cfg.batch_size)
        self.step += lay.num_minibatches * self.ppo_cfg.num_epochs
        self.env_steps += (self.ppo_cfg.rollout * self.ppo_cfg.num_envs
                           * self.env_cfg.num_agents)

    def _split_iteration(self):
        """One iteration of `split_mesh=(R, L)` on this rank (module
        docstring)."""
        r, l = self.split
        e = self.ppo_cfg.num_envs
        rolls = self.optimizer is None
        infos, metrics = None, None
        t0 = time.perf_counter()
        if rolls:
            self.behavior_version, weights = self._param_queue[0]
            self.behavior.load_state_dict(weights)
            (self.env_states, self.obs, self.replay_states, traj, _,
             infos) = collect_rollout(
                self.env_cfg, self.dyn_params, self.behavior, self.ppo_cfg,
                self.env_states, self.obs, self.gen, self.current_rew_coeff(),
                self.replay_states, norm=self.norm_state)
            packed, last = _pack(traj, self.obs)
            lo = self.mesh.rank * (e // r)
            sends = [(torch.cat([packed[:, a - lo:b - lo].reshape(-1),
                                 last[a - lo:b - lo].reshape(-1)]), r + j)
                     for i, j, a, b in _intersections(e, r, l)
                     if i == self.mesh.rank]
            mesh_lib.exchange(self.world, sends, [])
        else:
            t_dim, n = self.ppo_cfg.rollout, self.env_cfg.num_agents
            obs_dim = self.env_cfg.obs_dim
            width = obs_dim + self.model.action_head.out_features + 4
            lo = self.mesh.rank * (e // l)
            parts = [(i, a, b) for i, j, a, b in _intersections(e, r, l)
                     if j == self.mesh.rank]
            bufs = [torch.empty((b - a) * n * (t_dim * width + obs_dim),
                                device=self.device) for _, a, b in parts]
            mesh_lib.exchange(self.world, [], [
                (buf, i) for buf, (i, _, _) in zip(bufs, parts)])
            packed, last = [], []
            for buf, (_, a, b) in zip(bufs, parts):
                split = t_dim * (b - a) * n * width
                packed.append(buf[:split].reshape(t_dim, b - a, n, width))
                last.append(buf[split:].reshape(b - a, n, obs_dim))
            traj, last_obs = _unpack(torch.cat(packed, 1), torch.cat(last),
                                     obs_dim, self.env_cfg.dtype)
        _sync(self.device)
        t1 = time.perf_counter()
        recompute = None
        if not rolls:
            metrics, self.norm_state, recompute = appo_learn(
                self.model, self.optimizer, self.ppo_cfg, traj, last_obs,
                self.learner_gen, self.norm_state, self.mesh)
        # rank R's weights, normalizer and metrics to every rank
        vec = (torch.stack([metrics[k].float() for k in METRIC_KEYS])
               if metrics is not None else
               torch.empty(len(METRIC_KEYS), device=self.device))
        norm = [x for _, x in leaves(self.norm_state) if x is not None] \
            if self.norm_state is not None else []
        mesh_lib.replicate(self.world, list(
            self.model.state_dict().values()) + norm + [vec], src=r)
        metrics = dict(zip(METRIC_KEYS, vec.unbind(0)))
        self.version += 1
        if rolls:
            self._param_queue.append((self.version, self._snapshot()))
        _sync(self.device)
        self.seconds = {"rollout": t1 - t0,
                        "learner": time.perf_counter() - t1}
        if recompute is not None:
            self.seconds["recompute"] = recompute
        self._count_steps()
        return metrics, infos

    def episode_stats(self, infos) -> dict:
        """On a split, the rollout ranks sum the stats and rank 0 hands
        them to every rank (a collective every rank calls)."""
        if self.split is None:
            return super().episode_stats(infos)
        box = [super().episode_stats(infos) if infos is not None else None]
        dist.broadcast_object_list(box, src=self.world.ranks[0],
                                   group=self.world.group)
        return box[0]
