"""Synchronous PPO over batched envs, on one card or a mesh of ranks.

Port of quadswarm_tpu/parallel/ppo.py.  An iteration collects a rollout of
`PPOConfig.rollout` ticks (policy forward + env step, through collision
replay when `replay_sample_prob > 0`), computes GAE, folds the rollout into
the normalizers, then runs minibatch SGD over the trajectory: PPO loss,
global-norm clip, Adam.

The JAX package runs an iteration as one jitted program over a device mesh;
here the rollout is a Python loop over ticks (one device-to-host sync a
tick, for the episode ends and the replay branches) and the learner a
Python loop over minibatches with no sync at all: losses stay on the device
until the caller reads them.

On a mesh of D ranks (`parallel/mesh.py`, one process a card) each rank
rolls out its own E / D envs from its own generator, and the learner is
the JAX package's on a sharded batch: every rank draws the same chunk
permutations of the global minibatch layout (`sgd_shuffle_groups` resolves
to 32, D must divide the group count) and takes its own groups' rows; the
advantages are standardized over the global minibatch and the normalizers
fold in the global batch (all-reduced sums); the gradients are averaged in
one flat all-reduce before the global-norm clip, so every rank takes the
same Adam step and the weights stay equal bit for bit.  On one card
`sgd_shuffle_groups` resolves to 1.

Defaults mirror the 8-drone baseline: lr=1e-4, gamma=0.99, gae_lambda=1.0,
ppo_clip=0.1, clip_value=5.0, rollout=128, batch_size=1024,
max_grad_norm=5.0, reward_clip=10, exploration_loss_coeff=0.0.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from quadswarm_tpu_torch.env.multi import (
    EnvConfig, EnvState, batched_env_step, env_reset,
)
from quadswarm_tpu_torch.env.replay import (
    batched_replay_step, init_replay_state,
)
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.models.actor_critic import (
    ActorCritic, apply_fused, gaussian_entropy, gaussian_log_prob,
    sample_actions,
)
from quadswarm_tpu_torch.parallel.mesh import (
    DataMesh, all_mean, all_reduce_grads_, all_sum, all_sum_dict, env_range,
    make_mesh, replicate, world_size,
)
from quadswarm_tpu_torch.parallel.normalize import (
    NormalizerState, denormalize_value, make_norm_state, normalize_obs,
)
from quadswarm_tpu_torch.utils.metrics import (
    episode_stat_sums, stats_from_sums,
)
from quadswarm_tpu_torch.utils.struct import map_fields, resolve_device


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Every field of the JAX PPOConfig, with its default."""

    learning_rate: float = 1e-4
    gamma: float = 0.99
    gae_lambda: float = 1.0
    ppo_clip_ratio: float = 0.1
    ppo_clip_value: float = 5.0
    value_loss_coeff: float = 0.5
    exploration_loss_coeff: float = 0.0
    max_entropy_coeff: float = 0.0
    max_grad_norm: float = 5.0
    rollout: int = 128
    batch_size: int = 1024
    num_epochs: int = 1
    reward_clip: float = 10.0
    num_envs: int = 64
    replay_sample_prob: float = 0.0
    # APPO's (V-trace); the sync trainer does not read them.
    with_vtrace: bool = False
    vtrace_rho: float = 1.0
    vtrace_c: float = 1.0
    # The JAX package's XLA unroll factor for its SGD scan: accepted, no
    # effect here.
    sgd_unroll: int = 1
    # Env groups of the minibatch layout (`shuffled_minibatches`); 0 = auto:
    # 1 on one rank, 32 on a mesh (whose world must divide the groups).
    sgd_shuffle_groups: int = 0
    normalize_input: bool = False
    normalize_returns: bool = False

    def replace(self, **changes) -> "PPOConfig":
        return dataclasses.replace(self, **changes)


# The learner's metrics, in the order a mesh reduces them.
METRIC_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl",
               "reward_mean")


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generator: `seed` itself on rank 0, so
    rank 0 of any world draws what the one-card trainer draws; another
    stream of (seed, rank) elsewhere."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence(seed, spawn_key=(1, rank))
               .generate_state(1, np.uint64)[0])


def learner_seed(seed: int) -> int:
    """The seed of the learner's generator, the same on every rank."""
    return int(np.random.SeedSequence(seed, spawn_key=(0,))
               .generate_state(1, np.uint64)[0])


def resolve_groups(ppo_cfg: "PPOConfig", world: int) -> "PPOConfig":
    """`sgd_shuffle_groups` 0 (auto) as the JAX Trainer resolves it: 1 on
    one rank, 32 on a mesh."""
    if ppo_cfg.sgd_shuffle_groups:
        return ppo_cfg
    return ppo_cfg.replace(sgd_shuffle_groups=1 if world == 1 else 32)


def check_layout(dims: tuple, batch_size: int, groups: int,
                 world: int) -> None:
    """Raise unless a world of `world` ranks can share the global layout:
    each rank holds whole env groups."""
    lay = minibatch_layout(dims, batch_size, groups)
    if lay.groups % world:
        raise ValueError(
            f"the minibatch layout of {dims} at batch {batch_size} has "
            f"{lay.groups} env groups (sgd_shuffle_groups={groups}), which "
            f"{world} ranks do not divide")


class Transition(NamedTuple):
    obs: torch.Tensor        # (T, E, N, obs_dim)
    actions: torch.Tensor    # (T, E, N, A)
    log_prob: torch.Tensor   # (T, E, N)
    value: torch.Tensor      # (T, E, N)
    reward: torch.Tensor     # (T, E, N)
    done: torch.Tensor       # (T, E, N) bool


def policy_heads(model: ActorCritic, obs_flat,
                 norm: NormalizerState | None = None):
    """(mean, log_std, value) of a (B, obs_dim) batch in float32, whatever
    the model's compute dtype, so that sampling, log-probs, GAE and V-trace
    stay float32 (the JAX package's casts); the value denormalized into
    reward space when the returns are normalized."""
    mean, log_std, value = apply_fused(model, normalize_obs(norm, obs_flat))
    return (mean.float(), log_std.float(),
            denormalize_value(norm, value.float()))


@torch.no_grad()
def collect_rollout(env_cfg: EnvConfig, dyn_params, model: ActorCritic,
                    ppo_cfg: PPOConfig, env_states: EnvState,
                    obs: torch.Tensor, gen: torch.Generator,
                    rew_coeff: RewardCoeffs, replay_states=None,
                    norm: NormalizerState | None = None):
    """ppo_cfg.rollout ticks of policy + env.  Returns (env_states', obs',
    replay_states', Transition stacked over T, last_value (E, N), infos
    stacked over T).  With `replay_sample_prob > 0` and replay states the
    tick is `batched_replay_step`.  The policy sees normalized observations
    and its values are denormalized for GAE when `norm` says so."""
    use_replay = ppo_cfg.replay_sample_prob > 0.0 and replay_states is not None
    e, n = obs.shape[:2]
    dev = obs.device
    # A fill per coefficient: a host-to-device copy would synchronise.
    env_states = env_states.replace(rew_coeff=map_fields(
        lambda x: torch.full((e,), float(x), dtype=env_cfg.dtype, device=dev),
        rew_coeff))

    steps, infos = [], []
    for _ in range(ppo_cfg.rollout):
        mean, log_std, value = policy_heads(model, obs.reshape(e * n, -1),
                                            norm)
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
        steps.append(Transition(
            obs=obs, actions=actions_e, log_prob=log_prob.reshape(e, n),
            value=value.reshape(e, n),
            reward=torch.clamp(rew, -ppo_cfg.reward_clip,
                               ppo_cfg.reward_clip),
            done=dones))
        infos.append(info)
        obs = next_obs
    _, _, last_value = policy_heads(model, obs.reshape(e * n, -1), norm)
    traj = Transition(*(torch.stack(x) for x in zip(*steps)))
    info = {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
    return env_states, obs, replay_states, traj, last_value.reshape(e, n), info


def compute_gae(traj: Transition, last_value, gamma: float, lam: float):
    """Generalized advantage estimation over the (T, E, N) trajectory, a
    reverse loop over T.  Returns (advantages, returns)."""
    advantages = torch.empty_like(traj.value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(traj.value.shape[0])):
        not_done = 1.0 - traj.done[t].to(traj.value.dtype)
        delta = traj.reward[t] + gamma * next_value * not_done - traj.value[t]
        gae = delta + gamma * lam * not_done * gae
        advantages[t] = gae
        next_value = traj.value[t]
    return advantages, advantages + traj.value


def advantage_stats(advantages: torch.Tensor, mesh: DataMesh | None = None):
    """(mean, population std) of a minibatch's advantages: the mean, then
    the mean square about it (two passes, as `jnp.std`).  On a mesh the
    minibatch is every rank's rows (equal in number): the sums are
    all-reduced."""
    count = advantages.numel() * world_size(mesh)
    mean = all_sum(mesh, advantages.sum()) / count
    var = all_sum(mesh, torch.sum((advantages - mean) ** 2)) / count
    return mean, torch.sqrt(var)


def ppo_loss(model: ActorCritic, ppo_cfg: PPOConfig, batch,
             norm: NormalizerState | None = None,
             mesh: DataMesh | None = None):
    """(loss, metrics) of one minibatch: clipped surrogate, clipped value
    loss, entropy bonus.  Advantages are standardized over the minibatch
    with the population std (over every rank's rows on a `mesh`).  Metrics
    are detached scalar tensors."""
    obs, actions, old_log_prob, old_value, advantages, returns = batch
    mean, log_std, value = apply_fused(model, normalize_obs(norm, obs))
    # the loss in float32 whatever the model's compute dtype
    mean, log_std, value = mean.float(), log_std.float(), value.float()
    if norm is not None and norm.ret is not None:
        # The critic learns normalized returns: move the targets and the
        # clip anchor into that space.
        returns = norm.ret.normalize(returns, clip=None)
        old_value = norm.ret.normalize(old_value, clip=None)
    log_prob = gaussian_log_prob(mean, log_std, actions)
    ratio = torch.exp(log_prob - old_log_prob)
    adv_mean, adv_std = advantage_stats(advantages, mesh)
    adv = (advantages - adv_mean) / (adv_std + 1e-8)
    clip = ppo_cfg.ppo_clip_ratio
    pg_loss = -torch.mean(torch.minimum(
        ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv))
    v_clipped = old_value + torch.clamp(value - old_value,
                                        -ppo_cfg.ppo_clip_value,
                                        ppo_cfg.ppo_clip_value)
    v_loss = 0.5 * torch.mean(torch.maximum((value - returns) ** 2,
                                            (v_clipped - returns) ** 2))
    entropy = torch.mean(gaussian_entropy(log_std))
    loss = (pg_loss + ppo_cfg.value_loss_coeff * v_loss
            - (ppo_cfg.exploration_loss_coeff + ppo_cfg.max_entropy_coeff)
            * entropy)
    metrics = {"loss": loss, "pg_loss": pg_loss, "v_loss": v_loss,
               "entropy": entropy,
               "approx_kl": torch.mean(old_log_prob - log_prob)}
    return loss, {k: v.detach() for k, v in metrics.items()}


@dataclasses.dataclass(frozen=True)
class MinibatchLayout:
    """How `shuffled_minibatches` cuts a (T, E, N) trajectory: `groups` env
    groups, each a stream of num_chunks chunks of `chunk` samples; a
    minibatch is chunks_per_minibatch chunks of every group.  Tiled chunks
    are tb timesteps x sb agent series; else a chunk is a
    stride-num_chunks slice of the stream."""

    num_minibatches: int
    groups: int
    rows: int           # b: samples of one group in one minibatch
    chunk: int
    num_chunks: int
    chunks_per_minibatch: int
    series: int         # eng: agent series of one group
    tb: int
    sb: int
    tiled: bool


def minibatch_layout(dims: tuple, batch_size: int,
                     groups: int = 1) -> MinibatchLayout:
    """The JAX package's layout arithmetic, plus `t_dim % tb == 0` in the
    tiled guard: without it a rollout length that 16-sample tiles do not
    divide (dims (24, 4, 6), batch 192) fails to reshape."""
    t_dim, e_dim, n_dim = dims
    total = t_dim * e_dim * n_dim
    num_minibatches = max(total // batch_size, 1)
    batch = min(batch_size, total)
    g = math.gcd(math.gcd(e_dim, batch), max(groups, 1))
    b = batch // g
    chunk = min(256, b)
    while b % chunk:
        chunk //= 2
    s_g = total // g
    num_chunks = s_g // chunk
    eng = (e_dim // g) * n_dim
    tb = min(math.gcd(t_dim, chunk), 16)
    while chunk % tb:
        tb //= 2
    sb = chunk // tb
    tiled = (tb > 1 and sb > 0 and eng % sb == 0 and t_dim % tb == 0
             and s_g == num_chunks * chunk)
    return MinibatchLayout(num_minibatches, g, b, chunk, num_chunks,
                           b // chunk, eng, tb, sb, tiled)


def shuffled_minibatches(tree, dims: tuple, batch_size: int,
                         gen: torch.Generator | None, groups: int = 1,
                         perms: torch.Tensor | None = None,
                         shard: tuple = (0, 1)):
    """Chunk-shuffled minibatches: each leaf (T, E, N, ...) becomes
    (num_minibatches, batch, ...).

    The trajectory is cut into g contiguous env groups; each group's
    (T, env*agent) sample grid into chunks, two-axis tiles of tb timesteps
    x sb agent series where they divide it (so a chunk spans many steps and
    many series), else stride slices of the group's stream.  Every
    minibatch takes the same number of chunks from each group, in the
    order of an independent permutation per group: `perms` (g, num_chunks)
    int, or drawn from `gen`.  A leaf is copied once, by one indexed read
    of its chunk grid (twice when g > 1).

    `shard` (rank, world): `dims` are the global (T, E, N) and the leaves
    hold the rank's E / world envs, whole groups of the global layout.
    The permutations are the global layout's (every rank draws all g of
    them alike) and the rank takes its own groups' rows: its part of each
    global minibatch, batch / world rows."""
    t_dim = dims[0]
    lay = minibatch_layout(dims, batch_size, groups)
    g, nmb = lay.groups, lay.num_minibatches
    rank, world = shard
    if g % world:
        raise ValueError(f"{world} ranks do not divide {g} env groups")
    dev = tree[0].device
    if perms is None:
        perms = torch.stack([torch.randperm(lay.num_chunks, generator=gen,
                                            device=dev) for _ in range(g)])
    g //= world
    perms = perms.to(device=dev, dtype=torch.long)[
        rank * g:(rank + 1) * g, : nmb * lay.chunks_per_minibatch]
    gi = torch.arange(g, device=dev)[:, None]
    tiles_per_row = lay.series // lay.sb

    def layout(x):
        rest = x.shape[3:]
        xs = x.reshape((t_dim, g, lay.series) + rest).movedim(1, 0)
        if lay.tiled:
            xs = xs.reshape((g, t_dim // lay.tb, lay.tb, tiles_per_row,
                             lay.sb) + rest)
            out = xs[gi, perms // tiles_per_row, :, perms % tiles_per_row]
        else:
            xs = xs.reshape((g, -1) + rest)[:, : lay.num_chunks * lay.chunk]
            out = xs.reshape((g, lay.chunk, lay.num_chunks) + rest)[
                gi, :, perms]
        out = out.reshape((g, nmb, lay.rows) + rest)
        return out.transpose(0, 1).reshape((nmb, g * lay.rows) + rest)

    return tuple(layout(x) for x in tree)


def make_optimizer(model: ActorCritic, ppo_cfg: PPOConfig):
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8); the clip by
    global norm comes before it in `apply_gradients`."""
    fused = next(model.parameters()).device.type == "cuda"
    return torch.optim.Adam(model.parameters(), lr=ppo_cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, fused=fused)


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient times
    max_norm / g_norm when g_norm >= max_norm (computed as t / g_norm *
    max_norm, optax's order), untouched otherwise.  Returns g_norm; the
    decision stays on the device."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = g_norm >= max_norm
    one = torch.ones_like(g_norm)
    torch._foreach_div_(grads, torch.where(clip, g_norm, one))
    torch._foreach_mul_(grads, torch.where(clip, one * max_norm, one))
    return g_norm


def apply_gradients(model: ActorCritic, optimizer, max_grad_norm: float,
                    mesh: DataMesh | None = None):
    """Average the gradients over the `mesh` (one flat all-reduce), clip
    them by their global norm, then step Adam."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    all_reduce_grads_(mesh, grads)
    clip_by_global_norm_(grads, max_grad_norm)
    optimizer.step()


def mean_metrics(metrics: dict, mesh: DataMesh | None) -> dict:
    """Scalar metrics averaged over the mesh in one all-reduce (each rank's
    are means over as many rows, so this is the global mean)."""
    if mesh is None or not mesh.distributed:
        return metrics
    return {k: v / mesh.world for k, v in all_sum_dict(mesh, metrics).items()}


def sgd_epochs(model: ActorCritic, optimizer, ppo_cfg: PPOConfig,
               traj: Transition, advantages, returns,
               gen: torch.Generator | None,
               norm: NormalizerState | None = None, perms=None,
               mesh: DataMesh | None = None) -> dict:
    """Shuffled minibatch SGD over the (T, E, N) trajectory, num_epochs
    passes.  `perms`: one (g, num_chunks) chunk permutation per epoch
    (else drawn from `gen`).  On a `mesh` the trajectory is the rank's
    envs, the layout the global batch's (`shuffled_minibatches`' shard).
    Returns the last minibatch's metrics, averaged over the mesh;
    `sgd_epochs.rows` is the number of samples this call fed the loss."""
    t_dim, e_dim, n_dim = traj.reward.shape
    world, rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)
    dims = (t_dim, e_dim * world, n_dim)
    tree = (traj.obs, traj.actions, traj.log_prob, traj.value, advantages,
            returns)
    metrics, rows = {}, 0
    for epoch in range(ppo_cfg.num_epochs):
        batched = shuffled_minibatches(
            tree, dims, ppo_cfg.batch_size, gen,
            groups=max(ppo_cfg.sgd_shuffle_groups, 1),
            perms=None if perms is None else perms[epoch],
            shard=(rank, world))
        for i in range(batched[0].shape[0]):
            loss, metrics = ppo_loss(model, ppo_cfg,
                                     tuple(x[i] for x in batched), norm,
                                     mesh)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            apply_gradients(model, optimizer, ppo_cfg.max_grad_norm, mesh)
            rows += batched[0].shape[1]
    sgd_epochs.rows = rows
    return mean_metrics(metrics, mesh)


sgd_epochs.rows = 0


def train_iteration(env_cfg: EnvConfig, dyn_params, model: ActorCritic,
                    optimizer, ppo_cfg: PPOConfig, env_states: EnvState, obs,
                    gen: torch.Generator, rew_coeff: RewardCoeffs,
                    replay_states=None,
                    norm_state: NormalizerState | None = None,
                    mesh: DataMesh | None = None,
                    learner_gen: torch.Generator | None = None):
    """Rollout, GAE (with the rollout-time normalizer), normalizer update,
    then minibatch SGD.  Returns (env_states', obs', replay_states',
    metrics, infos, norm_state', seconds), where seconds is the host time
    of the rollout and of the learner, split at a device sync.  On a
    `mesh` the rollout is the rank's envs and the learner the mesh's;
    `learner_gen` draws the minibatch order (`gen` by default)."""
    t0 = time.perf_counter()
    env_states, obs, replay_states, traj, last_value, infos = collect_rollout(
        env_cfg, dyn_params, model, ppo_cfg, env_states, obs, gen, rew_coeff,
        replay_states, norm=norm_state)
    _sync(obs.device)
    t1 = time.perf_counter()
    with torch.no_grad():
        advantages, returns = compute_gae(traj, last_value, ppo_cfg.gamma,
                                          ppo_cfg.gae_lambda)
        # The normalizers fold in the rollout before SGD; GAE above used
        # the rollout-time stats.
        norm_state = update_normalizers(norm_state, traj, returns, mesh)
    metrics = sgd_epochs(model, optimizer, ppo_cfg, traj, advantages,
                         returns, learner_gen or gen, norm=norm_state,
                         mesh=mesh)
    metrics["reward_mean"] = all_mean(mesh, torch.mean(traj.reward))
    _sync(obs.device)
    seconds = {"rollout": t1 - t0, "learner": time.perf_counter() - t1}
    return (env_states, obs, replay_states, metrics, infos, norm_state,
            seconds)


def update_normalizers(norm_state: NormalizerState | None, traj: Transition,
                       returns, mesh: DataMesh | None = None):
    """Fold a rollout's observations and GAE returns into the normalizers
    that are on (the global batch on a mesh)."""
    if norm_state is not None and norm_state.obs is not None:
        norm_state = norm_state.replace(obs=norm_state.obs.update(
            traj.obs.reshape(-1, traj.obs.shape[-1]), mesh))
    if norm_state is not None and norm_state.ret is not None:
        norm_state = norm_state.replace(ret=norm_state.ret.update(returns,
                                                                  mesh))
    return norm_state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Host-side orchestration on one card or one rank of a mesh: env and
    replay state, the model and its optimizer, normalizers,
    reward-coefficient annealing.  The model comes with its weights (rank
    0's are broadcast); `seed` seeds the trainer's generator (env resets,
    actions, replay; on one rank the minibatch order too).

    `mesh`: the ranks that train together (`parallel/mesh.py`; by default
    the job's whole world, one rank without a process group).  Each rank
    holds `num_envs / world` envs; `num_envs`, `batch_size`, `env_steps`
    and `step` stay global.  Rank r's generator is seeded with
    `rank_seed(seed, r)` and, on a world of more than one, the minibatch
    order comes from a learner generator seeded alike on every rank.
    `holds` names the halves of an iteration this rank holds, "env"
    (the env batch, replay, rollout) and "learner" (the optimizer):
    both, but on an APPO split (`parallel/appo.py`)."""

    def __init__(self, env_cfg: EnvConfig, ppo_cfg: PPOConfig,
                 model: ActorCritic, dyn_params, seed: int = 0,
                 anneal_schedules: dict | None = None,
                 base_rew_coeff: dict | None = None, device="cuda",
                 mesh: DataMesh | None = None,
                 holds: tuple = ("env", "learner")):
        self.device = resolve_device(device)
        if next(model.parameters()).device.type != self.device.type:
            raise ValueError(f"the model is on {next(model.parameters()).device}"
                             f", the trainer on {self.device}")
        self.mesh = mesh if mesh is not None else make_mesh(
            device=self.device)
        world = self.mesh.world
        ppo_cfg = resolve_groups(ppo_cfg, world)
        dims = (ppo_cfg.rollout, ppo_cfg.num_envs, env_cfg.num_agents)
        lo, hi = env_range(self.mesh, ppo_cfg.num_envs)
        if "learner" in holds:
            check_layout(dims, ppo_cfg.batch_size,
                         ppo_cfg.sgd_shuffle_groups, world)
        self.env_cfg = env_cfg
        self.ppo_cfg = ppo_cfg
        self.model = model
        self.dyn_params = dyn_params
        replicate(self.mesh, model)
        self.optimizer = (make_optimizer(model, ppo_cfg)
                          if "learner" in holds else None)
        self.step = 0                 # optimizer steps taken
        self.env_steps = 0
        self.anneal_schedules = anneal_schedules or {}
        # Collision shaping coefficients: the CLI passes the --quads_*
        # reward flags; direct construction defaults to the 8-drone mix
        # baseline's values.
        self.base_rew_coeff = dict(base_rew_coeff) if base_rew_coeff else dict(
            quadcol_bin=5.0, quadcol_bin_smooth_max=10.0, quadcol_bin_obst=5.0)
        self.gen = torch.Generator(self.device).manual_seed(
            rank_seed(seed, self.mesh.rank))
        self.learner_gen = (self.gen if world == 1 else torch.Generator(
            self.device).manual_seed(learner_seed(seed)))
        self.norm_state = make_norm_state(
            ppo_cfg.normalize_input, ppo_cfg.normalize_returns,
            env_cfg.obs_dim, device=self.device)
        self.env_states = self.obs = self.replay_states = None
        if "env" in holds:
            self.env_states, self.obs = env_reset(
                env_cfg, dyn_params, self.gen, hi - lo, device=self.device)
            self.replay_states = (
                init_replay_state(self.env_states)
                if ppo_cfg.replay_sample_prob > 0.0 else None)
        self.seconds = {}

    @property
    def writes(self) -> bool:
        """Whether this rank writes the checkpoints: rank 0 of the mesh
        that holds the optimizer."""
        return self.mesh.is_main and self.optimizer is not None

    def set_ppo_cfg(self, ppo_cfg: PPOConfig) -> None:
        """Swap the trainer's hyperparameters (the next iteration reads
        them).  The optimizer keeps its learning rate, as the JAX Trainer's
        optimizer does."""
        self.ppo_cfg = ppo_cfg

    def current_rew_coeff(self) -> RewardCoeffs:
        """Annealed coefficients ramp linearly from 0 to their final value
        over their schedule's env steps."""
        coeffs = dict(self.base_rew_coeff)
        for name, (final, steps) in self.anneal_schedules.items():
            coeffs[name] = min(final * self.env_steps / max(steps, 1), final)
        return RewardCoeffs(**coeffs)

    def iteration(self):
        """One rollout + SGD pass.  Returns (metrics, infos): device
        tensors; `self.seconds` holds the rollout/learner split."""
        (self.env_states, self.obs, self.replay_states, metrics, infos,
         self.norm_state, self.seconds) = train_iteration(
            self.env_cfg, self.dyn_params, self.model, self.optimizer,
            self.ppo_cfg, self.env_states, self.obs, self.gen,
            self.current_rew_coeff(), self.replay_states, self.norm_state,
            self.mesh, self.learner_gen)
        lay = minibatch_layout(
            (self.ppo_cfg.rollout, self.ppo_cfg.num_envs,
             self.env_cfg.num_agents), self.ppo_cfg.batch_size)
        self.step += lay.num_minibatches * self.ppo_cfg.num_epochs
        self.env_steps += (self.ppo_cfg.rollout * self.ppo_cfg.num_envs
                           * self.env_cfg.num_agents)
        return metrics, infos

    def episode_stats(self, infos) -> dict:
        """Episode stats of a rollout's infos: reduced on the device (and
        summed over the mesh, a collective every rank calls), only the
        sums reach the host."""
        sums = all_sum_dict(self.mesh, episode_stat_sums(infos))
        return stats_from_sums({k: v.cpu().numpy() for k, v in sums.items()})

    def train(self, total_env_steps: int, log_every: int = 10, logger=None):
        it = 0
        last_t, last_steps = time.time(), self.env_steps
        while self.env_steps < total_env_steps:
            metrics, infos = self.iteration()
            it += 1
            if it % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                # windowed: the first window absorbs the warm-up
                sps = (self.env_steps - last_steps) / max(now - last_t, 1e-9)
                last_t, last_steps = now, self.env_steps
                m["sps"] = sps
                m["env_steps"] = self.env_steps
                if logger is not None:
                    logger(self.env_steps, m, infos)
                else:
                    print(f"steps={self.env_steps} sps={sps:,.0f} "
                          f"loss={m['loss']:.4f} rew={m['reward_mean']:.4f}")
        return self.model
