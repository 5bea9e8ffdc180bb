"""The reference's rollout: the frozen env, stepped from the program's
recorded state of each tick with the program's actions, draw for draw.

The program's rollout samples each tick's actions from the policy with its
generator, then steps the env, which draws from the same generator.  The
reference checks the two halves apart:

- the policy (`policy_gaps`): the reference actor-critic on the program's
  observations gives the values, the log-probabilities of the program's
  actions, and the actions themselves, drawn again from the generator's
  state that the program's draw started from;
- the env (`replay_env`): for each tick, from the state the program's env
  step was given and its generator's state there, the reference steps its
  own env with the program's actions: the same draws reach the same
  branches, and its observations, rewards, episode ends and next drone
  states are compared with the program's.  The replay rings are the
  reference's own from the call's start on.  Each tick starts again from
  the program's state because a rounding difference of the kernels (fused
  multiply-adds) grows over many ticks of drones flown by random actions;
  within one tick it stays at rounding, and the rare drone whose contact
  or collision it tips counts in the share of agent-steps over the
  tolerance, the number compared.
"""
from __future__ import annotations

import torch

from portbench.reference.qs.env.multi import batched_env_step
from portbench.reference.qs.env.replay import batched_replay_step
from portbench.reference.qs.models.actor_critic import gaussian_log_prob

# Shares of agent-steps whose gap exceeds these, reported beside the number
# compared (which uses the cell's own tolerance).
GAP_LEVELS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)


def rel_gap(got, want):
    """|got - want| / (1 + |want|), in float32."""
    got, want = got.float(), want.float()
    return (got - want).abs() / (1.0 + want.abs())


class Gaps:
    """Running comparison of the program's env outputs with the
    reference's: agent-steps compared, those over the tolerance, and the
    shares over each of GAP_LEVELS."""

    def __init__(self, tol: float, device):
        self.tol = tol
        self.count = 0
        self.over = torch.zeros((), dtype=torch.float64, device=device)
        self.levels = torch.zeros(len(GAP_LEVELS), dtype=torch.float64,
                                  device=device)

    def add(self, obs, obs_ref, rew, rew_ref, done, done_ref, extra=None):
        gap = torch.maximum(rel_gap(obs, obs_ref).amax(-1),
                            rel_gap(rew, rew_ref))
        if extra is not None:
            gap = torch.maximum(gap, extra)
        gap = torch.where(done.bool() != done_ref.bool(),
                          torch.full_like(gap, float("inf")), gap)
        gap = torch.nan_to_num(gap, nan=float("inf"))
        self.count += gap.numel()
        self.over += (gap > self.tol).sum()
        self.levels += torch.stack([(gap > lv).sum() for lv in GAP_LEVELS])

    def result(self) -> dict:
        n = max(self.count, 1)
        return {"share": float(self.over) / n,
                "levels": {f"{lv:g}": float(v) / n for lv, v in
                           zip(GAP_LEVELS, self.levels.tolist())},
                "agent_steps": self.count}


@torch.no_grad()
def replay_env(cfg, dyn, ticks: list, replay, traj, final_obs,
               params: dict, tol: float) -> dict:
    """Steps the reference env once for each tick of one call of the
    program's rollout, from the program's state at that tick.

    ticks: for each tick, the reference's copy of the state the program's
    env step was given and the generator's state there
    ((state, gen_state), or a function of t returning them); replay: the
    reference's copy of the replay state at the call's start (None without
    replay), which the reference then carries along itself; traj: the
    program's (T, E, N) outputs (obs, actions, reward, done); final_obs:
    the program's observation after the call; params:
    `config.rollout_params`.

    Each tick's gap of an agent is the largest relative gap of its
    observation, its reward and its drone state (position, velocity,
    rotation, body rates: the next tick's state the program's env was
    given), infinite where its episode end differs."""
    get = ticks if callable(ticks) else ticks.__getitem__
    dev = traj.obs.device
    gen = torch.Generator(dev)
    t_dim, e, n = traj.reward.shape
    use_replay = params["replay_buffer_sample_prob"] > 0 and replay is not None
    clip = params["reward_clip"]
    gaps = Gaps(tol, dev)
    state, gen_state = get(0)
    for t in range(t_dim):
        gen.set_state(gen_state.cpu())
        actions = traj.actions[t].float()
        if use_replay:
            ref, replay, obs, rew, dones, _ = batched_replay_step(
                cfg, dyn, params["replay_buffer_sample_prob"], state,
                replay, actions, gen)
        else:
            ref, obs, rew, dones, _ = batched_env_step(cfg, dyn, state,
                                                       actions, gen)
        rew = torch.clamp(rew, -clip, clip)
        want_obs = traj.obs[t + 1] if t + 1 < t_dim else final_obs
        extra = None
        if t + 1 < t_dim:
            state, gen_state = get(t + 1)
            extra = torch.stack([
                rel_gap(getattr(state.dyn, f), getattr(ref.dyn, f))
                .reshape(e, n, -1).amax(-1)
                for f in ("pos", "vel", "rot", "omega")]).amax(0)
        gaps.add(want_obs, obs, traj.reward[t], rew, traj.done[t], dones,
                 extra)
    return gaps.result()


@torch.no_grad()
def policy_gaps(model, traj, sample_gens: list) -> dict:
    """The widest gaps of the program's values, of its log-probabilities of
    its own actions and of those actions from the reference actor-critic's,
    tick by tick (one block of E * N rows at a time).  `sample_gens`: each
    tick's generator state before the program drew its actions, from which
    the reference draws the same standard normals (one (E * N, A) float32
    draw, as the program's)."""
    t_dim, e, n = traj.reward.shape
    dev = traj.obs.device
    gen = torch.Generator(dev)
    gaps = torch.zeros(3, device=dev)
    for t in range(t_dim):
        obs = traj.obs[t].reshape(e * n, -1).float()
        act = traj.actions[t].reshape(e * n, -1).float()
        gen.set_state(sample_gens[t].cpu())
        normal = torch.randn(act.shape, generator=gen, dtype=torch.float32,
                             device=dev)
        mean, log_std, value = model(obs)
        mean, log_std = mean.float(), log_std.float()
        logp = gaussian_log_prob(mean, log_std, act)
        drawn = mean + torch.exp(log_std) * normal
        gaps = torch.maximum(gaps, torch.stack([
            rel_gap(traj.value[t].reshape(-1), value).max(),
            rel_gap(traj.log_prob[t].reshape(-1), logp).max(),
            rel_gap(act, drawn).max()]))
    gaps = torch.nan_to_num(gaps, nan=float("inf")).tolist()
    return dict(zip(("value_gap", "logprob_gap", "action_gap"), gaps))


@torch.no_grad()
def reset_gap(obs_prog, obs_ref) -> float:
    """The widest gap of the program's first observation after its reset
    from the reference's reset with the same generator seed."""
    return float(torch.nan_to_num(rel_gap(obs_prog, obs_ref).max(),
                                  nan=float("inf")))
