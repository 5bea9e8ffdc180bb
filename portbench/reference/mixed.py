"""The reference's mixed-policy rollout: P actor-critics, each agent judged
under the policy assigned to it, and the frozen env stepped with each
agent's own reward coefficients.

The program (`parallel/pbt_mixed.py::mixed_rollout`) holds the P policies
stacked, runs every head on every row under `torch.vmap` and keeps each
row's assigned head; it pushes each agent's coefficients into the env
state from a (fields, P) table gathered by assignment, and redraws the
assignment of the envs whose episode ended.  The reference checks the
same outputs another way:

- the policy (`policy_gaps`): P unstacked reference actor-critics, each
  applied only to the rows assigned to it, with no `vmap`; the values, the
  log-probabilities of the program's actions and the actions drawn again
  from the generator's state before the program's draw;
- the env (`replay_env`): `rollout.replay_env` from the program's
  recorded state of each tick, its reward coefficients replaced by the
  reference's own: each agent's policy's coefficients, from the plain list
  of the run's coefficients (`per_agent_coeffs`); the coefficients the
  program pushed are counted where they differ from these;
- the assignment (`assignment_mismatches`): by its invariants, since its
  redraw is a free draw: it stays where no episode ended and lies in
  [0, P).

Imports nothing of the program.
"""
from __future__ import annotations

import torch

from portbench.reference import rollout as rroll
from portbench.reference.qs.env.reward import RewardCoeffs
from portbench.reference.qs.models.actor_critic import gaussian_log_prob


def per_agent_coeffs(coeffs: list, assignment) -> RewardCoeffs:
    """Each agent's reward coefficients as (E, N) float32 leaves: policy
    p's entries of `coeffs` (one dict of floats a policy) for the agents
    assigned to p, the defaults for the fields no policy sets."""
    defaults = RewardCoeffs().__dict__
    leaves = {}
    for name, default in defaults.items():
        per_policy = torch.tensor([float(c.get(name, default))
                                   for c in coeffs], dtype=torch.float32,
                                  device=assignment.device)
        leaves[name] = per_policy[assignment.long()]
    return RewardCoeffs(**leaves)


@torch.no_grad()
def policy_gaps(models: list, traj, sample_gens: list) -> dict:
    """The widest gaps of the program's values, of its log-probabilities of
    its own actions and of those actions, each row against the reference
    actor-critic of the policy that acted (`traj.assignment`), tick by
    tick and policy by policy.  `sample_gens`: each tick's generator state
    before the program drew its actions, from which the reference draws
    the same standard normals (one (E * N, A) float32 draw)."""
    t_dim, e, n = traj.reward.shape
    dev = traj.obs.device
    gen = torch.Generator(dev)
    gaps = torch.zeros(3, device=dev)
    for t in range(t_dim):
        obs = traj.obs[t].reshape(e * n, -1).float()
        act = traj.actions[t].reshape(e * n, -1).float()
        assign = traj.assignment[t].reshape(e * n)
        gen.set_state(sample_gens[t].cpu())
        normal = torch.randn(act.shape, generator=gen, dtype=torch.float32,
                             device=dev)
        for p, model in enumerate(models):
            rows = torch.nonzero(assign == p).squeeze(1)
            if rows.numel() == 0:
                continue
            mean, log_std, value = model(obs[rows])
            mean, log_std = mean.float(), log_std.float()
            logp = gaussian_log_prob(mean, log_std, act[rows])
            drawn = mean + torch.exp(log_std) * normal[rows]
            gaps = torch.maximum(gaps, torch.stack([
                rroll.rel_gap(traj.value[t].reshape(-1)[rows], value).max(),
                rroll.rel_gap(traj.log_prob[t].reshape(-1)[rows],
                              logp).max(),
                rroll.rel_gap(act[rows], drawn).max()]))
    gaps = torch.nan_to_num(gaps, nan=float("inf")).tolist()
    return dict(zip(("value_gap", "logprob_gap", "action_gap"), gaps))


@torch.no_grad()
def assignment_mismatches(assignment, done, start, final,
                          num_policies: int) -> int:
    """Agent-ticks whose assignment breaks an invariant of the redraw:
    `assignment` (T, E, N) is the policy that acted at each tick, `done`
    (T, E, N) the episode ends, `start` and `final` (E, N) the assignment
    before and after the call.  An agent's policy may change only after a
    tick on which its env's episode ended, and lies in [0, P)."""
    seq = torch.cat([start[None], assignment, final[None]]).long()
    out_of_range = ((seq < 0) | (seq >= num_policies)).sum()
    # seq[i + 1] follows seq[i]; it may differ only where tick i - 1 ended
    # an episode (the start and the first acting policy agree always)
    ended = torch.cat([torch.zeros_like(done[:1]), done]).bool().any(-1)
    changed = (seq[1:] != seq[:-1]) & ~ended[:, :, None]
    return int(out_of_range + changed.sum())


def replay_env(cfg, dyn, ticks, replay, traj, final_obs, params: dict,
               tol: float, coeffs: list) -> dict:
    """`rollout.replay_env` with each tick's state carrying the reference's
    per-agent coefficients: those of the policy each agent acted under at
    that tick (`traj.assignment[t]`), from `coeffs`.  Also counts the
    agent-ticks whose coefficients in the program's state differ from
    those in any field (`coeff_mismatches`): a coefficient reaches the
    reward only through a collision, which few agent-steps have, so the
    reward alone would not show a wrong push."""
    get = ticks if callable(ticks) else ticks.__getitem__
    mismatches = []

    def with_coeffs(t):
        state, gen_state = get(t)
        want = per_agent_coeffs(coeffs, traj.assignment[t])
        got = state.rew_coeff
        differ = torch.zeros(traj.assignment.shape[1:], dtype=torch.bool,
                             device=traj.assignment.device)
        for name, w in want.__dict__.items():
            g = torch.as_tensor(getattr(got, name), dtype=torch.float32,
                                device=w.device)
            if g.dim() == 1:          # a per-env coefficient
                g = g[:, None]
            differ |= torch.broadcast_to(g, w.shape) != w
        mismatches.append(differ.sum())
        return state.replace(rew_coeff=want), gen_state
    out = rroll.replay_env(cfg, dyn, with_coeffs, replay, traj, final_obs,
                           params, tol)
    out["coeff_mismatches"] = int(torch.stack(mismatches).sum())
    return out
