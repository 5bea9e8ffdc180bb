"""Population-based training over separate Trainers, on one card or a mesh.

Port of quadswarm_tpu/parallel/pbt.py (Sample Factory's PBT as the
reference's 8-policy obstacle run configures it): `num_policies` Trainers,
policy p seeded `seed + 1000 p` (its weights, env, replay and generator),
take turns for an iteration each.  Every policy is ranked by the windowed
mean of its episodes' `true_reward`; after `start_mutation` env steps, every
`period_env_steps`, the bottom fraction adopts the weights and the Adam
state of a top policy, with mutated reward-shaping coefficients (and, with
`optimize_gamma`, a mutated discount).  Every host decision draws from one
numpy `default_rng(seed)`, in the JAX package's order, so the decisions are
the JAX package's draw for draw.

On a mesh of ranks every policy's Trainer shards its env batch over the
mesh (the JAX package's `mesh` argument): the objectives come from
episode stats summed over the mesh and every rank's host generator has
the same seed, so every rank takes the same decisions; only rank 0 logs
and writes checkpoints.

With `anneal_collision_steps > 0` the annealing schedule overrides the
mutated base coefficients (`Trainer.current_rew_coeff`) until its ramp
ends, as in the JAX package: the reference's PBT run anneals all three
mutable coefficients, so its mutations have no effect before then.
"""
from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from quadswarm_tpu_torch.parallel.ppo import Trainer
from quadswarm_tpu_torch.utils.checkpoint import save_checkpoint
from quadswarm_tpu_torch.utils.metrics import MetricLogger

MUTABLE_COEFFS = ("quadcol_bin", "quadcol_bin_smooth_max", "quadcol_bin_obst")


@dataclass
class PBTConfig:
    num_policies: int = 8
    period_env_steps: int = 5_000_000       # --pbt_period_env_steps
    start_mutation: int = 20_000_000        # --pbt_start_mutation
    replace_fraction: float = 0.3           # --pbt_replace_fraction
    mutation_rate: float = 0.15             # --pbt_mutation_rate
    replace_reward_gap: float = 0.1         # --pbt_replace_reward_gap
    # --pbt_replace_reward_gap_absolute: the gap must pass
    # max(relative gap, this)
    replace_reward_gap_absolute: float = 1e-6
    perturb_range: tuple = (0.8, 1.2)       # (1/pbt_perturb_max, pbt_perturb_max)
    optimize_gamma: bool = False            # --pbt_optimize_gamma


@dataclass
class PolicySlot:
    trainer: Trainer
    recent_true_rewards: list = field(default_factory=list)
    last_pbt_steps: int = 0

    def objective(self) -> float:
        if not self.recent_true_rewards:
            return -np.inf
        return float(np.mean(self.recent_true_rewards[-100:]))


def copy_policy(src: Trainer, dst: Trainer) -> None:
    """dst takes src's weights and Adam state (moments and step) as copies
    of their own: nothing of dst aliases src.  dst keeps its env, replay,
    normalizers and generator."""
    dst.model.load_state_dict(src.model.state_dict())       # copies in place
    # Optimizer.load_state_dict keeps tensors that already sit on the right
    # device, so without the deep copy dst's moments would be src's.
    dst.optimizer.load_state_dict(copy.deepcopy(src.optimizer.state_dict()))


class PBTRunner:
    """`make_model()` builds one policy's model with fresh weights; it is
    called under `torch.manual_seed(seed + 1000 p)` for policy p."""

    def __init__(self, env_cfg, ppo_cfg, make_model: Callable, dyn_params,
                 pbt_cfg: PBTConfig, seed: int = 0, anneal_schedules=None,
                 exp_dir: str = "train_dir/pbt",
                 base_rew_coeff: dict | None = None, device="cuda",
                 mesh=None):
        self.pbt_cfg = pbt_cfg
        self.exp_dir = exp_dir
        self.rng = np.random.default_rng(seed)
        self.policies = []
        for p in range(pbt_cfg.num_policies):
            torch.manual_seed(seed + 1000 * p)
            self.policies.append(PolicySlot(Trainer(
                env_cfg, ppo_cfg, make_model(), dyn_params,
                seed=seed + 1000 * p, anneal_schedules=anneal_schedules,
                base_rew_coeff=base_rew_coeff, device=device, mesh=mesh)))
        self.is_main = self.policies[0].trainer.mesh.is_main

    @property
    def total_env_steps(self) -> int:
        return sum(s.trainer.env_steps for s in self.policies)

    def _record_objective(self, slot: PolicySlot, stats: dict) -> None:
        """The rollout's episode-mean true_reward enters the window once per
        finished episode, at most 100 times; the window keeps 1000."""
        if "true_reward" in stats:
            n = min(int(stats.get("num_episodes", 1)), 100)
            slot.recent_true_rewards.extend([stats["true_reward"]] * n)
            slot.recent_true_rewards = slot.recent_true_rewards[-1000:]

    def _mutate_coeffs(self, coeffs: dict) -> dict:
        out = dict(coeffs)
        for name in MUTABLE_COEFFS:
            if self.rng.random() < self.pbt_cfg.mutation_rate:
                lo, hi = self.pbt_cfg.perturb_range
                out[name] = float(out.get(name, 0.0)) * self.rng.uniform(lo, hi)
        return out

    def _pbt_round(self) -> None:
        """Rank the policies; each of the bottom fraction adopts a top
        policy drawn at random, if that one is better by the gap."""
        objectives = np.array([s.objective() for s in self.policies])
        order = np.argsort(-objectives)  # best first
        k = max(int(round(self.pbt_cfg.replace_fraction * len(self.policies))), 1)
        top, bottom = order[:k], order[-k:]
        for b in bottom:
            t = int(self.rng.choice(top))
            if t == b:
                continue
            gap = objectives[t] - objectives[b]
            threshold = max(abs(objectives[t]) * self.pbt_cfg.replace_reward_gap,
                            self.pbt_cfg.replace_reward_gap_absolute)
            if not np.isfinite(gap) or gap <= threshold:
                continue
            src, dst = self.policies[t].trainer, self.policies[b].trainer
            copy_policy(src, dst)
            dst.base_rew_coeff = self._mutate_coeffs(src.base_rew_coeff)
            if (self.pbt_cfg.optimize_gamma
                    and self.rng.random() < self.pbt_cfg.mutation_rate):
                # the discount mutates through the horizon 1 / (1 - gamma),
                # clamped to [0.9, 0.9995]
                lo, hi = self.pbt_cfg.perturb_range
                horizon = 1.0 / (1.0 - src.ppo_cfg.gamma)
                gamma = 1.0 - 1.0 / max(horizon * self.rng.uniform(lo, hi), 2.0)
                gamma = float(np.clip(gamma, 0.9, 0.9995))
                dst.set_ppo_cfg(dst.ppo_cfg.replace(gamma=gamma))
            self.policies[b].recent_true_rewards = []
            print(f"PBT: policy {b} <- policy {t} "
                  f"(obj {objectives[b]:.1f} <- {objectives[t]:.1f}), "
                  f"coeffs {dst.base_rew_coeff}", flush=True)

    def train(self, total_env_steps: int, log_every: int = 10) -> None:
        """Iterations in turns until the population has taken
        `total_env_steps`; each policy logs to `p{p}/metrics.jsonl` and is
        saved at the end to `checkpoint_p{p}` (by rank 0).  A round runs
        when the last policy is due, as in the JAX package."""
        loggers = [MetricLogger(os.path.join(self.exp_dir, f"p{p}"))
                   if self.is_main else None
                   for p in range(len(self.policies))]
        it = 0
        try:
            while self.total_env_steps < total_env_steps:
                for p, slot in enumerate(self.policies):
                    metrics, infos = slot.trainer.iteration()
                    stats = slot.trainer.episode_stats(infos)
                    self._record_objective(slot, stats)
                    if it % log_every == 0 and self.is_main:
                        m = {k: float(v) for k, v in metrics.items()}
                        m.update(stats)
                        m["pbt/objective"] = slot.objective()
                        loggers[p].log(slot.trainer.env_steps, m)
                    steps = slot.trainer.env_steps
                    if (steps >= self.pbt_cfg.start_mutation
                            and steps - slot.last_pbt_steps
                            >= self.pbt_cfg.period_env_steps):
                        slot.last_pbt_steps = steps
                        if p == len(self.policies) - 1:
                            self._pbt_round()
                it += 1
        finally:
            for logger in loggers:
                if logger is not None:
                    logger.close()
        if not self.is_main:
            return
        for p, slot in enumerate(self.policies):
            tr = slot.trainer
            save_checkpoint(os.path.join(self.exp_dir, f"checkpoint_p{p}"),
                            tr.model, tr.optimizer, tr.step, tr.env_steps,
                            extra=tr.norm_state)
