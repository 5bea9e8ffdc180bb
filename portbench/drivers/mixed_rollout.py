"""Traffic driver `mixed_rollout`: back-to-back mixed-policy rollout calls of
the configuration's length, with its collision replay, on one shared env
batch: `parallel/pbt_mixed.py::mixed_rollout` on the state that
`MixedPBTRunner` builds, called as `MixedPBTRunner.iteration` calls it
before its learner.  The learner and the PBT rounds never run.

The run is the runner's own construction (the CLI's functions build its
env, PPO settings, models and PBT settings from the configuration's
flags): the P stacked policies, the reset, the assignment draw, the
coefficient table and the replay rings.  Then each policy takes the
benchmark's weights (`harness.make_weights`, a sub-seed of the run's seed
a policy), and each policy's three mutable coefficients are perturbed from
the seed by `parallel/pbt.py`'s mutation rule, at rate 1 so that every
policy's coefficients differ, as after PBT rounds: an agent's rewards then
depend on its policy.

The check samples one call of the window, as the `rollout` driver does:
its replay state and assignment at the start, each tick's env state and
generator states, its outputs and its final assignment are kept on the
device, and after the window the reference (`reference/mixed.py`) judges
each row under its own policy, replays the env with each agent's own
coefficients and counts the assignment's broken invariants.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from portbench import program
from portbench.harness import sub_seeds
from portbench.reference import config as rconf
from portbench.reference import mixed as rmixed
from portbench.reference import rollout as rroll
from portbench.reference.convert import to_reference


class MixedStepRecorder(program.StepRecorder):
    """`program.StepRecorder` on `parallel/pbt_mixed.py`'s own names of the
    env steps and the action draw, which it imports into its namespace."""

    def __enter__(self):
        import quadswarm_tpu_torch.parallel.pbt_mixed as mixed
        self.saved = []
        for name, at_state, at_gen in self.STEPS:
            self._patch(mixed, name, self._step(getattr(mixed, name),
                                                at_state, at_gen))
        self._patch(mixed, "sample_actions", self._sample(mixed.sample_actions))
        return self


def perturbed_coeffs(base: dict, pbt_cfg, num_policies: int,
                     seed: int) -> list:
    """One dict of reward coefficients a policy: `base` with each of
    `MUTABLE_COEFFS` scaled by a draw from the PBT perturbation range,
    through `PBTRunner._mutate_coeffs` at mutation rate 1, from a numpy
    generator seeded by `seed`."""
    from quadswarm_tpu_torch.parallel.pbt import PBTRunner
    mutator = SimpleNamespace(
        rng=np.random.default_rng(seed),
        pbt_cfg=dataclasses.replace(pbt_cfg, mutation_rate=1.0))
    return [PBTRunner._mutate_coeffs(mutator, dict(base))
            for _ in range(num_policies)]


class Run:
    rate_metric = "rollout_agent_steps_per_s"

    def __init__(self, cell, seeds, device, rec, control=False,
                 overrides=None):
        self.cell, self.device, self.rec = cell, torch.device(device), rec
        self.control = control
        self.overrides = overrides
        self.args = program.program_args(cell, overrides, device, control)
        self.b = program.Built(self.args, device)
        self.w_seed, self.env_seed, pick, self.coeff_seed = seeds
        self.k = 1 + pick % cell.traffic["check_calls"]
        self.record_from = self.min_calls = self.k
        self.failed = 0
        self.details = {}
        e, n = self.args.num_envs, self.args.quads_num_agents
        self.per_call = self.b.ppo.rollout * e * n

    # --- set-up -----------------------------------------------------------

    def setup(self):
        from quadswarm_tpu_torch.env.multi import reset_like
        from quadswarm_tpu_torch.parallel.pbt_mixed import MixedPBTRunner
        from quadswarm_tpu_torch.training.config import (
            base_rew_coeff_from_args, pbt_config_from_args,
        )
        b, args = self.b, self.args
        pbt_cfg = pbt_config_from_args(args)
        base = base_rew_coeff_from_args(args)
        self.runner = r = MixedPBTRunner(
            b.env_cfg, b.ppo, b.new_model, b.dyn, pbt_cfg,
            seed=self.env_seed, base_rew_coeff=base, device=self.device)
        p_count = r.num_policies
        self.weights = [b.weights(s)
                        for s in sub_seeds(self.w_seed, p_count)]
        with torch.no_grad():
            for p, w in enumerate(self.weights):
                for k, v in w.items():
                    stack = r.heads.params.get(k)
                    if stack is None:
                        stack = r.heads.buffers[k]
                    stack[p].copy_(v)
        self.coeffs = perturbed_coeffs(base, pbt_cfg, p_count,
                                       self.coeff_seed)
        r.coeffs = [dict(c) for c in self.coeffs]
        self.reset_obs = r.obs.clone()
        program.control_products(self.control, self.device)
        for _ in range(self.cell.traffic["warmup_calls"]):
            self._rollout()
        # the auto-reset's shapes, on a throwaway generator
        gen = torch.Generator(self.device).manual_seed(self.env_seed ^ 1)
        reset_like(r.env_cfg, r.dyn_params, gen, r.env_states)

    def _rollout(self):
        """One call, as `MixedPBTRunner.iteration` makes it; returns the
        trajectory."""
        from quadswarm_tpu_torch.parallel.pbt_mixed import mixed_rollout
        r = self.runner
        (r.env_states, r.replay_states, r.obs, r.assignment, traj, _,
         _) = mixed_rollout(r.env_cfg, r.dyn_params, r.heads, r.ppo_cfg,
                            r.env_states, r.obs, r.assignment,
                            r.coeff_table(), r.gen,
                            replay_states=r.replay_states, norm=r.norm_state)
        return traj

    # --- the window -------------------------------------------------------

    def call(self, i: int):
        if i != self.k:
            traj = self._rollout()
        else:
            # the sampled call: its replay state and assignment at the
            # start, each tick's env state and generator states, and its
            # outputs are kept for the check
            r = self.runner
            self.replay_start = (program.tree_clone(r.replay_states)
                                 if r.replay_states is not None else None)
            self.assignment_start = r.assignment.clone()
            with MixedStepRecorder() as steps:
                traj = self._rollout()
            self.steps, self.traj = steps, traj
            self.final_obs = r.obs.clone()
            self.assignment_final = r.assignment.clone()
        if not program.finite(traj.obs, traj.reward, traj.value,
                              traj.log_prob):
            self.failed += 1
        self.rec.agent_steps += self.per_call

    def traced_call(self):
        """One more call, under the profiler; returns the ticks it ran."""
        self._rollout()
        return {"ticks": self.b.ppo.rollout, "samples": self.per_call}

    def release(self):
        """Frees the program's state: only the sampled call's record, its
        outputs, the weights and the reset's observation stay."""
        if hasattr(self, "runner"):
            del self.runner
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check --------------------------------------------------------

    def check(self) -> dict:
        from portbench.reference.qs.env.multi import env_reset
        program.full_precision()
        flags = program.reference_flags(self.cell, self.overrides)
        cfg = rconf.env_config(flags)
        dyn = rconf.dynamics_params(cfg)
        hp = rconf.rollout_params(flags)
        dev = self.device
        out = {}

        # the start: the runner's reset, from the same generator seed
        gen = torch.Generator(dev).manual_seed(self.env_seed)
        _, ref_obs = env_reset(cfg, dyn, gen, flags["num_envs"], device=dev)
        out["reset_gap"] = rroll.reset_gap(self.reset_obs, ref_obs)
        del ref_obs

        steps, traj = self.steps, self.traj
        models = [rconf.model(flags, cfg, w, dev) for w in self.weights]
        out.update(rmixed.policy_gaps(models, traj, steps.sample_gens))
        del models

        out["assignment_mismatches"] = rmixed.assignment_mismatches(
            traj.assignment, traj.done, self.assignment_start,
            self.assignment_final, flags["num_policies"])

        env = rmixed.replay_env(
            cfg, dyn, lambda t: (to_reference(steps.states[t]),
                                 steps.env_gens[t]),
            to_reference(self.replay_start), traj, self.final_obs, hp,
            self.cell.limits["env_gap_tol"], self.coeffs)
        out["env_mismatch_share"] = env["share"]
        out["coeff_mismatches"] = env["coeff_mismatches"]
        self.details.update(check_call=self.k, env_gap_shares=env["levels"],
                            agent_steps_compared=env["agent_steps"],
                            coeffs=self.coeffs)
        return out
