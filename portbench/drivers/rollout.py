"""Traffic driver `rollout`: back-to-back rollout calls of the configuration's
length, with its collision replay, on one env batch:
`parallel/ppo.py::collect_rollout` with the actor-critic.  The learner
never runs.

The check samples one call of the window (its index drawn from the seed
among calls 1 to `check_calls`, so that at least one call runs before
it): its replay state at the start, each tick's env state and generator
states, and its outputs are kept on the device, and after the window the
reference replays that call (see `reference/rollout.py`) and judges the
policy's outputs on it.  The memory peak is read before that call
(`record_from`), so the record is not in it.
"""
from __future__ import annotations

import torch

from portbench import program
from portbench.reference import config as rconf
from portbench.reference import rollout as rroll
from portbench.reference.convert import to_reference


class Run:
    rate_metric = "rollout_agent_steps_per_s"

    def __init__(self, cell, seeds, device, rec, control=False,
                 overrides=None):
        self.cell, self.device, self.rec = cell, torch.device(device), rec
        self.control = control
        self.overrides = overrides
        self.args = program.program_args(cell, overrides, device, control)
        self.b = program.Built(self.args, device)
        self.w_seed, self.env_seed, pick, _ = seeds
        self.k = 1 + pick % cell.traffic["check_calls"]
        self.record_from = self.min_calls = self.k
        self.failed = 0
        self.details = {}
        e, n = self.args.num_envs, self.args.quads_num_agents
        self.per_call = self.b.ppo.rollout * e * n

    # --- set-up -----------------------------------------------------------

    def setup(self):
        from quadswarm_tpu_torch.env.multi import env_reset, reset_like
        from quadswarm_tpu_torch.env.replay import init_replay_state
        b = self.b
        self.weights = b.weights(self.w_seed)
        self.model = b.new_model()
        self.model.load_state_dict(self.weights)
        self.gen = torch.Generator(self.device).manual_seed(self.env_seed)
        self.states, self.obs = env_reset(b.env_cfg, b.dyn, self.gen,
                                          self.args.num_envs,
                                          device=self.device)
        self.reset_obs = self.obs.clone()
        self.replay = (init_replay_state(self.states)
                       if b.ppo.replay_sample_prob > 0 else None)
        program.control_products(self.control, self.device)
        for _ in range(self.cell.traffic["warmup_calls"]):
            self._rollout()
        # the auto-reset's shapes, on a throwaway generator
        gen = torch.Generator(self.device).manual_seed(self.env_seed ^ 1)
        reset_like(b.env_cfg, b.dyn, gen, self.states)

    def _rollout(self):
        """One call; returns (traj, last obs)."""
        from quadswarm_tpu_torch.parallel.ppo import collect_rollout
        b = self.b
        (self.states, self.obs, self.replay, traj, _, _) = collect_rollout(
            b.env_cfg, b.dyn, self.model, b.ppo, self.states, self.obs,
            self.gen, b.rew_coeff, self.replay, norm=None)
        return traj, self.obs

    # --- the window -------------------------------------------------------

    def call(self, i: int):
        if i != self.k:
            traj, _ = self._rollout()
        else:
            # the sampled call: its replay state at the start, each tick's
            # env state and generator states, and its outputs are kept for
            # the check
            self.replay_start = (program.tree_clone(self.replay)
                                 if self.replay is not None else None)
            with program.StepRecorder() as steps:
                traj, last = self._rollout()
            self.steps, self.traj, self.final_obs = steps, traj, last.clone()
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
        for name in ("model", "states", "obs", "replay"):
            if hasattr(self, name):
                delattr(self, name)
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

        # the start: the reset, from the same generator seed
        gen = torch.Generator(dev).manual_seed(self.env_seed)
        _, ref_obs = env_reset(cfg, dyn, gen, flags["num_envs"], device=dev)
        out["reset_gap"] = rroll.reset_gap(self.reset_obs, ref_obs)
        del ref_obs

        steps = self.steps
        model = rconf.model(flags, cfg, self.weights, dev)
        out.update(rroll.policy_gaps(model, self.traj, steps.sample_gens))
        del model

        env = rroll.replay_env(
            cfg, dyn, lambda t: (to_reference(steps.states[t]),
                                 steps.env_gens[t]),
            to_reference(self.replay_start), self.traj, self.final_obs, hp,
            self.cell.limits["env_gap_tol"])
        out["env_mismatch_share"] = env["share"]
        self.details.update(check_call=self.k, env_gap_shares=env["levels"],
                            agent_steps_compared=env["agent_steps"])
        return out
