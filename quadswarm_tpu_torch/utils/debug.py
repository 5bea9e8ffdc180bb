"""Runtime sanitizers and the profiler hook.

Port of quadswarm_tpu/utils/debug.py:
- `checked_env_step`: the env step with the reference's finiteness checks
  of the reward and the drone positions; `err.throw()` raises ValueError
  with the JAX package's messages.  Both checks and the auto-reset's test
  travel to the host in one read a step.
- `enable_debug_checks()`: autograd anomaly mode, which `train.py
  --debug_checks=True` turns on.  It checks the backward pass only (it
  raises at the backward operation that makes a NaN), where the JAX
  package's `jax_debug_nans` checks every operation; a divergence by
  design (ROADMAP.md Queue 3).
- `trace(log_dir)`: a torch.profiler context over the CPU and the card
  that writes `<log_dir>/trace.json`, a Chrome trace (`train.py
  --profile_dir`).  The program's spans (`utils/tracing.py`: a rollout's
  `rollout.tick`, `rollout.policy`, `rollout.sample`, `rollout.env_step`
  and `rollout.stack`; the env step's `env.step` with its stages
  `env.scenario` ... `env.stats`, `env.sync`, `env.reset_done`; the
  replay's `replay.ring` and `replay.restore`; the learner's
  `learner.gae` and `learner.minibatch`) show in it beside the kernels.
  With no profiler recording they cost one C call each and record
  nothing; `portbench/run.py --trace 1` reads them too.
"""
from __future__ import annotations

import contextlib
import os

import torch

from quadswarm_tpu_torch.utils.tracing import annotated

_CHECKS = ("Reward is not finite. Debug this!",
           "Drone position is not finite. Debug this!")


class CheckError:
    """The outcome of one checked step: `throw()` raises ValueError with
    the message of the first check that failed, in the JAX package's
    order, and does nothing when all passed."""

    def __init__(self, passed: tuple):
        self.passed = tuple(bool(p) for p in passed)

    def get(self) -> str | None:
        return next((msg for msg, ok in zip(_CHECKS, self.passed) if not ok),
                    None)

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise ValueError(msg)


def checked_env_step(cfg, params):
    """A step `(states, actions, gen, draws=None) -> (err, (states', obs,
    rewards, dones, info))` of `env/multi.py::batched_env_step`, which
    also checks that every reward and every drone position it makes is
    finite.  The checks see the positions before the auto-reset replaces
    finished envs.

    Usage:
        step = checked_env_step(cfg, params)
        err, (states, obs, rew, done, info) = step(states, actions, gen)
        err.throw()   # raises ValueError if a check failed
    """
    from quadswarm_tpu_torch.env.multi import batched_env_step, reset_done

    def step(states, actions, gen, draws=None):
        states, obs, rew, dones, info = batched_env_step(
            cfg, params, states, actions, gen, draws, auto_reset=False)
        done_env = dones[:, 0]
        # one device-to-host read: the auto-reset's test and both checks
        any_done, rew_ok, pos_ok = torch.stack([
            done_env.any(), torch.isfinite(rew).all(),
            torch.isfinite(states.dyn.pos).all()]).tolist()
        if any_done:
            states, obs = reset_done(cfg, params, gen, states, obs, done_env)
        return CheckError((rew_ok, pos_ok)), (states, obs, rew, dones, info)

    return step


def enable_debug_checks() -> None:
    """Autograd anomaly mode: a backward operation that makes a NaN raises,
    with the traceback of the forward operation behind it."""
    torch.autograd.set_detect_anomaly(True)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the enclosed block, on the CPU and, where there
    is one, the card; on exit the Chrome trace goes to
    `<log_dir>/trace.json` (chrome://tracing or Perfetto read it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    try:
        with annotated():
            yield profiler
    finally:
        profiler.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "trace.json")
        profiler.export_chrome_trace(path)
        print(f"profiler trace written to {path}", flush=True)
