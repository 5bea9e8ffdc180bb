"""Faults planted in the program's timed path, to show that the comparison
deciding `correct` catches them (the CPU tests and `calibrate.py`).  Each
is a context manager that patches one function of the port and restores
it on exit.

- `env_step('unchanged')`: the env step returns the state it was given;
  `env_step('altered')`: it adds 1 to every reward of one tick in three
  (an answer altered where it is produced);
- `policy_value()`: the rollout's values shifted by 1e-2 where the policy
  produces them (`policy_heads`);
- `actions_shifted()`: every drawn action shifted by 1e-2 where it is
  drawn (`sample_actions`), its log-probability taken of the shifted one.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    saved = getattr(module, name)
    setattr(module, name, make(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def env_step(fault: str):
    import quadswarm_tpu_torch.env.replay as replay
    calls = [0]

    def make(step):
        def broken(cfg, params, states, actions, gen, draws):
            new, obs, rew, done, info = step(cfg, params, states, actions,
                                             gen, draws)
            calls[0] += 1
            if fault == "unchanged":
                new = states
            elif calls[0] % 3 == 0:
                rew = rew + 1.0
            return new, obs, rew, done, info
        return broken
    return _patched(replay, "_step", make)


def policy_value():
    import quadswarm_tpu_torch.parallel.ppo as ppo

    def make(heads):
        def broken(*a, **kw):
            mean, log_std, value = heads(*a, **kw)
            return mean, log_std, value + 1e-2
        return broken
    return _patched(ppo, "policy_heads", make)


def actions_shifted():
    import quadswarm_tpu_torch.parallel.ppo as ppo

    def make(sample):
        def broken(*a, **kw):
            return sample(*a, **kw) + 1e-2
        return broken
    return _patched(ppo, "sample_actions", make)


FAULTS = {
    "env_unchanged": lambda: env_step("unchanged"),
    "env_altered": lambda: env_step("altered"),
    "policy_value": policy_value,
    "actions_shifted": actions_shifted,
}
