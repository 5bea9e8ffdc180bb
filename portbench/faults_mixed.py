"""Faults planted in the mixed-policy rollout's timed path, to show that the
comparison deciding `rollout.pbt8`'s `correct` catches them (the CPU tests
and `tools/calibrate_mixed.py`).  Each is a context manager that patches
one function of the port and restores it on exit, as `faults.py`'s do.

- `next_head()`: every agent takes the next policy's head
  (`select_policy` with the assignment shifted by one, modulo P);
- `policy0_coeffs()`: every agent gets policy 0's reward coefficients
  (`push_coeffs` with an all-zero assignment);
- `stale_sdf()`: the obstacle SDF patch is left stale for one tick: each
  call of `obstacles.surround_sdf_obs` returns the patch the previous call
  of the same shape computed, so every observation carries the SDF of the
  drones' positions a tick before.
"""
from __future__ import annotations

import torch

from portbench.faults import _patched


def next_head():
    import quadswarm_tpu_torch.parallel.pbt_mixed as mixed

    def make(select):
        def broken(outs, assignment_flat):
            return select(outs, (assignment_flat + 1) % outs.shape[0])
        return broken
    return _patched(mixed, "select_policy", make)


def policy0_coeffs():
    import quadswarm_tpu_torch.parallel.pbt_mixed as mixed

    def make(push):
        def broken(env_states, table, assignment):
            return push(env_states, table, torch.zeros_like(assignment))
        return broken
    return _patched(mixed, "push_coeffs", make)


def stale_sdf():
    import quadswarm_tpu_torch.env.obstacles as obstacles
    last = {}

    def make(sdf):
        def broken(*a, **kw):
            fresh = sdf(*a, **kw)
            stale = last.get(fresh.shape, fresh)
            last[fresh.shape] = fresh
            return stale
        return broken
    return _patched(obstacles, "surround_sdf_obs", make)


FAULTS = {
    "next_head": next_head,
    "policy0_coeffs": policy0_coeffs,
    "stale_sdf": stale_sdf,
}
