"""Trajectory recording for the eval CLI.

Port of the recorder of quadswarm_tpu/utils/render.py: per-tick host copies
of one env's drones, dumped to `.npz` with the JAX package's keys (`pos`,
`goals`, `collisions`, `rewards`).  Plotting, live rendering and value maps
are not ported (ROADMAP.md Queue 1 item 15).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from quadswarm_tpu_torch.utils.struct import to_numpy


def _host(x) -> np.ndarray:
    return to_numpy(x)


@dataclass
class TrajectoryRecorder:
    """Accumulates one env's per-tick state on the host during an eval
    rollout."""

    pos: list = field(default_factory=list)         # [T] (N, 3)
    goals: list = field(default_factory=list)       # [T] (N, 3)
    collisions: list = field(default_factory=list)  # [T] (N,) bool
    rewards: list = field(default_factory=list)     # [T] (N,)
    obs: list = field(default_factory=list)         # [T] (N, obs_dim)
    vel: list = field(default_factory=list)         # [T] (N, 3)
    acc: list = field(default_factory=list)         # [T] (N, 3) world frame

    def record(self, state, reward=None, obs=None, env: int = 0) -> None:
        """Append env `env` of a batched EnvState (leading axis E); reward
        and obs, when given, are (E, N) and (E, N, D)."""
        self.pos.append(_host(state.dyn.pos[env]))
        self.goals.append(_host(state.scenario.goals[env]))
        self.collisions.append(_host(state.prev_coll_ids[env]))
        self.vel.append(_host(state.dyn.vel[env]))
        self.acc.append(_host(state.dyn.acc[env]))
        if reward is not None:
            self.rewards.append(_host(reward[env]))
        if obs is not None:
            self.obs.append(_host(obs[env]))

    def arrays(self):
        return (np.stack(self.pos), np.stack(self.goals),
                np.stack(self.collisions))

    def dump(self, path: str) -> None:
        pos, goals, cols = self.arrays()
        np.savez_compressed(path, pos=pos, goals=goals, collisions=cols,
                            rewards=np.stack(self.rewards) if self.rewards
                            else None)
