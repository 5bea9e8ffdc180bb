"""Episode-metrics aggregation and logging sinks.

Port of quadswarm_tpu/utils/metrics.py.  The env emits fixed-shape info
tensors every tick with an `episode_done` flag; `episode_stat_sums` reduces
a rollout's infos on the device to scalars and per-mode vectors, and
`stats_from_sums` turns those (on the host) into the flat stat dict with the
reference's scenario-prefixed names.  `MetricLogger` writes JSONL and,
where the packages are installed, TensorBoard and wandb.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from quadswarm_tpu_torch.env.scenarios import MODES

_SCENARIO_PREFIXED = {
    "num_collisions_after_settle": "num_collisions",
    "num_collisions_final_5_s": "num_collisions_final_5_s",
    "distance_to_goal_1s": "distance_to_goal_1s",
    "distance_to_goal_3s": "distance_to_goal_3s",
    "distance_to_goal_5s": "distance_to_goal_5s",
    "num_collisions_obst_quad": "num_collisions_obst",
    "metric/agent_success_rate": "agent_success_rate",
    "metric/agent_deadlock_rate": "agent_deadlock_rate",
    "metric/agent_col_rate": "agent_col_rate",
    "metric/agent_neighbor_col_rate": "agent_neighbor_col_rate",
    "metric/agent_obst_col_rate": "agent_obst_col_rate",
}


def _skipped(key: str) -> bool:
    return key in ("episode_done", "scenario_mode") or key.startswith(
        "rewards/")


def episode_stat_sums(infos: dict) -> dict:
    """Masked sums over the finished episodes of stacked infos (leaves
    (T, E) or (T, E, N)) and per-mode sums of the scenario-prefixed stats,
    as tensors on the infos' device."""
    done = infos["episode_done"].to(torch.float32)              # (T, E)
    modes = infos["scenario_mode"].long()
    onehot = torch.nn.functional.one_hot(modes, len(MODES)).to(torch.float32)
    onehot = onehot * done[..., None]                           # (T, E, M)
    sums = {"_count": torch.sum(done), "_mode_count": onehot.sum((0, 1))}
    for key, val in infos.items():
        if _skipped(key):
            continue
        v = val.to(torch.float32)
        if v.dim() == done.dim() + 1:                           # per agent
            v = v.mean(-1)
        sums[key] = torch.sum(v * done)
        if key in _SCENARIO_PREFIXED:
            sums["_mode/" + key] = torch.sum(v[..., None] * onehot, (0, 1))
    return sums


def stats_from_sums(sums: dict) -> dict[str, float]:
    """Host side: `episode_stat_sums` output as numpy -> the flat stat
    dict, with the scenario-prefixed copies."""
    count = float(sums["_count"])
    if count == 0:
        return {}
    mode_count = np.asarray(sums["_mode_count"])
    out: dict[str, float] = {}
    for key, val in sums.items():
        if key.startswith("_"):
            continue
        out[key] = float(val) / count
        base = _SCENARIO_PREFIXED.get(key)
        if base is not None:
            mode_sums = np.asarray(sums["_mode/" + key])
            for mode_id in np.nonzero(mode_count > 0)[0]:
                out[f"{MODES[int(mode_id)]}/{base}"] = float(
                    mode_sums[mode_id] / mode_count[mode_id])
    out["num_episodes"] = count
    return out


def aggregate_episode_stats(infos: dict) -> dict[str, float]:
    """Host side: the mean of each stat over all (t, env) entries where
    `episode_done`, from infos as numpy arrays."""
    infos = {k: np.asarray(v) for k, v in infos.items()}
    done = infos["episode_done"].astype(bool)          # (T, E)
    out: dict[str, float] = {}
    if not done.any():
        return out
    modes = infos["scenario_mode"][done]
    for key, val in infos.items():
        if _skipped(key):
            continue
        ep_vals = val[done].mean(-1) if val.ndim == done.ndim + 1 \
            else val[done]
        out[key] = float(np.mean(ep_vals))
        base = _SCENARIO_PREFIXED.get(key)
        if base is not None:
            for mode_id in np.unique(modes):
                sel = modes == mode_id
                out[f"{MODES[int(mode_id)]}/{base}"] = float(
                    np.mean(ep_vals[sel]))
    out["num_episodes"] = float(done.sum())
    return out


class MetricLogger:
    """JSONL sink (`metrics.jsonl` in the experiment dir), plus TensorBoard
    and wandb where their packages are installed."""

    def __init__(self, exp_dir: str, use_tensorboard: bool = True,
                 use_wandb: bool = False, wandb_kwargs: dict | None = None):
        os.makedirs(exp_dir, exist_ok=True)
        self.jsonl = open(os.path.join(exp_dir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self.tb = SummaryWriter(os.path.join(exp_dir, "tb"))
        self.wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                pass
            else:
                self.wandb = wandb
                wandb.init(dir=exp_dir, **(wandb_kwargs or {}))
        self.t0 = time.time()

    def log(self, env_steps: int, scalars: dict[str, float]) -> None:
        rec = {"env_steps": env_steps, "wall_time": time.time() - self.t0}
        rec.update(scalars)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, env_steps)
        if self.wandb is not None:
            self.wandb.log(scalars, step=env_steps)

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
