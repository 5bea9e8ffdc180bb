"""Evaluation CLI: `python -m quadswarm_tpu_torch.training.enjoy ...`

Port of quadswarm_tpu/training/enjoy.py: load the experiment's config.json
and its latest (or best) checkpoint, run the deterministic policy (the
action mean), print each episode's stats and their mean.  With
`--eval_envs > 1` a round runs that many envs side by side from a reset for
one episode's ticks, and the stats are read from the last tick's info (the
quality protocol of train.sh: `--eval_envs=32
--quads_mode=static_diff_goal`); with `--eval_envs=1` episodes run one at
a time, and `--render_mode=dump` writes each one's trajectory to
`<render_out>/epNNN.npz`.  The other render modes and
`--visualize_v_value` are not ported (ROADMAP.md Queue 1 item 15).

Episodes have a fixed length, so neither loop reads the device between
ticks: a round makes no device-to-host sync until its last tick's stats.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

_RENDERS_NOT_PORTED = ("plot", "human", "rgb_array", "live")


def _check_render(args) -> None:
    """Refuse a single-env run that would render (the batched path never
    renders, as in the JAX package)."""
    if args.eval_envs > 1:
        return
    what = (f"--render_mode={args.render_mode}"
            if args.render_mode in _RENDERS_NOT_PORTED
            else "--visualize_v_value" if args.visualize_v_value else None)
    if what:
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md Queue 1 item 15); the "
            "port's eval CLI runs --render_mode=dump and --render_mode=none")


def choose_checkpoint(args) -> str | None:
    """The checkpoint `--load_checkpoint_kind` names: the newest `best`
    one, falling back to the latest with a warning."""
    from quadswarm_tpu_torch.utils.checkpoint import (
        checkpoint_dir, get_checkpoints, latest_checkpoint,
    )

    cp_dir = checkpoint_dir(args.train_dir, args.experiment)
    cp = None
    if args.load_checkpoint_kind == "best":
        best = get_checkpoints(cp_dir, tag="best")
        cp = best[-1] if best else None
        if cp is None:
            print("WARNING: no best_* checkpoint found, falling back to "
                  "latest")
    return cp if cp is not None else latest_checkpoint(cp_dir)


def _mean_stats(info: dict, env: int) -> dict:
    """One env's episode stats from a done tick's host info, the per-drone
    values averaged."""
    return {k: float(np.mean(v[env])) for k, v in info.items()}


def _host_info(info: dict) -> dict:
    """A done tick's info on the host, without the per-tick reward terms
    and replay stats."""
    from quadswarm_tpu_torch.utils.struct import to_numpy

    return {k: to_numpy(v) for k, v in info.items()
            if not k.startswith("rewards/") and not k.startswith("replay/")}


def _report(episode_stats: list, with_count: bool) -> dict:
    agg = {k: float(np.mean([s[k] for s in episode_stats]))
           for k in episode_stats[0]}
    print(f"=== mean over {len(episode_stats)} episodes ===" if with_count
          else "=== mean over episodes ===")
    for k, v in sorted(agg.items()):
        print(f"  {k}: {v:.4f}")
    return agg


@dataclasses.dataclass
class EvalResult:
    stats: dict            # mean over the episodes
    episodes: list         # each episode's stats
    states: object         # the last round's EnvState at its done tick
    round_seconds: list    # wall time of each round (of each episode)


def run_eval(args) -> dict:
    """Evaluate the experiment's policy; returns the mean episode stats."""
    return evaluate(args).stats


def evaluate(args) -> EvalResult:
    """`run_eval` with what a caller may measure besides the stats."""
    import torch

    from quadswarm_tpu_torch.env.multi import batched_env_step, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.models.actor_critic import apply_fused
    from quadswarm_tpu_torch.parallel.normalize import (
        NormalizerState, RunningMeanStd, normalize_obs,
    )
    from quadswarm_tpu_torch.training.config import (
        env_config_from_args, model_from_args,
    )
    from quadswarm_tpu_torch.utils.checkpoint import load_checkpoint
    from quadswarm_tpu_torch.utils.render import TrajectoryRecorder
    from quadswarm_tpu_torch.utils.struct import resolve_device

    _check_render(args)
    device = resolve_device(args.device)
    env_cfg = env_config_from_args(args)
    torch.manual_seed(args.seed)
    model = model_from_args(args, env_cfg, device=device)
    dyn = make_dynamics_params(dt=env_cfg.dt)
    norm = None
    cp = choose_checkpoint(args)
    if cp is not None:
        payload = load_checkpoint(cp)          # the optimizer stays here
        model.load_state_dict(payload["model"])
        # A run trained with --normalize_input keeps its observation stats
        # in the checkpoint; the policy must see inputs scaled the same way.
        extra = payload.get("extra") or {}
        if extra.get("obs") is not None:
            norm = NormalizerState(obs=RunningMeanStd(
                **{k: v.to(device) for k, v in extra["obs"].items()}))
            print("input normalization active (stats from checkpoint)")
        print(f"loaded {cp}")
    else:
        print("WARNING: no checkpoint found, using random init")
    gen = torch.Generator(device).manual_seed(args.seed)
    n = env_cfg.num_agents

    @torch.no_grad()
    def policy(obs):
        e = obs.shape[0]
        mean, _, _ = apply_fused(model,
                                 normalize_obs(norm, obs.reshape(e * n, -1)))
        return mean.reshape(e, n, -1)

    round_seconds = []

    def episode(num_envs: int, recorder=None):
        """One episode of `num_envs` envs from a reset: its done tick's
        info, each env's summed reward, (E, N), and its final states."""
        t0 = time.perf_counter()
        states, obs = env_reset(env_cfg, dyn, gen, num_envs, device=device)
        rew_sum = torch.zeros((num_envs, n), device=device)
        for _ in range(env_cfg.ep_len + 1):   # done at tick ep_len + 1
            states, obs, rew, dones, info = batched_env_step(
                env_cfg, dyn, states, policy(obs), gen, auto_reset=False)
            rew_sum += rew
            if recorder is not None:
                recorder.record(states, rew)
        if not bool(dones.all()):
            raise AssertionError("an episode did not end on its last tick")
        host = _host_info(info), rew_sum.cpu().numpy(), states
        round_seconds.append(time.perf_counter() - t0)
        return host

    episode_stats = []
    if args.eval_envs > 1:
        e = args.eval_envs
        rounds = max(1, -(-args.max_num_episodes // e))     # ceil
        for rnd in range(rounds):
            info, rew_sum, states = episode(e)
            for i in range(e):
                episode_stats.append({**_mean_stats(info, i),
                                      "episode_reward": float(rew_sum[i]
                                                              .mean())})
            print(f"round {rnd}: {e} episodes, "
                  f"mean reward={float(rew_sum.mean()):.2f} "
                  f"({round_seconds[-1]:.2f} s)")
        episode_stats = episode_stats[:max(args.max_num_episodes, e)]
        return EvalResult(_report(episode_stats, True), episode_stats,
                          states, round_seconds)

    for ep in range(args.max_num_episodes):
        rec = TrajectoryRecorder() if args.render_mode == "dump" else None
        info, rew_sum, states = episode(1, rec)
        episode_stats.append({**_mean_stats(info, 0),
                              "episode_reward": float(rew_sum[0].mean())})
        print(f"episode {ep}: reward={episode_stats[-1]['episode_reward']:.2f}"
              f" collisions={episode_stats[-1]['num_collisions']:.0f}")
        if rec is not None:
            os.makedirs(args.render_out, exist_ok=True)
            rec.dump(os.path.join(args.render_out, f"ep{ep:03d}.npz"))
    return EvalResult(_report(episode_stats, False), episode_stats, states,
                      round_seconds)


def load_args(argv=None):
    """The eval flags over the experiment's config.json: the file is the
    base config, and flags given on the command line override it."""
    from quadswarm_tpu_torch.training.config import parse_swarm_cfg

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_swarm_cfg(argv, evaluation=True)
    cfg_path = os.path.join(args.train_dir, args.experiment, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            saved = json.load(f)
        explicit = {a.split("=", 1)[0].lstrip("-") for a in argv
                    if a.startswith("--")}
        for k, v in saved.items():
            if k not in explicit and hasattr(args, k):
                setattr(args, k, v)
        print(f"config loaded from {cfg_path}")
    return args


def main(argv=None) -> int:
    run_eval(load_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
