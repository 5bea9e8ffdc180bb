"""Evaluation CLI: `python -m quadswarm_tpu_torch.training.enjoy ...`

Port of quadswarm_tpu/training/enjoy.py: load the experiment's config.json
and its latest (or best) checkpoint, run the deterministic policy (the
action mean), print each episode's stats and their mean.  With
`--eval_envs > 1` a round runs that many envs side by side from a reset for
one episode's ticks, and the stats are read from the last tick's info (the
quality protocol of train.sh: `--eval_envs=32
--quads_mode=static_diff_goal`); with `--eval_envs=1` episodes run one at
a time and may render (`utils/render.py`) into `<render_out>/epNNN/`:
`--render_mode=plot` (or `human`, `rgb_array`) draws every 10th tick's
frame after the episode, `live` streams frames while it runs, `dump`
writes the trajectory to `<render_out>/epNNN.npz`, and
`--visualize_v_value` adds the critic-value map around drone 0 (and with
`plot` a value panel beside each frame).  Drawing needs matplotlib; a
render mode that draws is refused up front without it.  The batched path
never renders, as in the JAX package.

Episodes have a fixed length, so the loops do not test for an episode's
end between ticks: a round makes no device-to-host sync until its last
tick's stats, unless a render mode records every tick on the host.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time

import numpy as np

_FRAME_MODES = ("plot", "human", "rgb_array")   # frames after the episode
_DRAWING_MODES = _FRAME_MODES + ("live",)
_EVERY_NTH = 10          # render_trajectory's frame spacing


def _check_render(args) -> None:
    """A single-env render mode that draws needs matplotlib: refuse it
    before the episode runs (the batched path never renders)."""
    if (args.eval_envs == 1 and args.render_mode in _DRAWING_MODES
            and importlib.util.find_spec("matplotlib") is None):
        raise ImportError(
            f"--render_mode={args.render_mode} draws with matplotlib, which "
            "is not installed; --render_mode=dump records the trajectory "
            "without it")


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
    # wall time of each single-env episode's rendering after its last tick
    render_seconds: list = dataclasses.field(default_factory=list)
    recorder: object = None  # the last single-env episode's, if recorded


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

    def episode(num_envs: int, recorder=None, live=None, record_obs=False):
        """One episode of `num_envs` envs from a reset: its done tick's
        info, each env's summed reward, (E, N), and its final states.  A
        recorder takes env 0 every tick (with drone 0's observation when
        `record_obs`), a live renderer draws it."""
        t0 = time.perf_counter()
        states, obs = env_reset(env_cfg, dyn, gen, num_envs, device=device)
        if live is not None:
            live.start(states)
        rew_sum = torch.zeros((num_envs, n), device=device)
        for _ in range(env_cfg.ep_len + 1):   # done at tick ep_len + 1
            states, obs, rew, dones, info = batched_env_step(
                env_cfg, dyn, states, policy(obs), gen, auto_reset=False)
            rew_sum += rew
            if recorder is not None:
                recorder.record(states, rew,
                                obs=obs[:, 0] if record_obs else None)
            if live is not None:
                live.update(states)
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

    viz_v = args.visualize_v_value
    render_seconds = []
    for ep in range(args.max_num_episodes):
        out_dir = os.path.join(args.render_out, f"ep{ep:03d}")
        rec = (TrajectoryRecorder() if viz_v or args.render_mode
               in _FRAME_MODES + ("dump",) else None)
        live = (_Live(args, env_cfg, os.path.join(out_dir, "live"))
                if args.render_mode == "live" else None)
        info, rew_sum, states = episode(1, rec, live, record_obs=viz_v)
        episode_stats.append({**_mean_stats(info, 0),
                              "episode_reward": float(rew_sum[0].mean())})
        print(f"episode {ep}: reward={episode_stats[-1]['episode_reward']:.2f}"
              f" collisions={episode_stats[-1]['num_collisions']:.0f}")
        t0 = time.perf_counter()
        if live is not None:
            live.close()
        if viz_v:
            _save_v_value_map(model, rec.obs[-1], out_dir, ep)
        if args.render_mode in _FRAME_MODES:
            _render_frames(args, env_cfg, model, rec, states, out_dir, viz_v)
        elif args.render_mode == "dump":
            os.makedirs(args.render_out, exist_ok=True)
            rec.dump(os.path.join(args.render_out, f"ep{ep:03d}.npz"))
        render_seconds.append(time.perf_counter() - t0)
    return EvalResult(_report(episode_stats, False), episode_stats, states,
                      round_seconds, render_seconds, rec)


def _obstacles(env_cfg, states):
    """The (x, y) of env 0's active obstacles and their size; None in
    place of the positions without obstacles."""
    size = float(states.obst_size[0])
    if not env_cfg.use_obstacles:
        return None, size
    active = states.obst_active[0].cpu().numpy()
    return states.obst_pos[0].cpu().numpy()[active][:, :2], size


class _Live:
    """The live render mode: a LiveRenderer over env 0 of an episode,
    made at its reset (when the obstacles are known) and fed every tick."""

    def __init__(self, args, env_cfg, out_dir: str):
        self.args, self.env_cfg, self.out_dir = args, env_cfg, out_dir
        self.renderer = None

    def start(self, states) -> None:
        from quadswarm_tpu_torch.utils.render import LiveRenderer

        obstacles, size = _obstacles(self.env_cfg, states)
        self.renderer = LiveRenderer(
            room_dims=self.env_cfg.room_dims,
            views=tuple(self.args.quads_view_mode), out_dir=self.out_dir,
            every_nth=self.args.render_every_nth,
            realtime=self.args.realtime, control_dt=self.env_cfg.control_dt,
            obstacles=obstacles, obst_size=size)

    def update(self, states) -> None:
        host = lambda x: x[0].cpu().numpy()
        self.renderer.update(int(states.tick[0]), host(states.dyn.pos),
                             host(states.scenario.goals),
                             host(states.prev_coll_ids),
                             vel=host(states.dyn.vel),
                             acc=host(states.dyn.acc))

    def close(self) -> None:
        mp4 = self.renderer.close()
        print(f"live stream -> {self.out_dir}"
              + (f" ({os.path.basename(mp4)} written)" if mp4 else ""))


def _save_v_value_map(model, obs0, out_dir: str, ep: int) -> None:
    """The critic-value map around drone 0 at the episode's end
    (swarm_rl/env_wrappers/v_value_map.py:47-62), as a PNG, or as .npy
    without matplotlib."""
    from quadswarm_tpu_torch.utils.render import v_value_map

    os.makedirs(out_dir, exist_ok=True)
    vmap2d = v_value_map(model, obs0)
    try:
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure
    except ImportError:
        np.save(os.path.join(out_dir, "v_value_map.npy"), vmap2d)
        return
    fig = Figure(figsize=(4, 4))
    FigureCanvasAgg(fig)
    ax = fig.add_subplot()
    im = ax.imshow(vmap2d, origin="lower", extent=[-2, 2, -2, 2],
                   cmap="viridis")
    fig.colorbar(im, ax=ax, label="V(s)")
    ax.set_title(f"critic value map, ep {ep}")
    fig.savefig(os.path.join(out_dir, "v_value_map.png"), bbox_inches="tight")
    print(f"v-value map -> {out_dir}/v_value_map.png")


def _render_frames(args, env_cfg, model, rec, states, out_dir: str,
                   viz_v: bool) -> None:
    """Every 10th tick's frame of the recorded episode, with the value
    panel (one batched critic forward over those ticks) under
    --visualize_v_value."""
    from quadswarm_tpu_torch.utils.render import (
        render_trajectory, v_value_maps,
    )

    obstacles, size = _obstacles(env_cfg, states)
    v_maps = None
    if viz_v:
        ticks = range(0, len(rec.obs), _EVERY_NTH)
        maps = v_value_maps(model, np.stack([rec.obs[t] for t in ticks]))
        v_maps = dict(zip(ticks, maps.values()))
    render_trajectory(rec, out_dir, room_dims=env_cfg.room_dims,
                      views=tuple(args.quads_view_mode), every_nth=_EVERY_NTH,
                      obstacles=obstacles, obst_size=size, v_maps=v_maps)
    print(f"frames -> {out_dir}")


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
