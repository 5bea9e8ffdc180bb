"""The reference-shaped Python API over the batched env.

Port of quadswarm_tpu/env/gym_api.py: `QuadrotorEnvMulti`, a stateful
multi-agent env with the old gym list API (`reset() -> [obs_i]`,
`step([a_i]) -> ([obs_i], [rew_i], [done_i], [info_i])`, auto-reset, and
`info[i]["episode_extra_stats"]` at an episode's end with the reference's
metric names plus scenario-prefixed copies, and `render()`, an rgb_array
frame); `QuadEnvCompatibility`, the
gymnasium 5-tuple form; and `make_quadrotor_env_multi(args)`, the factory
from parsed `--quads_*` flags.

Underneath is one env of `env_reset` / `batched_env_step` with its own
`torch.Generator`, on the card by default (`device="cuda"`, which raises
without one; `device="cpu"` runs the plain PyTorch path).  A step reads
the device once: observations, rewards, dones and the info dict come back
as one buffer.  The dynamics run through the kernel K1 on the card, once
a step, in its per-drone form for a randomized fleet (`dyn_sampler_1`).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from quadswarm_tpu_torch.env.multi import (
    EnvConfig, batched_env_step, env_reset,
)
from quadswarm_tpu_torch.env.params import make_dynamics_params
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.env.scenarios import MODES
from quadswarm_tpu_torch.utils.struct import resolve_device

try:  # spaces come from gymnasium when present, else plain tuples
    from gymnasium import spaces as _spaces
except ImportError:  # pragma: no cover
    _spaces = None

# The info entries that are not episode statistics.
_NOT_STATS = ("episode_done", "scenario_mode")


def _box(low, high, shape):
    if _spaces is None:  # pragma: no cover
        return (low, high, shape)
    return _spaces.Box(low=low, high=high, shape=shape, dtype=np.float32)


def _to_host(tensors: dict) -> dict:
    """Every tensor of one env as numpy, through one device-to-host copy:
    the values travel as float64 (exact for the int32 and bool entries)
    and come back in their own shapes."""
    flat = torch.cat([t.reshape(-1).to(torch.float64)
                      for t in tensors.values()]).cpu().numpy()
    out, off = {}, 0
    for name, t in tensors.items():
        size = t.numel()
        out[name] = flat[off:off + size].reshape(tuple(t.shape))
        off += size
    return out


class QuadrotorEnvMulti:
    """Stateful, reference-compatible swarm env with the list API."""

    is_multiagent = True

    def __init__(self, num_agents: int = 8, ep_time: float = 15.0,
                 room_dims=(10.0, 10.0, 10.0),
                 obs_repr: str = "xyz_vxyz_R_omega",
                 neighbor_obs_type: str = "pos_vel",
                 neighbor_visible_num: int = -1,
                 collision_hitbox_radius: float = 2.0,
                 collision_falloff_radius: float = 4.0,
                 use_obstacles: bool = False, obst_density: float = 0.2,
                 obst_size: float = 1.0, obst_spawn_area=(6.0, 6.0),
                 use_downwash: bool = False,
                 quads_mode: str = "static_same_goal",
                 use_numba: bool = False,  # accepted for parity
                 quad: str = "Crazyflie", dynamics_change: dict | None = None,
                 dyn_sampler_1: dict | None = None,
                 sense_noise: str | None = "default",
                 render_mode: str | None = None, seed: int = 0,
                 rew_coeff: RewardCoeffs | None = None, device="cuda"):
        del use_numba
        self.device = resolve_device(device)
        self.cfg = EnvConfig(
            num_agents=num_agents, ep_time=ep_time,
            room_dims=tuple(room_dims), obs_repr=obs_repr,
            neighbor_obs_type=neighbor_obs_type,
            neighbor_visible_num=neighbor_visible_num,
            collision_hitbox_radius=collision_hitbox_radius,
            collision_falloff_radius=collision_falloff_radius,
            use_obstacles=use_obstacles, obst_density=obst_density,
            obst_size=obst_size, obst_spawn_area=tuple(obst_spawn_area),
            use_downwash=use_downwash, quads_mode=quads_mode,
            use_sensor_noise=sense_noise is not None)
        self.cfg.check_supported()
        self.params = make_dynamics_params(
            quad=quad, dynamics_change=dynamics_change,
            dyn_sampler_1=dyn_sampler_1, num_agents=num_agents,
            per_drone=dyn_sampler_1 is not None, seed=seed)
        self.num_agents = num_agents
        self.render_mode = render_mode
        self.rew_coeff = rew_coeff if rew_coeff is not None else RewardCoeffs()
        self._gen = torch.Generator(self.device)
        self.seed(seed)
        self._state = None
        self.observation_space = _box(-np.inf, np.inf, (self.cfg.obs_dim,))
        self.action_space = _box(-1.0, 1.0, (self.cfg.action_dim,))

    def seed(self, seed: int | None = None):
        if seed is not None:
            self._gen.manual_seed(seed)
        return [seed]

    def reset(self, seed: int | None = None, options: Any = None,
              obst_density=None, obst_size=None):
        """A fresh episode.  obst_density and obst_size override the
        config's for this episode (the hook of the reference's replay
        wrapper for obstacle domain randomization)."""
        del options
        if seed is not None:
            self.seed(seed)
        density = size = None
        if obst_density is not None or obst_size is not None:
            full = lambda v, fixed: torch.full(
                (1,), float(fixed if v is None else v), dtype=self.cfg.dtype,
                device=self.device)
            density = full(obst_density, self.cfg.obst_density)
            size = full(obst_size, self.cfg.obst_size)
        self._state, obs = env_reset(
            self.cfg, self.params, self._gen, 1, device=self.device,
            rew_coeff=self.rew_coeff, obst_density=density, obst_size=size)
        return list(obs[0].cpu().numpy().astype(np.float32))

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        acts = torch.as_tensor(
            np.stack([np.asarray(a, np.float32) for a in actions]),
            device=self.device)[None]
        self._state, obs, rew, done, info = batched_env_step(
            self.cfg, self.params, self._state, acts, self._gen)
        host = _to_host({"obs": obs[0], "rew": rew[0], "done": done[0],
                         **{k: v[0] for k, v in info.items()}})
        done_np = host.pop("done").astype(bool)
        obs_np = host.pop("obs").astype(np.float32)
        rew_np = host.pop("rew").astype(np.float32)
        return (list(obs_np), list(rew_np), list(done_np),
                self._build_infos(host, done_np))

    def _build_infos(self, host: dict, done: np.ndarray) -> list:
        """Per-agent info dicts; at an episode's end `episode_extra_stats`
        holds the reference's metric names plus copies prefixed by the
        finished episode's scenario."""
        rewards_i = {k: host[k] for k in host if k.startswith("rewards/")}
        ep_done = bool(done.any())
        scen = MODES[int(host["scenario_mode"])]
        infos = []
        for i in range(self.num_agents):
            d: dict[str, Any] = {"rewards": {
                k.split("/", 1)[1]: float(np.ravel(v)[i] if np.ndim(v) else v)
                for k, v in rewards_i.items()}}
            if ep_done:
                stats: dict[str, float] = {}
                for k, v in host.items():
                    if k.startswith("rewards/") or k in _NOT_STATS:
                        continue
                    val = float(np.ravel(v)[i]) if np.ndim(v) >= 1 \
                        else float(v)
                    stats[k] = val
                    stats[f"{scen}/{k}"] = val
                d["episode_extra_stats"] = stats
            infos.append(d)
        return infos

    def render(self, views=("topdown", "chase", "global")):
        """An rgb_array frame (H, W, 3) uint8 of the current state, one
        panel per view mode (`utils/render.py::render_frame`, which needs
        matplotlib); None before the first reset."""
        from quadswarm_tpu_torch.utils.render import render_frame

        if self._state is None:
            return None
        s = self._state
        host = lambda x: x[0].cpu().numpy()
        obstacles = None
        if self.cfg.use_obstacles:
            obstacles = host(s.obst_pos)[host(s.obst_active)]
        return render_frame(
            host(s.dyn.pos), host(s.scenario.goals), host(s.prev_coll_ids),
            room_dims=self.cfg.room_dims, views=views, obstacles=obstacles,
            obst_size=float(s.obst_size[0]))

    def close(self):
        self._state = None


class QuadEnvCompatibility:
    """The old 4-tuple as gymnasium's 5-tuple: `terminated` is False and
    `truncated` is the old done (episodes end only by time limit)."""

    def __init__(self, env: QuadrotorEnvMulti):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, seed: int | None = None, options: Any = None):
        return self.env.reset(seed=seed, options=options), {}

    def step(self, actions):
        obs, rew, done, infos = self.env.step(actions)
        return obs, rew, [False] * len(done), list(done), infos


def make_quadrotor_env_multi(args) -> QuadEnvCompatibility:
    """The env from parsed `--quads_*` flags (the port's
    `training/config.py`), with quad='Crazyflie' and the default sensor
    noise as in the reference's factory; on `args.device` when the flags
    have one, else the card."""
    env = QuadrotorEnvMulti(
        num_agents=args.quads_num_agents, ep_time=args.quads_episode_duration,
        room_dims=tuple(args.quads_room_dims), obs_repr=args.quads_obs_repr,
        neighbor_obs_type=args.quads_neighbor_obs_type,
        neighbor_visible_num=args.quads_neighbor_visible_num,
        collision_hitbox_radius=args.quads_collision_hitbox_radius,
        collision_falloff_radius=args.quads_collision_falloff_radius,
        use_obstacles=args.quads_use_obstacles,
        obst_density=args.quads_obst_density, obst_size=args.quads_obst_size,
        obst_spawn_area=tuple(args.quads_obst_spawn_area),
        use_downwash=args.quads_use_downwash, quads_mode=args.quads_mode,
        quad="Crazyflie", sense_noise="default",
        device=getattr(args, "device", "cuda"))
    return QuadEnvCompatibility(env)
