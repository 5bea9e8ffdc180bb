"""The multi-drone swarm environment, batched over envs.

Port of quadswarm_tpu/env/multi.py.  `env_reset` makes E fresh envs;
`batched_env_step` advances them one control tick:

    scenario step -> control + dynamics (fused kernel K1) -> per-drone
    reward -> drone/obstacle/room collisions -> collision rewards ->
    downwash and collision responses -> observations -> episode metrics ->
    auto-reset

With `EnvConfig.use_pallas_pairs` (the large-swarm path; the flag keeps the
JAX package's name) the collision stage runs the pair kernel K2, which
keeps the pair history as packed bits, (E, N, 128) int32, and the
neighbour observation runs the k-nearest kernel K3, so no (E, N, N) tensor
is made (`ops/kernels/swarm_interactions.py`).

The JAX package writes one env and vmaps it; here every tensor carries the
env axis E first and the agent axis N second.  The dynamics of the whole
fleet run in one launch of `ops/kernels/dynamics_kernel.py` on CUDA
tensors, and through its plain version on CPU tensors.

With `EnvConfig.use_obstacles` every env holds an obstacle grid
(`env/obstacles.py`): its drones observe a 9-point SDF patch, hit the
cylinders and bounce off them, and the obstacle mix's scenarios spawn them
on free cells.

Every control mode, shared or per-drone params (a randomized fleet: row i
of each field is drone i of every env, as in the JAX package's vmapped
dynamics) and all 20 scenario modes run, in float32 or in bfloat16
(`EnvConfig.dtype`: K1 casts at its boundary, and the event table stays
float32).  Like the JAX package, a
per-drone fleet takes its floor threshold and collision radii from drone
0's arm.

Randomness: every draw comes from the caller's `torch.Generator`, unless
`draws` supplies it (see `batched_env_step`).  The auto-reset is a Python
`if` on `any(done)`, which costs one device-to-host sync per tick.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from quadswarm_tpu_torch.env import collisions as coll
from quadswarm_tpu_torch.env import obstacles as obst
from quadswarm_tpu_torch.env.controls import (
    CONTROL_MODES, JACOBIAN_MODES, action_dim, apply_control,
    control_jacobian_inv,
)
from quadswarm_tpu_torch.env.downwash import apply_downwash
from quadswarm_tpu_torch.env.dynamics import (
    DroneState, DynamicsConfig, draw_tick_noise, init_state,
)
from quadswarm_tpu_torch.env.neighbors import neighbor_clip_bounds, neighbor_obs
from quadswarm_tpu_torch.env.obs import obs_size, self_obs
from quadswarm_tpu_torch.env.reward import (
    RewardCoeffs, agent_coeff, compute_reward, proximity_penalties,
)
from quadswarm_tpu_torch.env.scenarios import (
    MIX_MODES_MULTI, MIX_MODES_OBSTACLES, MIX_MODES_OBSTACLES_SINGLE,
    MODE_IDS, ScenarioConfig, ScenarioState, batched_scenario_step,
    check_modes, event_table_width, scenario_reset,
)
from quadswarm_tpu_torch.env.sensor import SensorNoiseParams, add_noise
from quadswarm_tpu_torch.ops.kernels.dynamics_kernel import dynamics_tick_fused
from quadswarm_tpu_torch.ops.kernels.swarm_interactions import (
    MAX_AGENTS, MAX_NEIGHBORS, PACK_LANES, neighbor_topk_obs, pair_collisions,
)
from quadswarm_tpu_torch.ops.rotations import yaw_rot
from quadswarm_tpu_torch.utils.struct import (
    Struct, map_fields, require_float_dtype, resolve_device,
)
from quadswarm_tpu_torch.utils.tracing import span

GRAV = 9.81
MIX_MODES_SINGLE = tuple(MODE_IDS[m] for m in (
    "static_same_goal", "static_diff_goal", "ep_lissajous3D", "ep_rand_bezier",
    "dynamic_same_goal"))


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static env configuration; field names and defaults are the JAX
    package's, so one kwargs dict builds both."""

    num_agents: int = 8
    ep_time: float = 15.0
    sim_freq: float = 200.0
    sim_steps: int = 2
    room_dims: tuple = (10.0, 10.0, 10.0)
    obs_repr: str = "xyz_vxyz_R_omega"
    neighbor_obs_type: str = "pos_vel"
    neighbor_visible_num: int = -1
    collision_hitbox_radius: float = 2.0
    collision_falloff_radius: float = 4.0
    use_obstacles: bool = False
    obst_density: float = 0.2
    obst_size: float = 1.0
    obst_spawn_area: tuple = (6.0, 6.0)
    obst_density_random: bool = False
    obst_density_min: float = 0.05
    obst_density_max: float = 0.2
    obst_size_random: bool = False
    obst_size_min: float = 0.3
    obst_size_max: float = 0.6
    use_downwash: bool = False
    use_pallas_pairs: bool = False
    quads_mode: str = "static_same_goal"
    control_mode: str = "raw"
    zero_action_middle: bool = True
    init_random_state: bool = False     # unused, as in the JAX package
    use_sensor_noise: bool = True
    apply_collision_force: bool = True
    # The JAX package's switch for its Pallas dynamics kernel.  The port
    # has one path: CUDA tensors always go through its kernel, CPU tensors
    # through the kernel's plain version.
    use_pallas_dynamics: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def dt(self) -> float:
        return 1.0 / self.sim_freq

    @property
    def control_freq(self) -> float:
        return self.sim_freq / self.sim_steps

    @property
    def control_dt(self) -> float:
        return 1.0 / self.control_freq

    @property
    def ep_len(self) -> int:
        return int(self.ep_time / (self.dt * self.sim_steps))

    @property
    def num_use_neighbor_obs(self) -> int:
        if self.neighbor_obs_type == "none":
            return 0
        if self.neighbor_visible_num == -1:
            return self.num_agents - 1
        return min(self.neighbor_visible_num, self.num_agents - 1)

    @property
    def use_topk_kernel(self) -> bool:
        """Whether the neighbour observation goes through K3.  With every
        neighbour visible (k = N - 1) the slots keep index order, which is
        the dense path's."""
        k = self.num_use_neighbor_obs
        return (self.use_pallas_pairs and 0 < k <= MAX_NEIGHBORS
                and k < self.num_agents - 1)

    @property
    def room_box(self) -> tuple:
        rd = self.room_dims
        return ((-rd[0] / 2.0, -rd[1] / 2.0, 0.0),
                (rd[0] / 2.0, rd[1] / 2.0, rd[2]))

    @property
    def spawn_box(self) -> float:
        return 0.1 if self.use_obstacles else 2.0

    @property
    def num_obstacle_cells(self) -> int:
        return int(self.obst_spawn_area[0]) * int(self.obst_spawn_area[1])

    @property
    def obs_dim(self) -> int:
        return obs_size(self.obs_repr, self.neighbor_obs_type,
                        self.num_use_neighbor_obs, self.use_obstacles)

    @property
    def action_dim(self) -> int:
        return action_dim(self.control_mode)

    def dynamics_config(self, arm) -> DynamicsConfig:
        """Floor contact clamps at the fleet's arm length (drone 0's for a
        per-drone fleet)."""
        return DynamicsConfig(dt=self.dt, sim_steps=self.sim_steps,
                              room_box=self.room_box,
                              floor_threshold=fleet_arm(arm))

    def scenario_config(self) -> ScenarioConfig:
        return ScenarioConfig(
            num_agents=self.num_agents, control_freq=self.control_freq,
            ep_time=self.ep_time, room_dims=self.room_dims,
            box=self.spawn_box,
            obst_area=(int(self.obst_spawn_area[0]),
                       int(self.obst_spawn_area[1])))

    def mode_list(self) -> tuple:
        """The modes an episode draws from: the mix's candidates, or the one
        mode asked for."""
        if self.quads_mode != "mix":
            return (MODE_IDS[self.quads_mode],)
        if self.num_agents == 1:
            return (MIX_MODES_OBSTACLES_SINGLE if self.use_obstacles
                    else MIX_MODES_SINGLE)
        return MIX_MODES_OBSTACLES if self.use_obstacles else MIX_MODES_MULTI

    def check_supported(self) -> None:
        """Raise on any option the port does not run."""
        if self.use_pallas_pairs and self.num_agents > MAX_AGENTS:
            raise ValueError(f"use_pallas_pairs supports num_agents <= "
                             f"{MAX_AGENTS}, got {self.num_agents}")
        if self.control_mode not in CONTROL_MODES:
            raise ValueError(f"unknown control mode: {self.control_mode}")
        require_float_dtype(self.dtype)
        check_modes(self.mode_list())


def fleet_arm(arm) -> float:
    """The arm length that sets the floor threshold and the collision
    radii: the shared one, or drone 0's of a per-drone fleet."""
    return float(torch.as_tensor(arm).reshape(-1)[0])


@dataclasses.dataclass
class EnvState(Struct):
    """Per-env swarm state: leading axes (E,) or (E, N)."""

    dyn: DroneState
    scenario: ScenarioState
    rew_coeff: RewardCoeffs          # (E,) or per agent (E, N) tensors
    tick: torch.Tensor               # (E,) int32
    # (E, N, N) bool; with use_pallas_pairs packed bits, (E, N, 128) int32
    prev_coll_pairs: torch.Tensor
    prev_coll_ids: torch.Tensor      # (E, N) bool
    prev_obst_hits: torch.Tensor
    prev_wall: torch.Tensor
    prev_ceiling: torch.Tensor
    prev_room: torch.Tensor
    obst_active: torch.Tensor        # (E, C) bool
    obst_pos: torch.Tensor           # (E, C, 3)
    obst_density: torch.Tensor       # (E,)
    obst_size: torch.Tensor          # (E,)
    gyro_bias: torch.Tensor          # (E, N, 3)
    dist5: torch.Tensor              # (E, N, 5) recent goal distances
    collisions_per_episode: torch.Tensor
    collisions_after_settle: torch.Tensor
    collisions_final_5s: torch.Tensor
    obst_collisions_per_episode: torch.Tensor
    obst_collisions_after_settle: torch.Tensor
    collisions_floor_per_episode: torch.Tensor
    collisions_wall_per_episode: torch.Tensor
    collisions_ceiling_per_episode: torch.Tensor
    collisions_room_per_episode: torch.Tensor
    obst_coll_dist_3_5: torch.Tensor
    obst_coll_dist_5: torch.Tensor
    agent_col_agent: torch.Tensor    # (E, N) 1.0 = never hit a drone
    agent_col_obst: torch.Tensor     # (E, N)
    reached_goal: torch.Tensor       # (E, N) bool
    dist_sum_1s: torch.Tensor        # (E, N)
    dist_sum_3s: torch.Tensor
    dist_sum_5s: torch.Tensor
    crashes_last_episode: torch.Tensor  # (E,)
    cum_rewraw_main: torch.Tensor    # (E, N)
    cum_rewraw_quadcol: torch.Tensor


def _sample_spawn(cfg: EnvConfig, gen, spawn_points):
    """Spawn around the scenario's spawn points, facing within 60 degrees
    of the room center."""
    dtype, dev = spawn_points.dtype, spawn_points.device
    box = cfg.spawn_box
    offset = torch.rand(spawn_points.shape, generator=gen, dtype=dtype,
                        device=dev) * (2 * box) - box
    pos = spawn_points + offset
    pos = torch.cat([pos[..., :2], torch.clamp(pos[..., 2:], min=0.75)], -1)
    face = torch.atan2(-pos[..., 1], -pos[..., 0])
    u = torch.rand(pos.shape[:-1], generator=gen, dtype=dtype, device=dev)
    yaw = face + (u * (2 * math.pi / 3) - math.pi / 3)
    zeros = torch.zeros_like(pos)
    return pos, zeros, yaw_rot(yaw), zeros.clone()


def obstacles_of(state: EnvState) -> tuple:
    """(obst_active, obst_pos, obst_size) of a state, as `_compute_obs`
    takes them."""
    return state.obst_active, state.obst_pos, state.obst_size


def _compute_obs(cfg: EnvConfig, dyn: DroneState, goals, gyro_bias, gen,
                 draws=None, obstacles=None):
    """(E, N, obs_dim): noisy self obs + clipped neighbor obs + the SDF
    patch of the obstacles (active (E, C), pos (E, C, 3), size (E,)); the
    last two from the true positions."""
    noise = SensorNoiseParams(bypass=not cfg.use_sensor_noise)
    pos, vel, rot, omega, _, gyro_bias = add_noise(
        noise, dyn.pos, dyn.vel, dyn.rot, dyn.omega, dyn.accelerometer,
        cfg.dt, gyro_bias, gen, draws)
    parts = [self_obs(cfg.obs_repr, pos, vel, rot, omega, goals, cfg.room_box)]
    k = cfg.num_use_neighbor_obs
    if k > 0:
        lo, hi = neighbor_clip_bounds(k, cfg.room_dims, 3.0, cfg.dtype,
                                      dyn.pos.device)
        if cfg.use_topk_kernel:
            nbr = neighbor_topk_obs(dyn.pos.contiguous(),
                                    dyn.vel.contiguous(), k)
            parts.append(torch.minimum(torch.maximum(nbr, lo), hi))
        else:
            parts.append(neighbor_obs(dyn.pos, dyn.vel, k, lo, hi))
    if cfg.use_obstacles:
        active, obst_pos, size = obstacles
        with span("env.obstacle_sdf"):
            parts.append(obst.surround_sdf_obs(dyn.pos[..., :2],
                                               obst_pos[..., :2], active,
                                               size / 2.0))
    return torch.cat(parts, -1).to(cfg.dtype), gyro_bias


def _episode_values(given, random: bool, lo: float, hi: float, step: float,
                    fixed: float, gen, e: int, dtype, device):
    """An obstacle density or size per env: `given` (E,), else a draw from
    the domain-random grid arange(lo, hi, step), else the fixed value."""
    if given is not None:
        return given
    if random:
        grid = torch.as_tensor(np.arange(lo, hi, step), dtype=dtype,
                               device=device)
        return grid[torch.randint(0, grid.shape[0], (e,), generator=gen,
                                  device=device)]
    return torch.full((e,), fixed, dtype=dtype, device=device)


def env_reset(cfg: EnvConfig, params, gen: torch.Generator, num_envs: int,
              device="cuda", rew_coeff: RewardCoeffs | None = None,
              mode=None, event_slots: int | None = None,
              obst_density=None, obst_size=None):
    """Fresh episodes for `num_envs` envs: obstacles -> scenario -> spawn
    -> obs; returns (EnvState, obs).

    mode: force one scenario mode for every env (an int), or one per env
    ((E,) ints), else each env samples one from the config's mode list.  event_slots pins the event-table size;
    the auto-reset passes the running episode's size.  obst_density and
    obst_size (E,): keep these per env (else drawn from the domain-random
    grids when those are on, else the config's)."""
    cfg.check_supported()
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, device {device}")
    e, n, dtype = num_envs, cfg.num_agents, cfg.dtype
    full = lambda v, d=dtype: torch.full((e,), v, dtype=d, device=device)
    rew_coeff = RewardCoeffs() if rew_coeff is None else rew_coeff

    def coeff(x):
        # a float for every env, or the (E,) / per-agent (E, N) leaves of
        # a reset that keeps an env's coefficients
        t = torch.as_tensor(x, dtype=dtype, device=device)
        return (t.expand(e) if t.dim() == 0 else t).clone()
    rew_coeff = map_fields(coeff, rew_coeff)

    density = _episode_values(obst_density, cfg.obst_density_random,
                              cfg.obst_density_min, cfg.obst_density_max,
                              0.05, cfg.obst_density, gen, e, dtype, device)
    size = _episode_values(obst_size, cfg.obst_size_random, cfg.obst_size_min,
                           cfg.obst_size_max, 0.1, cfg.obst_size, gen, e,
                           dtype, device)
    centers = torch.as_tensor(
        obst.cell_centers(*cfg.scenario_config().obst_area), dtype=dtype,
        device=device)
    if cfg.use_obstacles:
        obst_active, obst_pos = obst.generate_obstacle_grid(
            gen, density, centers, cfg.room_dims[2])
    else:
        obst_active = torch.zeros((e, centers.shape[0]), dtype=torch.bool,
                                  device=device)
        obst_pos = obst.grid_positions(centers, cfg.room_dims[2]).expand(
            e, -1, -1).clone()
    if mode is None:
        modes = torch.tensor(cfg.mode_list(), dtype=torch.int32,
                             device=device)
        pick = torch.randint(0, len(cfg.mode_list()), (e,), generator=gen,
                             device=device)
        mode_t, table_modes = modes[pick], cfg.mode_list()
    else:
        mode_t = torch.as_tensor(mode, dtype=torch.int32, device=device)
        mode_t, table_modes = mode_t.expand(e).clone(), None
    scen = scenario_reset(cfg.scenario_config(), gen, mode_t, dtype,
                          allowed_modes=table_modes, num_slots=event_slots,
                          obst_active=obst_active, obst_centers=centers)
    pos, vel, rot, omega = _sample_spawn(cfg, gen, scen.spawn_points)
    dyn = init_state((e, n), dtype, device).replace(pos=pos, vel=vel,
                                                    rot=rot, omega=omega)
    zi = lambda: torch.zeros((e,), dtype=torch.int32, device=device)
    flags = lambda: torch.zeros((e, n), dtype=torch.bool, device=device)
    zf = lambda *s: torch.zeros((e,) + s, dtype=dtype, device=device)
    state = EnvState(
        dyn=dyn, scenario=scen, rew_coeff=rew_coeff, tick=zi(),
        prev_coll_pairs=(
            torch.zeros((e, n, PACK_LANES), dtype=torch.int32, device=device)
            if cfg.use_pallas_pairs
            else torch.zeros((e, n, n), dtype=torch.bool, device=device)),
        prev_coll_ids=flags(), prev_obst_hits=flags(), prev_wall=flags(),
        prev_ceiling=flags(), prev_room=flags(),
        obst_active=obst_active, obst_pos=obst_pos, obst_density=density,
        obst_size=size,
        gyro_bias=zf(n, 3), dist5=zf(n, 5),
        collisions_per_episode=zi(), collisions_after_settle=zi(),
        collisions_final_5s=zi(), obst_collisions_per_episode=zi(),
        obst_collisions_after_settle=zi(), collisions_floor_per_episode=zi(),
        collisions_wall_per_episode=zi(),
        collisions_ceiling_per_episode=zi(), collisions_room_per_episode=zi(),
        obst_coll_dist_3_5=zi(), obst_coll_dist_5=zi(),
        agent_col_agent=zf(n) + 1.0, agent_col_obst=zf(n) + 1.0,
        reached_goal=flags(), dist_sum_1s=zf(n), dist_sum_3s=zf(n),
        dist_sum_5s=zf(n), crashes_last_episode=zf(), cum_rewraw_main=zf(n),
        cum_rewraw_quadcol=zf(n))
    obs, gyro_bias = _compute_obs(cfg, dyn, scen.goals, state.gyro_bias, gen,
                                  obstacles=obstacles_of(state))
    return state.replace(gyro_bias=gyro_bias), obs


def _control_thrusts(cfg: EnvConfig, params, states: EnvState, actions,
                     goals) -> torch.Tensor:
    """Policy actions (E, N, A) -> normalized motor thrusts (E, N, 4).  The
    model-based modes read J^-1, made once per params and device."""
    j_inv = None
    if cfg.control_mode in JACOBIAN_MODES:
        j_inv = control_jacobian_inv(params, actions.device, cfg.dtype)
    return apply_control(cfg.control_mode, actions, j_inv=j_inv,
                         state=states.dyn, goal=goals,
                         zero_action_middle=cfg.zero_action_middle)


def _fleet_dynamics(cfg: EnvConfig, params, states: EnvState, actions, gen,
                    draws: dict) -> DroneState:
    """Control + dynamics for all E * N drones in one K1 launch."""
    e, n = actions.shape[:2]
    thrust = _control_thrusts(cfg, params, states, actions,
                              states.scenario.goals)
    ou, yaw = draw_tick_noise(params, states.dyn, gen, draws.get("ou"),
                              draws.get("yaw"))
    flat = lambda x: x.reshape((e * n,) + x.shape[2:])
    out = dynamics_tick_fused(params, cfg.dynamics_config(params.arm),
                              map_fields(flat, states.dyn),
                              flat(thrust).contiguous(), flat(ou),
                              flat(yaw).contiguous())
    return map_fields(lambda x: x.reshape((e, n) + x.shape[1:]), out)


def batched_env_step(cfg: EnvConfig, params, states: EnvState,
                     actions: torch.Tensor, gen: torch.Generator | None,
                     draws: dict | None = None, auto_reset: bool = True,
                     ended: list | None = None):
    """One control tick for E envs.  Returns (states', obs (E, N, D),
    rewards (E, N), dones (E, N), info dict of (E,) / (E, N) tensors).

    draws: optional raw draws of this tick, each with leading (E, N):
      "ou" (4,) standard normals of the OU motor noise; "yaw" () crash-yaw
      angles in [-pi, pi); "downwash" a dict for env/downwash.py;
      "drone_normals" (3, 3, 3) and "drone_uniforms" (6,) per drone for
      the drone collision response; "obst_normals" (3, 2, 3) and
      "obst_uniforms" (5,) for the obstacle response; "wall" (11,) and
      "ceiling" (10,) unit uniforms; "sensor" a dict for env/sensor.py.
    Missing draws come from `gen`.  The auto-reset always draws from `gen`.
    With auto_reset=False a finished episode stays finished, and the tick
    makes no device-to-host sync.
    ended: a list to which the tick appends its read of whether some
    episode ended (a host bool; auto_reset only).
    """
    cfg.check_supported()
    with span("env.step"):
        new_state, obs, rewards, done, info = _step(cfg, params, states,
                                                    actions, gen, draws or {})
    # One device-to-host sync per tick: the reset runs only on ticks where
    # some episode ended (episodes are fixed-length).
    if auto_reset:
        with span("env.sync"):
            any_done = bool(torch.any(done))
        if ended is not None:
            ended.append(any_done)
        if any_done:
            with span("env.reset_done"):
                new_state, obs = reset_done(cfg, params, gen, new_state, obs,
                                            done)
    return new_state, obs, rewards, done[:, None].expand(rewards.shape), info


def reset_done(cfg: EnvConfig, params, gen, states: EnvState, obs, done):
    """The envs whose episode ended (done (E,) bool) replaced by fresh
    episodes (`reset_like`), the others kept; returns (states', obs')."""
    reset_states, reset_obs = reset_like(cfg, params, gen, states)
    return (_select_done(done, reset_states, states),
            _select_done(done, reset_obs, obs))


def reset_like(cfg: EnvConfig, params, gen, states: EnvState):
    """Fresh episodes for every env of `states`, in the shapes of their
    event tables, with their reward coefficients, and with their obstacle
    density and size unless those are domain-random."""
    slots = (states.scenario.events.shape[-1]
             // event_table_width(cfg.num_agents))
    return env_reset(
        cfg, params, gen, states.tick.shape[0], device=states.tick.device,
        rew_coeff=states.rew_coeff, event_slots=slots,
        obst_density=None if cfg.obst_density_random else states.obst_density,
        obst_size=None if cfg.obst_size_random else states.obst_size)


def _step(cfg: EnvConfig, params, states: EnvState, actions, gen,
          draws: dict):
    """Stages 1-7 of the tick without the auto-reset; done is (E,).  Each
    stage is a span of `utils/tracing.py`: env.scenario, env.dynamics,
    env.collisions, env.reward, env.interactions, env.obs, env.stats; with
    obstacles, env.obstacle_hits (in env.collisions) and env.obstacle_sdf
    (in env.obs, and in a reset's observation)."""
    dtype = cfg.dtype
    freq = cfg.control_freq
    goals = states.scenario.goals

    # Scenario: continuous goal motion + presampled event playback.
    with span("env.scenario"):
        actions = actions.to(dtype)
        tick = states.tick + 1
        time_remain = cfg.ep_len - states.tick
        done = tick > cfg.ep_len
        scen = batched_scenario_step(cfg.scenario_config(), states.scenario,
                                     tick)

    # 1. Control + dynamics (K1).
    with span("env.dynamics"):
        dyn = _fleet_dynamics(cfg, params, states, actions, gen, draws)

    # 2. Collision detection (radii from the fleet's arm length).
    with span("env.collisions"):
        arm = fleet_arm(params.arm)
        hitbox = cfg.collision_hitbox_radius * arm
        falloff = cfg.collision_falloff_radius * arm
        if cfg.use_pallas_pairs:
            # K2: the (N, N) matrices are never made; the history stays
            # packed.
            curr_ids, pen_unit, resp_any, resp_partner, curr_pairs = \
                pair_collisions(dyn.pos.contiguous(), states.prev_coll_pairs,
                                hitbox, falloff, 1.0)
        else:
            dist, curr_pairs = coll.collision_matrix(dyn.pos, hitbox)
            curr_ids = torch.any(curr_pairs, -1)
            new_pairs = curr_pairs & ~states.prev_coll_pairs
        unique_ids = curr_ids & ~states.prev_coll_ids
        cct = torch.sum(unique_ids, -1).to(torch.int32) // 2
        grace = tick >= int(1.5 * freq)
        final5 = time_remain <= int(5.0 * freq)
        zero_i = torch.zeros_like(cct)
        collisions_per_episode = states.collisions_per_episode + cct
        collisions_after_settle = (states.collisions_after_settle
                                   + torch.where(grace, cct, zero_i))
        collisions_final_5s = states.collisions_final_5s + torch.where(
            final5, cct, zero_i)
        agent_col_agent = torch.where(
            (cct > 0)[:, None] & grace[:, None] & unique_ids,
            torch.zeros_like(states.agent_col_agent), states.agent_col_agent)

        # Obstacle collisions: a hit counts on the tick it starts.
        if cfg.use_obstacles:
            with span("env.obstacle_hits"):
                obst_hit, obst_idx = obst.obstacle_collisions(
                    dyn.pos[..., :2], states.obst_pos[..., :2],
                    states.obst_active, states.obst_size / 2.0, arm)
                curr_obst = obst_hit & ~states.prev_obst_hits
                n_obst = torch.sum(curr_obst, -1).to(torch.int32)
                settled = curr_obst & grace[:, None]
                rel_dist = torch.linalg.vector_norm(dyn.pos - goals, dim=-1)
                binned = lambda far: torch.sum(settled & (rel_dist > far),
                                               -1).to(torch.int32)
                obst_counts = dict(
                    obst_collisions_per_episode=(
                        states.obst_collisions_per_episode + n_obst),
                    obst_collisions_after_settle=(
                        states.obst_collisions_after_settle
                        + torch.where(grace, n_obst, zero_i)),
                    obst_coll_dist_3_5=(states.obst_coll_dist_3_5
                                        + binned(3.5)),
                    obst_coll_dist_5=states.obst_coll_dist_5 + binned(5.0),
                    agent_col_obst=torch.where(
                        (n_obst > 0)[:, None] & settled,
                        torch.zeros_like(states.agent_col_obst),
                        states.agent_col_obst))
        else:
            obst_hit = curr_obst = torch.zeros_like(unique_ids)
            obst_counts = {}

        floor_crash = dyn.crashed_floor
        wall_crash = dyn.crashed_wall & ~states.prev_wall
        ceiling_crash = dyn.crashed_ceiling & ~states.prev_ceiling
        room_crash = ((floor_crash | wall_crash | ceiling_crash)
                      & ~states.prev_room)
    count = lambda prev, hits: prev + torch.where(
        grace, torch.sum(hits, -1).to(torch.int32), zero_i)

    # 3. The per-drone reward and the collision rewards.
    with span("env.reward"):
        rewards, rew_info = compute_reward(states.rew_coeff, dyn.pos, goals,
                                           actions, dyn.rot, dyn.omega,
                                           dyn.on_floor, cfg.dt)
        rc = states.rew_coeff
        rew_quadcol = -agent_coeff(rc.quadcol_bin) * unique_ids.to(dtype)
        if cfg.use_pallas_pairs:
            # K2's sum has unit coefficient, sum(1 - d / falloff); the
            # per-env (annealed) coefficient and dt scale it here.
            rew_proximity = -(cfg.control_dt
                              * agent_coeff(rc.quadcol_bin_smooth_max)
                              * pen_unit.to(dtype))
        else:
            # in float32 on a bfloat16 env: the JAX package's falloff is a
            # float32 array, which promotes the penalty
            wide = torch.promote_types(dtype, torch.float32)
            rew_proximity = -proximity_penalties(
                dist.to(wide), dist <= falloff, falloff,
                rc.quadcol_bin_smooth_max.to(wide), cfg.control_dt)
        rew_obst_raw = -curr_obst.to(dtype)
        rew_quadcol_obst = agent_coeff(rc.quadcol_bin_obst) * rew_obst_raw
        rewards = rewards + rew_quadcol + rew_proximity
        if cfg.use_obstacles:
            rewards = rewards + rew_quadcol_obst

    # 4. Interaction forces.
    with span("env.interactions"):
        vel, omega = dyn.vel, dyn.omega
        if cfg.use_downwash:
            vel, omega, _ = apply_downwash(dyn.pos, vel, omega, dyn.rot,
                                           cfg.control_dt, gen,
                                           draws.get("downwash"))
        if cfg.apply_collision_force:
            if cfg.use_pallas_pairs:
                vel, omega = coll.drone_collision_response_indexed(
                    dyn.pos, vel, omega, resp_any, resp_partner.long(), gen,
                    draws.get("drone_normals"), draws.get("drone_uniforms"))
            else:
                vel, omega = coll.drone_collision_response(
                    dyn.pos, vel, omega, new_pairs, gen,
                    draws.get("drone_normals"), draws.get("drone_uniforms"))
            if cfg.use_obstacles:
                hit_pos = torch.gather(states.obst_pos, 1, obst_idx[..., None]
                                       .expand(obst_idx.shape + (3,)))
                vel, omega = coll.obstacle_collision_response(
                    dyn.pos, vel, omega, hit_pos, states.obst_size[:, None],
                    curr_obst, gen, draws.get("obst_normals"),
                    draws.get("obst_uniforms"))
            vel, omega = coll.wall_collision_response(
                dyn.pos, vel, omega, cfg.room_box, wall_crash, gen,
                draws.get("wall"))
            vel, omega = coll.ceiling_collision_response(
                vel, omega, ceiling_crash, gen, draws.get("ceiling"))
        dyn = dyn.replace(vel=vel, omega=omega)

    # 6. Observations (K3 reads the post-response velocities).
    with span("env.obs"):
        obs, gyro_bias = _compute_obs(cfg, dyn, scen.goals, states.gyro_bias,
                                      gen, draws.get("sensor"),
                                      obstacles_of(states))

    # 7. Goal-distance tracking, the new state and the episode metrics (the
    # auto-reset of the finished envs is the caller's).
    with span("env.stats"):
        dist_to_goal = torch.linalg.vector_norm(dyn.pos - goals, dim=-1)
        dist5 = torch.cat([states.dist5[..., 1:], dist_to_goal[..., None]],
                          -1)
        reached = states.reached_goal | ((tick >= 5)[:, None] & (
            dist5.mean(-1) < states.scenario.approach_goal_metric[:, None]))
        last_ticks = cfg.ep_len + 1
        window = lambda secs: (tick > last_ticks - int(secs * freq))[:, None]
        zero_d = torch.zeros_like(dist_to_goal)
        new_state = states.replace(
            dyn=dyn, scenario=scen, tick=tick, prev_coll_pairs=curr_pairs,
            prev_coll_ids=curr_ids, prev_obst_hits=obst_hit,
            prev_wall=wall_crash, prev_ceiling=ceiling_crash,
            prev_room=room_crash, gyro_bias=gyro_bias, dist5=dist5,
            collisions_per_episode=collisions_per_episode,
            collisions_after_settle=collisions_after_settle,
            collisions_final_5s=collisions_final_5s,
            collisions_floor_per_episode=count(
                states.collisions_floor_per_episode, floor_crash),
            collisions_wall_per_episode=count(
                states.collisions_wall_per_episode, wall_crash),
            collisions_ceiling_per_episode=count(
                states.collisions_ceiling_per_episode, ceiling_crash),
            collisions_room_per_episode=count(
                states.collisions_room_per_episode, room_crash),
            agent_col_agent=agent_col_agent, reached_goal=reached,
            dist_sum_1s=states.dist_sum_1s + torch.where(
                window(1), dist_to_goal, zero_d),
            dist_sum_3s=states.dist_sum_3s + torch.where(
                window(3), dist_to_goal, zero_d),
            dist_sum_5s=states.dist_sum_5s + torch.where(
                window(5), dist_to_goal, zero_d),
            crashes_last_episode=states.crashes_last_episode
            + rew_info.rew_crash[:, 0],
            cum_rewraw_main=states.cum_rewraw_main + rew_info.rewraw_pos,
            cum_rewraw_quadcol=states.cum_rewraw_quadcol
            - unique_ids.to(dtype),
            **obst_counts)
        info = _episode_stats(cfg, new_state, done)
        info.update({
            "rewards/rew_pos": rew_info.rew_pos,
            "rewards/rew_action": rew_info.rew_action,
            "rewards/rew_crash": rew_info.rew_crash,
            "rewards/rew_orient": rew_info.rew_orient,
            "rewards/rew_spin": rew_info.rew_spin,
            "rewards/rewraw_pos": rew_info.rewraw_pos,
            "rewards/rewraw_crash": rew_info.rewraw_crash,
            "rewards/rew_quadcol": rew_quadcol,
            "rewards/rew_proximity": rew_proximity,
            "rewards/rewraw_quadcol": -unique_ids.to(dtype),
            "rewards/rew_quadcol_obstacle": rew_quadcol_obst,
            "rewards/rewraw_quadcol_obstacle": rew_obst_raw,
        })
    return new_state, obs, rewards, done, info


def _select_done(done_env, reset_tree, keep_tree):
    """Per-env select over every field: done_env (E,)."""
    def sel(a, b):
        return torch.where(done_env.reshape((-1,) + (1,) * (a.dim() - 1)),
                           a, b)
    return map_fields(sel, reset_tree, keep_tree)


def _episode_stats(cfg: EnvConfig, s: EnvState, done) -> dict:
    """Per-episode metrics (read by the trainer where `episode_done`)."""
    n = cfg.num_agents
    dtype = cfg.dtype
    freq = cfg.control_freq
    agent_col_flag = (s.agent_col_agent > 0) & (s.agent_col_obst > 0)
    success = agent_col_flag & s.reached_goal
    deadlock = agent_col_flag & ~s.reached_goal
    frac = lambda x: torch.sum(x, -1).to(dtype) / n
    return {
        "episode_done": done,
        "scenario_mode": s.scenario.mode,
        "num_collisions": s.collisions_per_episode,
        "num_collisions_after_settle": s.collisions_after_settle,
        "num_collisions_final_5_s": s.collisions_final_5s,
        "num_collisions_with_room": s.collisions_room_per_episode,
        "num_collisions_with_floor": s.collisions_floor_per_episode,
        "num_collisions_with_wall": s.collisions_wall_per_episode,
        "num_collisions_with_ceiling": s.collisions_ceiling_per_episode,
        "num_collisions_obst_quad": s.obst_collisions_per_episode,
        "num_collisions_obst_quad_after_settle":
            s.obst_collisions_after_settle,
        "num_collisions_obst_quad_3_5": s.obst_coll_dist_3_5,
        "num_collisions_obst_quad_5": s.obst_coll_dist_5,
        "distance_to_goal_1s": s.dist_sum_1s / (1 * freq),
        "distance_to_goal_3s": s.dist_sum_3s / (3 * freq),
        "distance_to_goal_5s": s.dist_sum_5s / (5 * freq),
        "metric/agent_success_rate": frac(success),
        "metric/agent_deadlock_rate": frac(deadlock),
        "metric/agent_col_rate": 1.0 - frac(agent_col_flag),
        "metric/agent_neighbor_col_rate": 1.0 - torch.sum(
            s.agent_col_agent, -1) / n,
        "metric/agent_obst_col_rate": 1.0 - torch.sum(
            s.agent_col_obst, -1) / n,
        "true_reward": s.cum_rewraw_main + 1000.0 * s.cum_rewraw_quadcol,
    }
