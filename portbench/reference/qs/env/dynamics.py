"""Batched, branchless quadrotor rigid-body dynamics: the plain spec.

Port of quadswarm_tpu/env/dynamics.py.  `dynamics_substep` is one physics
sub-step over any leading batch shape; every data-dependent branch (motor
tau, floor contact, room clip) is a `torch.where`.  It is the plain version
the fused CUDA kernel (ops/kernels/dynamics_kernel.py) is held to.

Parameters: shared (0-d and small fields) or per drone, with a leading
axis N that broadcasts against the state's agent axis: a state (E, N, ...)
or (N, ...) flies drone i with row i.  A parameter that scales a vector
field is indexed `[..., None]` so that both forms broadcast.

Randomness: `ou_noise_step` and `dynamics_step` take their draws as optional
tensors (standard normals for the OU noise, the crash-yaw angle) and draw
them from the caller's `torch.Generator` only when they are not given.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference.qs.ops.rotations import (
    reorthonormalize, rodrigues, yaw_rot,
)
from portbench.reference.qs.utils.struct import Struct

GRAV = 9.81
EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    """Static integrator configuration."""

    dt: float = 1.0 / 200.0
    sim_steps: int = 2
    room_box: tuple = ((-5.0, -5.0, 0.0), (5.0, 5.0, 10.0))
    floor_threshold: float = 0.05
    mu: float = 0.6
    omega_max: float = 40.0
    vxyz_max: float = 3.0
    acc_max: float = 3.0 * GRAV
    gravity: float = GRAV
    # Re-orthonormalize every ceil(0.5 / dt) + 1 sub-steps.
    orthonormalize_every: int = 101
    use_rotor_drag: bool = False


@dataclasses.dataclass
class DroneState(Struct):
    """Per-drone dynamic state; every field has the same leading batch dims."""

    pos: torch.Tensor               # (..., 3) world frame
    vel: torch.Tensor               # (..., 3) world frame
    rot: torch.Tensor               # (..., 3, 3) body -> world
    omega: torch.Tensor             # (..., 3) body frame
    thrust_cmds_damp: torch.Tensor  # (..., 4) motor filter state
    thrust_rot_damp: torch.Tensor   # (..., 4) filter state, sqrt domain
    acc: torch.Tensor               # (..., 3)
    accelerometer: torch.Tensor     # (..., 3) proper acceleration, body
    omega_dot: torch.Tensor         # (..., 3)
    torque: torch.Tensor            # (..., 3)
    on_floor: torch.Tensor          # (...,) bool
    crashed_floor: torch.Tensor     # (...,) bool
    crashed_wall: torch.Tensor      # (...,) bool
    crashed_ceiling: torch.Tensor   # (...,) bool
    step_count: torch.Tensor        # (...,) int32 sub-step counter
    ou_state: torch.Tensor          # (..., 4) OU thrust-noise state


def init_state(batch_shape: tuple, dtype=torch.float32,
               device="cpu") -> DroneState:
    """All-zero state with identity rotation and gravity-only accelerometer."""
    z3 = lambda: torch.zeros(batch_shape + (3,), dtype=dtype, device=device)
    z4 = lambda: torch.zeros(batch_shape + (4,), dtype=dtype, device=device)
    flag = lambda: torch.zeros(batch_shape, dtype=torch.bool, device=device)
    accel = z3()
    accel[..., 2] = GRAV
    rot = torch.eye(3, dtype=dtype, device=device).expand(
        batch_shape + (3, 3)).contiguous()
    return DroneState(
        pos=z3(), vel=z3(), rot=rot, omega=z3(), thrust_cmds_damp=z4(),
        thrust_rot_damp=z4(), acc=z3(), accelerometer=accel, omega_dot=z3(),
        torque=z3(), on_floor=flag(), crashed_floor=flag(),
        crashed_wall=flag(), crashed_ceiling=flag(),
        step_count=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        ou_state=z4())


def ou_noise_step(ou_state: torch.Tensor, thrust_noise_ratio,
                  gen: torch.Generator | None = None,
                  normal: torch.Tensor | None = None,
                  theta: float = 0.15) -> torch.Tensor:
    """Ornstein-Uhlenbeck motor noise, drawn once per control step.
    sigma = 0.2 * thrust_noise_ratio, mu = 0.  `normal` is the standard
    normal draw of this step (drawn from `gen` when None)."""
    if normal is None:
        normal = torch.randn(ou_state.shape, generator=gen,
                             dtype=ou_state.dtype, device=ou_state.device)
    sigma = 0.2 * thrust_noise_ratio
    # the noise in at least float32 on a bfloat16 state, cast back to the
    # state's dtype at the end (the JAX package's promotions against its
    # float32 params)
    wide = torch.promote_types(ou_state.dtype, torch.float32)
    return (ou_state + (theta * (0.0 - ou_state) + sigma * normal.to(wide))
            ).to(ou_state.dtype)


def _floor_interaction(p, cfg: DynamicsConfig, pos, vel, rot, omega,
                       cmds_damp, rot_damp, on_floor, force,
                       rand_yaw_theta):
    """Floor contact state machine: A below & on_floor (yaw-flatten, Coulomb
    friction), B below & !on_floor (crash landing), C above (free flight)."""
    below = pos[..., 2] <= cfg.floor_threshold
    case_a = below & on_floor
    case_b = below & ~on_floor

    floor_z = torch.full_like(pos[..., 2], cfg.floor_threshold)
    pos = torch.cat([pos[..., :2],
                     torch.where(below, floor_z, pos[..., 2])[..., None]], -1)

    theta = torch.atan2(rot[..., 1, 0], rot[..., 0, 0] + EPS)
    flat_rot = yaw_rot(theta)
    inverted = rot[..., 2, 2] < 0.0
    crash_rot = torch.where((case_b & inverted)[..., None, None],
                            yaw_rot(rand_yaw_theta), flat_rot)

    # Case A: friction.  friction_mag is not clamped at 0 (thrust above
    # weight on the floor gives a phantom static force along +x through
    # atan2(0, 0) = 0), as in the reference integrator.
    friction_mag = cfg.mu * (p.mass * GRAV - force[..., 2])
    vel_norm = torch.linalg.vector_norm(vel, dim=-1)
    force_xy_mag = torch.linalg.vector_norm(force[..., :2], dim=-1)
    static_mag = torch.clamp(force_xy_mag - friction_mag, min=0.0)
    force_angle = torch.atan2(force[..., 1], force[..., 0])
    static_dir = torch.stack([torch.cos(force_angle), torch.sin(force_angle)],
                             -1)
    static_xy = torch.where((static_mag == 0.0)[..., None],
                            torch.zeros_like(static_dir),
                            static_mag[..., None] * static_dir)
    force_static = torch.cat([static_xy, force[..., 2:]], -1)
    fr_angle = torch.atan2(-vel[..., 1], -vel[..., 0])
    fr_dir = torch.stack([torch.cos(fr_angle), torch.sin(fr_angle)], -1)
    force_kinetic = torch.cat(
        [force[..., :2] + fr_dir * friction_mag[..., None], force[..., 2:]], -1)
    force_floor = torch.where((vel_norm < EPS)[..., None], force_static,
                              force_kinetic)
    force = torch.where(case_a[..., None], force_floor, force)
    rot = torch.where(case_a[..., None, None], flat_rot, rot)

    # Case B: crash landing.
    b3 = case_b[..., None]
    vel = torch.where(b3, torch.zeros_like(vel), vel)
    omega = torch.where(b3, torch.zeros_like(omega), omega)
    rot = torch.where(case_b[..., None, None], crash_rot, rot)
    cmds_damp = torch.where(b3, torch.zeros_like(cmds_damp), cmds_damp)
    rot_damp = torch.where(b3, torch.zeros_like(rot_damp), rot_damp)

    acc = force / p.mass[..., None]
    acc = torch.cat([acc[..., :2], (-GRAV + acc[..., 2:])], -1)
    acc_floor_z = torch.where(below, torch.clamp(acc[..., 2], min=0.0),
                              acc[..., 2])
    acc = torch.cat([acc[..., :2], acc_floor_z[..., None]], -1)
    return pos, vel, rot, omega, cmds_damp, rot_damp, below, case_b, acc


def _rotor_drag(p, state: DroneState, cmds_damp: torch.Tensor, dt: float):
    """Rotor drag force and viscous (drag plus rolling) torque of each
    drone, each clipped so that it cannot reverse the body velocity or
    spin within two sub-steps.  Off unless cfg.use_rotor_drag; every preset
    has C_drag = C_roll = 0."""
    vel_body = (state.rot.transpose(-1, -2) @ state.vel[..., None])[..., 0]
    omega = state.omega[..., None, :].expand(cmds_damp.shape + (3,))
    v_rotor = vel_body[..., None, :] + torch.linalg.cross(
        omega, p.prop_pos.expand(omega.shape))
    v_rotor = torch.cat([v_rotor[..., :2], torch.zeros_like(v_rotor[..., 2:])],
                        -1)
    sqrt_cmd = torch.sqrt(cmds_damp)[..., None]
    drag_fi = -p.c_drag[..., None, None] * sqrt_cmd * v_rotor
    drag_force = torch.sum(drag_fi, -2)
    drag_torque = torch.sum(torch.linalg.cross(
        drag_fi, p.prop_pos.expand(drag_fi.shape)), -2)
    roll_torque = torch.sum(-p.c_roll[..., None, None]
                            * p.prop_ccw[..., None] * sqrt_cmd * v_rotor, -2)
    visc_torque = drag_torque + roll_torque

    def clip(x, cap):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        scaled = x / torch.clamp(norm, min=EPS) * torch.minimum(norm, cap)
        return torch.where(norm > EPS, scaled, x)

    vel_norm = torch.linalg.vector_norm(vel_body, dim=-1, keepdim=True)
    drag_force = clip(drag_force, vel_norm * p.mass[..., None] / (2 * dt))
    omega_cap = torch.linalg.vector_norm(state.omega * p.inertia, dim=-1,
                                         keepdim=True) / (2 * dt)
    return drag_force, clip(visc_torque, omega_cap)


def dynamics_substep(params, cfg: DynamicsConfig, state: DroneState,
                     thrust_cmds: torch.Tensor, thrust_noise: torch.Tensor,
                     rand_yaw_theta: torch.Tensor) -> DroneState:
    """One physics sub-step at cfg.dt (the reference's `step1`)."""
    p = params.to(state.pos.device, state.pos.dtype)
    dt = cfg.dt

    # Motor first-order filter in the sqrt domain.
    cmds = torch.clamp(thrust_cmds, 0.0, 1.0)
    tau = torch.where(cmds < state.thrust_cmds_damp,
                      p.motor_tau_down[..., None], p.motor_tau_up[..., None])
    tau = torch.clamp(tau, max=1.0)
    rot_damp = tau * (torch.sqrt(cmds) - state.thrust_rot_damp) \
        + state.thrust_rot_damp
    cmds_damp = torch.clamp(rot_damp**2 + cmds * thrust_noise, 0.0, 1.0)
    lin = p.motor_linearity[..., None]
    thrusts = p.thrust_max * ((1.0 - lin) * cmds_damp**2 + lin * cmds_damp)

    # Torques: prop cross-products plus the reaction torque about z.
    torques = p.prop_crossproducts * thrusts[..., None]
    torques = torch.cat([torques[..., :2], (
        torques[..., 2] + p.torque_max * p.prop_ccw * cmds_damp)[..., None]],
        -1)
    torque = torch.sum(torques, -2)
    thrust_total = torch.sum(thrusts, -1)
    if cfg.use_rotor_drag:
        drag_force, visc_torque = _rotor_drag(p, state, cmds_damp, dt)
        torque = torque + visc_torque

    # Rodrigues about the world-frame omega, then periodic Newton polar.
    omega_world = (state.rot @ state.omega[..., None])[..., 0]
    rot = rodrigues(omega_world, dt) @ state.rot
    step_count = state.step_count + 1
    do_ortho = step_count >= cfg.orthonormalize_every
    rot = torch.where(do_ortho[..., None, None], reorthonormalize(rot), rot)
    step_count = torch.where(do_ortho, torch.zeros_like(step_count),
                             step_count)

    # Omega: Euler with quadratic damping, then clip.
    omega_dot = (1.0 / p.inertia) * (
        torch.linalg.cross(-state.omega, p.inertia * state.omega) + torque)
    damp_quad = torch.clamp(p.damp_omega_quadratic[..., None]
                            * state.omega**2, 0.0, 1.0)
    omega = state.omega + (1.0 - damp_quad) * dt * omega_dot
    omega = torch.clamp(omega, -cfg.omega_max, cfg.omega_max)

    # Position + room clip.
    lo = torch.tensor(cfg.room_box[0], dtype=state.pos.dtype,
                      device=state.pos.device)
    hi = torch.tensor(cfg.room_box[1], dtype=state.pos.dtype,
                      device=state.pos.device)
    pos_raw = state.pos + dt * state.vel
    pos = torch.minimum(torch.maximum(pos_raw, lo), hi)
    crashed_wall = torch.any(pos_raw[..., :2] != pos[..., :2], -1)
    crashed_ceiling = pos_raw[..., 2] > pos[..., 2]

    # The body force R (drag + [0, 0, T]) in the world frame.
    if cfg.use_rotor_drag:
        body_force = torch.cat([drag_force[..., :2], (
            drag_force[..., 2] + thrust_total)[..., None]], -1)
        force = (rot @ body_force[..., None])[..., 0]
    else:
        force = rot[..., :, 2] * thrust_total[..., None]
    (pos, vel, rot, omega, cmds_damp, rot_damp, on_floor, crashed_floor,
     acc) = _floor_interaction(p, cfg, pos, state.vel, rot, omega, cmds_damp,
                               rot_damp, state.on_floor, force,
                               rand_yaw_theta)

    vel = (1.0 - p.vel_damp[..., None]) * vel + dt * acc
    acc_g = torch.cat([acc[..., :2], acc[..., 2:] + cfg.gravity], -1)
    accelerometer = (rot.transpose(-1, -2) @ acc_g[..., None])[..., 0]
    return state.replace(
        pos=pos, vel=vel, rot=rot, omega=omega, thrust_cmds_damp=cmds_damp,
        thrust_rot_damp=rot_damp, acc=acc, accelerometer=accelerometer,
        omega_dot=omega_dot, torque=torque, on_floor=on_floor,
        crashed_floor=crashed_floor, crashed_wall=crashed_wall,
        crashed_ceiling=crashed_ceiling, step_count=step_count)


def dynamics_tick(params, cfg: DynamicsConfig, state: DroneState,
                  thrust_cmds: torch.Tensor, ou_state: torch.Tensor,
                  rand_yaw_theta: torch.Tensor) -> DroneState:
    """cfg.sim_steps sub-steps with this tick's OU state and crash yaw, all
    sub-steps sharing both (the reference draws them once per control
    step).  The result carries `ou_state`."""
    state = state.replace(ou_state=ou_state)
    for _ in range(cfg.sim_steps):
        state = dynamics_substep(params, cfg, state, thrust_cmds, ou_state,
                                 rand_yaw_theta)
    return state


def noise_ratio(params, device, dtype):
    """The thrust-noise ratio as the OU step takes it: a float for shared
    params; for per-drone params an (N, 1) tensor on `device`, made once
    per (params, device, dtype) and kept on the params object."""
    if params.thrust_noise_ratio.dim() == 0:
        return float(params.thrust_noise_ratio)
    cache = params.__dict__.setdefault("_noise_ratio_cache", {})
    key = (torch.device(device), dtype)
    if key not in cache:
        cache[key] = params.thrust_noise_ratio[:, None].to(device=device,
                                                            dtype=dtype)
    return cache[key]


def draw_tick_noise(params, state: DroneState, gen: torch.Generator | None,
                    ou_normal: torch.Tensor | None = None,
                    rand_yaw_theta: torch.Tensor | None = None):
    """This tick's OU state and crash-yaw angle, from the given draws or
    from `gen`.  Per-drone params broadcast over the state's agent axis."""
    ou_state = ou_noise_step(state.ou_state,
                             noise_ratio(params, state.ou_state.device,
                                         torch.promote_types(
                                             state.ou_state.dtype,
                                             torch.float32)),
                             gen, ou_normal)
    if rand_yaw_theta is None:
        u = torch.rand(state.pos.shape[:-1], generator=gen,
                       dtype=state.pos.dtype, device=state.pos.device)
        rand_yaw_theta = u * (2 * math.pi) - math.pi
    return ou_state, rand_yaw_theta


def dynamics_step(params, cfg: DynamicsConfig, state: DroneState,
                  thrust_cmds: torch.Tensor, gen: torch.Generator | None = None,
                  ou_normal: torch.Tensor | None = None,
                  rand_yaw_theta: torch.Tensor | None = None) -> DroneState:
    """One control step = cfg.sim_steps sub-steps (plain path)."""
    ou_state, yaw = draw_tick_noise(params, state, gen, ou_normal,
                                    rand_yaw_theta)
    return dynamics_tick(params, cfg, state, thrust_cmds, ou_state, yaw)
