"""Controllers: policy action -> normalized motor thrusts.

Port of quadswarm_tpu/env/controls.py: the reference's controller objects as
functions of the action (and, for the model-based modes, of the drone state
and the goal) that return [0, 1] thrust commands.  Training uses `raw`.
`omega`, `velocity_yaw` and `mellinger` map a desired (thrust acceleration,
angular acceleration) through the inverse of the thrust Jacobian, J^-1,
which depends on the parameters only: `control_jacobian_inv` computes it
once per params in float64 on the CPU (per drone for a randomized fleet)
and keeps it on the params per device, so a tick neither inverts a matrix
nor waits for the device.
"""
from __future__ import annotations

import torch

GRAV = 9.81

CONTROL_MODES = ("raw", "vertical", "vert_plane", "omega", "velocity_yaw",
                 "mellinger")
# The modes that need J^-1.
JACOBIAN_MODES = ("omega", "velocity_yaw", "mellinger")


def raw_control(action: torch.Tensor,
                zero_action_middle: bool = True) -> torch.Tensor:
    """Clip to the action box and map affinely to [0, 1] thrusts."""
    if zero_action_middle:
        return 0.5 * (torch.clamp(action, -1.0, 1.0) + 1.0)
    return torch.clamp(action, 0.0, 1.0)


def vertical_control(action: torch.Tensor,
                     zero_action_middle: bool = True) -> torch.Tensor:
    """One action drives all four motors.  As in the reference, with
    zero_action_middle the action is scaled before it is clipped, to
    [-1, 1]."""
    if zero_action_middle:
        action = torch.clamp(0.5 * (action + 1.0), -1.0, 1.0)
    else:
        action = torch.clamp(action, 0.0, 1.0)
    return action[..., :1].expand(action.shape[:-1] + (4,))


def vert_plane_control(action: torch.Tensor,
                       zero_action_middle: bool = True) -> torch.Tensor:
    """Two actions drive the motor pairs (0, 1) and (2, 3); scaled before
    clipped, as vertical_control."""
    if zero_action_middle:
        action = torch.clamp(0.5 * (action + 1.0), -1.0, 1.0)
    else:
        action = torch.clamp(action, 0.0, 1.0)
    a0, a1 = action[..., 0:1], action[..., 1:2]
    return torch.cat([a0, a0, a1, a1], -1)


def quadrotor_jacobian(params) -> torch.Tensor:
    """Jacobian of (thrust acceleration, angular acceleration) with respect
    to the normalized motor thrusts: (4, 4), or (N, 4, 4) for per-drone
    params, in the params' dtype."""
    cross = params.prop_crossproducts.transpose(-1, -2)     # (..., 3, 4)
    torque = params.thrust_max[..., None, :] * cross
    torque = torch.cat([torque[..., :2, :], (
        params.torque_max * params.prop_ccw)[..., None, :]], -2)
    thrust = params.thrust_max[..., None, :]                 # (..., 1, 4)
    dw = (1.0 / params.inertia)[..., :, None] * torque
    dv = thrust / params.mass[..., None, None]
    return torch.cat([dv, dw], -2)


def jacobian_inv(params) -> torch.Tensor:
    """J^-1 of the params, computed in float64 on the CPU."""
    cpu = params.to("cpu", torch.float64)
    return torch.linalg.inv(quadrotor_jacobian(cpu))


def control_jacobian_inv(params, device, dtype) -> torch.Tensor:
    """J^-1 in `dtype` on `device`, built once per (params, device, dtype)
    and kept on the params object (parameters are set-up values, never
    modified in place)."""
    cache = params.__dict__.setdefault("_jacobian_inv_cache", {})
    key = (torch.device(device), dtype)
    if key not in cache:
        cache[key] = jacobian_inv(params).to(device=device, dtype=dtype)
    return cache[key]


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v[..., None])[..., 0]


def _normalize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Unit vector; a vector of norm below eps passes through unscaled."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    small = n < eps
    return torch.where(small, x, x / torch.where(small, torch.ones_like(n),
                                                  n))


def _vee(m: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def _attitude_error(rot_des: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    return 0.5 * _vee(rot_des.transpose(-1, -2) @ rot
                      - rot.transpose(-1, -2) @ rot_des)


def _up(x: torch.Tensor) -> torch.Tensor:
    """Gravity's counter, [0, 0, g], shaped like x."""
    return torch.tensor([0.0, 0.0, GRAV], dtype=x.dtype,
                        device=x.device).expand(x.shape)


def omega_thrust_control(j_inv: torch.Tensor, omega: torch.Tensor,
                         action: torch.Tensor) -> torch.Tensor:
    """P control on omega toward action[1:], plus a direct thrust
    magnitude from action[0]."""
    kp = 5.0
    dw_des = -kp * (omega - action[..., 1:])
    acc_des = GRAV * (action[..., 0:1] + 1.0)
    des = torch.cat([acc_des, dw_des], -1)
    return torch.clamp(_matvec(j_inv, des), 0.0, 1.0)


def mellinger_control(j_inv: torch.Tensor, pos, vel, rot, omega, goal,
                      kp_p: float = 4.5, kd_p: float = 3.5,
                      kp_a: float = 200.0,
                      kd_a: float = 50.0) -> torch.Tensor:
    """The reference's nonlinear position controller (Mellinger & Kumar
    2011) toward `goal`: the position error's norm clamped to 4, the
    desired frame's x along the world's x, yaw error slowed by 0.2."""
    to_goal = goal - pos
    gnorm = torch.linalg.vector_norm(to_goal, dim=-1, keepdim=True)
    e_p = -torch.where(gnorm <= 4.0, to_goal, to_goal * (4.0 / gnorm))
    acc_des = -kp_p * e_p - kd_p * vel + _up(pos)
    zb_des = _normalize(acc_des)
    xc_des = torch.tensor([1.0, 0.0, 0.0], dtype=pos.dtype,
                          device=pos.device).expand(pos.shape)
    yb_des = _normalize(torch.linalg.cross(zb_des, xc_des))
    xb_des = torch.linalg.cross(yb_des, zb_des)
    rot_des = torch.stack([xb_des, yb_des, zb_des], -1)
    e_r = _attitude_error(rot_des, rot)
    e_r = torch.cat([e_r[..., :2], 0.2 * e_r[..., 2:]], -1)
    dw_des = -kp_a * e_r - kd_a * omega
    thrust_mag = torch.sum(acc_des * rot[..., :, 2], -1, keepdim=True)
    des = torch.cat([thrust_mag, dw_des], -1)
    return torch.clamp(_matvec(j_inv, des), 0.0, 1.0)


def velocity_yaw_control(j_inv: torch.Tensor, pos, vel, rot, omega, action,
                         kp_v: float = 5.0, kp_a: float = 100.0,
                         kd_a: float = 50.0) -> torch.Tensor:
    """P control on velocity toward action[:3] plus a desired yaw rate
    action[3], with a geometric attitude loop.  The thrust magnitude is the
    intended dot(acc_des, R[:, 2]); the reference's code reaches a BLAS
    function object there instead, as the JAX package notes."""
    acc_des = -kp_v * (vel - action[..., :3]) + _up(pos)
    zb_des = _normalize(acc_des)
    yb_des = _normalize(torch.linalg.cross(zb_des, rot[..., :, 0]))
    xb_des = torch.linalg.cross(yb_des, zb_des)
    rot_des = torch.stack([xb_des, yb_des, zb_des], -1)
    e_r = _attitude_error(rot_des, rot)
    omega_des = torch.cat([torch.zeros_like(action[..., :2]),
                           action[..., 3:4]], -1)
    dw_des = -kp_a * e_r - kd_a * (omega - omega_des)
    thrust_mag = torch.sum(acc_des * rot[..., :, 2], -1, keepdim=True)
    des = torch.cat([thrust_mag, dw_des], -1)
    return torch.clamp(_matvec(j_inv, des), 0.0, 1.0)


def apply_control(mode: str, action: torch.Tensor, *, j_inv=None,
                  state=None, goal=None,
                  zero_action_middle: bool = True) -> torch.Tensor:
    """Dispatch on the control mode (configuration, not data).  `j_inv`
    (4, 4) or (N, 4, 4), `state` (a DroneState) and `goal` are read by the
    model-based modes only."""
    if mode == "raw":
        return raw_control(action, zero_action_middle)
    if mode == "vertical":
        return vertical_control(action, zero_action_middle)
    if mode == "vert_plane":
        return vert_plane_control(action, zero_action_middle)
    if mode == "omega":
        return omega_thrust_control(j_inv, state.omega, action)
    if mode == "velocity_yaw":
        return velocity_yaw_control(j_inv, state.pos, state.vel, state.rot,
                                    state.omega, action)
    if mode == "mellinger":
        return mellinger_control(j_inv, state.pos, state.vel, state.rot,
                                 state.omega, goal)
    raise ValueError(f"unknown control mode: {mode}")


def action_dim(mode: str) -> int:
    return {"raw": 4, "vertical": 1, "vert_plane": 2, "omega": 4,
            "velocity_yaw": 4, "mellinger": 4}[mode]
