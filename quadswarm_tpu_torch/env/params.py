"""Quadrotor parameter preset, composite inertia and `DynamicsParams`.

Port of quadswarm_tpu/env/params.py, limited to what the rollout path
uses: the Crazyflie preset, the composite-rigid-body inertia model and
`DynamicsParams.from_model`.  The randomized samplers and per-drone fleets
come later; asking for them raises.

The parameters are host-side set-up values, so `DynamicsParams` holds CPU
tensors.  The plain dynamics moves them to the state's device; the CUDA
kernel receives them by value as a flat float vector
(`ops/kernels/dynamics_kernel.py::param_vector`), so reading them never
waits for the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quadswarm_tpu_torch.utils.struct import Struct

GRAV = 9.81
EPS = 1e-6


def crazyflie_params() -> dict:
    """Crazyflie 2.x physical parameters."""
    return {
        "geom": {
            "body": {"l": 0.03, "w": 0.03, "h": 0.004, "m": 0.005},
            "payload": {"l": 0.035, "w": 0.02, "h": 0.008, "m": 0.01},
            "arms": {"l": 0.022, "w": 0.005, "h": 0.005, "m": 0.001},
            "motors": {"h": 0.02, "r": 0.0035, "m": 0.0015},
            "propellers": {"h": 0.002, "r": 0.022, "m": 0.00075},
            "motor_pos": {"xyz": [0.065 / 2, 0.065 / 2, 0.0]},
            "arms_pos": {"angle": 45.0, "z": 0.0},
            "payload_pos": {"xy": [0.0, 0.0], "z_sign": 1},
        },
        "damp": {"vel": 0.0, "omega_quadratic": 0.0},
        "noise": {"thrust_noise_ratio": 0.05},
        "motor": {
            "thrust_to_weight": 1.9,
            "assymetry": [1.0, 1.0, 1.0, 1.0],
            "torque_to_thrust": 0.006,
            "linearity": 1.0,
            "C_drag": 0.0,
            "C_roll": 0.0,
            "damp_time_up": 0.15,
            "damp_time_down": 0.15,
        },
    }


QUAD_PRESETS = {"Crazyflie": crazyflie_params}


def _box_inertia(l, w, h, m):
    return np.diag([m / 12.0 * (h**2 + w**2), m / 12.0 * (l**2 + h**2),
                    m / 12.0 * (w**2 + l**2)])


def _cylinder_inertia(h, r, m):
    a = m / 12.0 * (3 * r**2 + h**2)
    return np.diag([a, a, 0.5 * m * r**2])


def _translate_inertia(inertia, m, xyz):
    """Parallel-axis offset.  The [0, 2] term reuses I[0, 1] exactly as the
    reference model does; the off-diagonals cancel in the composed total."""
    x, y, z = xyz
    out = np.zeros((3, 3))
    out[0, 0] = inertia[0, 0] + m * (y**2 + z**2)
    out[1, 1] = inertia[1, 1] + m * (x**2 + z**2)
    out[2, 2] = inertia[2, 2] + m * (x**2 + y**2)
    out[0, 1] = out[1, 0] = inertia[0, 1] + m * x * y
    out[0, 2] = out[2, 0] = inertia[0, 1] + m * x * z
    out[1, 2] = out[2, 1] = inertia[1, 2] + m * y * z
    return out


def _yaw_mat(alpha):
    c, s = np.cos(alpha), np.sin(alpha)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def compute_quad_inertia(geom: dict) -> dict:
    """Compose body, payload, arms, motors and props into total mass, the
    COM-centred diagonal inertia, the propeller positions and the arm."""
    body, payload = geom["body"], geom["payload"]
    arms, motors, props = geom["arms"], geom["motors"], geom["propellers"]

    arm_angle = np.deg2rad(geom["arms_pos"]["angle"]) or 0.01
    motor_xyz = np.array(geom["motor_pos"]["xyz"], dtype=np.float64)
    delta_y = motor_xyz[1] - body["w"] / 2.0
    arm_l = arms.get("l", delta_y / np.sin(arm_angle))
    arm_xyz = np.array([motor_xyz[0] - delta_y / (2 * np.tan(arm_angle)),
                        motor_xyz[1] - delta_y / 2.0, geom["arms_pos"]["z"]])

    # X configuration, clockwise from front-right.
    x_sign = np.array([1, -1, -1, 1], dtype=np.float64)
    y_sign = np.array([-1, -1, 1, 1], dtype=np.float64)
    sign_mx = np.stack([x_sign, y_sign, np.ones(4)])
    motors_coord = sign_mx * motor_xyz[:, None]
    props_coord = motors_coord.copy()
    props_coord[2, :] += motors["h"] / 2.0 + props["h"]
    arms_coord = sign_mx * arm_xyz[:, None]
    arm_angles = np.array([-arm_angle, arm_angle, -arm_angle, arm_angle])

    masses = [body["m"], payload["m"]]
    inertias = [_box_inertia(body["l"], body["w"], body["h"], body["m"]),
                _box_inertia(payload["l"], payload["w"], payload["h"],
                             payload["m"])]
    poses = [np.zeros(3), np.array(
        list(geom["payload_pos"]["xy"])
        + [np.sign(geom["payload_pos"]["z_sign"])
           * (body["h"] + payload["h"]) / 2.0])]
    rots = [np.eye(3), np.eye(3)]
    for i in range(4):
        masses.append(arms["m"])
        inertias.append(_box_inertia(arm_l, arms["w"], arms["h"], arms["m"]))
        poses.append(arms_coord[:, i])
        rots.append(_yaw_mat(arm_angles[i]))
    for i in range(4):
        masses.append(motors["m"])
        inertias.append(_cylinder_inertia(motors["h"], motors["r"], motors["m"]))
        poses.append(motors_coord[:, i])
        rots.append(np.eye(3))
    for i in range(4):
        masses.append(props["m"])
        inertias.append(_cylinder_inertia(props["h"], props["r"], props["m"]))
        poses.append(props_coord[:, i])
        rots.append(np.eye(3))

    masses = np.array(masses)
    total_m = masses.sum()
    com = sum(m * p for m, p in zip(masses, poses)) / total_m
    total_inertia = np.zeros((3, 3))
    for m, inertia, pose, rot in zip(masses, inertias, poses, rots):
        total_inertia += _translate_inertia(rot @ inertia @ rot.T, m, pose - com)
    return {
        "mass": float(total_m),
        "inertia": np.diagonal(total_inertia).copy(),
        "prop_pos": motors_coord.T - com,
        "arm": float(np.linalg.norm(motor_xyz[:2])),
    }


@dataclasses.dataclass
class DynamicsParams(Struct):
    """Flat numeric parameters of one (shared) quad model, as CPU tensors."""

    mass: torch.Tensor
    inertia: torch.Tensor             # (3,) diagonal
    thrust_max: torch.Tensor          # (4,)
    torque_max: torch.Tensor          # (4,)
    prop_pos: torch.Tensor            # (4, 3)
    prop_crossproducts: torch.Tensor  # (4, 3)
    prop_ccw: torch.Tensor            # (4,)
    motor_linearity: torch.Tensor
    motor_tau_up: torch.Tensor
    motor_tau_down: torch.Tensor
    thrust_noise_ratio: torch.Tensor
    vel_damp: torch.Tensor
    damp_omega_quadratic: torch.Tensor
    c_drag: torch.Tensor
    c_roll: torch.Tensor
    arm: torch.Tensor
    torque_to_inertia: torch.Tensor   # (3,) obs-space metadata only

    @classmethod
    def from_model(cls, model_params: dict, dt: float = 1.0 / 200
                   ) -> "DynamicsParams":
        geom, motor = model_params["geom"], model_params["motor"]
        derived = compute_quad_inertia(geom)
        mass, inertia = derived["mass"], derived["inertia"]
        assym = np.array(motor.get("assymetry", [1.0] * 4), dtype=np.float64)
        assym = assym * 4.0 / assym.sum()
        thrust_max = GRAV * mass * motor["thrust_to_weight"] * assym / 4.0
        torque_max = motor["torque_to_thrust"] * thrust_max
        prop_pos = derived["prop_pos"]
        prop_crossproducts = np.cross(prop_pos, np.array([0.0, 0.0, 1.0]))
        prop_ccw = np.array([-1.0, 1.0, -1.0, 1.0])
        prop_ccw_mx = np.zeros((3, 4))
        prop_ccw_mx[2, :] = prop_ccw
        g_omega = (1.0 / inertia)[:, None] * (
            thrust_max * prop_crossproducts.T + torque_max * prop_ccw_mx)
        tti = np.sum(g_omega @ np.array(
            [[0.0, 0.0, 0.0], [0.0, 1.0, 1.0], [1.0, 1.0, 0.0],
             [1.0, 0.0, 1.0]]), axis=1)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float64))
        return cls(
            mass=t(mass), inertia=t(inertia), thrust_max=t(thrust_max),
            torque_max=t(torque_max), prop_pos=t(prop_pos),
            prop_crossproducts=t(prop_crossproducts), prop_ccw=t(prop_ccw),
            motor_linearity=t(motor["linearity"]),
            motor_tau_up=t(4 * dt / (motor["damp_time_up"] + EPS)),
            motor_tau_down=t(4 * dt / (motor["damp_time_down"] + EPS)),
            thrust_noise_ratio=t(model_params["noise"]["thrust_noise_ratio"]),
            vel_damp=t(model_params["damp"]["vel"]),
            damp_omega_quadratic=t(model_params["damp"]["omega_quadratic"]),
            c_drag=t(motor["C_drag"]), c_roll=t(motor["C_roll"]),
            arm=t(derived["arm"]), torque_to_inertia=t(tti))

    def to(self, device, dtype) -> "DynamicsParams":
        return DynamicsParams(**{
            f.name: getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)})


def make_dynamics_params(quad: str = "Crazyflie", per_drone: bool = False,
                         dt: float = 1.0 / 200,
                         dtype=torch.float32) -> DynamicsParams:
    """Shared parameters of a named preset.  Per-drone fleets (and the
    randomized samplers) are not ported yet and raise."""
    if quad not in QUAD_PRESETS or per_drone:
        raise NotImplementedError(
            "only the shared Crazyflie preset is ported; per-drone and "
            "randomized fleets are not")
    return DynamicsParams.from_model(QUAD_PRESETS[quad](), dt=dt).to(
        "cpu", dtype)
