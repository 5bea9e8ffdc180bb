"""Quadrotor parameter presets, composite inertia, domain randomization and
`DynamicsParams`.

Port of quadswarm_tpu/env/params.py: the four named presets, the
composite-rigid-body inertia model, the samplers of the reference's domain
randomization (relative, absolute and constant perturbations, fully random
quads) and `make_dynamics_params`, which builds a shared parameter set or,
with `per_drone=True`, one set per drone stacked along a leading axis.  The
samplers draw from `np.random.default_rng(seed)` on the host in the JAX
package's order, so the same arguments give the same parameters bit for
bit in float64.

The parameters are host-side set-up values, so `DynamicsParams` holds CPU
tensors.  The plain dynamics moves them to the state's device; the CUDA
kernel receives shared ones by value as a flat float vector and per-drone
ones as a table on the device (`ops/kernels/dynamics_kernel.py`), both
built once per params.
"""
from __future__ import annotations

import copy
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


def defaultquad_params() -> dict:
    """AscTec-Hummingbird-like default quad."""
    return {
        "geom": {
            "body": {"l": 0.1, "w": 0.1, "h": 0.085, "m": 0.5},
            "payload": {"l": 0.12, "w": 0.12, "h": 0.04, "m": 0.1},
            "arms": {"l": 0.1, "w": 0.015, "h": 0.015, "m": 0.025},
            "motors": {"h": 0.02, "r": 0.025, "m": 0.02},
            "propellers": {"h": 0.001, "r": 0.1, "m": 0.009},
            "motor_pos": {"xyz": [0.12, 0.12, 0.0]},
            "arms_pos": {"angle": 45.0, "z": 0.0},
            "payload_pos": {"xy": [0.0, 0.0], "z_sign": -1},
        },
        "damp": {"vel": 0.0, "omega_quadratic": 0.0},
        "noise": {"thrust_noise_ratio": 0.05},
        "motor": {
            "thrust_to_weight": 2.8,
            "assymetry": [1.0, 1.0, 1.0, 1.0],
            "torque_to_thrust": 0.05,
            "linearity": 1.0,
            "C_drag": 0.0,
            "C_roll": 0.0,
            "damp_time_up": 0.0,
            "damp_time_down": 0.0,
        },
    }


def mediumquad_params() -> dict:
    """Medium quad preset."""
    return {
        "geom": {
            "body": {"l": 0.04, "w": 0.04, "h": 0.04, "m": 0.04},
            "payload": {"l": 0.06, "w": 0.015, "h": 0.015, "m": 0.029},
            "arms": {"l": 0.04, "w": 0.01, "h": 0.003, "m": 0.006},
            "motors": {"h": 0.013, "r": 0.007, "m": 0.006},
            "propellers": {"h": 0.007, "r": 0.035, "m": 0.0012},
            "motor_pos": {"xyz": [0.046, 0.046, 0.0]},
            "arms_pos": {"angle": 45.0, "z": 0.0},
            "payload_pos": {"xy": [0.0, 0.0], "z_sign": -1},
        },
        "damp": {"vel": 0.0, "omega_quadratic": 0.0},
        "noise": {"thrust_noise_ratio": 0.05},
        "motor": {
            "thrust_to_weight": 2.5,
            "assymetry": [1.0, 1.0, 1.0, 1.0],
            "torque_to_thrust": 0.05,
            "linearity": 1.0,
            "C_drag": 0.0,
            "C_roll": 0.0,
            "damp_time_up": 0.15,
            "damp_time_down": 0.15,
        },
    }


def crazyflie_lowinertia_params() -> dict:
    """Low-inertia Crazyflie variant."""
    p = crazyflie_params()
    p["geom"]["body"]["m"] = 0.014
    p["geom"]["arms"]["m"] = 0.0005
    p["geom"]["motors"]["m"] = 0.0005
    p["geom"]["propellers"]["m"] = 0.0000075
    return p


QUAD_PRESETS = {
    "Crazyflie": crazyflie_params,
    "CrazyflieLowInertia": crazyflie_lowinertia_params,
    "DefaultQuad": defaultquad_params,
    "MediumQuad": mediumquad_params,
}


def dict_update_existing(dic: dict, upd: dict) -> None:
    """Recursively overwrite existing keys only."""
    for key in upd:
        if isinstance(dic.get(key), dict):
            dict_update_existing(dic[key], upd[key])
        else:
            dic[key] = upd[key]


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
    """Flat numeric parameters of a quad model, as CPU tensors: 0-d and
    small fields for a shared model, or with a leading per-drone axis
    (`stack`) for a randomized fleet, whose drone i of every env flies
    row i."""

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

    @property
    def per_drone(self) -> bool:
        """Whether the fields carry a leading per-drone axis."""
        return self.mass.dim() >= 1

    @staticmethod
    def stack(items: list) -> "DynamicsParams":
        """Stack per-drone parameter sets along a new leading axis."""
        return DynamicsParams(**{
            f.name: torch.stack([getattr(it, f.name) for it in items])
            for f in dataclasses.fields(DynamicsParams)})

    @staticmethod
    def tile(item: "DynamicsParams", n: int) -> "DynamicsParams":
        return DynamicsParams.stack([item] * n)


# --------------------------------------------------------------------------
# Domain randomization
# --------------------------------------------------------------------------

def check_quad_param_limits(params: dict, params_init: dict | None = None
                            ) -> dict:
    """Clamp sampled parameters to physical limits, in place."""
    p = params
    geom = p["geom"]
    body = geom["body"]
    body["w"] = body["l"] = float(np.clip(body["l"], 0.005, 0.3))
    body["h"] = float(np.clip(body["h"], 0.001, body["w"]))
    geom["motor_pos"]["xyz"][0] = float(
        np.clip(geom["motor_pos"]["xyz"][0], body["l"] / 2.0 + 0.005, 0.6))
    geom["motor_pos"]["xyz"][1] = geom["motor_pos"]["xyz"][0]
    geom["payload_pos"]["xy"] = list(
        np.clip(geom["payload_pos"]["xy"], -body["l"] / 2.0,
                body["l"] / 2.0))
    motor = p["motor"]
    motor["thrust_to_weight"] = float(
        np.clip(motor["thrust_to_weight"], 1.2, 5.0))
    motor["torque_to_thrust"] = float(
        np.clip(motor["torque_to_thrust"], 0.005, 1.0))
    motor["linearity"] = 1.0   # the firmware compensates the non-linearity
    motor["damp_time_up"] = float(np.clip(motor["damp_time_up"], 0.0, 1.0))
    motor["damp_time_down"] = float(
        np.clip(motor["damp_time_down"], 0.0, 1.0))
    p["noise"]["thrust_noise_ratio"] = float(
        np.clip(p["noise"]["thrust_noise_ratio"], 0.0, 0.3))
    p["damp"]["vel"] = float(np.clip(p["damp"]["vel"], 0.0, 1.0))
    p["damp"]["omega_quadratic"] = float(
        np.clip(p["damp"]["omega_quadratic"], 0.0, 1.0))
    return p


class ConstValueSampler:
    """Always returns the given params."""

    def __init__(self, params: dict | None = None):
        self.params = params

    def sample(self, params: dict | None = None) -> dict:
        return copy.deepcopy(params if params is not None else self.params)


class RelativeSampler:
    """Perturb every numeric leaf by relative noise of scale noise_ratio
    (normal, or uniform in +-noise_ratio)."""

    def __init__(self, params: dict | None = None, noise_ratio: float = 0.1,
                 sampler: str = "normal",
                 rng: np.random.Generator | None = None):
        self.params = params
        self.noise_ratio = noise_ratio
        self.sampler = sampler
        self.rng = rng or np.random.default_rng()

    def _noise(self):
        if self.sampler == "normal":
            return self.rng.normal(0.0, self.noise_ratio)
        return self.rng.uniform(-self.noise_ratio, self.noise_ratio)

    def _apply(self, value: float, noise: float) -> float:
        return value * (1.0 + noise)

    def _perturb(self, value):
        if isinstance(value, (list, tuple, np.ndarray)):
            return [self._perturb(v) for v in value]
        if not isinstance(value, (int, float)):
            return value
        return self._apply(float(value), self._noise())

    def sample(self, params: dict | None = None) -> dict:
        base = copy.deepcopy(params if params is not None else self.params)

        def walk(node):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v)
                else:
                    node[k] = self._perturb(v)

        walk(base)
        return check_quad_param_limits(base)


class AbsoluteSampler(RelativeSampler):
    """Perturb every numeric leaf by absolute noise of scale noise_ratio."""

    def _apply(self, value: float, noise: float) -> float:
        return value + noise


class _PresetSampler:
    def __init__(self, factory):
        self._factory = factory

    def sample(self, params: dict | None = None) -> dict:
        return self._factory()


def Crazyflie(**kwargs):  # noqa: N802 - the reference's sampler names
    return _PresetSampler(crazyflie_params)


def CrazyflieLowInertia(**kwargs):  # noqa: N802
    return _PresetSampler(crazyflie_lowinertia_params)


def DefaultQuad(**kwargs):  # noqa: N802
    return _PresetSampler(defaultquad_params)


def MediumQuad(**kwargs):  # noqa: N802
    return _PresetSampler(mediumquad_params)


class RandomQuad:
    """A fully random quad: body size, motor placement, masses from the
    volume at a random density, motor and damping values in the
    reference's ranges."""

    def __init__(self, rng: np.random.Generator | None = None, **kwargs):
        self.rng = rng or np.random.default_rng()

    def sample(self, params: dict | None = None) -> dict:
        rng = self.rng
        p = crazyflie_params()
        geom = p["geom"]
        body_l = rng.uniform(0.005, 0.3)
        geom["body"] = {"l": body_l, "w": body_l,
                        "h": rng.uniform(0.001, body_l), "m": 0.0}
        geom["body"]["m"] = 600.0 * rng.uniform(0.5, 2.0) * (
            geom["body"]["l"] * geom["body"]["w"] * geom["body"]["h"])
        motor_x = rng.uniform(body_l / 2.0 + 0.005, 0.6)
        geom["motor_pos"] = {"xyz": [motor_x, motor_x, 0.0]}
        geom["payload"]["m"] = geom["body"]["m"] * rng.uniform(0.3, 1.0)
        geom["arms"]["l"] = motor_x * np.sqrt(2.0) * rng.uniform(0.5, 1.0)
        p["motor"]["thrust_to_weight"] = rng.uniform(1.8, 2.5)
        p["motor"]["torque_to_thrust"] = rng.uniform(0.005, 0.025)
        p["motor"]["damp_time_up"] = rng.uniform(0.1, 0.2)
        p["motor"]["damp_time_down"] = p["motor"]["damp_time_up"]
        p["damp"]["omega_quadratic"] = rng.uniform(0.0, 0.05)
        p["noise"]["thrust_noise_ratio"] = rng.uniform(0.01, 0.05)
        return check_quad_param_limits(p)


DYN_SAMPLERS = {
    "Crazyflie": Crazyflie,
    "CrazyflieLowInertia": CrazyflieLowInertia,
    "DefaultQuad": DefaultQuad,
    "MediumQuad": MediumQuad,
    "RandomQuad": RandomQuad,
    "RelativeSampler": RelativeSampler,
    "AbsoluteSampler": AbsoluteSampler,
    "ConstValueSampler": ConstValueSampler,
}


def make_dynamics_params(quad: str = "Crazyflie",
                         dynamics_change: dict | None = None,
                         dyn_sampler_1: dict | None = None,
                         num_agents: int = 1, per_drone: bool = False,
                         dt: float = 1.0 / 200, seed: int = 0,
                         dtype=torch.float32) -> DynamicsParams:
    """Parameters as the reference's env factory builds them: the base
    sampler named by `quad`, the `dynamics_change` dict update, then the
    optional perturbation sampler `dyn_sampler_1` ({"class": name, ...its
    keyword arguments}).  With per_drone=True every one of `num_agents`
    drones gets its own draw, stacked along a leading axis."""
    rng = np.random.default_rng(seed)
    base_sampler = DYN_SAMPLERS[quad]()
    if hasattr(base_sampler, "rng"):
        base_sampler.rng = rng
    sampler_1 = None
    if dyn_sampler_1 is not None:
        kwargs = dict(dyn_sampler_1)
        cls_name = kwargs.pop("class", kwargs.pop("type", None))
        sampler_1 = DYN_SAMPLERS[cls_name](rng=rng, **kwargs)

    def sample_one() -> DynamicsParams:
        model = base_sampler.sample()
        if dynamics_change is not None:
            dict_update_existing(model, copy.deepcopy(dynamics_change))
        if sampler_1 is not None:
            model = sampler_1.sample(model)
        check_quad_param_limits(model)
        return DynamicsParams.from_model(model, dt=dt)

    if per_drone:
        params = DynamicsParams.stack([sample_one()
                                       for _ in range(num_agents)])
    else:
        params = sample_one()
    return params.to("cpu", dtype)
