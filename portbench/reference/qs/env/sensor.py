"""Sensor noise model.

Port of quadswarm_tpu/env/sensor.py.  `apply_noise` is the deterministic
half (pre-sampled noise vectors in, noisy state out); `add_noise` draws the
vectors from the caller's generator unless `draws` supplies them.

`draws` holds the raw draws of one call, keyed as below, each shaped like
`pos`: standard normals "pos_n", "vel_n", "omega_n", "theta_n", "acc_n",
"acc_dyn_n" and unit uniforms "pos_u", "vel_u", "theta_u".  A uniform whose
range (or a normal whose std) is zero in the parameters contributes
nothing and is not drawn.  Under the gyro random-walk model
(`gyro_norm_std != 0` and a `gyro_bias` given) "omega_n" is not drawn;
the standard normals "gyro_bias_n" (the bias step, the JAX package's
`keys[4]`) and "gyro_walk_n" (the random walk, its `keys[5]`) take its
place.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference.qs.ops.rotations import (
    quat2rot, quat_from_small_angle, quat_mul, rot2quat,
)


@dataclasses.dataclass(frozen=True)
class SensorNoiseParams:
    """Defaults of the training configuration (`sense_noise='default'`)."""

    pos_norm_std: float = 0.005
    pos_unif_range: float = 0.0
    vel_norm_std: float = 0.01
    vel_unif_range: float = 0.0
    quat_norm_std: float = 0.0
    quat_unif_range: float = 0.0
    gyro_norm_std: float = 0.0
    gyro_noise_density: float = 0.000175
    gyro_random_walk: float = 0.0105
    gyro_bias_correlation_time: float = 1000.0
    acc_static_noise_std: float = 0.002
    acc_dynamic_noise_ratio: float = 0.005
    bypass: bool = False


def apply_noise(params: SensorNoiseParams, pos, vel, rot, omega, acc,
                pos_noise, vel_noise, omega_noise, theta, acc_noise):
    """Apply pre-sampled noise vectors."""
    del params
    noisy_rot = quat2rot(quat_mul(rot2quat(rot), quat_from_small_angle(theta)))
    return (pos + pos_noise, vel + vel_noise, noisy_rot, omega + omega_noise,
            acc + acc_noise)


def add_noise(params: SensorNoiseParams, pos, vel, rot, omega, acc,
              dt: float, gyro_bias=None, gen: torch.Generator | None = None,
              draws: dict | None = None):
    """Noisy (pos, vel, rot, omega, acc, gyro_bias) given the true state."""
    if params.bypass:
        return pos, vel, rot, omega, acc, gyro_bias
    draws = {} if draws is None else draws
    shape = pos.shape

    def normal(name, std):
        # std * N(0, 1); a zero std adds nothing and is not drawn.
        if std == 0.0:
            return 0.0
        n = draws[name] if name in draws else torch.randn(
            shape, generator=gen, dtype=pos.dtype, device=pos.device)
        return std * n

    def uniform(name, rng):
        # U(-rng, rng) as lo + (hi - lo) * u; a zero range adds nothing.
        if rng == 0.0:
            return 0.0
        u = draws[name] if name in draws else torch.rand(
            shape, generator=gen, dtype=pos.dtype, device=pos.device)
        return u * (2 * rng) - rng

    pos_noise = normal("pos_n", params.pos_norm_std) + uniform(
        "pos_u", params.pos_unif_range)
    vel_noise = normal("vel_n", params.vel_norm_std) + uniform(
        "vel_u", params.vel_unif_range)
    if params.gyro_norm_std != 0.0 and gyro_bias is not None:
        # the RotorS IMU bias model: a first-order Gauss-Markov bias plus
        # white noise of std gyro_random_walk
        sigma_g_d = params.gyro_noise_density / math.sqrt(dt)
        tau = params.gyro_bias_correlation_time
        sigma_b_g_d = math.sqrt(-(sigma_g_d ** 2) * (tau / 2)
                                * (math.exp(-2 * dt / tau) - 1.0))
        gyro_bias = math.exp(-dt / tau) * gyro_bias + normal(
            "gyro_bias_n", sigma_b_g_d)
        omega_noise = gyro_bias + normal("gyro_walk_n",
                                         params.gyro_random_walk)
    else:
        omega_noise = normal("omega_n", params.gyro_noise_density)
    theta = normal("theta_n", params.quat_norm_std) + uniform(
        "theta_u", params.quat_unif_range)
    acc_noise = normal("acc_n", params.acc_static_noise_std) + acc * normal(
        "acc_dyn_n", params.acc_dynamic_noise_ratio)
    theta = theta + torch.zeros_like(pos)
    out = apply_noise(params, pos, vel, rot, omega, acc, pos_noise,
                      vel_noise, omega_noise, theta, acc_noise)
    return (*out, gyro_bias)

