"""Parity of the port's controllers with the JAX package.

Each of the six control modes goes through the port's `apply_control` and
the JAX function of the same name on 64 random drone states, actions and
goals made with numpy: within atol 1e-9 in float64, and within rtol 1e-5
(plus atol 1e-6 for thrusts near 0, the float32 rounding of the products
through J^-1) in float32.  J^-1 is held to the JAX package's for shared
and per-drone params, and a per-drone table broadcasts over the env axis
as the JAX package's vmap over drones does.  The JAX functions run eagerly
on small arrays; nothing is jitted.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.env import controls as j_controls
from quadswarm_tpu.env import params as j_params
from quadswarm_tpu_torch.env import controls as t_controls
from quadswarm_tpu_torch.env import dynamics as t_dyn
from quadswarm_tpu_torch.env import params as t_params

from .test_torch_env_parts import random_rotations

B = 64
TOL = {"float64": dict(rtol=0.0, atol=1e-9),
       "float32": dict(rtol=1e-5, atol=1e-6)}
PER_DRONE = dict(per_drone=True, num_agents=4, seed=2,
                 dyn_sampler_1={"class": "RelativeSampler",
                                "noise_ratio": 0.2})


def _inputs(seed: int, shape: tuple, dtype: str) -> dict:
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.normal(0, 1, shape + s)
    b = int(np.prod(shape))
    return {k: v.astype(dtype) for k, v in dict(
        pos=2 * g(3), vel=g(3), omega=3 * g(3),
        rot=random_rotations(rng, b).reshape(shape + (3, 3)),
        goal=np.concatenate([3 * g(2), 2 + g(1)], -1),
        action=rng.uniform(-1.5, 1.5, shape + (4,))).items()}


def _jax(mode: str, j_inv, x: dict, zero_action_middle: bool):
    a = jnp.asarray(x["action"])
    if mode == "raw":
        return j_controls.raw_control(a, zero_action_middle)
    if mode == "vertical":
        return j_controls.vertical_control(a[..., :1], zero_action_middle)
    if mode == "vert_plane":
        return j_controls.vert_plane_control(a[..., :2], zero_action_middle)
    if mode == "omega":
        return j_controls.omega_thrust_control(j_inv, x["omega"], a)
    s = [jnp.asarray(x[k]) for k in ("pos", "vel", "rot", "omega")]
    if mode == "velocity_yaw":
        return j_controls.velocity_yaw_control(j_inv, *s, a)
    return j_controls.mellinger_control(j_inv, *s, jnp.asarray(x["goal"]))


def _port(mode: str, j_inv, x: dict, zero_action_middle: bool):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    state = t_dyn.init_state(t["pos"].shape[:-1], t["pos"].dtype).replace(
        pos=t["pos"], vel=t["vel"], rot=t["rot"], omega=t["omega"])
    action = t["action"][..., :t_controls.action_dim(mode)]
    return t_controls.apply_control(mode, action, j_inv=j_inv, state=state,
                                    goal=t["goal"],
                                    zero_action_middle=zero_action_middle)


# zero_action_middle is read by raw, vertical and vert_plane only.
CASES = [(m, z) for m in t_controls.CONTROL_MODES for z in (True, False)
         if z or m not in t_controls.JACOBIAN_MODES]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode,zero_action_middle", CASES)
def test_control_mode_matches_jax(mode, zero_action_middle, dtype):
    x = _inputs(1, (B,), dtype)
    params = t_params.make_dynamics_params(dtype=getattr(torch, dtype))
    j_inv = t_controls.control_jacobian_inv(params, "cpu",
                                            getattr(torch, dtype))
    got = _port(mode, j_inv, x, zero_action_middle)
    want = _jax(mode, jnp.asarray(j_inv.numpy()), x, zero_action_middle)
    assert got.shape == (B, 4) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])
    # vertical and vert_plane scale before they clip, to [-1, 1] (the
    # reference's quirk; the motor filter clips to [0, 1])
    low = -1.0 if mode in ("vertical", "vert_plane") and zero_action_middle \
        else 0.0
    assert float(got.min()) >= low and float(got.max()) <= 1.0


def test_jacobian_inverse_matches_jax():
    """J^-1 of shared and per-drone params against the JAX package's, in
    float64; the port's is computed once per (params, device, dtype)."""
    for kwargs in ({}, PER_DRONE):
        jp = j_params.make_dynamics_params(dtype=np.float64, **kwargs)
        tp = t_params.make_dynamics_params(dtype=torch.float64, **kwargs)
        if kwargs:
            want = jax.vmap(j_controls.jacobian_inv)(jp)
        else:
            want = j_controls.jacobian_inv(jp)
        got = t_controls.jacobian_inv(tp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(
            t_controls.quadrotor_jacobian(tp).numpy(),
            np.asarray(j_controls.quadrotor_jacobian(jp)) if not kwargs
            else np.stack([j_controls.quadrotor_jacobian(
                jax.tree.map(lambda v: np.asarray(v)[i], jp))
                for i in range(4)]), rtol=1e-12, atol=0)
    f32 = t_controls.control_jacobian_inv(tp, "cpu", torch.float32)
    assert f32.shape == (4, 4, 4) and f32.dtype == torch.float32
    assert t_controls.control_jacobian_inv(tp, "cpu", torch.float32) is f32


@pytest.mark.parametrize("mode", t_controls.JACOBIAN_MODES)
def test_per_drone_table_broadcasts_over_envs(mode):
    """A per-drone J^-1 (N, 4, 4) against (E, N) states: drone i of every
    env uses row i, as the JAX package's vmap over drones."""
    e, n = 3, 4
    x = _inputs(2, (e, n), "float64")
    jp = j_params.make_dynamics_params(dtype=np.float64, **PER_DRONE)
    tp = t_params.make_dynamics_params(dtype=torch.float64, **PER_DRONE)
    j_inv = t_controls.control_jacobian_inv(tp, "cpu", torch.float64)
    got = _port(mode, j_inv, x, True)
    j_table = jax.vmap(j_controls.jacobian_inv)(jp)
    per_drone = jax.vmap(lambda j, xi: _jax(mode, j, xi, True),
                         in_axes=(0, 1), out_axes=1)
    want = per_drone(j_table, {k: jnp.asarray(v) for k, v in x.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float64"])


def test_velocity_yaw_control_hovers():
    """velocity_yaw at rest with a zero command gives equal, positive
    hover thrusts (tests/test_gym_api.py's case)."""
    p = t_params.make_dynamics_params()
    j_inv = t_controls.jacobian_inv(p).float()
    z = torch.zeros(3)
    t = t_controls.velocity_yaw_control(j_inv, z, z, torch.eye(3), z,
                                        torch.zeros(4))
    assert t.shape == (4,) and bool(((t >= 0) & (t <= 1)).all())
    assert torch.allclose(t, t[0].expand(4), atol=1e-6) and float(t[0]) > 0
    assert t_controls.action_dim("velocity_yaw") == 4
