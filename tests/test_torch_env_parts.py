"""Parity of the PyTorch port's per-drone env pieces with the JAX package.

Same inputs, made from a numpy seed, go through each quadswarm_tpu function
and its quadswarm_tpu_torch counterpart on the CPU.  Where the point is the
algorithm the comparison is in float64 (atol 1e-10).  Random draws are
injected into both: the port through its `draws` / draw arguments, the JAX
package through its own seams (`set_response_tape`) or, where it has none,
a stand-in for `jax.random` inside the one module under test that hands
out the same recorded draws in call order (`taped`).

Also holds the helpers the other tests/test_torch_*.py files share.
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from quadswarm_tpu.env import collisions as j_coll
from quadswarm_tpu.env import controls as j_controls
from quadswarm_tpu.env import downwash as j_downwash
from quadswarm_tpu.env import dynamics as j_dyn
from quadswarm_tpu.env import multi as j_multi
from quadswarm_tpu.env import neighbors as j_neighbors
from quadswarm_tpu.env import obs as j_obs
from quadswarm_tpu.env import params as j_params
from quadswarm_tpu.env import reward as j_reward
from quadswarm_tpu.env import scenarios as j_scen
from quadswarm_tpu.env import sensor as j_sensor
from quadswarm_tpu.ops import rotations as j_rot
from quadswarm_tpu_torch.env import collisions as t_coll
from quadswarm_tpu_torch.env import controls as t_controls
from quadswarm_tpu_torch.env import downwash as t_downwash
from quadswarm_tpu_torch.env import dynamics as t_dyn
from quadswarm_tpu_torch.env import neighbors as t_neighbors
from quadswarm_tpu_torch.env import obs as t_obs
from quadswarm_tpu_torch.env import params as t_params
from quadswarm_tpu_torch.env import reward as t_reward
from quadswarm_tpu_torch.env import sensor as t_sensor
from quadswarm_tpu_torch.ops import rotations as t_rot
from quadswarm_tpu_torch.utils.convert import dynamics_params_from_numpy
from quadswarm_tpu_torch.utils.struct import leaves

F64 = dict(rtol=0.0, atol=1e-10)


# --------------------------------------------------------------------------
# Shared helpers
# --------------------------------------------------------------------------

class _TapeRandom:
    """Stands in for `jax.random` in one JAX module: `normal` and `uniform`
    return the next recorded unit draw (uniform mapped to [minval, maxval)
    the way jax.random.uniform maps its bits); key handling is real."""

    def __init__(self, draws):
        # traced draws (a jitted reference) stay as they are
        self.draws = [d if isinstance(d, jax.Array) else np.asarray(d)
                      for d in draws]

    def split(self, key, num=2):
        return jax.random.split(key, num)

    def fold_in(self, key, data):
        return jax.random.fold_in(key, data)

    def _next(self, shape, dtype):
        draw = self.draws.pop(0)
        assert draw.shape == tuple(shape), (draw.shape, shape)
        return jnp.asarray(draw, dtype)

    def normal(self, key, shape=(), dtype=jnp.float32):
        return self._next(shape, dtype)

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                maxval=1.0):
        return self._next(shape, dtype) * (maxval - minval) + minval


class _JaxShim:
    def __init__(self, random):
        self.random = random

    def __getattr__(self, name):
        return getattr(jax, name)


@contextlib.contextmanager
def taped(module, draws):
    """Run `module`'s jax.random calls from `draws`, in call order."""
    rnd = _TapeRandom(draws)
    original = module.jax
    module.jax = _JaxShim(rnd)
    try:
        yield
    finally:
        module.jax = original
    assert not rnd.draws, f"{len(rnd.draws)} recorded draws left unused"


def jax_tree_numpy(state) -> dict:
    """A flax struct (e.g. EnvState) as a nested dict of numpy arrays."""
    return jax.tree.map(np.asarray, serialization.to_state_dict(state))


def assert_matches_jax(port_obj, jax_obj, skip=(), tol=None,
                       field_tol=None):
    """Every leaf of a port state against the JAX state's leaf of the same
    dotted name: exact for bool/int, else within tol."""
    tol = tol or dict(rtol=2e-4, atol=2e-5)
    flat = traverse_util.flatten_dict(jax_tree_numpy(jax_obj), sep=".")
    for name, val in leaves(port_obj):
        if name in skip or name.split(".")[-1] in skip:
            continue
        got = val.detach().cpu().numpy()
        want = flat[name]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            t = (field_tol or {}).get(name.split(".")[-1], tol)
            np.testing.assert_allclose(got, want, err_msg=name, **t)


def _jax_array(t: torch.Tensor):
    """A port tensor as a JAX array of its dtype (bfloat16 through numpy's
    float32, exactly)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _jax_state(tstate):
    """A port EnvState as the JAX package's, its scenario key zero: the
    lockstep tests start from a port reset carried over (a JAX reset
    compiles for half a minute) and play few enough ticks that no
    scenario draws after reset."""
    def build(cls, obj):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name == "scen_key":
                kwargs[f.name] = jnp.zeros(obj.scen_seed.shape + (2,),
                                           jnp.uint32)
                continue
            val = getattr(obj, f.name)
            sub = {"dyn": j_dyn.DroneState, "scenario": j_scen.ScenarioState,
                   "rew_coeff": j_reward.RewardCoeffs}.get(f.name)
            kwargs[f.name] = (build(sub, val) if sub is not None
                              else _jax_array(val))
        return cls(**kwargs)
    return build(j_multi.EnvState, tstate)


def t64(x):
    return torch.as_tensor(np.array(x, np.float64))


def j64(x):
    return jnp.asarray(np.asarray(x, np.float64))


def random_rotations(rng, b):
    q, r = np.linalg.qr(rng.standard_normal((b, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q


# --------------------------------------------------------------------------
# Parameters, rotations, control
# --------------------------------------------------------------------------

def test_crazyflie_params_and_inertia():
    want = j_params.DynamicsParams.from_model(j_params.crazyflie_params())
    got = t_params.DynamicsParams.from_model(t_params.crazyflie_params())
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                   np.asarray(getattr(want, f.name)),
                                   rtol=1e-12, atol=0, err_msg=f.name)
    inertia = t_params.compute_quad_inertia(
        t_params.crazyflie_params()["geom"])
    ref = j_params.compute_quad_inertia(j_params.crazyflie_params()["geom"])
    np.testing.assert_allclose(inertia["inertia"], ref["inertia"], rtol=1e-12)
    assert inertia["mass"] == ref["mass"] and inertia["arm"] == ref["arm"]
    # carried across from the JAX params: the same values, field by field
    carried = dynamics_params_from_numpy(
        {f.name: np.asarray(getattr(want, f.name))
         for f in dataclasses.fields(got)})
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(getattr(carried, f.name).numpy(),
                                   getattr(got, f.name).numpy(),
                                   rtol=1e-12, atol=0, err_msg=f.name)
    # a per-drone fleet: the same stacked values as the JAX package's, bit
    # for bit in float64
    want = j_params.make_dynamics_params(
        num_agents=3, per_drone=True, dtype=np.float64,
        dyn_sampler_1={"class": "RelativeSampler", "noise_ratio": 0.2})
    got = t_params.make_dynamics_params(
        num_agents=3, per_drone=True, dtype=torch.float64,
        dyn_sampler_1={"class": "RelativeSampler", "noise_ratio": 0.2})
    assert got.per_drone and got.mass.shape == (3,)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)


def test_rotations_float64():
    rng = np.random.default_rng(0)
    rot = random_rotations(rng, 64)
    w = rng.normal(0, 5, (64, 3))
    w[0] = 0.0                                     # identity branch
    np.testing.assert_allclose(t_rot.rodrigues(t64(w), 0.005).numpy(),
                               np.asarray(j_rot.rodrigues(j64(w), 0.005)),
                               **F64)
    near = rot + 1e-3 * rng.standard_normal(rot.shape)
    np.testing.assert_allclose(t_rot.reorthonormalize(t64(near)).numpy(),
                               np.asarray(j_rot.reorthonormalize(j64(near))),
                               **F64)
    q = np.asarray(j_rot.rot2quat(j64(rot)))
    np.testing.assert_allclose(t_rot.rot2quat(t64(rot)).numpy(), q, **F64)
    np.testing.assert_allclose(t_rot.quat2rot(t64(q)).numpy(),
                               np.asarray(j_rot.quat2rot(j64(q))), **F64)
    q2 = rng.standard_normal((64, 4))
    np.testing.assert_allclose(t_rot.quat_mul(t64(q), t64(q2)).numpy(),
                               np.asarray(j_rot.quat_mul(j64(q), j64(q2))),
                               **F64)
    theta = rng.normal(0, 1.5, (64, 3))            # both small/big branches
    np.testing.assert_allclose(
        t_rot.quat_from_small_angle(t64(theta)).numpy(),
        np.asarray(j_rot.quat_from_small_angle(j64(theta))), **F64)
    yaw = rng.uniform(-np.pi, np.pi, 64)
    np.testing.assert_allclose(t_rot.yaw_rot(t64(yaw)).numpy(),
                               np.asarray(j_rot.yaw_rot(j64(yaw))), **F64)


@pytest.mark.parametrize("zero_action_middle", [True, False])
def test_raw_control(zero_action_middle):
    a = np.random.default_rng(1).uniform(-1.5, 1.5, (10, 4))
    np.testing.assert_allclose(
        t_controls.apply_control("raw", t64(a),
                                 zero_action_middle=zero_action_middle),
        np.asarray(j_controls.raw_control(j64(a), zero_action_middle)), **F64)
    # a model-based mode through the same dispatch: Mellinger toward a goal
    rng = np.random.default_rng(11)
    params = t_params.make_dynamics_params(dtype=torch.float64)
    j_inv = t_controls.jacobian_inv(params)
    state = t_dyn.init_state((10,), torch.float64).replace(
        pos=t64(rng.normal(0, 1, (10, 3))), vel=t64(rng.normal(0, 1, (10, 3))),
        rot=t64(random_rotations(rng, 10)),
        omega=t64(rng.normal(0, 1, (10, 3))))
    goal = rng.normal(0, 3, (10, 3))
    got = t_controls.apply_control("mellinger", t64(a), j_inv=j_inv,
                                   state=state, goal=t64(goal))
    want = j_controls.mellinger_control(
        j64(j_inv.numpy()), j64(state.pos.numpy()), j64(state.vel.numpy()),
        j64(state.rot.numpy()), j64(state.omega.numpy()), j64(goal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


# --------------------------------------------------------------------------
# Sensor noise, observations, neighbors, reward
# --------------------------------------------------------------------------

def test_sensor_noise_with_injected_draws():
    rng = np.random.default_rng(2)
    n = 8
    pos, vel, omega, acc = (rng.normal(0, 2, (n, 3)) for _ in range(4))
    rot = random_rotations(rng, n)
    names = ["pos_n", "pos_u", "vel_n", "vel_u", "omega_n", "theta_n",
             "theta_u", "acc_n", "acc_dyn_n"]
    raw = {k: rng.standard_normal((n, 3)) if k.endswith("_n")
           else rng.uniform(0, 1, (n, 3)) for k in names}
    params = dict(pos_unif_range=0.01, vel_unif_range=0.02,
                  quat_norm_std=0.05, quat_unif_range=0.03)
    with taped(j_sensor, [raw[k] for k in names]):
        want = j_sensor.add_noise(
            j_sensor.SensorNoiseParams(**params), jax.random.PRNGKey(0),
            j64(pos), j64(vel), j64(rot), j64(omega), j64(acc), 0.005)
    got = t_sensor.add_noise(
        t_sensor.SensorNoiseParams(**params), t64(pos), t64(vel), t64(rot),
        t64(omega), t64(acc), 0.005,
        draws={k: t64(v) for k, v in raw.items()})
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)


@pytest.mark.parametrize("repr_name", ["xyz_vxyz_R_omega",
                                       "xyz_vxyz_R_omega_floor",
                                       "xyz_vxyz_R_omega_wall"])
def test_self_obs(repr_name):
    rng = np.random.default_rng(3)
    pos, vel, omega, goal = (rng.normal(0, 3, (8, 3)) for _ in range(4))
    rot = random_rotations(rng, 8)
    box = ((-5.0, -5.0, 0.0), (5.0, 5.0, 10.0))
    got = t_obs.self_obs(repr_name, t64(pos), t64(vel), t64(rot), t64(omega),
                         t64(goal), box)
    want = j_obs.self_obs(repr_name, j64(pos), j64(vel), j64(rot), j64(omega),
                          j64(goal), box)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    assert got.shape[-1] == t_obs.obs_size(repr_name, "none", 0, False)


@pytest.mark.parametrize("k", [3, 7])
def test_neighbor_obs(k):
    rng = np.random.default_rng(4)
    pos = rng.normal(0, 2, (8, 3))
    vel = rng.normal(0, 1, (8, 3))
    lo, hi = j_neighbors.neighbor_clip_bounds(k, (10.0, 10.0, 10.0), 3.0,
                                              jnp.float64)
    tlo, thi = t_neighbors.neighbor_clip_bounds(k, (10.0, 10.0, 10.0), 3.0,
                                                torch.float64)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo))
    got = t_neighbors.neighbor_obs(t64(pos), t64(vel), k, tlo, thi)
    want = j_neighbors.neighbor_obs(j64(pos), j64(vel), k, lo, hi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


def test_neighbor_ties_break_by_lowest_index():
    """Drones 1..4 sit at the same distance from drone 0 with zero
    velocity: equal metrics, so the lowest indices must win, in order."""
    pos = np.zeros((6, 3))
    pos[1:5] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]]
    pos[5] = [5.0, 5.0, 5.0]
    vel = np.zeros((6, 3))
    want = np.asarray(j_neighbors.neighbor_indices(j64(pos), j64(vel), 3))
    got = t_neighbors.neighbor_indices(t64(pos), t64(vel), 3).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [1, 2, 3])
    # batched over a leading env axis
    got_b = t_neighbors.neighbor_indices(t64(pos)[None].expand(2, 6, 3),
                                         t64(vel)[None].expand(2, 6, 3), 3)
    np.testing.assert_array_equal(got_b[1].numpy(), want)


def test_reward_and_proximity_penalty():
    rng = np.random.default_rng(5)
    n = 8
    pos, goal, omega = (rng.normal(0, 2, (n, 3)) for _ in range(3))
    action = rng.uniform(-1, 1, (n, 4))
    rot = random_rotations(rng, n)
    on_floor = rng.uniform(0, 1, n) < 0.3
    coeff = dict(pos=1.0, effort=0.05, crash=1.0, orient=1.0, spin=0.1)
    want, winfo = j_reward.compute_reward(
        j_reward.RewardCoeffs(**coeff), j64(pos), j64(goal), j64(action),
        j64(rot), j64(omega), jnp.asarray(on_floor), 0.005)
    got, ginfo = t_reward.compute_reward(
        t_reward.RewardCoeffs(**coeff), t64(pos), t64(goal), t64(action),
        t64(rot), t64(omega), torch.as_tensor(on_floor), 0.005)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    for g, w in zip(ginfo, winfo):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    dist = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    mask = dist <= 2.0
    np.testing.assert_allclose(
        t_reward.proximity_penalties(t64(dist), torch.as_tensor(mask), 2.0,
                                     10.0, 0.01).numpy(),
        np.asarray(j_reward.proximity_penalties(j64(dist), jnp.asarray(mask),
                                                2.0, 10.0, 0.01)), **F64)


# --------------------------------------------------------------------------
# Collisions and downwash
# --------------------------------------------------------------------------

def test_drone_collision_response_with_tape():
    rng = np.random.default_rng(6)
    n = 6
    pos = rng.normal(0, 0.05, (n, 3))
    vel, omega = rng.normal(0, 1, (n, 3)), rng.normal(0, 1, (n, 3))
    mask = np.zeros((n, n), bool)
    for i, j in [(0, 1), (0, 3), (2, 4)]:          # drone 0 has two partners
        mask[i, j] = mask[j, i] = True
    normals = rng.standard_normal((n, 3, 3, 3))
    uniforms = rng.uniform(0, 1, (n, 6))
    j_coll.set_response_tape({"drone_normals": normals,
                              "drone_uniforms": uniforms})
    try:
        want = j_coll.drone_collision_response(
            jax.random.PRNGKey(0), j64(pos), j64(vel), j64(omega),
            jnp.asarray(mask))
    finally:
        j_coll.set_response_tape(None)
    got = t_coll.drone_collision_response(
        t64(pos), t64(vel), t64(omega), torch.as_tensor(mask), None,
        t64(normals), t64(uniforms))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    dist, hit = t_coll.collision_matrix(t64(pos), 0.05)
    jdist, jhit = j_coll.collision_matrix(j64(pos), 0.05)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), **F64)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))


def test_drawn_collision_response_shares_pair_draws():
    """Without injected draws, both drones of a pair use the same row, so
    the conserved noise cancels in the pair's total momentum change."""
    gen = torch.Generator().manual_seed(0)
    pos = torch.tensor([[0.0, 0.0, 1.0], [0.05, 0.0, 1.0], [3.0, 0, 1]])
    vel = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0, 0]])
    mask = torch.zeros((3, 3), dtype=torch.bool)
    mask[0, 1] = mask[1, 0] = True
    new_vel, new_omega = t_coll.drone_collision_response(
        pos, vel, torch.zeros_like(vel), mask, gen)
    assert torch.equal(new_vel[2], vel[2])
    # the omega kicks of a pair are opposite: same draw row, sign by role
    torch.testing.assert_close(new_omega[0], -new_omega[1])


@pytest.mark.parametrize("surface", ["wall", "ceiling"])
def test_room_collision_response(surface):
    rng = np.random.default_rng(7)
    n = 6
    pos = rng.uniform(-5, 5, (n, 3))
    pos[0, 0], pos[1, 1], pos[2, 0] = -5.0, 5.0, 5.0
    vel, omega = rng.normal(0, 2, (n, 3)), rng.normal(0, 1, (n, 3))
    hit = np.array([True, True, True, False, True, False])
    box = ((-5.0, -5.0, 0.0), (5.0, 5.0, 10.0))
    u = rng.uniform(0, 1, (n, 11 if surface == "wall" else 10))
    with taped(j_coll, [u]):
        if surface == "wall":
            want = j_coll.wall_collision_response(
                jax.random.PRNGKey(0), j64(pos), j64(vel), j64(omega), box,
                jnp.asarray(hit))
        else:
            want = j_coll.ceiling_collision_response(
                jax.random.PRNGKey(0), j64(vel), j64(omega), jnp.asarray(hit))
    if surface == "wall":
        got = t_coll.wall_collision_response(
            t64(pos), t64(vel), t64(omega), box, torch.as_tensor(hit),
            uniforms=t64(u))
    else:
        got = t_coll.ceiling_collision_response(
            t64(vel), t64(omega), torch.as_tensor(hit), uniforms=t64(u))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)


def test_downwash_with_injected_draws():
    rng = np.random.default_rng(8)
    n = 6
    pos = rng.uniform(-1, 1, (n, 3))
    pos[1] = pos[0] + [0.02, -0.03, -0.3]          # under drone 0
    pos[2] = pos[0] + [0.0, 0.05, -0.6]            # also under drone 0
    pos[4] = pos[3] + [0.01, 0.0, -0.2]            # under drone 3
    rot = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    vel, omega = rng.normal(0, 1, (n, 3)), rng.normal(0, 1, (n, 3))
    raw = {"acc": rng.uniform(0, 1, (n, 1)), "omega": rng.uniform(0, 1, (n, 1)),
           "axis": rng.uniform(0, 1, (n, 3)), "dir": rng.uniform(0, 1, (n, 3))}
    with taped(j_downwash, [raw[k] for k in ("acc", "omega", "axis", "dir")]):
        want = j_downwash.apply_downwash(jax.random.PRNGKey(0), j64(pos),
                                         j64(vel), j64(omega), j64(rot), 0.01)
    got = t_downwash.apply_downwash(t64(pos), t64(vel), t64(omega), t64(rot),
                                    0.01, draws={k: t64(v)
                                                 for k, v in raw.items()})
    assert np.asarray(want[2]).sum() == 3
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)


# --------------------------------------------------------------------------
# Formations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 5])
def test_formation_goals(n):
    from quadswarm_tpu.env import formations as j_form
    from quadswarm_tpu_torch.env import formations as t_form

    center = np.array([0.3, -1.0, 2.0])
    # the formation id is data: one compile serves all eight
    j_goals = jax.jit(j_form.generate_goals, static_argnums=(0, 6))
    for fid in range(t_form.NUM_FORMATIONS):
        npl = 50 if 4 <= fid <= 6 else 8
        want = j_goals(n, jnp.int32(fid), j64(center), j64(0.7), j64(0.4),
                       jnp.int32(npl), jnp.float64)
        got = t_form.generate_goals(n, fid, t64(center), 0.7, 0.4, npl,
                                    torch.float64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64,
                                   err_msg=f"formation {fid}")
    # the batched affine form, float32 tables, one env per formation
    fids = np.arange(8)
    centers = np.random.default_rng(9).normal(0, 1, (8, 3)).astype(np.float32)
    want = j_form.generate_goals_affine(n, jnp.asarray(fids),
                                        jnp.asarray(centers),
                                        jnp.full(8, 0.7, jnp.float32),
                                        jnp.full(8, 0.4, jnp.float32),
                                        jnp.float32)
    got = t_form.generate_goals_affine(n, torch.as_tensor(fids),
                                       torch.as_tensor(centers),
                                       torch.full((8,), 0.7),
                                       torch.full((8,), 0.4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
