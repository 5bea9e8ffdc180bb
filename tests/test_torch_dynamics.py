"""Parity of the port's dynamics and its fused kernel K1 with the JAX package.

The port's `dynamics_substep` is held to the JAX one with injected noise and
crash yaw (float64 where the point is the algorithm, float32 at the
per-tick tolerance of tests/test_pallas_dynamics.py); and K1's plain version
to the JAX Pallas kernel run in interpret mode on branch-covering states.
K1 itself is held to its plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.env import dynamics as j_dyn
from quadswarm_tpu.env.params import make_dynamics_params as j_make_params
from quadswarm_tpu.ops.pallas import dynamics_kernel as j_kernel
from quadswarm_tpu_torch.env import dynamics as t_dyn
from quadswarm_tpu_torch.env.params import make_dynamics_params as t_make_params
from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as t_kernel
from quadswarm_tpu_torch.utils.convert import drone_state_from_numpy

from .test_pallas_dynamics import FIELDS, _random_state
from .test_torch_env_parts import assert_matches_jax, jax_tree_numpy

# Per-tick float32 tolerance of the JAX package's kernel test.  omega_dot
# divides torque sums that cancel to ~1e-4 N m by the ~1.4e-5 kg m^2
# inertia, so a last-bit difference moves it by up to ~1e-4 rad/s^2.
F32_TOL = dict(rtol=2e-4, atol=2e-5)
F32_FIELD_TOL = {"omega_dot": dict(rtol=2e-4, atol=1e-3)}
F64_TOL = dict(rtol=0.0, atol=1e-10)

# The JAX sub-step compiled once per (config, dtype, shapes) and reused by
# every call of a test, where calling it eagerly would trace it each time.
_j_substep = jax.jit(j_dyn.dynamics_substep, static_argnums=1)


def _inputs(seed: int, b: int, cfg, dtype=np.float32):
    rng = np.random.default_rng(seed)
    state = _random_state(rng, b, cfg)
    state = jax.tree.map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, state)
    cmds = rng.uniform(0, 1, (b, 4)).astype(dtype)
    noise = (0.01 * rng.standard_normal((b, 4))).astype(dtype)
    yaw = rng.uniform(-np.pi, np.pi, b).astype(dtype)
    return state, cmds, noise, yaw


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dynamics_substep_matches_jax(dtype):
    np_dtype = np.dtype(dtype)
    j_cfg = j_dyn.DynamicsConfig(orthonormalize_every=7)
    t_cfg = t_dyn.DynamicsConfig(orthonormalize_every=7)
    j_params = j_make_params(dtype=np_dtype)
    t_params = t_make_params(dtype=getattr(torch, dtype))
    jstate, cmds, noise, yaw = _inputs(0, 200, j_cfg, np_dtype)
    tstate = drone_state_from_numpy(jax_tree_numpy(jstate))
    if dtype == "float64":
        tstate = tstate.replace(**{
            f: getattr(tstate, f).double() for f in
            ("pos", "vel", "rot", "omega", "thrust_cmds_damp",
             "thrust_rot_damp", "acc", "accelerometer", "omega_dot", "torque",
             "ou_state")})
    tcmds, tnoise, tyaw = (torch.from_numpy(x) for x in (cmds, noise, yaw))
    # float64: three chained sub-steps (through floor and ortho events);
    # float32: one, as a single sub-step from a settled drone leaves a
    # near-zero floor velocity whose friction direction amplifies rounding.
    for _ in range(3 if dtype == "float64" else 1):
        jstate = _j_substep(j_params, j_cfg, jstate, jnp.asarray(cmds),
                            jnp.asarray(noise), jnp.asarray(yaw))
        tstate = t_dyn.dynamics_substep(t_params, t_cfg, tstate, tcmds,
                                        tnoise, tyaw)
        if dtype == "float64":
            assert_matches_jax(tstate, jstate, tol=F64_TOL)
        else:
            assert_matches_jax(tstate, jstate, tol=F32_TOL,
                               field_tol=F32_FIELD_TOL)


def test_dynamics_step_draw_seam_matches_jax():
    """dynamics_step with the JAX step's own OU normals and crash-yaw
    uniforms injected equals the JAX dynamics_step with its key."""
    cfg = j_dyn.DynamicsConfig()
    j_params, t_params = j_make_params(), t_make_params()
    b = 64
    jstate, cmds, _, _ = _inputs(1, b, cfg)
    key = jax.random.PRNGKey(5)
    want = jax.jit(j_dyn.dynamics_step, static_argnums=1)(
        j_params, cfg, jstate, jnp.asarray(cmds), key)
    noise_key, yaw_key = jax.random.split(key)
    normal = jax.random.normal(noise_key, (b, 4), jnp.float32)
    yaw = jax.random.uniform(yaw_key, (b,), jnp.float32, -jnp.pi, jnp.pi)
    got = t_dyn.dynamics_step(
        t_params, t_dyn.DynamicsConfig(),
        drone_state_from_numpy(jax_tree_numpy(jstate)),
        torch.from_numpy(cmds), ou_normal=torch.from_numpy(np.asarray(normal)),
        rand_yaw_theta=torch.from_numpy(np.asarray(yaw)))
    assert_matches_jax(got, want, tol=F32_TOL, field_tol=F32_FIELD_TOL)


def test_kernel_param_vector_matches_tpu_layout():
    cfg = j_dyn.DynamicsConfig(floor_threshold=0.046)
    want = np.asarray(j_kernel._param_vector(j_make_params(), cfg))
    got = t_kernel.param_vector(t_make_params(),
                                t_dyn.DynamicsConfig(floor_threshold=0.046))
    np.testing.assert_array_equal(got, want)


def test_kernel_param_table_rows_match_tpu_layout():
    """K1's per-drone table: row i is the TPU kernel's parameter vector of
    drone i's parameters."""
    cfg = j_dyn.DynamicsConfig(floor_threshold=0.046)
    kw = dict(num_agents=5, per_drone=True, seed=4,
              dyn_sampler_1={"class": "RelativeSampler", "noise_ratio": 0.2})
    j_fleet = j_make_params(**kw)
    got = t_kernel.param_table(t_make_params(**kw),
                               t_dyn.DynamicsConfig(floor_threshold=0.046))
    assert got.shape == (5, t_kernel.N_PARAMS) and got.dtype == np.float32
    for i in range(5):
        row = jax.tree.map(lambda x: np.asarray(x)[i], j_fleet)
        np.testing.assert_array_equal(
            got[i], np.asarray(j_kernel._param_vector(row, cfg)))
    assert len(np.unique(got[:, 9])) == 5          # five masses


@pytest.mark.parametrize("b", [300])
def test_kernel_plain_version_matches_pallas_kernel(b):
    """K1's CPU route (its plain version) against the Pallas kernel in
    interpret mode, on states covering every floor branch and the ortho
    trigger; b is ragged (not a multiple of 128)."""
    cfg = j_dyn.DynamicsConfig()
    jstate, cmds, noise, yaw = _inputs(2, b, cfg)
    want = j_kernel.dynamics_step_planes(
        j_make_params(), cfg, jstate, jnp.asarray(cmds), jnp.asarray(noise),
        jnp.asarray(yaw), interpret=True)
    got = t_kernel.dynamics_tick_fused(
        t_make_params(), t_dyn.DynamicsConfig(),
        drone_state_from_numpy(jax_tree_numpy(jstate)),
        torch.from_numpy(cmds), torch.from_numpy(noise), torch.from_numpy(yaw))
    # the Pallas kernel passes omega_dot, torque and ou_state through
    assert_matches_jax(got, want, skip=("omega_dot", "torque", "ou_state"),
                       tol=F32_TOL)
    assert set(FIELDS) <= {f for f in t_kernel._OUT_FIELDS}


def test_kernel_wrapper_has_no_fallback():
    """A tensor that is neither on the CPU nor on a CUDA device raises; the
    wrapper never quietly takes the plain path for it."""
    state = t_dyn.init_state((4,), torch.float32, "meta")
    meta = lambda *s: torch.empty(s, device="meta")
    before = t_kernel.dynamics_tick_fused.launches
    with pytest.raises(ValueError, match="unsupported device"):
        t_kernel.dynamics_tick_fused(t_make_params(), t_dyn.DynamicsConfig(),
                                     state, meta(4, 4), meta(4, 4), meta(4))
    assert t_kernel.dynamics_tick_fused.launches == before


# --------------------------------------------------------------------------
# Rotor drag (plain dynamics only) and per-drone parameters
# --------------------------------------------------------------------------

DRAG = {"motor": {"C_drag": 0.02, "C_roll": 0.01}}


def _jax_substep_per_drone(params, cfg, per_drone):
    """JAX's dynamics_substep one drone at a time, as its env vmaps it (its
    rotor drag takes one drone's state), jitted once per case."""
    return jax.jit(jax.vmap(
        lambda p, s, c, n, y: j_dyn.dynamics_substep(p, cfg, s, c, n, y),
        in_axes=(0 if per_drone else None, 0, 0, 0, 0)))


@pytest.mark.parametrize("per_drone", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rotor_drag_matches_jax(dtype, per_drone):
    """Sub-steps with use_rotor_drag and nonzero C_drag / C_roll (through
    `dynamics_change`), shared or per drone, against JAX's: float64 over 3
    chained sub-steps at atol 1e-10, float32 over one at the per-tick
    tolerance."""
    np_dtype = np.dtype(dtype)
    j_cfg = j_dyn.DynamicsConfig(orthonormalize_every=7, use_rotor_drag=True)
    t_cfg = t_dyn.DynamicsConfig(orthonormalize_every=7, use_rotor_drag=True)
    b = 64
    kw = dict(dynamics_change=DRAG, num_agents=b, per_drone=per_drone,
              dyn_sampler_1={"class": "RelativeSampler", "noise_ratio": 0.2}
              if per_drone else None)
    j_params = j_make_params(dtype=np_dtype, **kw)
    t_params = t_make_params(dtype=getattr(torch, dtype), **kw)
    assert float(np.min(np.asarray(j_params.c_drag))) > 0.01
    jstate, cmds, noise, yaw = _inputs(3, b, j_cfg, np_dtype)
    tstate = drone_state_from_numpy(jax_tree_numpy(jstate))
    if dtype == "float64":
        tstate = tstate.replace(**{
            f: getattr(tstate, f).double() for f in
            ("pos", "vel", "rot", "omega", "thrust_cmds_damp",
             "thrust_rot_damp", "acc", "accelerometer", "omega_dot", "torque",
             "ou_state")})
    tcmds, tnoise, tyaw = (torch.from_numpy(x) for x in (cmds, noise, yaw))
    no_drag = t_dyn.dynamics_substep(
        t_params, t_dyn.DynamicsConfig(orthonormalize_every=7), tstate, tcmds,
        tnoise, tyaw)
    j_substep = _jax_substep_per_drone(j_params, j_cfg, per_drone)
    for _ in range(3 if dtype == "float64" else 1):
        jstate = j_substep(j_params, jstate, jnp.asarray(cmds),
                           jnp.asarray(noise), jnp.asarray(yaw))
        tstate = t_dyn.dynamics_substep(t_params, t_cfg, tstate, tcmds,
                                        tnoise, tyaw)
        if dtype == "float64":
            assert_matches_jax(tstate, jstate, tol=F64_TOL)
            if no_drag is not None:     # the drag term moved the drones
                assert not torch.allclose(tstate.torque, no_drag.torque)
                no_drag = None
        else:
            assert_matches_jax(tstate, jstate, tol=F32_TOL,
                               field_tol=F32_FIELD_TOL)


def _numpy_rotor_drag(p: dict, rot, vel, omega, cmds_damp, dt):
    """The reference's rotor drag for one drone, restated in NumPy: each
    rotor's in-plane air velocity, its drag force and rolling moment, both
    totals clipped so they cannot reverse the body velocity or spin within
    two sub-steps."""
    vel_body = rot.T @ vel
    force, torque = np.zeros(3), np.zeros(3)
    for m in range(4):
        v = vel_body + np.cross(omega, p["prop_pos"][m])
        v[2] = 0.0
        f = -p["c_drag"] * np.sqrt(cmds_damp[m]) * v
        force += f
        torque += np.cross(f, p["prop_pos"][m])
        torque += -p["c_roll"] * p["prop_ccw"][m] * np.sqrt(cmds_damp[m]) * v

    def clip(x, cap):
        n = np.linalg.norm(x)
        return x / max(n, EPS_NP) * min(n, cap) if n > EPS_NP else x

    force = clip(force, np.linalg.norm(vel_body) * p["mass"] / (2 * dt))
    torque = clip(torque, np.linalg.norm(omega * p["inertia"]) / (2 * dt))
    return force, torque


EPS_NP = 1e-6


def test_rotor_drag_term_against_numpy_restatement():
    rng = np.random.default_rng(4)
    params = t_make_params(dtype=torch.float64, dynamics_change=DRAG)
    state, _, _, _ = _inputs(5, 32, j_dyn.DynamicsConfig(), np.float64)
    t_state = drone_state_from_numpy(jax_tree_numpy(state))
    t_state = t_state.replace(**{f: getattr(t_state, f).double() for f in
                                 ("pos", "vel", "rot", "omega")})
    cmds = rng.uniform(0, 1, (32, 4))
    force, torque = t_dyn._rotor_drag(params, t_state, torch.from_numpy(cmds),
                                      0.005)
    p = {k: np.asarray(getattr(params, k).numpy()) for k in
         ("c_drag", "c_roll", "prop_pos", "prop_ccw", "mass", "inertia")}
    for i in range(32):
        f, t = _numpy_rotor_drag(p, t_state.rot[i].numpy(),
                                 t_state.vel[i].numpy(),
                                 t_state.omega[i].numpy(), cmds[i], 0.005)
        np.testing.assert_allclose(force[i].numpy(), f, **F64_TOL)
        np.testing.assert_allclose(torque[i].numpy(), t, **F64_TOL)


def test_per_drone_drag_path_matches_numpy_oracle():
    """A per-drone fleet (RelativeSampler, noise 0.2) through the drag path
    with C_drag = C_roll = 0, 40 sub-steps of near-hover flight in float64,
    against tests/oracle_dynamics.py drone by drone (each with its own
    parameters): the drag path adds nothing and every drone flies its own
    row."""
    from .oracle_dynamics import oracle_init_state, oracle_params, oracle_substep

    n = 4
    params = t_make_params(dtype=torch.float64, num_agents=n, per_drone=True,
                           dyn_sampler_1={"class": "RelativeSampler",
                                          "noise_ratio": 0.2})
    cfg = t_dyn.DynamicsConfig(use_rotor_drag=True)
    rng = np.random.default_rng(6)
    oracles = []
    for i in range(n):
        o = oracle_init_state()
        o["pos"] = np.array([0.5 * i, -0.3, 2.0])
        o["vel"] = rng.normal(0, 0.2, 3)
        o["omega"] = rng.normal(0, 0.3, 3)
        oracles.append(o)
    stack = lambda k: torch.from_numpy(np.stack([o[k] for o in oracles]))
    state = t_dyn.init_state((n,), torch.float64).replace(
        pos=stack("pos"), vel=stack("vel"), omega=stack("omega"))
    op = [oracle_params(type("P", (), {
        f: getattr(params, f)[i].numpy() for f in (
            "mass", "inertia", "thrust_max", "torque_max",
            "prop_crossproducts", "prop_ccw", "motor_linearity",
            "motor_tau_up", "motor_tau_down", "vel_damp",
            "damp_omega_quadratic")})) for i in range(n)]
    lo, hi = np.array(cfg.room_box[0]), np.array(cfg.room_box[1])
    for _ in range(40):
        cmds = rng.uniform(0.4, 0.8, (n, 4))
        noise = 0.01 * rng.standard_normal((n, 4))
        state = t_dyn.dynamics_substep(params, cfg, state,
                                       torch.from_numpy(cmds),
                                       torch.from_numpy(noise),
                                       torch.zeros(n, dtype=torch.float64))
        oracles = [oracle_substep(op[i], oracles[i], cmds[i], noise[i],
                                  cfg.dt, lo, hi,
                                  floor_threshold=cfg.floor_threshold)
                   for i in range(n)]
    for key, field in (("pos", "pos"), ("vel", "vel"), ("rot", "rot"),
                       ("omega", "omega"), ("acc", "acc")):
        np.testing.assert_allclose(getattr(state, field).numpy(),
                                   stack(key).numpy(), **F64_TOL,
                                   err_msg=field)
    assert len(np.unique(np.round(state.pos[:, 2].numpy(), 9))) == n


def test_kernel_refuses_rotor_drag_and_flat_per_drone_batches():
    """K1's wrapper refuses rotor drag (the TPU kernel has none) and a flat
    batch that is no whole number of fleets of the per-drone params; its
    CPU route flies drone b of a flat batch with row b % N."""
    cfg = j_dyn.DynamicsConfig()
    jstate, cmds, noise, yaw = _inputs(7, 12, cfg)
    state = drone_state_from_numpy(jax_tree_numpy(jstate))
    args = (state, torch.from_numpy(cmds), torch.from_numpy(noise),
            torch.from_numpy(yaw))
    with pytest.raises(NotImplementedError, match="TPU kernel"):
        t_kernel.dynamics_tick_fused(
            t_make_params(), t_dyn.DynamicsConfig(use_rotor_drag=True), *args)
    fleet = t_make_params(num_agents=4, per_drone=True,
                          dyn_sampler_1={"class": "RandomQuad"})
    got = t_kernel.dynamics_tick_fused(fleet, t_dyn.DynamicsConfig(), *args)
    split = lambda x: x.reshape((3, 4) + x.shape[1:])
    want = t_dyn.dynamics_tick(fleet, t_dyn.DynamicsConfig(),
                               *(t_kernel.map_fields(split, a) for a in args))
    for name in ("pos", "vel", "omega", "on_floor"):
        assert torch.equal(getattr(got, name), getattr(want, name).reshape(
            getattr(got, name).shape)), name
    with pytest.raises(ValueError, match="whole number"):
        t_kernel.dynamics_tick_fused(
            t_make_params(num_agents=5, per_drone=True,
                          dyn_sampler_1={"class": "RandomQuad"}),
            t_dyn.DynamicsConfig(), *args)
