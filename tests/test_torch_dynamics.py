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
        jstate = j_dyn.dynamics_substep(j_params, j_cfg, jstate,
                                        jnp.asarray(cmds), jnp.asarray(noise),
                                        jnp.asarray(yaw))
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
    want = j_dyn.dynamics_step(j_params, cfg, jstate, jnp.asarray(cmds), key)
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
