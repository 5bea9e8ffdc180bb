"""The plain version of the dynamics kernel K1, frozen: the port's
`ops/kernels/dynamics_kernel.py` as it stood when the benchmark was written,
without the CUDA launch.  `dynamics_tick_fused` takes the plain route on
every device.
"""
from __future__ import annotations

import torch

from portbench.reference.qs.env.dynamics import (
    DroneState, DynamicsConfig, dynamics_tick,
)
from portbench.reference.qs.utils.struct import map_fields

_FLOAT_IN_FIELDS = ("pos", "vel", "rot", "omega", "thrust_cmds_damp",
              "thrust_rot_damp", "on_floor", "step_count")[:6]


def _float32_inputs(state: DroneState, thrust_cmds, ou_state,
                    rand_yaw_theta) -> tuple:
    """K1's inputs cast to float32 (the Pallas wrapper's `f32` planes)."""
    return (state.replace(**{f: getattr(state, f).float()
                             for f in _FLOAT_IN_FIELDS}),
            thrust_cmds.float(), ou_state.float(), rand_yaw_theta.float())


def _in_dtype(out: DroneState, dtype, ou_state) -> DroneState:
    """K1's float32 outputs cast back to the state's dtype, carrying the
    tick's OU state as it came."""
    return map_fields(lambda x: x.to(dtype) if x.is_floating_point() else x,
                      out).replace(ou_state=ou_state)


def dynamics_tick_flat(params, cfg: DynamicsConfig, state: DroneState,
                       thrust_cmds, ou_state, rand_yaw_theta) -> DroneState:
    """The plain version of one kernel call on a flat batch: per-drone
    params of N rows fly drone b with row b % N (the batch seen as
    (B / N, N)); shared params as they are.  In float32 whatever the
    state's float dtype, as the kernel."""
    if state.pos.dtype != torch.float32:
        out = dynamics_tick_flat(params, cfg, *_float32_inputs(
            state, thrust_cmds, ou_state, rand_yaw_theta))
        return _in_dtype(out, state.pos.dtype, ou_state)
    if not params.per_drone:
        return dynamics_tick(params, cfg, state, thrust_cmds, ou_state,
                             rand_yaw_theta)
    b, n = state.pos.shape[0], params.mass.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} drones is no whole number of "
                         f"fleets of the params' {n} drones")
    split = lambda x: x.reshape((b // n, n) + x.shape[1:])
    out = dynamics_tick(params, cfg, map_fields(split, state),
                        split(thrust_cmds), split(ou_state),
                        split(rand_yaw_theta))
    return map_fields(lambda x: x.reshape((b,) + x.shape[2:]), out)


def dynamics_tick_fused(params, cfg: DynamicsConfig, state: DroneState,
                        thrust_cmds, ou_state, rand_yaw_theta) -> DroneState:
    """K1's output from the plain version."""
    if cfg.use_rotor_drag:
        raise NotImplementedError("rotor drag is not in the dynamics kernel")
    return dynamics_tick_flat(params, cfg, state, thrust_cmds, ou_state,
                              rand_yaw_theta)
