"""K1: the fused dynamics kernel for Hopper, and its wrapper.

Replaces quadswarm_tpu/ops/pallas/dynamics_kernel.py::_dynamics_kernel (the
Pallas TPU kernel launched by `dynamics_step_planes`).  One launch runs one
control tick (cfg.sim_steps sub-steps) for a flat batch of drones: the
motor filter with OU noise, thrust and torques, the Rodrigues update,
Newton-polar re-orthonormalization, the damped Euler omega update, the room
clip with wall/ceiling flags, the floor friction state machine, velocity
damping and the accelerometer.  Source: csrc/dynamics_kernel.cu (one
thread per drone; see the note there on what bounds it).

The TPU wrapper packs every field into (38, R, 128) planes and unpacks the
result; this wrapper passes the fields' own row-major buffers instead.  The
OU noise and the crash yaw are drawn outside the kernel with the caller's
generator, as `dynamics_step_flat` draws them outside the Pallas kernel.

`dynamics_tick_fused` takes a CPU state to the plain version
(env/dynamics.py::dynamics_tick) and a CUDA state to the kernel; there is
no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from quadswarm_tpu_torch.env.dynamics import (
    DroneState, DynamicsConfig, dynamics_tick,
)
from quadswarm_tpu_torch.ops.kernels import build

SOURCE = "dynamics_kernel.cu"
N_PARAMS = 44

_IN_FIELDS = ("pos", "vel", "rot", "omega", "thrust_cmds_damp",
              "thrust_rot_damp", "on_floor", "step_count")
_OUT_FIELDS = ("pos", "vel", "rot", "omega", "thrust_cmds_damp",
               "thrust_rot_damp", "acc", "accelerometer", "omega_dot",
               "torque", "on_floor", "crashed_floor", "crashed_wall",
               "crashed_ceiling", "step_count")
_TRAILING = {"pos": (3,), "vel": (3,), "rot": (3, 3), "omega": (3,),
             "thrust_cmds_damp": (4,), "thrust_rot_damp": (4,), "acc": (3,),
             "accelerometer": (3,), "omega_dot": (3,), "torque": (3,),
             "on_floor": (), "crashed_floor": (), "crashed_wall": (),
             "crashed_ceiling": (), "step_count": ()}
_DTYPES = {"on_floor": torch.bool, "crashed_floor": torch.bool,
           "crashed_wall": torch.bool, "crashed_ceiling": torch.bool,
           "step_count": torch.int32}


def param_vector(params, cfg: DynamicsConfig) -> np.ndarray:
    """The 44 shared parameters in the kernel's layout (the TPU kernel's
    SMEM vector), as float32 on the host."""
    f = lambda x: np.asarray(x, np.float64).reshape(-1)
    vec = np.concatenate([
        f(cfg.dt), f(cfg.mu), f(cfg.omega_max), f(cfg.floor_threshold),
        f(cfg.gravity), f(params.vel_damp), f(params.motor_linearity),
        f(params.motor_tau_up), f(params.motor_tau_down), f(params.mass),
        f(params.inertia), f(params.damp_omega_quadratic),
        f(params.thrust_max), f(params.torque_max),
        f(params.prop_crossproducts), f(params.prop_ccw),
        f(cfg.room_box[0]), f(cfg.room_box[1]),
    ]).astype(np.float32)
    assert vec.shape == (N_PARAMS,)
    return vec


def _param_buffer(params, cfg: DynamicsConfig):
    """The parameter vector as a ctypes array, built once per (params, cfg)
    and kept on the params object (parameters are set-up values and are
    never modified in place)."""
    cache = params.__dict__.setdefault("_kernel_param_cache", {})
    if cfg not in cache:
        cache[cfg] = (ctypes.c_float * N_PARAMS)(*param_vector(params, cfg))
    return cache[cfg]


def _load():
    lib = build.load(SOURCE)
    if getattr(lib, "ready", False):
        return lib
    fn = lib.qs_dynamics_step
    fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.qs_error_string.argtypes = [ctypes.c_int]
    lib.qs_error_string.restype = ctypes.c_char_p
    lib.ready = True
    return lib


def dynamics_tick_fused(params, cfg: DynamicsConfig, state: DroneState,
                        thrust_cmds: torch.Tensor, ou_state: torch.Tensor,
                        rand_yaw_theta: torch.Tensor) -> DroneState:
    """One control tick for a flat batch: state leaves (B, ...), thrust
    commands and this tick's OU state (B, 4), crash yaw angles (B,).
    Returns the new DroneState, carrying `ou_state`."""
    if cfg.use_rotor_drag:
        raise NotImplementedError("rotor drag is not ported yet")
    device = state.pos.device
    if device.type == "cpu":
        return dynamics_tick(params, cfg, state, thrust_cmds, ou_state,
                             rand_yaw_theta)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    b = state.pos.shape[0]
    for name in _IN_FIELDS:
        build.check_tensor(name, getattr(state, name), (b,) + _TRAILING[name],
                           _DTYPES.get(name, torch.float32), device)
    for name, t, trailing in (("thrust_cmds", thrust_cmds, (4,)),
                              ("ou_state", ou_state, (4,)),
                              ("rand_yaw_theta", rand_yaw_theta, ())):
        build.check_tensor(name, t, (b,) + trailing, torch.float32, device)

    outs = {name: torch.empty((b,) + _TRAILING[name],
                              dtype=_DTYPES.get(name, torch.float32),
                              device=device)
            for name in _OUT_FIELDS}
    tensors = ([getattr(state, name) for name in _IN_FIELDS]
               + [thrust_cmds, ou_state, rand_yaw_theta]
               + [outs[name] for name in _OUT_FIELDS])
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    lib = _load()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.qs_dynamics_step(_param_buffer(params, cfg), cfg.sim_steps,
                              cfg.orthonormalize_every, b, ptrs, stream)
    if rc != 0:
        raise RuntimeError("dynamics kernel launch failed: "
                           + lib.qs_error_string(rc).decode())
    dynamics_tick_fused.launches += 1
    return state.replace(ou_state=ou_state, **outs)


dynamics_tick_fused.launches = 0
