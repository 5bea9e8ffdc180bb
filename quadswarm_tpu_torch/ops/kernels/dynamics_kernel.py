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

The outputs come from three arenas per call (float32, bool, int32; see
`arena_layout`): every field of the returned state is a contiguous view of
one of them, with the shape and dtype the plain version gives it.  The
wrapper's host work is kept small because the env step pays it every tick:
inputs are checked in one pass against shapes cached by batch size, and the
ctypes pointer block is reused between calls (so the wrapper is not
re-entrant: one thread launches at a time).

`dynamics_tick_fused` takes a CPU state to the plain version
(env/dynamics.py::dynamics_tick) and a CUDA state to the kernel; there is
no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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

# The kernel's 11 inputs, in the order of its pointer block: the state's
# input fields, then the tick's thrust commands, OU state and crash yaw.
_IN_NAMES = _IN_FIELDS + ("thrust_cmds", "ou_state", "rand_yaw_theta")
_IN_TRAILING = tuple(_TRAILING[f] for f in _IN_FIELDS) + ((4,), (4,), ())
_IN_DTYPES = tuple(_DTYPES.get(f, torch.float32) for f in _IN_NAMES)
# The (B, 4) inputs, which the kernel reads as one 16-byte word per drone.
_IN_WIDE = tuple(k for k, trailing in enumerate(_IN_TRAILING)
                 if trailing == (4,))

# Output arenas, a layout shared with csrc/dynamics_kernel.cu.  Float arena:
# these fields in this order, each starting on a multiple of 4 floats (16
# bytes).  Bool arena: the four flags, B each.  Int arena: step_count.
ARENA_FLOAT_FIELDS = ("pos", "vel", "omega", "acc", "accelerometer",
                      "omega_dot", "torque", "rot", "thrust_cmds_damp",
                      "thrust_rot_damp")
ARENA_BOOL_FIELDS = ("on_floor", "crashed_floor", "crashed_wall",
                     "crashed_ceiling")
assert set(ARENA_FLOAT_FIELDS + ARENA_BOOL_FIELDS + ("step_count",)) \
    == set(_OUT_FIELDS)


class ArenaLayout(NamedTuple):
    """The float output arena for a batch of B drones: its size in floats,
    and each field's (name, offset in floats, shape, strides) in it."""
    float_numel: int
    float_fields: tuple


@functools.lru_cache(maxsize=64)
def arena_layout(b: int) -> ArenaLayout:
    """Where the kernel writes its outputs for B drones.  The float fields
    hold 38 * B floats; each starts on a 16-byte boundary, so when B is no
    multiple of 4 up to 3 floats of padding follow a field."""
    fields, offset = [], 0
    for name in ARENA_FLOAT_FIELDS:
        shape = (b,) + _TRAILING[name]
        strides = tuple(int(np.prod(shape[k + 1:], dtype=np.int64))
                        for k in range(len(shape)))
        fields.append((name, offset, shape, strides))
        offset += -(-int(np.prod(shape, dtype=np.int64)) // 4) * 4
    return ArenaLayout(offset, tuple(fields))


def output_arenas(b: int, device) -> tuple:
    """Allocate the three arenas for B drones (the call's only allocations)
    and cut them into fields.  Returns ((float, bool, int32 arena), {field
    name: contiguous view})."""
    layout = arena_layout(b)
    arena_f = torch.empty(layout.float_numel, dtype=torch.float32,
                          device=device)
    arena_b = torch.empty((len(ARENA_BOOL_FIELDS), b), dtype=torch.bool,
                          device=device)
    arena_i = torch.empty(b, dtype=torch.int32, device=device)
    views = {name: torch.as_strided(arena_f, shape, strides, offset)
             for name, offset, shape, strides in layout.float_fields}
    views.update(zip(ARENA_BOOL_FIELDS, arena_b.unbind(0)))
    views["step_count"] = arena_i
    return (arena_f, arena_b, arena_i), views


@functools.lru_cache(maxsize=64)
def _input_shapes(b: int) -> tuple:
    return tuple((b,) + trailing for trailing in _IN_TRAILING)


def kernel_inputs(state: DroneState, thrust_cmds, ou_state,
                  rand_yaw_theta) -> tuple:
    """The kernel's 11 inputs, in the order of its pointer block."""
    return tuple(getattr(state, f) for f in _IN_FIELDS) + (
        thrust_cmds, ou_state, rand_yaw_theta)


def check_inputs(inputs: tuple, b: int, device) -> None:
    """Raise unless each of the kernel's 11 inputs (in the order of
    `_IN_NAMES`) is on `device`, of its dtype, of its shape for B drones and
    contiguous, and each (B, 4) input starts on a 16-byte boundary (as a
    fresh tensor, a field of the kernel's own output and any row slice of
    either do).  One pass; the message is built only on a failure."""
    shapes = _input_shapes(b)
    for k, t in enumerate(inputs):
        if (t.shape != shapes[k] or t.dtype != _IN_DTYPES[k]
                or t.device != device or not t.is_contiguous()):
            build.check_tensor(_IN_NAMES[k], t, shapes[k], _IN_DTYPES[k],
                               device)
    for k in _IN_WIDE:
        if inputs[k].data_ptr() % 16:
            raise ValueError(f"{_IN_NAMES[k]}: starts at address "
                             f"{inputs[k].data_ptr():#x}, not on a 16-byte "
                             "boundary")


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
    lib.qs_dynamics_block_threads.argtypes = []
    lib.qs_dynamics_block_threads.restype = ctypes.c_int
    lib.qs_launch_floor.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.qs_launch_floor.restype = ctypes.c_int
    lib.qs_error_string.argtypes = [ctypes.c_int]
    lib.qs_error_string.restype = ctypes.c_char_p
    lib.ready = True
    return lib


# The kernel's pointer block: 11 inputs, then the three output arenas.
_PTRS = (ctypes.c_void_p * (len(_IN_NAMES) + 3))()


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
    inputs = kernel_inputs(state, thrust_cmds, ou_state, rand_yaw_theta)
    check_inputs(inputs, b, device)
    arenas, outs = output_arenas(b, device)
    for k, t in enumerate(inputs + arenas):
        _PTRS[k] = t.data_ptr()
    lib = _load()
    rc = lib.qs_dynamics_step(_param_buffer(params, cfg), cfg.sim_steps,
                              cfg.orthonormalize_every, b, _PTRS,
                              build.current_stream(device))
    if rc != 0:
        raise RuntimeError("dynamics kernel launch failed: "
                           + lib.qs_error_string(rc).decode())
    dynamics_tick_fused.launches += 1
    return DroneState(ou_state=ou_state, **outs)


dynamics_tick_fused.launches = 0


def block_threads() -> int:
    """Threads (drones) per block of the built kernel."""
    return _load().qs_dynamics_block_threads()


def launch_floor(blocks: int, threads: int) -> None:
    """Launch an empty kernel of the given grid on the current stream: timed
    in a CUDA graph it gives the card's launch floor, the least any kernel
    of that grid can take.  Not counted as a launch of K1."""
    lib = _load()
    rc = lib.qs_launch_floor(blocks, threads,
                             build.current_stream(torch.device("cuda")))
    if rc != 0:
        raise RuntimeError("empty kernel launch failed: "
                           + lib.qs_error_string(rc).decode())
