"""Controllers: policy action -> normalized motor thrusts.

Port of quadswarm_tpu/env/controls.py, limited to `raw` control (the one
training uses).  The other modes are not ported yet and raise.
"""
from __future__ import annotations

import torch

CONTROL_MODES = ("raw", "vertical", "vert_plane", "omega", "velocity_yaw",
                 "mellinger")


def raw_control(action: torch.Tensor,
                zero_action_middle: bool = True) -> torch.Tensor:
    """Clip to the action box and map affinely to [0, 1] thrusts."""
    if zero_action_middle:
        return 0.5 * (torch.clamp(action, -1.0, 1.0) + 1.0)
    return torch.clamp(action, 0.0, 1.0)


def apply_control(mode: str, action: torch.Tensor, *,
                  zero_action_middle: bool = True) -> torch.Tensor:
    if mode == "raw":
        return raw_control(action, zero_action_middle)
    if mode in CONTROL_MODES:
        raise NotImplementedError(f"control mode {mode!r} is not ported yet")
    raise ValueError(f"unknown control mode: {mode}")


def action_dim(mode: str) -> int:
    return {"raw": 4, "vertical": 1, "vert_plane": 2, "omega": 4,
            "velocity_yaw": 4, "mellinger": 4}[mode]
