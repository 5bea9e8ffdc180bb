"""State objects handed to the reference: a recorded state of the program
(dataclasses of tensors) rebuilt, field by field, as the frozen copy's
classes of the same names, its tensors copied; and the walk over such
trees that the drivers' copies use."""
from __future__ import annotations

import dataclasses
import sys

import torch

from portbench.reference.qs.env import (  # noqa: F401  (registers classes)
    dynamics, multi, obstacles, replay, reward, scenarios,
)


def _classes() -> dict:
    found = {}
    prefix = "portbench.reference.qs."
    for name, mod in list(sys.modules.items()):
        if not name.startswith(prefix) or mod is None:
            continue
        for attr in vars(mod).values():
            if (isinstance(attr, type) and dataclasses.is_dataclass(attr)
                    and attr.__module__.startswith(prefix)):
                found[attr.__name__] = attr
    return found


def to_reference(obj, device=None):
    """A copy of `obj` made of the reference's classes and fresh tensors, on
    `device` (where the tensors are, if None)."""
    classes = _classes()

    def conv(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            cls = classes[type(x).__name__]
            return cls(**{f.name: conv(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
        if isinstance(x, torch.Tensor):
            # the reference computes in float32 (a control's bfloat16
            # state is widened)
            x = x.detach()
            dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
            return x.to(device or x.device, dtype, copy=True)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(conv(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return x
    return conv(obj)


def tree_map(fn, obj):
    """`obj` (dataclasses, named tuples, tuples, lists and dicts of them)
    with every tensor `t` replaced by `fn(t)`, the classes kept."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_map(fn, v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_map(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    return obj
