"""Dataclasses of tensors: the port's counterpart of flax `struct.dataclass`.

A state object (DroneState, ScenarioState, EnvState, ...) is a plain
dataclass whose fields are tensors or nested state objects.  `replace`
returns a copy with some fields swapped; `map_fields` applies a function
leaf by leaf over one or more objects of the same structure, the way
`jax.tree.map` does over a pytree.
"""
from __future__ import annotations

import dataclasses

import torch


class Struct:
    """Mixin for tensor dataclasses."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def map_fields(fn, *objs):
    """Apply fn to matching leaves of dataclass trees; returns a new tree."""
    first = objs[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: map_fields(fn, *(getattr(o, f.name) for o in objs))
            for f in dataclasses.fields(first)})
    return fn(*objs)


def leaves(obj, prefix: str = ""):
    """(dotted name, tensor) pairs of a dataclass tree, in field order."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), prefix + f.name + ".")
    else:
        yield prefix[:-1], obj


def to_numpy(t: torch.Tensor):
    """A tensor on the host as numpy; bfloat16, which numpy lacks, as
    float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default; without a
    card that raises, and the caller must ask for the CPU explicitly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def require_float_dtype(dtype) -> None:
    """The port computes in float32 or bfloat16, as the JAX package does;
    any other dtype raises."""
    if dtype not in FLOAT_DTYPES:
        raise NotImplementedError(
            f"dtype {dtype} is not supported; the port runs float32 and "
            "bfloat16")
