"""Checkpoint save/load with `torch.save`.

Port of quadswarm_tpu/utils/checkpoint.py: the same directory layout
(`<train_dir>/<experiment>/checkpoint_p0/`), tags (`checkpoint`, `best`),
`keep` pruning and file names with the zero-padded env-step count, here
`<tag>_<env_steps>.pt`.  A checkpoint holds the model's and the optimizer's
`state_dict`, the optimizer step, `env_steps` and, as `extra`, the
normalizer state, so a resume is exact.

The port does not read the JAX package's `.msgpack` checkpoints: `msgpack`
is not among the GPU machine's packages.  Weights cross between the packages
through `utils/convert.py` instead.
"""
from __future__ import annotations

import glob
import os
import re

import torch

from quadswarm_tpu_torch.parallel.normalize import (
    NormalizerState, RunningMeanStd,
)


def checkpoint_dir(train_dir: str, experiment: str, policy_id: int = 0) -> str:
    return os.path.join(train_dir, experiment, f"checkpoint_p{policy_id}")


def _norm_payload(norm: NormalizerState | None):
    if norm is None:
        return None
    field = lambda r: None if r is None else {
        "mean": r.mean.cpu(), "var": r.var.cpu(), "count": r.count.cpu()}
    return {"obs": field(norm.obs), "ret": field(norm.ret)}


def _norm_from_payload(payload: dict, device) -> NormalizerState:
    field = lambda d: None if d is None else RunningMeanStd(
        **{k: v.to(device) for k, v in d.items()})
    return NormalizerState(obs=field(payload["obs"]),
                           ret=field(payload["ret"]))


def save_checkpoint(path_dir: str, model, optimizer, step: int,
                    env_steps: int, keep: int = 3, tag: str = "checkpoint",
                    extra: NormalizerState | None = None) -> str:
    """Write `<tag>_<env_steps>.pt` and keep the newest `keep` of the tag."""
    os.makedirs(path_dir, exist_ok=True)
    payload = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
               "step": int(step), "env_steps": int(env_steps),
               "extra": _norm_payload(extra)}
    path = os.path.join(path_dir, f"{tag}_{env_steps:012d}.pt")
    torch.save(payload, path)
    for old in get_checkpoints(path_dir, tag)[:-keep]:
        os.remove(old)
    return path


def get_checkpoints(path_dir: str, tag: str = "checkpoint") -> list[str]:
    return sorted(glob.glob(os.path.join(path_dir, f"{tag}_*.pt")))


def load_checkpoint(path: str, model=None, optimizer=None,
                    extra: NormalizerState | None = None, device="cpu"):
    """The raw payload (tensors on `device`) without a model; with one,
    restore the model and optimizer in place and return (step, env_steps,
    normalizer state), the latter `extra` itself if the file has none."""
    payload = torch.load(path, map_location=device, weights_only=True)
    if model is None:
        return payload
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    norm = extra if payload.get("extra") is None else _norm_from_payload(
        payload["extra"], device)
    return payload["step"], payload["env_steps"], norm


def latest_checkpoint(path_dir: str) -> str | None:
    cps = get_checkpoints(path_dir)
    return cps[-1] if cps else None


def env_steps_of(path: str) -> int:
    m = re.search(r"_(\d+)\.pt$", path)
    return int(m.group(1)) if m else 0
