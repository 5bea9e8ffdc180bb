"""Carry weights and state across from the JAX package, via numpy.

The inputs are plain nested dicts of numpy arrays (for a flax module, its
`params` tree; for a flax struct, `flax.serialization.to_state_dict` mapped
to numpy), so this module needs neither jax nor flax.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from quadswarm_tpu_torch.env.dynamics import DroneState
from quadswarm_tpu_torch.env.multi import EnvState
from quadswarm_tpu_torch.env.params import DynamicsParams
from quadswarm_tpu_torch.env.replay import ReplayState
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.env.scenarios import ScenarioState
from quadswarm_tpu_torch.parallel.normalize import (
    NormalizerState, RunningMeanStd,
)

_NESTED = {"dyn": DroneState, "scenario": ScenarioState,
           "rew_coeff": RewardCoeffs, "ep_checkpoints": EnvState,
           "buffer": EnvState, "obs": RunningMeanStd, "ret": RunningMeanStd}

# flax's numbered names of single submodules -> the port's attribute names
_RENAMED = {"MLP_0": "mlp", "LayerNorm_0": "layer_norm"}


def actor_critic_from_flax(tree: dict) -> dict:
    """flax ActorCritic params -> a state_dict for the port's ActorCritic.

    Every encoder type and neighbour encoder: the port's attribute names
    are flax's module names (`self_embed`, `attention/w_qs`, ...), and this
    renames the names flax numbers: a `Dense_i` inside an MLP is
    `layers.i`, the unnamed `MLP_0` of the mean_embed and mlp neighbour
    encoders is `mlp`, the attention block's `LayerNorm_0` is
    `layer_norm`.  A Dense kernel (in, out) becomes a Linear weight
    (out, in); a LayerNorm scale becomes weight."""
    tree = tree.get("params", tree)
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                m = re.fullmatch(r"Dense_(\d+)", key)
                name = (f"layers.{m.group(1)}" if m
                        else _RENAMED.get(key, key))
                walk(val, prefix + name + ".")
                continue
            arr = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                out[prefix + "weight"] = torch.from_numpy(arr.T.copy())
            elif key == "scale":
                out[prefix + "weight"] = torch.from_numpy(arr.copy())
            else:
                out[prefix + key] = torch.from_numpy(arr.copy())

    walk(tree, "")
    return out


def stacked_actor_critic_from_flax(tree: dict) -> dict:
    """P flax ActorCritic parameter trees stacked on a leading [P] axis
    (numpy; the JAX package's mixed-PBT `params`) -> the port's stacked
    weights, name -> (P, ...) tensor, in the layout of
    `parallel/pbt_mixed.py::StackedPolicies.params`."""
    tree = tree.get("params", tree)
    p_count = len(next(iter(_leaf_arrays(tree))))
    per_policy = [actor_critic_from_flax(_index_tree(tree, p))
                  for p in range(p_count)]
    return {k: torch.stack([sd[k] for sd in per_policy])
            for k in per_policy[0]}


def _leaf_arrays(tree: dict):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _leaf_arrays(val)
        else:
            yield np.asarray(val)


def _index_tree(tree: dict, p: int) -> dict:
    return {k: _index_tree(v, p) if isinstance(v, dict) else np.asarray(v)[p]
            for k, v in tree.items()}


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":    # JAX's bfloat16 (ml_dtypes), exact
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype in (np.int64, np.uint32):
        arr = arr.astype(np.int32)
    return torch.from_numpy(np.array(arr)).to(device)


def _seed_from_key(key) -> np.ndarray:
    """A JAX raw PRNG key (..., 2) uint32 -> the port's int64 hash seed."""
    key = np.asarray(key).astype(np.int64)
    return (key[..., 0] ^ key[..., 1]) & 0x7FFFFFFF


def _build(cls, tree: dict, device):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name == "scen_seed":
            kwargs[f.name] = torch.from_numpy(
                _seed_from_key(tree["scen_key"])).to(device)
        elif f.name in _NESTED:
            sub = tree.get(f.name)
            kwargs[f.name] = None if sub is None else _build(
                _NESTED[f.name], sub, device)
        else:
            kwargs[f.name] = _tensor(tree[f.name], device)
    return cls(**kwargs)


def drone_state_from_numpy(tree: dict, device="cpu") -> DroneState:
    return _build(DroneState, tree, device)


def scenario_state_from_numpy(tree: dict, device="cpu") -> ScenarioState:
    return _build(ScenarioState, tree, device)


def env_state_from_numpy(tree: dict, device="cpu") -> EnvState:
    """A (batched) JAX EnvState as a nested dict of numpy arrays -> the
    port's EnvState.  The scenario's PRNG key becomes its hash seed.  A
    state made under `use_pallas_pairs` carries its pair history packed,
    (E, N, 128) int32, in the layout the port's pair kernel reads."""
    return _build(EnvState, tree, device)


def dynamics_params_from_numpy(fields: dict) -> DynamicsParams:
    """JAX DynamicsParams fields (name -> numpy array) -> the port's
    DynamicsParams (CPU tensors, in the arrays' precision)."""
    return DynamicsParams(**{
        f.name: torch.as_tensor(np.asarray(fields[f.name]))
        for f in dataclasses.fields(DynamicsParams)})


def replay_state_from_numpy(tree: dict, device="cpu") -> ReplayState:
    """A batched JAX ReplayState (nested dict of numpy arrays) -> the
    port's; its rings become EnvStates with leaves (E, slots, ...)."""
    return _build(ReplayState, tree, device)


def norm_state_from_numpy(tree: dict, device="cpu") -> NormalizerState:
    """A JAX NormalizerState (nested dict of numpy arrays; a normalizer that
    is off is None or absent) -> the port's."""
    return _build(NormalizerState, tree, device)
