"""Parity of the port's quad presets and domain randomization with the JAX
package.

Both packages draw their randomized parameters from
`np.random.default_rng(seed)` on the host in the same order, so
`make_dynamics_params` with the same arguments must give the same values
bit for bit in float64: every `DYN_SAMPLERS` entry as the base sampler
(`quad`) and as the perturbation sampler (`dyn_sampler_1`), shared and
per drone, with and without a `dynamics_change`.  Where the JAX package
raises for an entry, the port raises the same exception type.  No JAX
function is compiled.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from quadswarm_tpu.env import params as j_params
from quadswarm_tpu_torch.env import params as t_params
from quadswarm_tpu_torch.utils.convert import dynamics_params_from_numpy

SAMPLERS = sorted(j_params.DYN_SAMPLERS)
# Nonzero rotor drag and a heavier body, written over the sampled model.
CHANGE = {"motor": {"C_drag": 0.02, "C_roll": 0.01},
          "geom": {"body": {"m": 0.007}}}


def _both(**kwargs):
    """Each package's make_dynamics_params on the same arguments, in
    float64; an exception is returned in place of the params."""
    out = []
    for mod, dtype in ((j_params, np.float64), (t_params, torch.float64)):
        try:
            out.append(mod.make_dynamics_params(dtype=dtype, **kwargs))
        except Exception as err:   # noqa: BLE001 - compared across packages
            out.append(err)
    return out


def assert_params_equal(got, want):
    assert isinstance(got, t_params.DynamicsParams), got
    for f in dataclasses.fields(got):
        g = getattr(got, f.name)
        w = np.asarray(getattr(want, f.name))
        assert g.dtype == torch.float64, f.name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)


def _check(want, got):
    if isinstance(want, Exception):
        assert type(got) is type(want), (got, want)
    else:
        assert_params_equal(got, want)


@pytest.mark.parametrize("change", [None, CHANGE], ids=["plain", "change"])
@pytest.mark.parametrize("per_drone", [False, True])
@pytest.mark.parametrize("quad", SAMPLERS)
def test_base_sampler_matches_jax(quad, per_drone, change):
    want, got = _both(quad=quad, per_drone=per_drone, num_agents=3,
                      dynamics_change=change, seed=5)
    _check(want, got)


@pytest.mark.parametrize("per_drone", [False, True])
@pytest.mark.parametrize("name", SAMPLERS)
def test_perturbation_sampler_matches_jax(name, per_drone):
    sampler = {"class": name, "noise_ratio": 0.2}
    if name in ("RelativeSampler", "AbsoluteSampler"):
        sampler["sampler"] = "uniform" if per_drone else "normal"
    want, got = _both(quad="Crazyflie", dyn_sampler_1=sampler,
                      per_drone=per_drone, num_agents=4,
                      dynamics_change=CHANGE, seed=7)
    _check(want, got)
    if not isinstance(want, Exception) and per_drone and name in (
            "RelativeSampler", "AbsoluteSampler", "RandomQuad"):
        assert len(np.unique(got.mass.numpy())) == 4


def test_presets_and_limits_match_jax():
    assert set(t_params.QUAD_PRESETS) == set(j_params.QUAD_PRESETS)
    assert set(t_params.DYN_SAMPLERS) == set(j_params.DYN_SAMPLERS)
    for name in j_params.QUAD_PRESETS:
        assert t_params.QUAD_PRESETS[name]() == j_params.QUAD_PRESETS[name]()
    rng = np.random.default_rng(0)
    for _ in range(20):
        model = j_params.crazyflie_params()
        for node in (model["geom"]["body"], model["motor"]):
            for k, v in node.items():
                if isinstance(v, float):
                    node[k] = v * rng.uniform(-10, 10)
        want = j_params.check_quad_param_limits(
            copy.deepcopy(model))
        assert t_params.check_quad_param_limits(model) == want
    base = t_params.crazyflie_params()
    upd = {"motor": {"C_drag": 1.0}, "geom": {"body": {"l": 2.0}}}
    t_params.dict_update_existing(base, upd)
    ref = j_params.crazyflie_params()
    j_params.dict_update_existing(ref, upd)
    assert base == ref


def test_stack_tile_and_dtype():
    one = t_params.make_dynamics_params(dtype=torch.float64)
    tiled = t_params.DynamicsParams.tile(one, 3)
    assert tiled.per_drone and not one.per_drone
    for f in dataclasses.fields(one):
        g, w = getattr(tiled, f.name), getattr(one, f.name)
        assert g.shape == (3,) + w.shape, f.name
        assert torch.equal(g[2], w), f.name
    jt = j_params.DynamicsParams.tile(
        j_params.make_dynamics_params(dtype=np.float64), 3)
    assert_params_equal(tiled, jt)
    f32 = t_params.make_dynamics_params(
        per_drone=True, num_agents=2,
        dyn_sampler_1={"class": "RelativeSampler"})
    assert f32.mass.dtype == torch.float32 and f32.prop_pos.shape == (2, 4, 3)


def test_per_drone_params_convert_from_jax():
    """utils/convert.py carries per-drone JAX params (leading N axis) as
    they are."""
    want = j_params.make_dynamics_params(
        quad="RandomQuad", per_drone=True, num_agents=5, seed=3,
        dtype=np.float64)
    got = dynamics_params_from_numpy(
        {f.name: np.asarray(getattr(want, f.name))
         for f in dataclasses.fields(t_params.DynamicsParams)})
    assert got.per_drone and got.mass.shape == (5,)
    assert_params_equal(got, want)
