"""The port's runtime sanitizers (quadswarm_tpu_torch/utils/debug.py) on the
CPU, against the JAX package's.

- `checked_env_step` passes on a healthy state, and on a state with NaN
  positions raises ValueError with the message of the JAX package's
  checkified step on the same state (carried over from a port reset);
  its auto-reset replaces a finished env as `batched_env_step`'s does.
- `enable_debug_checks` turns on autograd's anomaly mode.
- `trace` writes a Chrome trace (the train CLI's --profile_dir).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from quadswarm_tpu.env import multi as j_multi
from quadswarm_tpu.env.params import make_dynamics_params as j_make_params
from quadswarm_tpu.utils.debug import checked_env_step as j_checked_env_step
from quadswarm_tpu_torch.env import multi as t_multi
from quadswarm_tpu_torch.env.params import make_dynamics_params
from quadswarm_tpu_torch.utils import debug

from .test_torch_env_parts import _jax_state

KW = dict(num_agents=2, ep_time=1.0, quads_mode="static_same_goal")


def _reset(seed: int = 0, num_envs: int = 1):
    cfg = t_multi.EnvConfig(**KW)
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator().manual_seed(seed)
    states, _ = t_multi.env_reset(cfg, params, gen, num_envs, device="cpu")
    return cfg, params, gen, states


def test_checked_step_passes_on_a_healthy_state():
    cfg, params, gen, states = _reset(num_envs=3)
    step = debug.checked_env_step(cfg, params)
    for _ in range(3):
        err, (states, obs, rew, done, info) = step(
            states, torch.zeros((3, 2, 4)), gen)
        err.throw()
        assert err.get() is None and err.passed == (True, True)
    assert torch.isfinite(rew).all() and obs.shape[:2] == (3, 2)


def test_checked_step_raises_the_jax_message_on_a_nan_position():
    cfg, params, gen, states = _reset()
    bad = states.replace(dyn=states.dyn.replace(
        pos=torch.full_like(states.dyn.pos, float("nan"))))
    err, _ = debug.checked_env_step(cfg, params)(bad, torch.zeros((1, 2, 4)),
                                                gen)
    jbad = jax.tree.map(lambda x: x[0], _jax_state(bad))
    jerr, _ = jax.jit(j_checked_env_step(
        j_multi.EnvConfig(**KW, dtype=jnp.float32), j_make_params()))(
        jbad, jnp.zeros((2, 4), jnp.float32), jax.random.PRNGKey(1))
    want = jerr.get()
    assert want is not None and err.get() is not None
    assert want.startswith(err.get())
    with pytest.raises(ValueError, match="Debug this!") as raised:
        err.throw()
    assert str(raised.value) == err.get()
    # a finite reward with NaN positions names the positions
    assert debug.CheckError((True, False)).get() == (
        "Drone position is not finite. Debug this!")


def test_checked_step_resets_a_finished_env_as_the_env_step():
    """At the episode's last tick the checked step and batched_env_step,
    from the same state and generator, give the same reset states."""
    cfg, params, _, states = _reset(num_envs=2)
    states = states.replace(tick=torch.full_like(states.tick, cfg.ep_len))
    acts = torch.zeros((2, 2, 4))
    err, got = debug.checked_env_step(cfg, params)(
        states, acts, torch.Generator().manual_seed(5))
    want = t_multi.batched_env_step(cfg, params, states, acts,
                                    torch.Generator().manual_seed(5))
    err.throw()
    assert bool(got[3].all()) and int(got[0].tick.max()) == 0
    for g, w in zip((got[0].dyn.pos, got[1], got[2]),
                    (want[0].dyn.pos, want[1], want[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_enable_debug_checks_turns_on_anomaly_mode():
    before = torch.is_anomaly_enabled()
    try:
        debug.enable_debug_checks()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_trace_writes_a_chrome_trace(tmp_path):
    with debug.trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
