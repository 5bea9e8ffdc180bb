"""The port's reference-shaped stateful API (env/gym_api.py) on the CPU.

Mirrors tests/test_gym_api.py (construct, reset, step with random actions,
the list types and shapes, auto-reset with `episode_extra_stats`, the
5-tuple form, the factory) with `device="cpu"`; the set of
`episode_extra_stats` keys at an episode's end must be the JAX env's for
the same config.  The JAX side of that comparison is traced with
`jax.eval_shape` and its own `_build_infos`, so no JAX program compiles.
"""
from __future__ import annotations

import argparse

import jax
import numpy as np
import pytest
import torch

from quadswarm_tpu.env import gym_api as j_gym
from quadswarm_tpu_torch.env.gym_api import (
    QuadEnvCompatibility, QuadrotorEnvMulti, make_quadrotor_env_multi,
)
from quadswarm_tpu_torch.env.multi import EnvConfig
from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
from quadswarm_tpu_torch.training import config as t_config

PER_DRONE = {"class": "RelativeSampler", "noise_ratio": 0.2,
             "sampler": "normal"}


@pytest.fixture(scope="module")
def env():
    e = QuadrotorEnvMulti(num_agents=4, ep_time=1.0, device="cpu")
    yield e
    e.close()


def test_reset_returns_list_of_obs(env):
    obs = env.reset(seed=7)
    assert isinstance(obs, list) and len(obs) == 4
    assert obs[0].shape == (env.cfg.obs_dim,) and obs[0].dtype == np.float32
    assert np.all(np.isfinite(obs[0]))


def test_step_four_tuple_lists(env):
    env.reset(seed=1)
    rng = np.random.default_rng(0)
    for _ in range(5):
        acts = [rng.uniform(-1, 1, 4).astype(np.float32) for _ in range(4)]
        obs, rew, done, infos = env.step(acts)
        assert len(obs) == len(rew) == len(done) == len(infos) == 4
        assert np.all(np.isfinite(obs[0]))
        assert isinstance(infos[0]["rewards"], dict)
        assert "rew_pos" in infos[0]["rewards"]


def _jax_stats_keys(num_agents: int, ep_time: float) -> set:
    """The JAX env's `episode_extra_stats` keys at a done, from its own
    `_build_infos` over the info dict's traced shapes."""
    jenv = j_gym.QuadrotorEnvMulti(num_agents=num_agents, ep_time=ep_time)
    key = jax.random.PRNGKey(0)
    state, _ = jax.eval_shape(jenv._reset_fn, key, jenv.rew_coeff)
    acts = jax.ShapeDtypeStruct((num_agents, 4), np.float32)
    info = jax.eval_shape(jenv._step_fn, state, acts, key)[4]
    host = {k: np.zeros(v.shape, v.dtype) for k, v in info.items()}
    infos = jenv._build_infos(host, np.ones(num_agents, bool))
    return set(infos[0]["episode_extra_stats"])


def test_auto_reset_and_episode_stats(env):
    env.reset(seed=2)
    # ep_time=1.0 at 100 Hz control: done on tick 101
    zero = [np.zeros(4, np.float32)] * 4
    got_done = False
    for _ in range(120):
        obs, rew, done, infos = env.step(zero)
        if any(done):
            got_done = True
            stats = infos[0]["episode_extra_stats"]
            assert "num_collisions_after_settle" in stats
            assert "metric/agent_success_rate" in stats
            assert any(k.startswith("static_same_goal/") for k in stats)
            assert set(stats) == _jax_stats_keys(4, 1.0)
            break
    assert got_done
    # auto-reset: stepping again still works
    obs, _, done, _ = env.step(zero)
    assert not any(done)


def test_compatibility_five_tuple(env):
    compat = QuadEnvCompatibility(env)
    obs, info = compat.reset(seed=3)
    assert isinstance(obs, list) and isinstance(info, dict)
    obs, rew, term, trunc, infos = compat.step([np.zeros(4, np.float32)] * 4)
    assert term == [False] * 4
    assert len(trunc) == 4
    assert compat.num_agents == 4


def test_factory_from_namespace():
    ns = argparse.Namespace(
        quads_num_agents=2, quads_episode_duration=1.0,
        quads_room_dims=[10.0, 10.0, 10.0], quads_obs_repr="xyz_vxyz_R_omega",
        quads_neighbor_obs_type="pos_vel", quads_neighbor_visible_num=-1,
        quads_collision_hitbox_radius=2.0, quads_collision_falloff_radius=4.0,
        quads_use_obstacles=False, quads_obst_density=0.2, quads_obst_size=1.0,
        quads_obst_spawn_area=[6.0, 6.0], quads_use_downwash=False,
        quads_mode="static_same_goal", device="cpu")
    env = make_quadrotor_env_multi(ns)
    obs, _ = env.reset(seed=0)
    assert len(obs) == 2


def test_factory_from_train_sh_flags():
    """train.sh's parsed flags: 8 drones, the mix and downwash, 6 visible
    neighbours; a few steps of random actions."""
    from .test_torch_training import _train_sh_flags
    args = t_config.parse_swarm_cfg(_train_sh_flags() + ["--device=cpu"])
    env = make_quadrotor_env_multi(args)
    assert (env.cfg.num_agents, env.cfg.quads_mode, env.cfg.use_downwash,
            env.cfg.num_use_neighbor_obs) == (8, "mix", True, 6)
    obs, _ = env.reset(seed=4)
    rng = np.random.default_rng(1)
    for _ in range(3):
        obs, rew, term, trunc, infos = env.step(
            list(rng.uniform(-1, 1, (8, 4)).astype(np.float32)))
    assert len(obs) == 8 and np.all(np.isfinite(np.stack(obs)))


def test_per_drone_fleet_and_obstacle_overrides():
    """A randomized fleet (dyn_sampler_1) runs through the same API, with
    its own parameters per drone; obst_density / obst_size override the
    config for one episode."""
    env = QuadrotorEnvMulti(num_agents=4, ep_time=1.0, dyn_sampler_1=PER_DRONE,
                            device="cpu")
    assert env.params.per_drone
    assert len(np.unique(env.params.mass.numpy())) == 4
    env.reset(seed=5)
    for _ in range(3):
        obs, rew, done, infos = env.step([np.full(4, 0.2, np.float32)] * 4)
    assert np.all(np.isfinite(np.stack(obs)))
    oenv = QuadrotorEnvMulti(num_agents=2, ep_time=1.0, use_obstacles=True,
                             quads_mode="o_random", device="cpu")
    oenv.reset(seed=0, obst_density=0.5)
    assert float(oenv._state.obst_density[0]) == 0.5
    assert int(oenv._state.obst_active.sum()) == 18
    assert float(oenv._state.obst_size[0]) == oenv.cfg.obst_size


def test_render_raises_and_card_is_the_default():
    """render() is None before a reset, then an (H, W, 3) uint8 frame of
    the state: `render_frame` of its host arrays."""
    from quadswarm_tpu_torch.utils.render import render_frame

    env = QuadrotorEnvMulti(num_agents=2, ep_time=1.0, device="cpu")
    assert env.render() is None
    env.reset(seed=0)
    frame = env.render(views=("topdown",))
    s = env._state
    want = render_frame(s.dyn.pos[0].numpy(), s.scenario.goals[0].numpy(),
                        s.prev_coll_ids[0].numpy(), views=("topdown",))
    assert frame.dtype == np.uint8 and frame.shape == want.shape
    assert frame.ndim == 3 and frame.shape[2] == 3
    np.testing.assert_array_equal(frame, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            QuadrotorEnvMulti(num_agents=2)
    assert dk.dynamics_tick_fused.per_drone_launches == 0


def test_neighbor_visible_num_clamped_to_swarm_size():
    """A baseline config (visible_num=6) run with a smaller swarm clamps to
    N-1 observable neighbours."""
    assert EnvConfig(num_agents=4, neighbor_visible_num=6
                     ).num_use_neighbor_obs == 3
    assert EnvConfig(num_agents=8, neighbor_visible_num=6
                     ).num_use_neighbor_obs == 6
