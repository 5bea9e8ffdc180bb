"""The rollout slice as a whole: policy forward + batched env step.

2 envs x 8 drones, the mix curriculum, 6 visible neighbors, downwash on.
A JAX `env_reset` state is converted to the port; drones are placed so that
the first ticks see a drone-drone collision, downwash, a wall, a ceiling
and a floor crash.  Each tick both packages run the policy (converted flax
weights), sample actions from the same standard normals, and step with
every random draw injected (the JAX side through its `dyn_override`,
`set_response_tape` and the recorded-draw stand-in of
tests/test_torch_env_parts.py); states, observations, rewards and the info
dict agree within the dynamics tolerance, rtol 2e-4 / atol 2e-5 per tick.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.env import collisions as j_coll
from quadswarm_tpu.env import downwash as j_downwash
from quadswarm_tpu.env import dynamics as j_dyn
from quadswarm_tpu.env import multi as j_multi
from quadswarm_tpu.env import scenarios as j_scen
from quadswarm_tpu.env import sensor as j_sensor
from quadswarm_tpu.env.controls import raw_control
from quadswarm_tpu.env.params import make_dynamics_params as j_make_params
from quadswarm_tpu.env.reward import RewardCoeffs as JRewardCoeffs
from quadswarm_tpu.models import actor_critic as j_ac
from quadswarm_tpu_torch.env import multi as t_multi
from quadswarm_tpu_torch.env.params import make_dynamics_params as t_make_params
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.models import actor_critic as t_ac
from quadswarm_tpu_torch.parallel.ppo import PPOConfig, collect_rollout
from quadswarm_tpu_torch.utils.convert import (
    actor_critic_from_flax, env_state_from_numpy,
)
from quadswarm_tpu_torch.utils.struct import leaves

from .test_torch_env_parts import assert_matches_jax, jax_tree_numpy, taped

E, N = 2, 8
ENV_KW = dict(num_agents=N, quads_mode="mix", neighbor_obs_type="pos_vel",
              neighbor_visible_num=6, collision_hitbox_radius=2.0,
              collision_falloff_radius=4.0, use_downwash=True)
REWARD = dict(quadcol_bin=5.0, quadcol_bin_smooth_max=10.0)
MODEL_KW = dict(action_dim=4, self_obs_dim=18, neighbor_obs_dim=6,
                num_neighbors=6, neighbor_hidden=32, rnn_size=32)
TOL = dict(rtol=2e-4, atol=2e-5)
FIELD_TOL = {"omega_dot": dict(rtol=2e-4, atol=1e-3)}
SENSOR_ORDER = ("pos_n", "pos_u", "vel_n", "vel_u", "omega_n", "theta_n",
                "theta_u", "acc_n", "acc_dyn_n")


def _set(x, idx, value):
    return x.at[idx].set(jnp.asarray(value, x.dtype))


@pytest.fixture(scope="module")
def start():
    """A JAX-reset pair of envs with interacting drones, and both models."""
    jcfg = j_multi.EnvConfig(**ENV_KW)
    jparams = j_make_params()
    keys = jax.random.split(jax.random.PRNGKey(11), E)
    reset = jax.jit(jax.vmap(lambda k: j_multi.env_reset(
        jcfg, jparams, k, rew_coeff=JRewardCoeffs(**REWARD))))
    jstate, jobs = reset(keys)
    d = jstate.dyn
    pos, vel = d.pos, d.vel
    pos = _set(pos, (0, 1), pos[0, 0] + jnp.asarray([0.05, 0.0, 0.0]))
    vel = _set(vel, (0, 0), [1.0, 0.0, 0.0])              # head-on collision
    vel = _set(vel, (0, 1), [-1.0, 0.0, 0.0])
    pos = _set(pos, (0, 2), pos[0, 3] + jnp.asarray([0.02, 0.0, -0.3]))
    pos = _set(pos, (1, 0), [4.995, 0.0, 2.0])             # wall next step
    vel = _set(vel, (1, 0), [2.0, 0.0, 0.0])
    pos = _set(pos, (1, 1), [0.0, 1.0, 9.995])             # ceiling
    vel = _set(vel, (1, 1), [0.0, 0.0, 2.0])
    pos = _set(pos, (1, 2), [1.0, -1.0, 0.06])   # floor crash, 2nd sub-step
    vel = _set(vel, (1, 2), [0.0, 0.0, -2.0])
    jstate = jstate.replace(dyn=d.replace(pos=pos, vel=vel))

    jmodel = j_ac.ActorCritic(**MODEL_KW, dtype=jnp.float32)
    jpolicy = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 54), jnp.float32))
    tmodel = t_ac.ActorCritic(**MODEL_KW, device="cpu")
    tmodel.load_state_dict(actor_critic_from_flax(
        jax.tree.map(np.asarray, jpolicy)))
    return jcfg, jparams, jstate, jobs, jmodel, jpolicy, tmodel


def _draws(rng) -> dict:
    u = lambda *s: rng.uniform(0, 1, (E, N) + s).astype(np.float32)
    g = lambda *s: rng.standard_normal((E, N) + s).astype(np.float32)
    return {"ou": g(4), "yaw": (u() * 2 * np.pi - np.pi).astype(np.float32),
            "downwash": {"acc": u(1), "omega": u(1), "axis": u(3),
                         "dir": u(3)},
            "drone_normals": g(3, 3, 3), "drone_uniforms": u(6),
            "wall": u(11), "ceiling": u(10),
            "sensor": {k: g(3) for k in SENSOR_ORDER if k.endswith("_n")}}


def _torch(draws):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in draws.items()}


def _jax_step(jcfg, jparams, jstate, actions, draws):
    """The JAX env step of every env with the given draws injected.  With
    `use_pallas_pairs` it follows `batched_env_step`'s large-swarm route: the
    pair kernel over the whole fleet, `env_step` with `pairs_override` and
    `defer_obs`, then the k-nearest kernel on the post-response state (both
    kernels in interpret mode off the TPU)."""
    n_envs = actions.shape[0]
    scen = j_scen.batched_scenario_step(jcfg.scenario_config(),
                                        jstate.scenario, jstate.tick + 1,
                                        jcfg.mode_list())
    dyn_cfg = jcfg.dynamics_config(arm=jparams.arm)
    env = lambda tree, e: jax.tree.map(lambda x: x[e], tree)
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    dyns = []
    for e in range(n_envs):
        dyn = jstate.dyn
        with taped(j_dyn, [draws["ou"][e]]):
            ou = j_dyn.ou_noise_step(dyn.ou_state[e], jax.random.PRNGKey(0),
                                     jparams.thrust_noise_ratio)
        dyn = env(dyn, e).replace(ou_state=ou)
        thrust = raw_control(actions[e])
        for _ in range(jcfg.sim_steps):
            dyn = j_dyn.dynamics_substep(jparams, dyn_cfg, dyn, thrust, ou,
                                         jnp.asarray(draws["yaw"][e]))
        dyns.append(dyn)
    pairs = None
    if jcfg.use_pallas_pairs:
        pairs = j_multi._batched_pair_interactions(jcfg, jparams, jstate,
                                                   stack(dyns))
    defer = jcfg.use_pallas_pairs and 0 < jcfg.num_use_neighbor_obs <= 16
    sensor = lambda e: [
        draws["sensor"].get(k, np.zeros(actions.shape[:2] + (3,),
                                        np.float32))[e] for k in SENSOR_ORDER]
    outs = []
    for e in range(n_envs):
        dw = [draws["downwash"][k][e] for k in ("acc", "omega", "axis", "dir")
              ] if jcfg.use_downwash else []
        j_coll.set_response_tape({"drone_normals": draws["drone_normals"][e],
                                  "drone_uniforms": draws["drone_uniforms"][e]})
        try:
            with taped(j_downwash, dw), \
                    taped(j_sensor, [] if defer else sensor(e)), \
                    taped(j_coll, [draws["wall"][e], draws["ceiling"][e]]):
                outs.append(j_multi.env_step(
                    jcfg, jparams, env(jstate, e), actions[e],
                    jax.random.PRNGKey(e), auto_reset=False,
                    dyn_override=dyns[e], scen_override=env(scen, e),
                    pairs_override=None if pairs is None else env(pairs, e),
                    defer_obs=defer))
        finally:
            j_coll.set_response_tape(None)
    new_state, obs, rew, dones, info = stack(outs)
    if defer:
        from quadswarm_tpu.ops.pallas.swarm_interactions import (
            neighbor_topk_obs)
        d = new_state.dyn
        nbr = neighbor_topk_obs(d.pos.astype(jnp.float32),
                                d.vel.astype(jnp.float32),
                                jcfg.num_use_neighbor_obs, interpret=True)
        obs_parts = []
        for e in range(n_envs):
            s = env(new_state, e)
            with taped(j_sensor, sensor(e)):
                obs_parts.append(j_multi._compute_obs(
                    jcfg, s.dyn, s.scenario.goals, jstate.gyro_bias[e],
                    jax.random.PRNGKey(e), s.obst_active, s.obst_pos,
                    s.obst_size, neighbor_override=nbr[e]))
        obs, gyro_bias = stack(obs_parts)
        new_state = new_state.replace(gyro_bias=gyro_bias)
    return new_state, obs, rew, dones, info


def test_slice_lockstep_with_jax(start):
    jcfg, jparams, jstate, jobs, jmodel, jpolicy, tmodel = start
    tcfg = t_multi.EnvConfig(**ENV_KW)
    tparams = t_make_params()
    tstate = env_state_from_numpy(jax_tree_numpy(jstate))
    tobs = torch.from_numpy(np.asarray(jobs))
    rng = np.random.default_rng(0)
    seen = {"collision": False, "wall": False, "ceiling": False,
            "floor": False}
    for _ in range(3):
        # policy forward and actions from the same standard normals
        normal = rng.standard_normal((E * N, 4)).astype(np.float32)
        jmean, jlog_std, jvalue = j_ac.apply_fused(
            jmodel, jpolicy, jobs.reshape(E * N, -1))
        jactions = (jmean + jnp.exp(jlog_std) * normal).reshape(E, N, 4)
        with torch.no_grad():
            tmean, tlog_std, tvalue = t_ac.apply_fused(
                tmodel, tobs.reshape(E * N, -1))
            tactions = t_ac.sample_actions(None, tmean, tlog_std,
                                           torch.from_numpy(normal))
        for g, w in ((tmean, jmean), (tvalue, jvalue), (tactions,
                                                          jactions)):
            np.testing.assert_allclose(g.reshape(w.shape).numpy(),
                                       np.asarray(w), **TOL)
        draws = _draws(rng)
        jstate, jobs, jrew, jdones, jinfo = _jax_step(
            jcfg, jparams, jstate, jactions, draws)
        tstate, tobs, trew, tdones, tinfo = t_multi.batched_env_step(
            tcfg, tparams, tstate, tactions.reshape(E, N, 4), None,
            _torch(draws))
        assert_matches_jax(tstate, jstate, skip=("scen_seed",), tol=TOL,
                           field_tol=FIELD_TOL)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TOL)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)
        np.testing.assert_array_equal(tdones.numpy(), np.asarray(jdones))
        assert set(tinfo) == set(jinfo)
        for key, val in tinfo.items():
            want = np.asarray(jinfo[key])
            if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
                np.testing.assert_array_equal(val.numpy(), want, err_msg=key)
            else:
                np.testing.assert_allclose(val.numpy(), want, err_msg=key,
                                           **TOL)
        seen["collision"] |= bool(tinfo["rewards/rewraw_quadcol"].any())
        seen["wall"] |= bool(tstate.prev_wall.any())
        seen["ceiling"] |= bool(tstate.prev_ceiling.any())
        seen["floor"] |= bool(tstate.dyn.crashed_floor.any())
    assert all(seen.values()), seen


def test_auto_reset_resets_finished_envs_only():
    """Env 1 finishes one tick before the others: after the tick it is a
    fresh episode, while envs 0 and 2 equal the step without reset."""
    cfg = t_multi.EnvConfig(**{**ENV_KW, "ep_time": 0.05})
    params = t_make_params()
    gen = torch.Generator().manual_seed(3)
    state, _ = t_multi.env_reset(cfg, params, gen, 3, device="cpu",
                                 rew_coeff=RewardCoeffs(**REWARD))
    state = state.replace(tick=torch.tensor([0, cfg.ep_len, 0],
                                            dtype=torch.int32))
    actions = torch.rand((3, N, 4), generator=gen) * 2 - 1
    rng = np.random.default_rng(1)
    draws = _draws(rng)
    draws = {k: ({kk: np.concatenate([vv, vv[:1]]) for kk, vv in v.items()}
                 if isinstance(v, dict) else np.concatenate([v, v[:1]]))
             for k, v in draws.items()}
    kept, kept_obs, _, done, _ = t_multi._step(cfg, params, state, actions,
                                               None, _torch(draws))
    assert done.tolist() == [False, True, False]
    new, obs, rew, dones, info = t_multi.batched_env_step(
        cfg, params, state, actions, gen, _torch(draws))
    assert dones[1].all() and not dones[0].any() and not dones[2].any()
    assert info["episode_done"].tolist() == [False, True, False]
    for (name, got), (_, want) in zip(leaves(new), leaves(kept)):
        assert torch.equal(got[[0, 2]], want[[0, 2]]), name
    assert torch.equal(obs[[0, 2]], kept_obs[[0, 2]])
    # env 1 starts over
    assert int(new.tick[1]) == 0 and int(new.scenario.event_count[1]) == 0
    assert int(new.collisions_per_episode[1]) == 0
    assert not new.prev_coll_pairs[1].any() and not new.reached_goal[1].any()
    assert torch.equal(new.dyn.vel[1], torch.zeros(N, 3))
    assert torch.equal(new.dist5[1], torch.zeros(N, 5))
    assert new.scenario.events.shape == state.scenario.events.shape
    spawn = new.scenario.spawn_points[1]
    assert float((new.dyn.pos[1, :, :2] - spawn[:, :2]).abs().max()) <= 2.0
    assert torch.isfinite(obs).all()


def test_collect_rollout_shapes_and_counts():
    cfg = t_multi.EnvConfig(**ENV_KW)
    params = t_make_params()
    gen = torch.Generator().manual_seed(4)
    torch.manual_seed(0)
    model = t_ac.ActorCritic(**MODEL_KW, device="cpu")
    state, obs = t_multi.env_reset(cfg, params, gen, E, device="cpu")
    _, obs2, _, traj, last_value, infos = collect_rollout(
        cfg, params, model, PPOConfig(rollout=3), state, obs,
        gen, RewardCoeffs(**REWARD))
    assert traj.obs.shape == (3, E, N, cfg.obs_dim)
    assert traj.actions.shape == (3, E, N, 4)
    assert traj.done.dtype == torch.bool and last_value.shape == (E, N)
    assert torch.equal(traj.obs[0], obs) and infos["episode_done"].shape == (
        3, E)
    for x in traj:
        assert torch.isfinite(x.float()).all()
    with pytest.raises(NotImplementedError):
        collect_rollout(cfg, params, model, PPOConfig(
            rollout=1, replay_sample_prob=0.75), state, obs, gen,
            RewardCoeffs(), replay_states=object())


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import quadswarm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "assert ('quadswarm_tpu_torch.ops.kernels.swarm_interactions'\n"
        "        in sys.modules)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'quadswarm_tpu'))\n"
        "assert not bad, bad\n")
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                   check=True, timeout=120)
