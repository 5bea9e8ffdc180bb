"""The obstacle path of the port (train_local_obst.sh's configuration) as a
whole, against the JAX package and on its own.

- Lockstep: a port `env_reset` of 2 envs x 4 drones on the 8 x 8 obstacle
  grid (density 0.2, size 0.6, floor observation, 2 visible neighbours, no
  neighbour encoder, the SDF observation and the obstacle encoder,
  downwash), with drones set on active obstacles, is carried over to the
  JAX package's EnvState (a JAX reset would compile for half a minute).
  For 3 ticks both packages run the policy (converted flax weights) and
  step with every draw injected (the JAX step jitted once), the obstacle
  response's through `set_response_tape`; states, observations, rewards and the info dict
  agree within the slice's tolerance (rtol 2e-4 / atol 2e-5).  An obstacle
  hit, its response and its reward must fire.
- The obstacle mix's reset, by invariants: modes, spawns on free cells, the
  per-mode approach metric, the domain-random grids, the auto-reset's
  density and size, and `obs_dim` against JAX's for train_local_obst.sh.
- A forced obstacle hit is buffered by the collision replay and replayed,
  and the replayed observation carries the replayed state's SDF.
- `QuadMultiEncoder` with the obstacle encoder and no neighbour encoder
  against flax through `utils/convert.py` (atol 2e-5).
"""
from __future__ import annotations

import dataclasses
import shlex
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
from quadswarm_tpu.training import config as j_config
from quadswarm_tpu_torch.env import collisions as t_coll
from quadswarm_tpu_torch.env import multi as t_multi
from quadswarm_tpu_torch.env import obstacles as t_obst
from quadswarm_tpu_torch.env import replay as t_replay
from quadswarm_tpu_torch.env.params import make_dynamics_params as t_make_params
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.models import actor_critic as t_ac
from quadswarm_tpu_torch.training import config as t_config
from quadswarm_tpu_torch.utils.convert import actor_critic_from_flax

from .test_torch_env_parts import _jax_state, assert_matches_jax
from .test_torch_replay import _tape
from .test_torch_slice import SENSOR_ORDER, _torch

ROOT = Path(__file__).resolve().parents[1]
E, N = 2, 4
ENV_KW = dict(num_agents=N, quads_mode="mix",
              obs_repr="xyz_vxyz_R_omega_floor", neighbor_obs_type="pos_vel",
              neighbor_visible_num=2, collision_hitbox_radius=2.0,
              collision_falloff_radius=4.0, use_obstacles=True,
              obst_spawn_area=(8.0, 8.0), obst_density=0.2, obst_size=0.6,
              use_downwash=True)
REWARD = dict(quadcol_bin=5.0, quadcol_bin_smooth_max=4.0,
              quadcol_bin_obst=5.0)
OBS_DIM = 19 + 2 * 6 + 9
MODEL_KW = dict(action_dim=4, self_obs_dim=19, neighbor_obs_dim=6,
                num_neighbors=2, neighbor_encoder_type="no_encoder",
                neighbor_hidden=32, use_obstacles=True, obstacle_hidden=32,
                rnn_size=32)
TOL = dict(rtol=2e-4, atol=2e-5)
FIELD_TOL = {"omega_dot": dict(rtol=2e-4, atol=1e-3)}


@pytest.fixture(scope="module")
def start():
    """A port-reset pair of envs with drones on active obstacles (env 0
    after the grace period, env 1 at its start), the same state in the JAX
    package's form, and both models."""
    tcfg = t_multi.EnvConfig(**ENV_KW)
    gen = torch.Generator().manual_seed(7)
    tstate, _ = t_multi.env_reset(tcfg, t_make_params(), gen, E, device="cpu",
                                  rew_coeff=RewardCoeffs(**REWARD))
    pos, vel = tstate.dyn.pos.clone(), tstate.dyn.vel.clone()
    for e, drones in ((0, (0, 1)), (1, (2,))):
        cells = torch.nonzero(tstate.obst_active[e])[:, 0]
        for d, k in zip(drones, cells.tolist()):
            pos[e, d] = tstate.obst_pos[e, k] + torch.tensor([0.2, -0.1, 0.0])
            pos[e, d, 2] = 2.0
            vel[e, d] = torch.tensor([-1.5, 0.5, 0.0])
    tstate = tstate.replace(dyn=tstate.dyn.replace(pos=pos, vel=vel),
                            tick=torch.tensor([200, 0], dtype=torch.int32))
    obs, _ = t_multi._compute_obs(tcfg, tstate.dyn, tstate.scenario.goals,
                                  tstate.gyro_bias, gen,
                                  obstacles=t_multi.obstacles_of(tstate))
    jcfg = j_multi.EnvConfig(**ENV_KW)

    jmodel = j_ac.ActorCritic(**MODEL_KW, dtype=jnp.float32)
    jpolicy = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, OBS_DIM), jnp.float32))
    tmodel = t_ac.ActorCritic(**MODEL_KW, device="cpu")
    tmodel.load_state_dict(actor_critic_from_flax(
        jax.tree.map(np.asarray, jpolicy)))
    return (jcfg, j_make_params(), tstate, obs.numpy(), jmodel, jpolicy,
            tmodel)


def _draws(rng, e=E, n=N) -> dict:
    u = lambda *s: rng.uniform(0, 1, (e, n) + s).astype(np.float32)
    g = lambda *s: rng.standard_normal((e, n) + s).astype(np.float32)
    return {"ou": g(4), "yaw": (u() * 2 * np.pi - np.pi).astype(np.float32),
            "downwash": {"acc": u(1), "omega": u(1), "axis": u(3),
                         "dir": u(3)},
            "drone_normals": g(3, 3, 3), "drone_uniforms": u(6),
            "obst_normals": g(3, 2, 3), "obst_uniforms": u(5),
            "wall": u(11), "ceiling": u(10),
            "sensor": {k: g(3) if k.endswith("_n") else np.zeros(
                (e, n, 3), np.float32) for k in SENSOR_ORDER}}


def _port_draws(draws):
    d = dict(draws)
    d["sensor"] = {k: v for k, v in draws["sensor"].items()
                   if k.endswith("_n")}
    return _torch(d)


def _jax_tick_fn(jcfg, jparams):
    """The JAX env step of every env with the given draws injected, jitted
    once: the batched scenario step, each env's dynamics (OU draw and crash
    yaw injected), then `env_step` with its responses' draws through
    `set_response_tape` and the rest taped."""
    dyn_cfg = jcfg.dynamics_config(arm=jparams.arm)
    responses = ("drone_normals", "drone_uniforms", "obst_normals",
                 "obst_uniforms")

    def dynamics(dyn, action, ou_draw, yaw):
        with _tape(j_dyn, [ou_draw]):
            ou = j_dyn.ou_noise_step(dyn.ou_state, jax.random.PRNGKey(0),
                                     jparams.thrust_noise_ratio)
        dyn = dyn.replace(ou_state=ou)
        thrust = raw_control(action)
        for _ in range(jcfg.sim_steps):
            dyn = j_dyn.dynamics_substep(jparams, dyn_cfg, dyn, thrust, ou,
                                         yaw)
        return dyn

    def one_env(state, action, dyn, scen, d):
        j_coll.set_response_tape({k: d[k] for k in responses})
        dw = [d["downwash"][k] for k in ("acc", "omega", "axis", "dir")]
        try:
            with _tape(j_downwash, dw), \
                    _tape(j_sensor, [d["sensor"][k] for k in SENSOR_ORDER]), \
                    _tape(j_coll, [d["wall"], d["ceiling"]]):
                return j_multi.env_step(
                    jcfg, jparams, state, action, jax.random.PRNGKey(0),
                    auto_reset=False, dyn_override=dyn, scen_override=scen)
        finally:
            j_coll.set_response_tape(None)

    @jax.jit
    def tick(states, actions, draws):
        scen = j_scen.batched_scenario_step(
            jcfg.scenario_config(), states.scenario, states.tick + 1,
            jcfg.mode_list())
        dyn = jax.vmap(dynamics)(states.dyn, actions, draws["ou"],
                                 draws["yaw"])
        return jax.vmap(one_env)(states, actions, dyn, scen, draws)

    return tick


def test_obstacle_lockstep_with_jax(start, monkeypatch):
    jcfg, jparams, tstate, jobs, jmodel, jpolicy, tmodel = start
    tcfg = t_multi.EnvConfig(**ENV_KW)
    tparams = t_make_params()
    jstate = _jax_state(tstate)
    assert_matches_jax(tstate, jstate, skip=("scen_seed",))
    tick = _jax_tick_fn(jcfg, jparams)
    tobs = torch.from_numpy(jobs.copy())
    assert tobs.shape == (E, N, OBS_DIM)
    rng = np.random.default_rng(0)
    hits = 0
    for t in range(3):
        normal = rng.standard_normal((E * N, 4)).astype(np.float32)
        jmean, jlog_std, jvalue = j_ac.apply_fused(
            jmodel, jpolicy, jobs.reshape(E * N, -1))
        jactions = (jmean + jnp.exp(jlog_std) * normal).reshape(E, N, 4)
        with torch.no_grad():
            tmean, tlog_std, tvalue = t_ac.apply_fused(
                tmodel, tobs.reshape(E * N, -1))
            tactions = t_ac.sample_actions(None, tmean, tlog_std,
                                           torch.from_numpy(normal))
        for g, w in ((tmean, jmean), (tvalue, jvalue),
                     (tactions, jactions)):
            np.testing.assert_allclose(g.reshape(w.shape).numpy(),
                                       np.asarray(w), **TOL)
        draws = _draws(rng)
        prev = tstate
        jstate, jobs, jrew, jdones, jinfo = tick(
            jstate, jactions, jax.tree.map(jnp.asarray, draws))
        tstate, tobs, trew, tdones, tinfo = t_multi.batched_env_step(
            tcfg, tparams, tstate, tactions.reshape(E, N, 4), None,
            _port_draws(draws))
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
        new_hit = tstate.prev_obst_hits & ~prev.prev_obst_hits
        hits += int(new_hit.sum())
        if t == 0:
            # every placed drone hit on the first tick: the counters, the
            # settled env's flags and the reward of -quadcol_bin_obst
            assert new_hit.tolist() == [[True, True, False, False],
                                        [False, False, True, False]]
            assert tstate.obst_collisions_per_episode.tolist() == [2, 1]
            assert tstate.obst_collisions_after_settle.tolist() == [2, 0]
            assert tstate.agent_col_obst[0, :2].tolist() == [0.0, 0.0]
            assert tstate.agent_col_obst[1].tolist() == [1.0] * 4
            np.testing.assert_array_equal(
                tinfo["rewards/rew_quadcol_obstacle"].numpy(),
                np.where(new_hit.numpy(), -5.0, 0.0))
            # the response: the same tick without it leaves the hit drones'
            # velocities elsewhere and the others where they are
            monkeypatch.setattr(t_coll, "obstacle_collision_response",
                                lambda pos, vel, omega, *a, **k: (vel, omega))
            bare = t_multi._step(tcfg, tparams, prev,
                                 tactions.reshape(E, N, 4), None,
                                 _port_draws(draws))[0]
            monkeypatch.undo()
            moved = (bare.dyn.vel != tstate.dyn.vel).any(-1)
            assert torch.equal(moved, new_hit)
    assert hits == 3


def _flags(script: str) -> list:
    text = (ROOT / script).read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "training.train" in ln)
    words = shlex.split(line)
    start = next(i for i, w in enumerate(words)
                 if w.endswith("training.train")) + 1
    return [w for w in words[start:] if w != "$@"]


def test_obstacle_mix_reset_invariants():
    flags = _flags("train_local_obst.sh")
    tcfg = t_config.env_config_from_args(t_config.parse_swarm_cfg(flags))
    jcfg = j_config.env_config_from_args(j_config.parse_swarm_cfg(flags))
    assert tcfg.obs_dim == jcfg.obs_dim == 40
    assert tcfg.mode_list() == jcfg.mode_list() == (10, 11)

    cfg = t_multi.EnvConfig(**ENV_KW)
    params = t_make_params(dt=cfg.dt)
    gen = torch.Generator().manual_seed(0)
    e = 16
    state, obs = t_multi.env_reset(cfg, params, gen, e, device="cpu")
    scen = state.scenario
    assert obs.shape == (e, N, cfg.obs_dim) and torch.isfinite(obs).all()
    assert set(scen.mode.tolist()) == {10, 11}
    assert (state.obst_active.sum(-1) == 12).all()
    np.testing.assert_array_equal(
        scen.approach_goal_metric.numpy(),
        np.where(scen.mode.numpy() == 10, 0.5, 1.0).astype(np.float32))
    centers = torch.from_numpy(t_obst.cell_centers(8, 8).astype(np.float32))

    def cells(points):
        match = (points[..., None, :2] == centers).all(-1)
        assert match.any(-1).all()
        return match.to(torch.uint8).argmax(-1)

    spawn_cells = cells(scen.spawn_points)
    for env in range(e):
        assert len(set(spawn_cells[env].tolist())) == N
        assert not state.obst_active[env, spawn_cells[env]].any()
        if int(scen.mode[env]) == 10:
            goal_cells = cells(scen.goals[env])
            assert len(set(goal_cells.tolist())) == N
            assert not state.obst_active[env, goal_cells].any()
        else:
            assert (scen.goals[env] == scen.end_point[env]).all()
        # both modes end at the freest square's centre cell, z in [1.5, 3)
        cells(scen.end_point[env][None])
        assert 1.5 <= float(scen.end_point[env, 2]) < 3.0
    assert ((scen.spawn_points[..., 2] >= 1.0)
            & (scen.spawn_points[..., 2] < 3.0)).all()
    assert ((state.dyn.pos[..., :2] - scen.spawn_points[..., :2]).abs()
            <= 0.1 + 1e-6).all()
    # the SDF part of the observation is the true positions' patch
    sdf = t_obst.surround_sdf_obs(state.dyn.pos[..., :2],
                                  state.obst_pos[..., :2], state.obst_active,
                                  state.obst_size / 2)
    assert torch.equal(obs[..., -9:], sdf)

    # domain randomization: density and size from the reference's grids,
    # kept by the auto-reset unless random
    rcfg = dataclasses.replace(cfg, obst_density_random=True,
                               obst_size_random=True)
    rstate, _ = t_multi.env_reset(rcfg, params, gen, 64, device="cpu")
    dens = np.arange(0.05, 0.2, 0.05).astype(np.float32)
    sizes = np.arange(0.3, 0.6, 0.1).astype(np.float32)
    assert set(rstate.obst_density.tolist()) == set(dens.tolist())
    assert set(rstate.obst_size.tolist()) == set(sizes.tolist())
    want = (rstate.obst_density * 64).to(torch.int32)
    assert torch.equal(rstate.obst_active.sum(-1).to(torch.int32), want)
    kept, _ = t_multi.reset_like(cfg, params, gen, rstate)
    assert torch.equal(kept.obst_density, rstate.obst_density)
    assert torch.equal(kept.obst_size, rstate.obst_size)
    redrawn, _ = t_multi.reset_like(rcfg, params, gen, rstate)
    assert not torch.equal(redrawn.obst_density, rstate.obst_density)


def test_forced_obstacle_hit_is_buffered_and_replayed():
    """A drone set on an obstacle after the grace period puts the
    checkpoint from 1.5 s before into the buffer, and the next episode
    replays it (sample_prob 1) with its own obstacles' SDF."""
    cfg = t_multi.EnvConfig(num_agents=2, ep_time=4.0,
                            neighbor_obs_type="pos_vel",
                            neighbor_visible_num=1, quads_mode="o_random",
                            use_obstacles=True, obst_spawn_area=(8.0, 8.0),
                            obst_density=0.2, obst_size=0.6)
    params = t_make_params(dt=cfg.dt)
    gen = torch.Generator().manual_seed(0)
    state, _ = t_multi.env_reset(cfg, params, gen, 1, device="cpu")
    rstate = t_replay.init_replay_state(state)
    rstate = rstate.replace(activated=torch.ones(1, dtype=torch.bool))
    k = int(torch.nonzero(state.obst_active[0])[0])
    saw_entry = saw_replay = False
    for t in range(440):            # ep_len 400: one episode and a reset
        actions = torch.rand((1, 2, 4), generator=gen) * 2 - 1
        if t == 170 and not saw_entry:
            pos = state.dyn.pos.clone()
            pos[0, 0, :2] = state.obst_pos[0, k, :2] + 0.1
            pos[0, 0, 2] = 3.0
            state = state.replace(dyn=state.dyn.replace(pos=pos))
        prev = state
        state, rstate, obs, rew, dones, info = t_replay.batched_replay_step(
            cfg, params, 1.0, state, rstate, actions, gen)
        assert torch.isfinite(obs).all()
        if int(rstate.buffer_count[0]) > 0 and not saw_entry:
            saw_entry = True
            assert t == 170
            assert bool(state.prev_obst_hits[0, 0])
            assert not (state.prev_coll_ids & ~prev.prev_coll_ids).any()
            assert int(rstate.buffer.tick[0, 0]) == 50
        if bool(rstate.saved_in_replay_buffer[0]) and not saw_replay:
            saw_replay = True
            assert int(state.tick[0]) == int(rstate.buffer.tick[0, 0])
            assert int(state.obst_collisions_per_episode[0]) == 0
            sdf = t_obst.surround_sdf_obs(
                state.dyn.pos[..., :2], state.obst_pos[..., :2],
                state.obst_active, state.obst_size / 2)
            assert torch.equal(obs[..., -9:], sdf)
            assert torch.equal(state.obst_active,
                               rstate.buffer.obst_active[:, 0])
    assert saw_entry, "the obstacle hit was not written to the buffer"
    assert saw_replay, "no episode was replayed despite sample_prob=1"


def test_obstacle_encoder_matches_flax(start):
    *_, jmodel, jpolicy, tmodel = start
    converted = actor_critic_from_flax(jax.tree.map(np.asarray, jpolicy))
    assert set(converted) == set(tmodel.state_dict())
    assert "actor_encoder.obstacle_encoder.layers.1.weight" in converted
    assert not any("neighbor_encoder" in k for k in converted)
    w = jpolicy["params"]["critic_encoder"]["obstacle_encoder"]["Dense_0"][
        "kernel"]
    np.testing.assert_array_equal(
        tmodel.critic_encoder.obstacle_encoder.layers[0].weight.detach()
        .numpy(), np.asarray(w).T)
    obs = np.random.default_rng(4).normal(0, 2, (37, OBS_DIM)).astype(
        np.float32)
    want = j_ac.apply_fused(jmodel, jpolicy, jnp.asarray(obs))
    with torch.no_grad():
        got = t_ac.apply_fused(tmodel, torch.from_numpy(obs))
    for name, g, w in zip(("mean", "log_std", "value"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   rtol=0.0, atol=2e-5)
