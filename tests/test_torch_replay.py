"""Collision replay of the port (quadswarm_tpu_torch/env/replay.py).

Against the JAX package: `batched_replay_step` and JAX's `replay_step`
(each env, vmapped and jitted once) run in lockstep for 10 ticks from one
mid-episode state of 4 envs x 4 drones (a port reset carried over to the
JAX package's EnvState), every random draw
injected into both.  The state is prepared so that on the first tick env 0
saves a checkpoint, env 1 saves one and writes the buffer (a new drone
collision), env 2 ends its episode and replays a buffered state, and env 3
ends its episode with its sampled slot replayed 10 times already, so it
starts afresh: the port resets it (checked by invariants), the JAX
`replay_step` leaves it terminal, and it leaves the comparison.  States
agree within the dynamics tolerance (rtol 2e-4, atol 2e-5 per field);
rings, counters and masks are equal.

On the port alone: the forced-collision replay and the can-fly gate (the
mirror of tests/test_replay.py), and the order of a tick's ring writes.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from quadswarm_tpu.env import collisions as j_coll
from quadswarm_tpu.env import downwash as j_downwash
from quadswarm_tpu.env import dynamics as j_dyn
from quadswarm_tpu.env import multi as j_multi
from quadswarm_tpu.env import replay as j_replay
from quadswarm_tpu.env import scenarios as j_scen
from quadswarm_tpu.env import sensor as j_sensor
from quadswarm_tpu.env.controls import raw_control
from quadswarm_tpu.env.params import make_dynamics_params as j_make_params
from quadswarm_tpu_torch.env import multi as t_multi
from quadswarm_tpu_torch.env import replay as t_replay
from quadswarm_tpu_torch.env.params import make_dynamics_params as t_make_params
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.utils.convert import (
    env_state_from_numpy, replay_state_from_numpy,
)
from quadswarm_tpu_torch.utils.struct import leaves, map_fields

from .test_torch_env_parts import (
    _JaxShim, _jax_state, assert_matches_jax, jax_tree_numpy,
)

E, N = 4, 4
ENV_KW = dict(num_agents=N, quads_mode="mix", neighbor_obs_type="pos_vel",
              neighbor_visible_num=2, collision_hitbox_radius=2.0,
              collision_falloff_radius=4.0, use_downwash=True, ep_time=2.5)
REWARD = dict(quadcol_bin=5.0, quadcol_bin_smooth_max=10.0)
SAMPLE_PROB = 0.75
TOL = dict(rtol=2e-4, atol=2e-5)
FIELD_TOL = {"omega_dot": dict(rtol=2e-4, atol=1e-3)}
SENSOR_ORDER = ("pos_n", "pos_u", "vel_n", "vel_u", "omega_n", "theta_n",
                "theta_u", "acc_n", "acc_dyn_n")
SKIP = ("scen_seed",)


class _TracedTape:
    """Stands in for `jax.random` in one JAX module under jit: each draw is
    the next of the given (possibly traced) arrays, in call order; a
    `randint` maps its unit uniform u to minval + floor(u * (maxval -
    minval)), as the port maps "replay_choice"."""

    def __init__(self, draws):
        self.draws = list(draws)

    def split(self, key, num=2):
        return jax.random.split(key, num)

    def fold_in(self, key, data):
        return jax.random.fold_in(key, data)

    def _next(self, shape):
        draw = self.draws.pop(0)
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return draw

    def normal(self, key, shape=(), dtype=jnp.float32):
        return self._next(shape).astype(dtype)

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                maxval=1.0):
        return (self._next(shape).astype(dtype) * (maxval - minval)
                + minval)

    def randint(self, key, shape, minval, maxval):
        u = self._next(shape).astype(jnp.float32)
        return (jnp.floor(u * (maxval - minval)).astype(jnp.int32)
                + jnp.asarray(minval, jnp.int32))


@contextlib.contextmanager
def _tape(module, draws):
    rnd = _TracedTape(draws)
    original = module.jax
    module.jax = _JaxShim(rnd)
    try:
        yield
    finally:
        module.jax = original
    assert not rnd.draws, f"{len(rnd.draws)} recorded draws left unused"


def _draws(rng, e=E, n=N) -> dict:
    u = lambda *s: rng.uniform(0, 1, (e, n) + s).astype(np.float32)
    g = lambda *s: rng.standard_normal((e, n) + s).astype(np.float32)
    sensor = lambda: {k: g(3) if k.endswith("_n") else np.zeros(
        (e, n, 3), np.float32) for k in SENSOR_ORDER}
    return {"ou": g(4), "yaw": (u() * 2 * np.pi - np.pi).astype(np.float32),
            "downwash": {"acc": u(1), "omega": u(1), "axis": u(3),
                         "dir": u(3)},
            "drone_normals": g(3, 3, 3), "drone_uniforms": u(6),
            "wall": u(11), "ceiling": u(10), "sensor": sensor(),
            "replay_sensor": sensor(),
            "replay_u": rng.uniform(0, 1, e).astype(np.float32),
            "replay_choice": rng.uniform(0, 1, e).astype(np.float32)}


def _torch(draws):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in draws.items()}


def _port_draws(draws):
    d = {k: v for k, v in draws.items() if k != "replay_sensor"}
    d["sensor"] = {k: v for k, v in draws["sensor"].items()
                   if k.endswith("_n")}
    d["replay_sensor"] = {k: v for k, v in draws["replay_sensor"].items()
                          if k.endswith("_n")}
    return _torch(d)


def _jax_tick_fn(jcfg, jparams):
    """The JAX replay tick of every env with injected draws, jitted once:
    the batched scenario step, each env's dynamics (OU draw and crash yaw
    injected), then `replay_step` with auto_reset=False and in-line ring
    writes, its env step's draws and its k_choice / k_sample taped."""
    dyn_cfg = jcfg.dynamics_config(arm=jparams.arm)

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

    def one_env(state, rstate, action, dyn, scen, d):
        j_coll.set_response_tape({"drone_normals": d["drone_normals"],
                                  "drone_uniforms": d["drone_uniforms"]})
        dw = [d["downwash"][k] for k in ("acc", "omega", "axis", "dir")]
        sensor = [d["sensor"][k] for k in SENSOR_ORDER] + [
            d["replay_sensor"][k] for k in SENSOR_ORDER]
        try:
            with _tape(j_downwash, dw), _tape(j_sensor, sensor), \
                    _tape(j_coll, [d["wall"], d["ceiling"]]), \
                    _tape(j_replay, [d["replay_choice"], d["replay_u"]]):
                return j_replay.replay_step(
                    jcfg, jparams, SAMPLE_PROB, state, rstate, action,
                    jax.random.PRNGKey(0), auto_reset=False,
                    dyn_override=dyn, scen_override=scen)
        finally:
            j_coll.set_response_tape(None)

    @jax.jit
    def tick(states, rstates, actions, draws):
        scen = j_scen.batched_scenario_step(
            jcfg.scenario_config(), states.scenario, states.tick + 1,
            jcfg.mode_list())
        dyn = jax.vmap(dynamics)(states.dyn, actions, draws["ou"],
                                 draws["yaw"])
        return jax.vmap(one_env)(states, rstates, actions, dyn, scen, draws)

    return tick


@pytest.fixture(scope="module")
def start():
    """4 envs mid-episode, each set up for one branch of the replay tick: a
    port reset carried over to the JAX package's EnvState (a JAX reset
    would compile for half a minute)."""
    jcfg = j_multi.EnvConfig(**ENV_KW)
    jparams = j_make_params()
    tcfg = t_multi.EnvConfig(**ENV_KW)
    gen = torch.Generator().manual_seed(5)
    tstate, tobs = t_multi.env_reset(tcfg, t_make_params(), gen, E,
                                     device="cpu",
                                     rew_coeff=RewardCoeffs(**REWARD))
    ep_len = jcfg.ep_len                                  # 250
    pos = tstate.dyn.pos.clone()
    pos[:, :, 2] = torch.clamp(pos[:, :, 2], min=1.5)
    pos[1, 1] = pos[1, 0] + torch.tensor([0.05, 0.0, 0.0])
    tstate = tstate.replace(
        dyn=tstate.dyn.replace(pos=pos),
        tick=torch.tensor([199, 199, ep_len, ep_len], dtype=torch.int32))
    jstate, jobs = _jax_state(tstate), jnp.asarray(tobs.numpy())

    rstate = jax.vmap(j_replay.init_replay_state)(jstate)
    # Ring slot s of env e: the env's state moved by 0.01 * (s + 1) m with
    # tick 100 + s, so every slot read is told apart.
    def mark(ring, k):
        off = 0.01 * (jnp.arange(k, dtype=jnp.float32) + 1.0)
        return ring.replace(
            tick=jnp.broadcast_to(100 + jnp.arange(k, dtype=jnp.int32),
                                  (E, k)),
            dyn=ring.dyn.replace(pos=ring.dyn.pos + off[None, :, None, None]))
    rstate = rstate.replace(
        ep_checkpoints=mark(rstate.ep_checkpoints, j_replay.EP_CP_SLOTS),
        buffer=mark(rstate.buffer, j_replay.BUFFER_SLOTS),
        activated=jnp.ones((E,), bool),
        ep_cp_count=jnp.asarray([3, 3, 4, 4], jnp.int32),
        buffer_count=jnp.asarray([0, 2, 5, 1], jnp.int32),
        buffer_idx=jnp.asarray([0, 2, 5, 1], jnp.int32),
        num_replayed=jnp.zeros((E, j_replay.BUFFER_SLOTS), jnp.int32)
        .at[3, 0].set(j_replay.MAX_REPLAYS).at[2, 3].set(4),
        episode_count=jnp.asarray([12, 12, 12, 12], jnp.int32),
        replayed_events=jnp.asarray([0, 1, 2, 0], jnp.int32))
    return jcfg, jparams, jstate, jobs, rstate


def _env(tree, keep):
    return jax.tree.map(lambda x: x[np.asarray(keep)], tree)


def _port_env(obj, keep):
    return map_fields(lambda x: x[keep], obj)


def test_replay_step_lockstep_with_jax(start):
    jcfg, jparams, jstate, _, jrstate = start
    tick = _jax_tick_fn(jcfg, jparams)
    tcfg = t_multi.EnvConfig(**ENV_KW)
    tparams = t_make_params()
    tstate = env_state_from_numpy(jax_tree_numpy(jstate))
    trstate = replay_state_from_numpy(jax_tree_numpy(jrstate))
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    keep = [0, 1, 2]
    fired = dict(checkpoint=False, collision_write=False, replay=False,
                 fresh_reset=False)
    for t in range(10):
        actions = rng.uniform(-1, 1, (E, N, 4)).astype(np.float32)
        draws = _draws(rng)
        if t == 0:
            draws["replay_u"][:] = [0.9, 0.9, 0.1, 0.2]
            draws["replay_choice"][:] = [0.5, 0.5, 0.7, 0.5]
        prev_r = trstate
        counts = (trstate.ep_cp_count.clone(), trstate.buffer_count.clone(),
                  trstate.replayed_events.clone())
        jstate, jrstate, jobs, jrew, jdones, jinfo = tick(
            jstate, jrstate, jnp.asarray(actions),
            jax.tree.map(jnp.asarray, draws))
        tstate, trstate, tobs, trew, tdones, tinfo = t_replay.batched_replay_step(
            tcfg, tparams, SAMPLE_PROB, tstate, trstate,
            torch.from_numpy(actions), gen, _port_draws(draws))
        fired["checkpoint"] |= bool((trstate.ep_cp_count[keep]
                                     > counts[0][keep]).any())
        fired["collision_write"] |= bool((trstate.buffer_count
                                          > counts[1]).any())
        fired["replay"] |= bool((trstate.replayed_events > counts[2]).any())
        if t == 0:
            assert tdones[:, 0].tolist() == [False, False, True, True]
            assert tinfo["episode_done"].tolist() == [False, False, True,
                                                      True]
            assert_matches_jax(trstate, jrstate, skip=SKIP, tol=TOL,
                               field_tol=FIELD_TOL)
            # env 1 saved a checkpoint into slot 3 and, on the same tick,
            # wrote the one from 1.5 s before (slot (4 - 3) % 6 = 1, read
            # before the write) into buffer slot 2
            assert int(trstate.ep_checkpoints.tick[1, 3]) == 200
            assert int(trstate.buffer.tick[1, 2]) == 101
            assert torch.equal(trstate.buffer.dyn.pos[1, 2],
                               prev_r.ep_checkpoints.dyn.pos[1, 1])
            _check_fresh_reset(tcfg, tstate, trstate, tobs, 3)
            fired["fresh_reset"] = True
        assert_matches_jax(_port_env(tstate, keep), _env(jstate, keep),
                           skip=SKIP, tol=TOL, field_tol=FIELD_TOL)
        assert_matches_jax(_port_env(trstate, keep), _env(jrstate, keep),
                           skip=SKIP, tol=TOL, field_tol=FIELD_TOL)
        np.testing.assert_allclose(tobs[keep].numpy(),
                                   np.asarray(jobs)[keep], **TOL)
        np.testing.assert_allclose(trew[keep].numpy(),
                                   np.asarray(jrew)[keep], **TOL)
        for key in ("replay/replay_rate", "replay/replay_buffer_size",
                    "replay/activated", "num_collisions"):
            np.testing.assert_allclose(tinfo[key][keep].numpy(),
                                       np.asarray(jinfo[key])[keep],
                                       rtol=1e-6, err_msg=key)
    assert all(fired.values()), fired
    # env 2 replayed buffer slot floor(0.7 * 5) = 3, with its tick
    assert int(trstate.num_replayed[2, 3]) == 5
    assert bool(trstate.saved_in_replay_buffer[2])


def _check_fresh_reset(cfg, state, rstate, obs, e):
    """Env e started a fresh episode: counters zero, no pair history,
    drones still, near the spawn points; its replay counters say done."""
    assert int(state.tick[e]) == 0 and int(state.scenario.event_count[e]) == 0
    assert int(state.collisions_per_episode[e]) == 0
    assert not state.prev_coll_pairs[e].any()
    assert not state.reached_goal[e].any()
    assert torch.equal(state.dyn.vel[e], torch.zeros(N, 3))
    assert torch.equal(state.dist5[e], torch.zeros(N, 5))
    spawn = state.scenario.spawn_points[e]
    assert float((state.dyn.pos[e, :, :2] - spawn[:, :2]).abs().max()) <= 2.0
    assert torch.isfinite(obs[e]).all()
    assert not bool(rstate.saved_in_replay_buffer[e])
    assert int(rstate.ep_cp_count[e]) == 0
    assert int(rstate.last_tick_added[e]) == t_replay.NO_TICK


@pytest.mark.parametrize("pairs", [False, True])
def test_forced_collision_is_buffered_and_replayed(pairs):
    """The mirror of tests/test_replay.py: a mid-air collision after the
    grace period puts the pre-collision checkpoint into the buffer, and the
    next episode replays it (sample_prob 1).  On the pairs route the rings
    hold the packed pair history."""
    cfg = t_multi.EnvConfig(num_agents=2, ep_time=4.0,
                            neighbor_obs_type="pos_vel",
                            neighbor_visible_num=1,
                            quads_mode="static_same_goal",
                            use_pallas_pairs=pairs)
    params = t_make_params(dt=cfg.dt)
    gen = torch.Generator().manual_seed(0)
    state, _ = t_multi.env_reset(cfg, params, gen, 1, device="cpu")
    rstate = t_replay.init_replay_state(state)
    rstate = rstate.replace(activated=torch.ones(1, dtype=torch.bool))
    if pairs:
        assert rstate.buffer.prev_coll_pairs.shape == (1, 20, 2, 128)
        assert rstate.buffer.prev_coll_pairs.dtype == torch.int32
    saw_entry = saw_replay = False
    for t in range(440):           # ep_len 400: one episode and a reset
        actions = torch.rand((1, 2, 4), generator=gen) * 2 - 1
        if t == 170 and not saw_entry:
            pos = torch.tensor([[[0.0, 0.0, 3.0], [0.05, 0.0, 3.0]]])
            state = state.replace(dyn=state.dyn.replace(pos=pos))
        state, rstate, obs, rew, dones, info = t_replay.batched_replay_step(
            cfg, params, 1.0, state, rstate, actions, gen)
        assert torch.isfinite(obs).all()
        if int(rstate.buffer_count[0]) > 0 and not saw_entry:
            saw_entry = True
            # checkpoints at ticks 50, 100, 150: the buffer takes the one
            # three back, 1.5 s before the next
            assert int(rstate.buffer.tick[0, 0]) == 50
        if bool(rstate.saved_in_replay_buffer[0]) and not saw_replay:
            saw_replay = True
            assert int(state.tick[0]) == int(rstate.buffer.tick[0, 0])
            assert int(state.collisions_per_episode[0]) == 0
            assert int(rstate.num_replayed[0, 0]) == 1
    assert saw_entry, "no checkpoint was ever written to the buffer"
    assert saw_replay, "no episode was replayed despite sample_prob=1"


def test_can_fly_gate():
    """The gate opens after 10 episodes averaging under one crash."""
    cfg = t_multi.EnvConfig(num_agents=1, ep_time=0.2,
                            neighbor_obs_type="none",
                            quads_mode="static_same_goal")
    params = t_make_params(dt=cfg.dt)
    gen = torch.Generator().manual_seed(1)
    state, _ = t_multi.env_reset(cfg, params, gen, 2, device="cpu")
    rstate = t_replay.init_replay_state(state)
    # env 1 crashed in every one of its last 100 episodes
    rstate = rstate.replace(crash_history=torch.stack(
        [torch.zeros(100), torch.full((100,), 5.0)]),
        episode_count=torch.tensor([0, 100], dtype=torch.int32))
    actions = torch.full((2, 1, 4), 0.25)      # hover: off the floor
    opened_at = None
    for t in range(300):
        state, rstate, *_ = t_replay.batched_replay_step(
            cfg, params, 0.75, state, rstate, actions, gen)
        if opened_at is None and bool(rstate.activated[0]):
            opened_at = int(rstate.episode_count[0])
    assert int(rstate.episode_count[0]) >= 10
    assert opened_at == 10, opened_at
    assert not bool(rstate.activated[1])
