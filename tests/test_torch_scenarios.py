"""Parity of the port's scenarios with the JAX package.

One JAX ScenarioState per mode of the multi-drone mix and per mode beyond
it (run_away and the obstacle modes, on an obstacle map), reset by the JAX
package in one compile with their event tables, is converted to the port;
both then step tick by tick through each mode's first events, and must
agree on every field.  The port's reset draws from a torch generator, not
from the JAX keys, so its samplers are checked by invariants instead, and
its own episodes by playback.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.env import scenarios as js
from quadswarm_tpu_torch.env import obstacles as t_obst
from quadswarm_tpu_torch.env import scenarios as ts
from quadswarm_tpu_torch.env.multi import (
    EnvConfig, batched_env_step, env_reset,
)
from quadswarm_tpu_torch.env.params import make_dynamics_params
from quadswarm_tpu_torch.utils.convert import scenario_state_from_numpy

from .test_torch_env_parts import assert_matches_jax, jax_tree_numpy

N = 8
J_CFG = js.ScenarioConfig(num_agents=N, control_freq=100.0, ep_time=15.0)
T_CFG = ts.ScenarioConfig(num_agents=N, control_freq=100.0, ep_time=15.0)
MODES = js.MIX_MODES_MULTI


# The modes beyond the two mixes: run_away and the obstacle modes.
NEW_MODES = tuple(js.MODE_IDS[m] for m in (
    "run_away", "o_dynamic_same_goal", "o_swap_goals", "o_ep_rand_bezier",
    "o_uniform_same_goal_spawn", "o_diagonal", "o_static_diff_goal",
    "o_dynamic_diff_goal", "o_test"))
ALL_MODES = MODES + NEW_MODES
CENTERS = t_obst.cell_centers(6, 6).astype(np.float32)


def _obstacle_maps(seed: int, e: int) -> np.ndarray:
    """(E, 36) occupancy at density 0.2 (7 cells of 36), from numpy."""
    rng = np.random.default_rng(seed)
    maps = np.zeros((e, 36), bool)
    for row in maps:
        row[rng.choice(36, 7, replace=False)] = True
    return maps


@pytest.fixture(scope="module")
def jax_resets():
    """The JAX reset of one env per mode of the mix and one per mode beyond
    it (those with an obstacle map), in one compile: (mix envs, others)."""
    keys = jnp.concatenate([jax.random.split(jax.random.PRNGKey(3), 9),
                            jax.random.split(jax.random.PRNGKey(5), 9)])
    maps = np.concatenate([np.zeros((9, 36), bool), _obstacle_maps(0, 9)])
    reset = jax.jit(jax.vmap(lambda k, m, a: js.scenario_reset(
        J_CFG, k, m, a, jnp.asarray(CENTERS), jnp.float32,
        allowed_modes=ALL_MODES)))
    st = reset(keys, jnp.asarray(ALL_MODES, jnp.int32), jnp.asarray(maps))
    return (jax.tree.map(lambda x: x[:9], st),
            jax.tree.map(lambda x: x[9:], st))


@pytest.fixture(scope="module")
def jax_reset(jax_resets):
    return jax_resets[0]


def test_scenario_step_matches_jax_through_events(jax_reset):
    jst = jax_reset
    tst = scenario_state_from_numpy(jax_tree_numpy(jst))
    assert tst.events.shape == (len(MODES), ts.num_event_slots(
        T_CFG, ALL_MODES) * ts.event_table_width(N))
    interval = np.asarray(jst.interval)
    bezier = np.asarray(jst.mode) == js.MODE_IDS["ep_rand_bezier"]
    first_event = np.where(bezier, 5 * 100, interval)
    tick_rows = [np.full(len(MODES), t) for t in (1, 2, 3)] + [
        first_event + d for d in (-1, 0, 1)]
    df = np.asarray(jst.mode) == js.MODE_IDS["dynamic_formations"]
    for ticks in tick_rows:
        size, hi = np.asarray(jst.formation_size), np.asarray(jst.highest_size)
        assert not np.any(df & ((size <= -hi) | (size >= hi))), \
            "this seed must not hit a dynamic_formations speed resample"
        jst = js.batched_scenario_step(J_CFG, jst,
                                       jnp.asarray(ticks, jnp.int32), MODES)
        tst = ts.batched_scenario_step(T_CFG, tst,
                                       torch.as_tensor(ticks, dtype=torch.int32))
        assert_matches_jax(tst, jst, skip=("scen_seed",),
                           tol=dict(rtol=1e-6, atol=1e-6))
    # every interval mode fired its first event, the Bezier env two events
    counts = np.asarray(jst.event_count)
    modes = np.asarray(jst.mode)
    for m, c in zip(modes, counts):
        want = 2 if m == js.MODE_IDS["ep_rand_bezier"] else (
            1 if m in (2, 3, 4, 8) else 0)
        assert c == want, (js.MODES[m], c)
    np.testing.assert_array_equal(tst.event_count.numpy(), counts)


@pytest.fixture(scope="module")
def port_reset():
    modes = torch.as_tensor(MODES, dtype=torch.int32).repeat(24)
    gen = torch.Generator().manual_seed(0)
    return ts.scenario_reset(T_CFG, gen, modes, allowed_modes=MODES)


def test_reset_sampler_invariants(port_reset):
    st = port_reset
    mode = st.mode.numpy()
    e = mode.shape[0]
    assert st.goals.shape == (e, N, 3) and torch.isfinite(st.goals).all()
    fid = st.formation.numpy()
    assert np.all(fid >= 0) and np.all(fid < ts.MODE_NUM_CHOICES[mode])
    lo, hi = st.lowest_size.numpy(), st.highest_size.numpy()
    size = st.formation_size.numpy()
    assert np.all(lo <= size + 1e-6) and np.all(size <= hi + 1e-6)
    ld = st.layer_dist.numpy()
    assert np.all(lo <= ld + 1e-6) and np.all(ld <= hi + 1e-6)
    iv = st.interval.numpy()
    assert np.all((iv >= 400) & (iv < 600))
    speed = st.control_speed.numpy()
    assert np.all((speed >= 1.0) & (speed <= 3.0))
    assert np.all(st.event_count.numpy() == 0)
    np.testing.assert_array_equal(st.goals.numpy(), st.spawn_points.numpy())
    # static/dynamic same goal and lissajous: a point formation (size 0)
    for name in ("static_same_goal", "dynamic_same_goal", "ep_lissajous3D"):
        g = st.goals.numpy()[mode == ts.MODE_IDS[name]]
        np.testing.assert_allclose(g, np.broadcast_to(g[:, :1], g.shape))
    liss = mode == ts.MODE_IDS["ep_lissajous3D"]
    np.testing.assert_allclose(st.formation_center.numpy()[liss],
                               np.broadcast_to([-2.0, 0.0, 2.0],
                                               (liss.sum(), 3)))
    # goals == goals_base + size * goals_slope (the affine cache)
    pts = st.goals_base + st.formation_size[:, None, None] * st.goals_slope
    keep = ~np.isin(mode, [ts.MODE_IDS["ep_lissajous3D"],
                           ts.MODE_IDS["swarm_vs_swarm"]])
    np.testing.assert_allclose(np.sort(pts.numpy()[keep], axis=1),
                               np.sort(st.goals.numpy()[keep], axis=1),
                               atol=1e-5)
    # Bezier: the curve starts at the first goal
    bez = mode == ts.MODE_IDS["ep_rand_bezier"]
    np.testing.assert_allclose(st.bezier_nodes.numpy()[bez][:, :, 0],
                               st.goals.numpy()[bez][:, 0])


def test_presampled_event_chain_invariants(port_reset):
    st = port_reset
    mode = st.mode.numpy()
    d = ts.event_table_width(N)
    k = st.events.shape[-1] // d
    rows = [ts._unpack_row(st.events[:, j * d:(j + 1) * d], N, torch.float32)
            for j in range(k)]
    prev_goals = st.goals.numpy()
    swap = mode == ts.MODE_IDS["swap_goals"]
    dsg = mode == ts.MODE_IDS["dynamic_same_goal"]
    svs = mode == ts.MODE_IDS["swarm_vs_swarm"]
    static = np.isin(mode, [0, 1, 5, 6])
    for j, row in enumerate(rows):
        goals = row["goals"].numpy()
        # swap_goals: each event permutes the previous goals
        np.testing.assert_allclose(np.sort(goals[swap], axis=1),
                                   np.sort(prev_goals[swap], axis=1))
        # dynamic_same_goal: one shared goal at the new formation center
        center = row["formation_center"].numpy()[dsg]
        np.testing.assert_allclose(goals[dsg],
                                   np.broadcast_to(center[:, None], (
                                       dsg.sum(), N, 3)), atol=1e-6)
        assert np.all(center[:, 2] >= 0.25)
        # swarm_vs_swarm: the two centers swap at every event
        c1, c2 = row["goal_center_1"].numpy(), row["goal_center_2"].numpy()
        prev = rows[j - 1] if j else {"goal_center_1": st.goal_center_1,
                                      "goal_center_2": st.goal_center_2}
        np.testing.assert_array_equal(c1[svs],
                                      np.asarray(prev["goal_center_2"])[svs])
        np.testing.assert_array_equal(c2[svs],
                                      np.asarray(prev["goal_center_1"])[svs])
        # modes without events keep their reset values
        np.testing.assert_array_equal(goals[static], st.goals.numpy()[static])
        prev_goals = goals


# --------------------------------------------------------------------------
# The modes beyond the two mixes: run_away and the obstacle modes
# --------------------------------------------------------------------------

def test_new_modes_play_back_jax_events(jax_resets):
    """A JAX reset of each new mode, converted, stepped in both packages
    through ticks 1-3 and around each mode's first event (run_away's 1 s,
    o_dynamic_same_goal's tick 1 and interval, the obstacle Bezier's 6 s
    resample, o_test's interval + 1): every field agrees."""
    jst = jax_resets[1]
    tst = scenario_state_from_numpy(jax_tree_numpy(jst))
    mode = np.asarray(jst.mode)
    interval = np.asarray(jst.interval)
    assert interval[mode == js.MODE_IDS["run_away"]][0] == 100
    first = np.where(mode == js.MODE_IDS["o_ep_rand_bezier"], 600,
                     np.where(mode == js.MODE_IDS["o_test"], interval + 1,
                              interval))
    tick_rows = [np.full(len(NEW_MODES), t) for t in (1, 2, 3)] + [
        first + d for d in (-1, 0, 1)]
    for ticks in tick_rows:
        jst = js.batched_scenario_step(J_CFG, jst,
                                       jnp.asarray(ticks, jnp.int32),
                                       NEW_MODES)
        tst = ts.batched_scenario_step(
            T_CFG, tst, torch.as_tensor(ticks, dtype=torch.int32))
        assert_matches_jax(tst, jst, skip=("scen_seed",),
                           tol=dict(rtol=1e-6, atol=1e-6))
    want = {"run_away": 1, "o_dynamic_same_goal": 2, "o_swap_goals": 1,
            "o_ep_rand_bezier": 2, "o_dynamic_diff_goal": 1, "o_test": 1}
    counts = tst.event_count.numpy()
    for m, c in zip(mode, counts):
        assert c == want.get(js.MODES[m], 0), (js.MODES[m], c)
    np.testing.assert_array_equal(counts, np.asarray(jst.event_count))


@pytest.fixture(scope="module")
def port_reset_new_modes():
    modes = torch.as_tensor(NEW_MODES, dtype=torch.int32).repeat(8)
    e = modes.shape[0]
    active = torch.as_tensor(_obstacle_maps(1, e))
    gen = torch.Generator().manual_seed(2)
    st = ts.scenario_reset(T_CFG, gen, modes, allowed_modes=NEW_MODES,
                           obst_active=active,
                           obst_centers=torch.as_tensor(CENTERS))
    return st, active.numpy()


def _cell_of(points: np.ndarray) -> np.ndarray:
    """The index of the grid cell centred under each point's xy (-1 when
    none is)."""
    d = np.abs(points[..., None, :2] - CENTERS).max(-1)
    return np.where(d.min(-1) < 1e-6, d.argmin(-1), -1)


def test_new_mode_reset_invariants(port_reset_new_modes):
    st, active = port_reset_new_modes
    mode = st.mode.numpy()
    goals, spawn = st.goals.numpy(), st.spawn_points.numpy()
    for pts in (goals, spawn):
        assert np.isfinite(pts).all()
        assert np.all(np.abs(pts[..., :2]) <= 5.0)
        assert np.all((pts[..., 2] >= 0.0) & (pts[..., 2] <= 10.0))
    # the obstacle modes but o_test spawn on free cells
    obst = np.isin(mode, [m for m in NEW_MODES if m >= 10 and m != 19])
    cells = _cell_of(spawn)
    assert np.all(cells[obst] >= 0)
    free = ~np.take_along_axis(active, np.maximum(cells, 0), 1)
    assert np.all(free[obst])
    # shared-goal modes: one goal, at the end point
    shared = np.isin(mode, [js.MODE_IDS[m] for m in (
        "o_dynamic_same_goal", "o_ep_rand_bezier",
        "o_uniform_same_goal_spawn", "o_diagonal")])
    np.testing.assert_array_equal(
        goals[shared], np.broadcast_to(st.end_point.numpy()[shared, None],
                                       goals[shared].shape))
    # o_diagonal: the spawn cells are the free cells nearest one corner, the
    # goal the free cell nearest the opposite one
    for i in np.flatnonzero(mode == js.MODE_IDS["o_diagonal"]):
        ok = False
        for sign in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            score = CENTERS @ np.asarray(sign, np.float32)
            fscore = score[~active[i]]
            spawn_score = score[_cell_of(spawn[i])]
            goal_score = score[_cell_of(goals[i, :1])][0]
            ok |= (goal_score == fscore.min()
                   and spawn_score.min() >= np.sort(fscore)[::-1][N - 1])
        assert ok, i
        np.testing.assert_array_equal(spawn[i, :, 2], 2.0)
    # o_test: a point formation at the start, its end point opposite
    test = mode == js.MODE_IDS["o_test"]
    np.testing.assert_allclose(goals[test], np.broadcast_to(
        ts.O_TEST_START, goals[test].shape))
    np.testing.assert_array_equal(st.end_point.numpy()[test],
                                  np.broadcast_to(ts.O_TEST_END, (test.sum(), 3)))
    iv = st.interval.numpy()
    assert np.all((iv[test] >= 200) & (iv[test] < 400))
    assert np.all(iv[mode == js.MODE_IDS["run_away"]] == 100)
    # Bezier: the curve starts at the goal, its points in z 1.5-3 bounds
    bez = mode == js.MODE_IDS["o_ep_rand_bezier"]
    np.testing.assert_allclose(st.bezier_nodes.numpy()[bez][:, :, 0],
                               goals[bez][:, 0])


def test_new_mode_events_by_playback(port_reset_new_modes):
    """The port's own episodes, played back tick by tick for 7 s (past
    every mode's first event): run_away fires every second, o_test once
    (its goals reach the end point after its interval),
    o_dynamic_same_goal at tick 1 and every interval, the obstacle Bezier
    at tick 1 and every 6 s; goals stay in the room."""
    st, active = port_reset_new_modes
    mode = st.mode.numpy()
    iv = st.interval.numpy()
    test = mode == js.MODE_IDS["o_test"]
    prev = st.event_count.numpy()
    for tick in range(1, 701):
        st = ts.batched_scenario_step(
            T_CFG, st, torch.full((mode.shape[0],), tick, dtype=torch.int32))
        count = st.event_count.numpy()
        fired = count - prev
        prev = count
        ra = mode == js.MODE_IDS["run_away"]
        assert np.all(fired[ra] == (tick % 100 == 0)), tick
        odsg = mode == js.MODE_IDS["o_dynamic_same_goal"]
        assert np.all(fired[odsg] == ((tick == 1) | (tick % iv[odsg] == 0)))
        ob = mode == js.MODE_IDS["o_ep_rand_bezier"]
        assert np.all(fired[ob] == ((tick == 1) | (tick % 600 == 0)))
        assert np.all(fired[test] == (tick == iv[test] + 1))
        if tick in (int(iv[test].min()), int(iv[test].max()) + 1):
            g = st.goals.numpy()[test]
            done = tick > iv[test]
            np.testing.assert_allclose(g[done], np.broadcast_to(
                ts.O_TEST_END, g[done].shape), atol=1e-6)
        if tick % 100 == 0:
            g = st.goals.numpy()
            assert np.isfinite(g).all() and np.all(np.abs(g[..., :2]) <= 5.0)
            assert np.all((g[..., 2] >= 0.0) & (g[..., 2] <= 10.0))
    np.testing.assert_array_equal(prev[mode == js.MODE_IDS["run_away"]], 7)


def test_counter_uniform_stream():
    seed = torch.arange(4096, dtype=torch.int64) * 7919
    u1 = ts.counter_uniform(seed, torch.full((4096,), 17))
    u2 = ts.counter_uniform(seed, torch.full((4096,), 18))
    assert torch.equal(u1, ts.counter_uniform(seed, torch.full((4096,), 17)))
    assert float(u1.min()) >= 0.0 and float(u1.max()) < 1.0
    assert abs(float(u1.mean()) - 0.5) < 0.02
    assert abs(float(torch.corrcoef(torch.stack([u1, u2]))[0, 1])) < 0.1


def test_unported_modes_raise():
    """The modes refused before they were ported now build and run: an
    o_swap_goals reset and tick, run_away's and o_dynamic_same_goal's env
    configs (the latter with obstacles) through a reset and a tick; an
    unknown mode id still raises."""
    gen = torch.Generator().manual_seed(0)
    st = ts.scenario_reset(T_CFG, gen,
                           torch.tensor([js.MODE_IDS["o_swap_goals"]]))
    st = ts.batched_scenario_step(T_CFG, st, torch.ones(1, dtype=torch.int32))
    assert torch.isfinite(st.goals).all()
    for cfg in (EnvConfig(num_agents=4, quads_mode="run_away"),
                EnvConfig(num_agents=4, use_obstacles=True,
                          quads_mode="o_dynamic_same_goal")):
        cfg.check_supported()
        params = make_dynamics_params(dt=cfg.dt)
        state, obs = env_reset(cfg, params, gen, 2, device="cpu")
        state, obs, *_ = batched_env_step(cfg, params, state,
                                          torch.zeros(2, 4, 4), gen)
        assert obs.shape == (2, 4, cfg.obs_dim) and torch.isfinite(obs).all()
    with pytest.raises(ValueError, match="unknown scenario mode"):
        ts.check_modes([len(ts.MODES)])
