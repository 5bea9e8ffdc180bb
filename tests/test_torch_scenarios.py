"""Parity of the port's scenarios with the JAX package.

One JAX ScenarioState per mode of the multi-drone mix (reset by the JAX
package, event table included) is converted to the port; both then step
tick by tick through the tick-1 Bezier event and the first interval event
of every interval mode, and must agree on every field.  The port's reset
draws from a torch generator, not from the JAX keys, so its samplers are
checked by invariants instead.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.env import scenarios as js
from quadswarm_tpu_torch.env import scenarios as ts
from quadswarm_tpu_torch.env.multi import EnvConfig
from quadswarm_tpu_torch.utils.convert import scenario_state_from_numpy

from .test_torch_env_parts import assert_matches_jax, jax_tree_numpy

N = 8
J_CFG = js.ScenarioConfig(num_agents=N, control_freq=100.0, ep_time=15.0)
T_CFG = ts.ScenarioConfig(num_agents=N, control_freq=100.0, ep_time=15.0)
MODES = js.MIX_MODES_MULTI


@pytest.fixture(scope="module")
def jax_reset():
    keys = jax.random.split(jax.random.PRNGKey(3), len(MODES))
    reset = jax.jit(jax.vmap(lambda k, m: js.scenario_reset(
        J_CFG, k, m, None, None, jnp.float32, allowed_modes=MODES)))
    return reset(keys, jnp.asarray(MODES, jnp.int32))


def test_scenario_step_matches_jax_through_events(jax_reset):
    jst = jax_reset
    tst = scenario_state_from_numpy(jax_tree_numpy(jst))
    assert tst.events.shape == (len(MODES), ts.num_event_slots(T_CFG, MODES)
                                * ts.event_table_width(N))
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


def test_counter_uniform_stream():
    seed = torch.arange(4096, dtype=torch.int64) * 7919
    u1 = ts.counter_uniform(seed, torch.full((4096,), 17))
    u2 = ts.counter_uniform(seed, torch.full((4096,), 18))
    assert torch.equal(u1, ts.counter_uniform(seed, torch.full((4096,), 17)))
    assert float(u1.min()) >= 0.0 and float(u1.max()) < 1.0
    assert abs(float(u1.mean()) - 0.5) < 0.02
    assert abs(float(torch.corrcoef(torch.stack([u1, u2]))[0, 1])) < 0.1


def test_unported_modes_raise():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        ts.scenario_reset(T_CFG, gen,
                          torch.tensor([js.MODE_IDS["o_swap_goals"]]))
    with pytest.raises(NotImplementedError):
        EnvConfig(quads_mode="run_away").check_supported()
    with pytest.raises(NotImplementedError, match="item 11b"):
        EnvConfig(use_obstacles=True,
                  quads_mode="o_dynamic_same_goal").check_supported()
