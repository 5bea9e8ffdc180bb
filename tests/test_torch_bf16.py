"""bfloat16 compute in the port against the JAX package's.

- The models (`--model_dtype=bfloat16`): every encoder type of
  tests/test_torch_encoder_zoo.py computing in bfloat16 from the same
  float32 parameters as flax's `dtype=bfloat16` module: mean and value
  within rtol 2e-2 plus 2e-2 of the output's largest entry (the largest
  difference seen is 1.1e-2 of the largest entry, about three bfloat16
  ulps; the log std, a float32 parameter, is equal).
- The PPO loss and its gradients on a bfloat16 model against JAX's (loss
  math in float32 in both): the loss and its metrics within 2e-2; each
  gradient entry within rtol 1e-2 plus 1e-2 of the model's largest
  gradient entry (the largest difference seen is 6% of that bound), and
  the whole gradient within 1e-2 in relative L2 norm; an Adam step keeps
  the parameters and the moments float32.
- The env at `--dtype=bfloat16`: a port reset at bfloat16 (the event table
  float32) with interacting drones, carried over to the JAX package's
  EnvState, stepped 3 ticks with every draw injected, the JAX tick jitted
  once with its dynamics through the Pallas kernel in interpret mode (the
  wrapper casts the state into float32 and back, as the port's K1 does):
  every leaf has JAX's dtype, and every float leaf, the
  observations and the rewards are within rtol 2e-2 plus 2e-2 of the
  leaf's largest entry.  All 7 neighbours are visible, so no neighbour
  sort decides between two bfloat16 metrics one ulp apart.  The reset at
  bfloat16 has the dtypes of JAX's reset (`jax.eval_shape`, no compile),
  and the event table stays float32 so interval ticks survive.
- A bfloat16 env on the pairs route: the pair kernels' wrappers cast its
  positions and velocities to float32; collisions as on the dense route.
- A bfloat16 run of the train CLI evaluated by the eval CLI, both loops.
- K1's plain version on a bfloat16 state against the Pallas kernel in
  interpret mode: within one bfloat16 ulp (rtol 2**-7, atol 1e-6).
"""
from __future__ import annotations

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
from quadswarm_tpu.env import scenarios as j_scen
from quadswarm_tpu.env import sensor as j_sensor
from quadswarm_tpu.env.params import make_dynamics_params as j_make_params
from quadswarm_tpu.models import actor_critic as j_ac
from quadswarm_tpu.ops.pallas import dynamics_kernel as j_kernel
from quadswarm_tpu.parallel import ppo as j_ppo
from quadswarm_tpu_torch.env import dynamics as t_dyn
from quadswarm_tpu_torch.env import multi as t_multi
from quadswarm_tpu_torch.env import scenarios as t_scen
from quadswarm_tpu_torch.env.params import make_dynamics_params as t_make_params
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.models import actor_critic as t_ac
from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as t_kernel
from quadswarm_tpu_torch.parallel import ppo as t_ppo
from quadswarm_tpu_torch.utils.convert import (
    actor_critic_from_flax, drone_state_from_numpy, env_state_from_numpy,
)
from quadswarm_tpu_torch.utils.struct import leaves

from .flax_params import random_flax_params
from .test_torch_dynamics import _inputs
from .test_torch_encoder_zoo import BASE, CASES, _obs_dim
from .test_torch_env_parts import jax_tree_numpy
from .test_torch_env_parts import _jax_state
from .test_torch_obstacle_env import _port_draws
from .test_torch_replay import SENSOR_ORDER, _tape
from .test_torch_replay import _draws as _replay_draws

BF = jnp.bfloat16
MODEL_TOL = 2e-2
LOSS_TOL = 2e-2
GRAD_TOL = 1e-2
ENV_TOL = 2e-2
ULP = 2.0 ** -7


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol: float, msg: str = "") -> None:
    """|got - want| <= tol * |want| + tol * max|want|."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    big = float(np.max(np.abs(w))) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * big + 1e-30,
                               err_msg=msg)


def _bf16_pair(case: str, seed: int = 0):
    kw = {**BASE, **CASES[case]}
    jmodel = j_ac.ActorCritic(**kw, dtype=BF)
    params = random_flax_params(jmodel, _obs_dim(kw), seed)
    tmodel = t_ac.ActorCritic(
        **kw, obstacle_obs_dim=9 if kw.get("use_obstacles") else 0,
        dtype=torch.bfloat16, device="cpu")
    tmodel.load_state_dict(actor_critic_from_flax(params))
    return jmodel, jax.tree.map(jnp.asarray, params), tmodel, _obs_dim(kw)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_models_match_flax(case):
    jmodel, params, tmodel, obs_dim = _bf16_pair(case)
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    obs = np.random.default_rng(1).normal(0, 2, (64, obs_dim)).astype(
        np.float32)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(obs))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(obs))
    for name, g, w in zip(("mean", "log_std", "value"), got, want):
        assert str(g.dtype).split(".")[1] == str(w.dtype), name
        _close(g, w, MODEL_TOL, f"{case} {name}")
    np.testing.assert_array_equal(_f32(got[1]), _f32(want[1]))


def test_bf16_ppo_loss_gradients_and_adam_step_match_jax():
    from .test_torch_training import MODEL_KW, OBS_DIM, PPO_KW, _batch
    jmodel = j_ac.ActorCritic(**MODEL_KW, dtype=BF)
    params = jax.tree.map(jnp.asarray,
                          random_flax_params(jmodel, OBS_DIM, seed=2))
    tmodel = t_ac.ActorCritic(**MODEL_KW, dtype=torch.bfloat16, device="cpu")
    tmodel.load_state_dict(actor_critic_from_flax(
        jax.tree.map(np.asarray, params)))
    batch = _batch(np.random.default_rng(3))
    jcfg, tcfg = j_ppo.PPOConfig(**PPO_KW), t_ppo.PPOConfig(**PPO_KW)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: j_ppo.ppo_loss(jmodel, jcfg, p, b), has_aux=True))(
        params, tuple(jnp.asarray(x) for x in batch))
    loss, metrics = t_ppo.ppo_loss(
        tmodel, tcfg, tuple(torch.from_numpy(x) for x in batch))
    assert loss.dtype == torch.float32
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    want = actor_critic_from_flax(jax.tree.map(np.asarray, jgrads))
    largest = max(float(w.abs().max()) for w in want.values())
    flat_g, flat_w = [], []
    for name, p in tmodel.named_parameters():
        assert p.grad.dtype == torch.float32, name
        np.testing.assert_allclose(_f32(p.grad), _f32(want[name]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL * largest,
                                   err_msg=name)
        flat_g.append(p.grad.reshape(-1))
        flat_w.append(want[name].reshape(-1))
    g, w = torch.cat(flat_g), torch.cat(flat_w)
    assert float((g - w).norm() / w.norm()) < GRAD_TOL
    opt = t_ppo.make_optimizer(tmodel, tcfg)
    t_ppo.apply_gradients(tmodel, opt, tcfg.max_grad_norm)
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    assert all(v.dtype == torch.float32 for st in opt.state.values()
               for k, v in st.items() if k != "step")


# --------------------------------------------------------------------------
# The env at --dtype=bfloat16
# --------------------------------------------------------------------------

ENV_KW = dict(num_agents=8, quads_mode="mix", neighbor_obs_type="pos_vel",
              neighbor_visible_num=-1, collision_hitbox_radius=2.0,
              collision_falloff_radius=4.0, use_downwash=True)
REWARD = dict(quadcol_bin=5.0, quadcol_bin_smooth_max=10.0)


def _jax_kernel_tick(jcfg, jparams):
    """The JAX env step of a batch of envs with every draw injected, jitted
    once: the batched scenario step; the fleet's dynamics as its TPU path
    runs them (this tick's OU state from the taped normal, then the Pallas
    kernel over the flat fleet in interpret mode, which reads float32 and
    casts back); then `env_step` with its responses' draws taped."""
    dyn_cfg = jcfg.dynamics_config(arm=jparams.arm)

    def ou_of(dyn, draw):
        with _tape(j_dyn, [draw]):
            return j_dyn.ou_noise_step(dyn.ou_state, jax.random.PRNGKey(0),
                                       jparams.thrust_noise_ratio)

    def one_env(state, action, dyn, scen, d):
        j_coll.set_response_tape({k: d[k] for k in ("drone_normals",
                                                    "drone_uniforms")})
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
        e, n = actions.shape[:2]
        scen = j_scen.batched_scenario_step(
            jcfg.scenario_config(), states.scenario, states.tick + 1,
            jcfg.mode_list())
        ou = jax.vmap(ou_of)(states.dyn, draws["ou"])
        thrust = jax.vmap(lambda s, a: j_multi._control_thrusts(
            jcfg, jparams, s, a, s.scenario.goals))(states, actions)
        flat = lambda x: x.reshape((e * n,) + x.shape[2:])
        out = j_kernel.dynamics_step_planes(
            jparams, dyn_cfg, jax.tree.map(flat, states.dyn), flat(thrust),
            flat(ou), flat(draws["yaw"]), interpret=True)
        dyn = jax.tree.map(lambda x: x.reshape((e, n) + x.shape[1:]),
                           out.replace(ou_state=flat(ou)))
        return jax.vmap(one_env)(states, actions, dyn, scen, draws)

    return tick


def _assert_state_close(tstate, jstate):
    want = traverse_util.flatten_dict(jax_tree_numpy(jstate), sep=".")
    # the Pallas wrapper passes omega_dot and torque through from its input
    # state (diagnostics the env does not read); K1 computes them
    skip = ("scen_seed", "scen_key", "omega_dot", "torque")
    for name, got in leaves(tstate):
        if name.split(".")[-1] in skip:
            continue
        w = want[name]
        assert str(got.dtype).split(".")[1] == str(w.dtype), (name, got.dtype,
                                                              w.dtype)
        if got.is_floating_point():
            _close(got, w, ENV_TOL, name)
        else:
            np.testing.assert_array_equal(got.numpy(), w, err_msg=name)


def test_bf16_env_steps_match_jax():
    """A port reset at bfloat16 of 2 envs x 8 drones (a static and a
    swap-goals episode) with a head-on collision, a wall, a ceiling and a
    floor crash set up as in tests/test_torch_slice.py, carried over to the
    JAX package's EnvState, then 3 ticks in both."""
    tcfg = t_multi.EnvConfig(**ENV_KW, dtype=torch.bfloat16)
    modes = torch.tensor([t_scen.MODE_IDS["static_same_goal"],
                          t_scen.MODE_IDS["swap_goals"]], dtype=torch.int32)
    tstate, _ = t_multi.env_reset(
        tcfg, t_make_params(), torch.Generator().manual_seed(11), 2,
        device="cpu", rew_coeff=RewardCoeffs(**REWARD), mode=modes)
    pos, vel = tstate.dyn.pos.clone(), tstate.dyn.vel.clone()
    bf = lambda v: torch.tensor(v, dtype=torch.bfloat16)
    pos[0, 1] = pos[0, 0] + bf([0.05, 0.0, 0.0])          # head-on
    vel[0, 0], vel[0, 1] = bf([1.0, 0.0, 0.0]), bf([-1.0, 0.0, 0.0])
    pos[1, 0], vel[1, 0] = bf([4.97, 0.0, 2.0]), bf([2.0, 0.0, 0.0])
    pos[1, 1], vel[1, 1] = bf([0.0, 1.0, 9.97]), bf([0.0, 0.0, 2.0])
    pos[1, 2], vel[1, 2] = bf([1.0, -1.0, 0.06]), bf([0.0, 0.0, -2.0])
    tstate = tstate.replace(dyn=tstate.dyn.replace(pos=pos, vel=vel))
    assert tstate.dyn.pos.dtype == torch.bfloat16
    assert tstate.scenario.events.dtype == torch.float32
    jstate = _jax_state(tstate)
    jcfg = j_multi.EnvConfig(**ENV_KW, dtype=BF)
    tick = _jax_kernel_tick(jcfg, j_make_params())
    tparams = t_make_params()
    rng = np.random.default_rng(0)
    # the draws as the env's generator makes them, in bfloat16
    to_bf16 = lambda x: np.asarray(jnp.asarray(x, BF).astype(jnp.float32))
    seen = {"collision": False, "wall": False, "ceiling": False,
            "floor": False}
    for _ in range(3):
        actions = rng.uniform(-1, 1, (2, 8, 4)).astype(np.float32)
        draws = jax.tree.map(to_bf16, _replay_draws(rng, 2, 8))
        jstate, jobs, jrew, jdones, jinfo = tick(
            jstate, jnp.asarray(actions), jax.tree.map(jnp.asarray, draws))
        tstate, tobs, trew, tdones, tinfo = t_multi.batched_env_step(
            tcfg, tparams, tstate, torch.from_numpy(actions), None,
            jax.tree.map(lambda x: x.to(torch.bfloat16), _port_draws(draws)))
        _assert_state_close(tstate, jstate)
        assert (tobs.dtype, trew.dtype) == (torch.bfloat16, torch.float32)
        assert (jobs.dtype, jrew.dtype) == (BF, jnp.float32)
        _close(tobs, jobs, ENV_TOL, "obs")
        _close(trew, jrew, ENV_TOL, "rewards")
        np.testing.assert_array_equal(tdones.numpy(), np.asarray(jdones))
        for key, val in tinfo.items():
            w = jinfo[key]
            assert str(val.dtype).split(".")[1] == str(w.dtype), key
            if val.is_floating_point():
                _close(val, w, ENV_TOL, key)
            else:
                np.testing.assert_array_equal(val.numpy(), np.asarray(w),
                                              err_msg=key)
        seen["collision"] |= bool(tinfo["rewards/rewraw_quadcol"].any())
        seen["wall"] |= bool(tstate.prev_wall.any())
        seen["ceiling"] |= bool(tstate.prev_ceiling.any())
        seen["floor"] |= bool(tstate.dyn.crashed_floor.any())
    assert all(seen.values()), seen


def test_bf16_env_reset_has_jax_dtypes_and_float32_events():
    """The port's counterpart of the JAX package's
    `test_event_table_exact_under_bfloat16_env_dtype`: a bfloat16 reset of
    the interval modes keeps its event table float32 (goals are bfloat16),
    every leaf has the dtype of JAX's bfloat16 reset, and a whole episode
    of playback reads each slot's interval back exactly, values above 256
    that bfloat16 cannot hold among them."""
    kw = dict(num_agents=4, quads_mode="mix", neighbor_obs_type="pos_vel",
              neighbor_visible_num=2)
    jcfg = j_multi.EnvConfig(**kw, dtype=BF)
    shapes = jax.eval_shape(lambda k: j_multi.env_reset(
        jcfg, j_make_params(), k), jax.random.PRNGKey(0))
    want = traverse_util.flatten_dict(jax_tree_numpy(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes[0])), sep=".")
    tcfg = t_multi.EnvConfig(**kw, dtype=torch.bfloat16)
    names = ("dynamic_same_goal", "swap_goals", "run_away",
             "dynamic_diff_goal")
    modes = torch.tensor([t_scen.MODE_IDS[m] for m in names] * 2,
                         dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    state, obs = t_multi.env_reset(tcfg, t_make_params(), gen, 8,
                                   device="cpu", mode=modes)
    for name, got in leaves(state):
        if name != "scenario.scen_seed":
            assert str(got.dtype).split(".")[1] == str(
                want[name].dtype), name
    assert obs.dtype == torch.bfloat16 and str(shapes[1].dtype) == "bfloat16"
    st = state.scenario
    assert st.events.dtype == torch.float32
    assert st.goals.dtype == torch.bfloat16
    # env 0 (dynamic_same_goal) plays back 401-tick intervals, which a
    # bfloat16 round trip would make 400
    d = t_scen.event_table_width(4)
    table = st.events.reshape(8, -1, d).clone()
    table[0, :, -4] = 401.0                          # the 'interval' column
    assert float(torch.tensor(401.0).to(torch.bfloat16)) != 401.0
    st = st.replace(events=table.reshape(st.events.shape))
    intervals = table[..., -4].to(torch.int64)
    scfg = tcfg.scenario_config()
    fired_env0 = []
    for tick in range(1, tcfg.ep_len + 1):
        before = st.event_count.clone()
        st = t_scen.batched_scenario_step(
            scfg, st, torch.full((8,), tick, dtype=torch.int32))
        for e in (st.event_count > before).nonzero()[:, 0].tolist():
            assert int(st.interval[e]) == int(intervals[e, int(before[e])])
            if e == 0:
                fired_env0.append(tick)
    assert st.goals.dtype == torch.bfloat16
    assert fired_env0[1:] == [802, 1203][:len(fired_env0) - 1], fired_env0
    assert len(fired_env0) >= 2


def test_eval_cli_runs_a_bf16_run(tmp_path, monkeypatch):
    """A run trained with --model_dtype=bfloat16 --dtype=bfloat16 through
    the train CLI (tiny, on the CPU) is evaluated by the eval CLI in both
    of its loops: the batched rounds and the single env dumping its
    trajectory (bfloat16 leaves reach numpy as float32)."""
    import sys
    from quadswarm_tpu_torch.training import enjoy, train
    from .test_torch_training import TINY, _train_sh_flags
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train.main(_train_sh_flags() + TINY + [
        "--model_dtype=bfloat16", "--dtype=bfloat16",
        "--train_for_env_steps=128", f"--train_dir={tmp_path}",
        "--experiment=bf16"]) == 0
    base = [f"--train_dir={tmp_path}", "--experiment=bf16", "--device=cpu"]
    stats = enjoy.run_eval(enjoy.load_args(base + [
        "--eval_envs=2", "--max_num_episodes=2", "--render_mode=none"]))
    assert np.isfinite(stats["true_reward"])
    stats = enjoy.run_eval(enjoy.load_args(base + [
        "--eval_envs=1", "--max_num_episodes=1", "--render_mode=dump",
        f"--render_out={tmp_path / 'r'}"]))
    dump = np.load(tmp_path / "r" / "ep000.npz")
    assert dump["pos"].dtype == np.float32 and np.isfinite(dump["pos"]).all()


def test_bf16_env_takes_the_pairs_route():
    """The pair kernels' wrappers take a bfloat16 env's positions and
    velocities, cast to float32 as the JAX wrappers cast them: 3 ticks of
    16 drones with two colliding, on the pairs route (K2, K3's plain
    versions here), keep the state bfloat16 and the history packed, and
    count the collision the dense route counts."""
    from quadswarm_tpu_torch.ops.kernels import swarm_interactions as t_si
    kw = dict(num_agents=16, quads_mode="static_same_goal",
              neighbor_obs_type="pos_vel", neighbor_visible_num=6,
              dtype=torch.bfloat16)
    outs = []
    for pairs in (True, False):
        cfg = t_multi.EnvConfig(**kw, use_pallas_pairs=pairs)
        params = t_make_params(dt=cfg.dt)
        gen = torch.Generator().manual_seed(2)
        state, _ = t_multi.env_reset(cfg, params, gen, 2, device="cpu")
        pos = state.dyn.pos.clone()
        pos[:, 1] = pos[:, 0] + torch.tensor([0.05, 0.0, 0.0],
                                             dtype=torch.bfloat16)
        state = state.replace(dyn=state.dyn.replace(pos=pos))
        for _ in range(3):
            state, obs, rew, _, info = t_multi.batched_env_step(
                cfg, params, state, torch.zeros((2, 16, 4)), gen)
        outs.append((state, obs, info))
    (sp, op, ip), (sd, _, idd) = outs
    assert t_multi.EnvConfig(**kw, use_pallas_pairs=True).use_topk_kernel
    assert sp.prev_coll_pairs.shape == (2, 16, t_si.PACK_LANES)
    assert sp.dyn.pos.dtype == op.dtype == torch.bfloat16
    assert torch.isfinite(op.float()).all()
    assert ip["num_collisions"].tolist() == idd["num_collisions"].tolist() \
        == [1, 1]
    assert torch.equal(t_si.unpack_pairs(sp.prev_coll_pairs, 16),
                       sd.prev_coll_pairs)


def test_k1_plain_version_on_bf16_state_matches_pallas_kernel():
    """K1's CPU route on a bfloat16 state (cast to float32, the plain
    dynamics, cast back) against the Pallas kernel, whose wrapper does the
    same, on branch-covering states."""
    cfg = j_dyn.DynamicsConfig()
    jstate, cmds, noise, yaw = _inputs(2, 300, cfg)
    cast = lambda x: x.astype(BF) if jnp.issubdtype(x.dtype, jnp.floating) \
        else x
    jstate = jax.tree.map(cast, jstate)
    cmds, noise, yaw = (jnp.asarray(x, BF) for x in (cmds, noise, yaw))
    want = j_kernel.dynamics_step_planes(j_make_params(), cfg, jstate, cmds,
                                         noise, yaw, interpret=True)
    tt = lambda x: torch.from_numpy(_f32(x)).to(torch.bfloat16)
    got = t_kernel.dynamics_tick_fused(
        t_make_params(), t_dyn.DynamicsConfig(),
        drone_state_from_numpy(jax_tree_numpy(jstate)), tt(cmds), tt(noise),
        tt(yaw))
    flat = traverse_util.flatten_dict(jax_tree_numpy(want), sep=".")
    for name, g in leaves(got):
        if name in ("omega_dot", "torque", "ou_state"):
            continue                 # the Pallas wrapper passes these through
        assert str(g.dtype).split(".")[1] == str(flat[name].dtype), name
        if g.is_floating_point():
            np.testing.assert_allclose(_f32(g), _f32(flat[name]), rtol=ULP,
                                       atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), flat[name],
                                          err_msg=name)
