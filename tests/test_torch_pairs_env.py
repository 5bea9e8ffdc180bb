"""The large-swarm route of the env step (`EnvConfig.use_pallas_pairs`).

Counterpart of tests/test_pallas_pairs_env.py for the port.  Under the flag
`batched_env_step` runs the pair kernel K2 for the collision stage (packed
pair history) and the k-nearest kernel K3 for the neighbour observation;
on CPU tensors both take their plain versions.

  (a) the port's pairs route against the port's dense route in lockstep,
      under the same generator;
  (b) the port's pairs route against the JAX package's, from a converted
      JAX state with every draw injected (the JAX kernels in interpret
      mode), rtol 2e-4 / atol 2e-5 per tick;
  (c) a forced collision: the response fires on the first tick and not on
      the repeat;
  (d) the auto-reset zeroes the packed history of the finished env only;
  (e) with every neighbour visible (k = N - 1) the slots keep index order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.env import multi as j_multi
from quadswarm_tpu.env.params import make_dynamics_params as j_make_params
from quadswarm_tpu.env.reward import RewardCoeffs as JRewardCoeffs
from quadswarm_tpu_torch.env import multi as t_multi
from quadswarm_tpu_torch.env.params import make_dynamics_params as t_make_params
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.ops.kernels import swarm_interactions as t_si
from quadswarm_tpu_torch.utils.convert import env_state_from_numpy
from quadswarm_tpu_torch.utils.struct import leaves

from .test_torch_env_parts import assert_matches_jax, jax_tree_numpy
from .test_torch_slice import _draws, _jax_step, _torch

E, N, K = 2, 8, 2
ENV_KW = dict(num_agents=N, quads_mode="mix", neighbor_obs_type="pos_vel",
              neighbor_visible_num=K, ep_time=4.0)
REWARD = dict(quadcol_bin=5.0, quadcol_bin_smooth_max=10.0)
TOL = dict(rtol=2e-4, atol=2e-5)
FIELD_TOL = {"omega_dot": dict(rtol=2e-4, atol=1e-3)}


def _collide(pos, vel):
    """Env 0: drones 0 and 1 inside the hitbox (about 0.09 m) head-on, and
    drone 3 inside drone 0's too, so drone 0 has two new partners.  Env 1:
    drones 5 and 6."""
    pos, vel = pos.clone(), vel.clone()
    pos[0, 1] = pos[0, 0] + torch.tensor([0.05, 0.0, 0.0])
    pos[0, 3] = pos[0, 0] + torch.tensor([0.0, 0.06, 0.0])
    vel[0, 0] = torch.tensor([1.0, 0.0, 0.0])
    vel[0, 1] = torch.tensor([-1.0, 0.0, 0.0])
    pos[1, 6] = pos[1, 5] + torch.tensor([0.0, 0.0, 0.07])
    return pos, vel


def _reset_pair(seed=0, **kw):
    """The same fresh envs (with colliding drones) under both routes."""
    out = []
    for pairs in (False, True):
        cfg = t_multi.EnvConfig(**{**ENV_KW, **kw}, use_pallas_pairs=pairs)
        params = t_make_params(dt=cfg.dt)
        gen = torch.Generator().manual_seed(seed)
        state, obs = t_multi.env_reset(cfg, params, gen, E, device="cpu",
                                       rew_coeff=RewardCoeffs(**REWARD))
        pos, vel = _collide(state.dyn.pos, state.dyn.vel)
        out.append((cfg, params, gen,
                    state.replace(dyn=state.dyn.replace(pos=pos, vel=vel))))
    return out


def test_reset_state_is_packed_under_the_flag():
    (_, _, _, dense), (cfg, _, _, packed) = _reset_pair()
    assert dense.prev_coll_pairs.shape == (E, N, N)
    assert dense.prev_coll_pairs.dtype == torch.bool
    assert packed.prev_coll_pairs.shape == (E, N, t_si.PACK_LANES)
    assert packed.prev_coll_pairs.dtype == torch.int32
    assert not packed.prev_coll_pairs.any()
    assert cfg.use_topk_kernel
    for (name, a), (_, b) in zip(leaves(dense), leaves(packed)):
        if name != "prev_coll_pairs":
            assert torch.equal(a, b), name


def test_pairs_route_matches_dense_route_in_lockstep():
    """(a) Same generator, same actions: both routes draw the same numbers
    in the same order, a colliding pair reads the same noise row."""
    (cfg_d, params, gen_d, sd), (cfg_p, _, gen_p, sp) = _reset_pair()
    act_gen = torch.Generator().manual_seed(5)
    collisions = 0
    for tick in range(6):
        actions = torch.rand((E, N, 4), generator=act_gen) * 2 - 1
        sd, od, rd, dd, idd = t_multi.batched_env_step(cfg_d, params, sd,
                                                       actions, gen_d)
        sp, op, rp, dp, idp = t_multi.batched_env_step(cfg_p, params, sp,
                                                       actions, gen_p)
        np.testing.assert_allclose(op.numpy(), od.numpy(), rtol=0, atol=2e-5,
                                   err_msg=f"obs tick {tick}")
        np.testing.assert_allclose(rp.numpy(), rd.numpy(), rtol=0, atol=2e-5,
                                   err_msg=f"rewards tick {tick}")
        assert torch.equal(idp["num_collisions"], idd["num_collisions"])
        assert torch.equal(dp, dd)
        for key in idd:
            torch.testing.assert_close(idp[key], idd[key], rtol=0, atol=2e-5,
                                       msg=key)
        collisions = int(idp["num_collisions"].sum())
    assert collisions >= 2
    assert torch.equal(t_si.unpack_pairs(sp.prev_coll_pairs, N),
                       sd.prev_coll_pairs)
    for (name, a), (_, b) in zip(leaves(sd), leaves(sp)):
        if name != "prev_coll_pairs":
            torch.testing.assert_close(b, a, rtol=0, atol=2e-5, msg=name)
    assert torch.equal(gen_d.get_state(), gen_p.get_state())


def test_forced_collision_fires_once():
    """(c) Tick 1: the pairs are new, the response changes the velocities
    and kicks omega.  Tick 2: the drones still overlap, the pairs are no
    longer new, and nothing but the dynamics moves them."""
    cfg = t_multi.EnvConfig(**ENV_KW, use_pallas_pairs=True)
    quiet = t_multi.EnvConfig(**ENV_KW, use_pallas_pairs=True,
                              apply_collision_force=False)
    (_, params, _, _), (_, _, _, start) = _reset_pair()
    actions = torch.zeros((E, N, 4))
    hit = torch.zeros((E, N), dtype=torch.bool)
    hit[0, [0, 1, 3]] = True
    hit[1, [5, 6]] = True

    def both(state, seed):
        with_resp = t_multi.batched_env_step(
            cfg, params, state, actions, torch.Generator().manual_seed(seed))
        without = t_multi.batched_env_step(
            quiet, params, state, actions,
            torch.Generator().manual_seed(seed))
        return with_resp, without

    (s1, _, _, _, info1), (q1, *_) = both(start, 1)
    changed = (s1.dyn.vel != q1.dyn.vel).any(-1)
    assert torch.equal(changed, hit)
    kick = torch.linalg.vector_norm(s1.dyn.omega - q1.dyn.omega, dim=-1)
    assert bool((kick[hit] >= 10 * np.pi - 1e-3).all())
    assert bool((kick[~hit] == 0).all())
    assert info1["num_collisions"].tolist() == [1, 1]
    assert torch.equal(s1.prev_coll_ids, hit)
    pairs1 = t_si.unpack_pairs(s1.prev_coll_pairs, N)
    assert pairs1[0, 0, 1] and pairs1[0, 1, 0] and pairs1[0, 0, 3]
    assert pairs1[1, 5, 6] and int(pairs1.sum()) >= 6

    # Repeat tick from the un-responded state: the drones still overlap.
    q1 = q1.replace(prev_coll_pairs=s1.prev_coll_pairs)
    (s2, _, _, _, info2), (q2, *_) = both(q1, 2)
    still = t_si.unpack_pairs(s2.prev_coll_pairs, N)
    assert still[0, 0, 1] and still[1, 5, 6]
    assert torch.equal(s2.dyn.vel, q2.dyn.vel)
    assert torch.equal(s2.dyn.omega, q2.dyn.omega)
    assert info2["num_collisions"].tolist() == [1, 1]


def test_auto_reset_zeroes_the_packed_history_of_finished_envs_only():
    """(d) Env 1 finishes; env 0 keeps the bits of its colliding pairs."""
    (_, params, _, _), (cfg, _, gen, state) = _reset_pair()
    state = state.replace(tick=torch.tensor([0, cfg.ep_len],
                                            dtype=torch.int32))
    actions = torch.zeros((E, N, 4))
    kept, _, _, done, _ = t_multi._step(cfg, params, state, actions,
                                        torch.Generator().manual_seed(9), {})
    assert done.tolist() == [False, True]
    assert kept.prev_coll_pairs[1].any()
    new, obs, _, dones, info = t_multi.batched_env_step(
        cfg, params, state, actions, torch.Generator().manual_seed(9))
    assert dones[1].all() and not dones[0].any()
    assert new.prev_coll_pairs.shape == (E, N, t_si.PACK_LANES)
    assert not new.prev_coll_pairs[1].any()
    assert torch.equal(new.prev_coll_pairs[0], kept.prev_coll_pairs[0])
    assert new.prev_coll_pairs[0].any()
    assert int(new.tick[1]) == 0 and not new.prev_coll_ids[1].any()
    assert torch.isfinite(obs).all()


def test_all_neighbors_visible_keeps_index_order():
    """(e) k = N - 1: slot s of drone i is the s-th other drone in index
    order, on both routes of the port (the dense path's contract).  The JAX
    package sends this case to its k-nearest kernel, which sorts the slots
    by the metric instead; the port does not copy that."""
    (cfg_d, params, gen_d, sd), (cfg_p, _, gen_p, sp) = _reset_pair(
        neighbor_visible_num=-1)
    assert cfg_p.num_use_neighbor_obs == N - 1 and not cfg_p.use_topk_kernel
    actions = torch.zeros((E, N, 4))
    sd, od, *_ = t_multi.batched_env_step(cfg_d, params, sd, actions, gen_d)
    sp, op, *_ = t_multi.batched_env_step(cfg_p, params, sp, actions, gen_p)
    np.testing.assert_allclose(op.numpy(), od.numpy(), rtol=0, atol=2e-5)
    nbr = op[..., 18:].reshape(E, N, N - 1, 6)
    for i in range(N):
        others = [j for j in range(N) if j != i]
        want = torch.clamp(sp.dyn.pos[:, others] - sp.dyn.pos[:, i:i + 1],
                           -10.0, 10.0)
        torch.testing.assert_close(nbr[:, i, :, :3], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,n,expect", [(6, 128, True), (2, 8, True),
                                        (7, 8, False), (0, 8, False),
                                        (16, 18, True), (17, 32, False)])
def test_topk_kernel_routing(k, n, expect):
    cfg = t_multi.EnvConfig(num_agents=n, neighbor_visible_num=k,
                            neighbor_obs_type="pos_vel" if k else "none",
                            use_pallas_pairs=True)
    assert cfg.use_topk_kernel is expect
    assert not t_multi.EnvConfig(num_agents=n, neighbor_visible_num=k
                                 ).use_topk_kernel


def test_flag_is_supported_and_too_many_agents_refused():
    t_multi.EnvConfig(num_agents=2048, use_pallas_pairs=True).check_supported()
    with pytest.raises(ValueError, match="2048"):
        t_multi.EnvConfig(num_agents=2049,
                          use_pallas_pairs=True).check_supported()
    with pytest.raises(NotImplementedError):
        t_multi.EnvConfig(use_obstacles=True,
                          use_pallas_pairs=True).check_supported()


@pytest.mark.parametrize("mode", sorted(
    t_multi.EnvConfig(num_agents=128, quads_mode="mix").mode_list()))
def test_every_mix_mode_runs_at_128_drones(mode):
    """Reset and two ticks of each free-space mix mode at N = 128 on the
    pairs route: finite observations of the expected shape, a packed
    history, and K3's neighbours equal to the dense route's."""
    cfg = t_multi.EnvConfig(num_agents=128, quads_mode="mix",
                            neighbor_visible_num=6, use_pallas_pairs=True)
    dense = t_multi.EnvConfig(num_agents=128, quads_mode="mix",
                              neighbor_visible_num=6)
    params = t_make_params(dt=cfg.dt)
    gen_p, gen_d = (torch.Generator().manual_seed(mode) for _ in range(2))
    sp, op = t_multi.env_reset(cfg, params, gen_p, 2, device="cpu", mode=mode)
    sd, od = t_multi.env_reset(dense, params, gen_d, 2, device="cpu",
                               mode=mode)
    assert op.shape == (2, 128, 54) and torch.equal(op, od)
    actions = torch.zeros((2, 128, 4))
    for _ in range(2):
        sp, op, rp, _, ip = t_multi.batched_env_step(cfg, params, sp, actions,
                                                     gen_p)
        sd, od, rd, _, idd = t_multi.batched_env_step(dense, params, sd,
                                                      actions, gen_d)
        assert torch.isfinite(op).all() and torch.isfinite(rp).all()
        torch.testing.assert_close(op, od, rtol=0, atol=2e-5)
        torch.testing.assert_close(rp, rd, rtol=0, atol=2e-5)
        assert torch.equal(ip["num_collisions"], idd["num_collisions"])
    assert sp.prev_coll_pairs.shape == (2, 128, t_si.PACK_LANES)
    assert torch.equal(t_si.unpack_pairs(sp.prev_coll_pairs, 128),
                       sd.prev_coll_pairs)


# --------------------------------------------------------------------------
# (b) against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_start():
    """A JAX-reset pair of envs on the pairs route, with colliding drones."""
    jcfg = j_multi.EnvConfig(**ENV_KW, use_pallas_pairs=True)
    jparams = j_make_params()
    keys = jax.random.split(jax.random.PRNGKey(21), E)
    jstate, jobs = jax.jit(jax.vmap(lambda k: j_multi.env_reset(
        jcfg, jparams, k, rew_coeff=JRewardCoeffs(**REWARD))))(keys)
    pos, vel = _collide(torch.from_numpy(np.array(jstate.dyn.pos)),
                        torch.from_numpy(np.array(jstate.dyn.vel)))
    jstate = jstate.replace(dyn=jstate.dyn.replace(
        pos=jnp.asarray(pos.numpy()), vel=jnp.asarray(vel.numpy())))
    return jcfg, jparams, jstate


def test_converted_jax_state_carries_the_packed_history(jax_start):
    _, _, jstate = jax_start
    assert jstate.prev_coll_pairs.shape == (E, N, t_si.PACK_LANES)
    bits = np.zeros((E, N, N), bool)
    bits[0, 2, 4] = bits[0, 4, 2] = True
    jstate = jstate.replace(prev_coll_pairs=jnp.asarray(
        t_si.pack_pairs(torch.from_numpy(bits)).numpy()))
    tstate = env_state_from_numpy(jax_tree_numpy(jstate))
    assert tstate.prev_coll_pairs.dtype == torch.int32
    assert tstate.prev_coll_pairs.shape == (E, N, t_si.PACK_LANES)
    np.testing.assert_array_equal(
        t_si.unpack_pairs(tstate.prev_coll_pairs, N).numpy(), bits)


def test_pairs_route_lockstep_with_jax(jax_start):
    """(b) Three ticks from the converted JAX state, every draw injected
    into both packages: states (the packed words included, exactly),
    observations, rewards and the info dict agree per tick."""
    jcfg, jparams, jstate = jax_start
    tcfg = t_multi.EnvConfig(**ENV_KW, use_pallas_pairs=True)
    tparams = t_make_params()
    tstate = env_state_from_numpy(jax_tree_numpy(jstate))
    rng = np.random.default_rng(0)
    new_pairs = []
    for _ in range(3):
        actions = rng.uniform(-1, 1, (E, N, 4)).astype(np.float32)
        draws = _draws(rng)
        before = np.asarray(jstate.prev_coll_pairs)
        jstate, jobs, jrew, jdones, jinfo = _jax_step(
            jcfg, jparams, jstate, jnp.asarray(actions), draws)
        tstate, tobs, trew, tdones, tinfo = t_multi.batched_env_step(
            tcfg, tparams, tstate, torch.from_numpy(actions), None,
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
        now = tstate.prev_coll_pairs.numpy()
        new_pairs.append(bool((now & ~before).any()))
    assert new_pairs[0], "the first tick saw no new pair"
    assert tstate.prev_coll_ids.any()
