"""The port's data-parallel learner over ranks, against the JAX package.

Worlds of 2 gloo processes on the CPU (`tests/torch_dist_worker.py`,
started through `file://` so that parallel test workers never share a
port), on inputs made from numpy seeds:
- the 2-rank learner (sgd_shuffle_groups 32, so g = 4 env groups, 2 a
  rank) against the JAX package's grouped `sgd_epochs` at that g on the
  same trajectory and permutations, within the learner check's bounds: the
  first minibatch's averaged gradient rtol 1e-4 plus 1e-6 of the model's
  largest entry, the parameters after 2 epochs within the learning rate;
- the Trainer on 2 ranks: weights bit for bit equal across the ranks after
  each of 2 iterations, normalizers and statistics too;
- a world of one (a group of one rank) against the Trainer without a
  group: the rollout bit for bit, the learner within the learner check's
  bounds;
- the normalizers, `episode_stats`, the advantage statistics and mixed
  PBT's masked ones and objectives over 2 ranks against one process over
  the joined batch (rtol 1e-6, the normalizers' tolerance of
  tests/test_torch_training.py).
In one process: the mesh helpers without a group, the backend choice, and
the layouts a world cannot share.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState

from quadswarm_tpu.models import actor_critic as j_ac
from quadswarm_tpu.parallel import ppo as j_ppo
from quadswarm_tpu_torch.parallel import distributed as t_dist
from quadswarm_tpu_torch.parallel import mesh as t_mesh
from quadswarm_tpu_torch.parallel import ppo as t_ppo
from quadswarm_tpu_torch.parallel.normalize import RunningMeanStd
from quadswarm_tpu_torch.parallel.pbt_mixed import policy_objectives
from quadswarm_tpu_torch.utils.convert import actor_critic_from_flax

from .flax_params import random_flax_params
from .torch_dist_worker import (
    LEARNER_DIMS, LEARNER_PPO, MODEL_KW, OBS_DIM, joined_batch, launch,
    tiny_trainer,
)

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6      # atol times the model's largest entry
NORM_TOL = dict(rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# The learner against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def learner(tmp_path_factory):
    """The JAX package's grouped learner and the 2 ranks' on one
    trajectory and one set of permutations."""
    workdir = tmp_path_factory.mktemp("learner")
    rng = np.random.default_rng(5)
    t, e, n = LEARNER_DIMS
    f = lambda *s: rng.normal(0, 1, (t, e, n) + s).astype(np.float32)
    traj = (f(OBS_DIM), f(4), f() - 4.0, f(), f(), f() > 1.2)
    adv, ret = f() * 2 + 0.3, f()
    jmodel = j_ac.ActorCritic(**MODEL_KW, dtype=jnp.float32)
    params = random_flax_params(jmodel, OBS_DIM, 3)
    cfg = t_ppo.PPOConfig(**LEARNER_PPO)
    jcfg = j_ppo.PPOConfig(**LEARNER_PPO)
    lay = t_ppo.minibatch_layout(LEARNER_DIMS, cfg.batch_size,
                                 cfg.sgd_shuffle_groups)
    assert lay.groups == 4 and lay.num_minibatches == 4
    key = jax.random.PRNGKey(9)
    # the JAX package's own draws (parallel/ppo.py:297-299, :384)
    epoch_keys = jax.random.split(key, cfg.num_epochs)
    perms = [torch.tensor(np.asarray(jax.vmap(
        lambda k: jax.random.permutation(k, lay.num_chunks))(
            jax.random.split(ek, lay.groups)))) for ek in epoch_keys]
    torch.save({"traj": tuple(torch.from_numpy(x) for x in traj),
                "adv": torch.from_numpy(adv), "ret": torch.from_numpy(ret),
                "weights": actor_critic_from_flax(params), "perms": perms},
               workdir / "learner_inputs.pt")
    outs = launch("learner", workdir)

    jtraj = j_ppo.Transition(*(jnp.asarray(x) for x in traj))
    tree = (jtraj.obs, jtraj.actions, jtraj.log_prob, jtraj.value,
            jnp.asarray(adv), jnp.asarray(ret))
    first = jax.tree.map(lambda x: x[0], j_ppo.shuffled_minibatches(
        tree, LEARNER_DIMS, cfg.batch_size, epoch_keys[0],
        groups=cfg.sgd_shuffle_groups))
    jparams = jax.tree.map(jnp.asarray, params)
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_ppo.ppo_loss(jmodel, jcfg, p, first), has_aux=True))(
            jparams)
    tx = optax.flatten(optax.chain(optax.clip_by_global_norm(
        cfg.max_grad_norm), optax.adam(cfg.learning_rate)))
    state = TrainState.create(apply_fn=jmodel.apply, params=jparams, tx=tx)
    state, _ = jax.jit(lambda s: j_ppo.sgd_epochs(
        jmodel, jcfg, s, jtraj, jnp.asarray(adv), jnp.asarray(ret), key))(
            state)
    return SimpleNamespace(
        outs=outs, metrics=jmetrics,
        grads=actor_critic_from_flax(jax.tree.map(np.asarray, jgrads)),
        params=actor_critic_from_flax(jax.tree.map(np.asarray,
                                                   state.params)))


def test_two_rank_gradient_matches_jax_global_minibatch(learner):
    """The first minibatch: each rank's half of the global minibatch, the
    advantages standardized over both halves, the gradients averaged."""
    top = max(float(g.abs().max()) for g in learner.grads.values())
    for out in learner.outs:
        assert out["rows"] == LEARNER_PPO["batch_size"] // 2
        assert set(out["grads"]) == set(learner.grads)
        for name, g in out["grads"].items():
            np.testing.assert_allclose(g.numpy(), learner.grads[name].numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL * top,
                                       err_msg=name)
        for k, v in out["metrics"].items():
            np.testing.assert_allclose(float(v), float(learner.metrics[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_two_rank_sgd_epochs_match_jax_grouped_learner(learner):
    """2 epochs of 4 minibatches: the ranks' weights are equal bit for bit
    and within the learning rate of the JAX package's; each rank fed the
    loss half the samples."""
    a, b = learner.outs
    for name, want in learner.params.items():
        assert torch.equal(a["params"][name], b["params"][name]), name
        np.testing.assert_allclose(a["params"][name].numpy(), want.numpy(),
                                   rtol=0, atol=LEARNER_PPO["learning_rate"],
                                   err_msg=name)
    total = np.prod(LEARNER_DIMS) * LEARNER_PPO["num_epochs"]
    assert a["sgd_rows"] == b["sgd_rows"] == total // 2


# --------------------------------------------------------------------------
# The Trainer on a mesh
# --------------------------------------------------------------------------

def test_trainer_weights_equal_bit_for_bit_across_ranks(tmp_path):
    a, b = launch("trainer", tmp_path)
    assert a["groups"] == b["groups"] == 32
    assert all(torch.equal(a["init"][k], b["init"][k]) for k in a["init"])
    for ia, ib in zip(a["iters"], b["iters"]):
        for k in ia["params"]:
            assert torch.equal(ia["params"][k], ib["params"][k]), k
        for k in ia["norm"]:
            assert torch.equal(ia["norm"][k], ib["norm"][k]), k
        assert ia["metrics"] == ib["metrics"] and ia["stats"] == ib["stats"]
    # each rank rolled out its own 2 envs; the counts are global
    assert not torch.equal(a["iters"][0]["obs"], b["iters"][0]["obs"])
    assert a["iters"][0]["obs"].shape[0] == 2
    assert [i["env_steps"] for i in a["iters"]] == [128, 256]
    assert [i["step"] for i in a["iters"]] == [4, 8]
    assert any(not torch.equal(a["init"][k], a["iters"][1]["params"][k])
               for k in a["init"])


def test_world_of_one_matches_the_trainer_without_a_group(tmp_path):
    """A group of one rank runs every collective; its rollout is the
    one-card Trainer's bit for bit, its learner within the learner check's
    bounds."""
    (one,) = launch("trainer", tmp_path, world=1)
    tr = tiny_trainer()
    assert not tr.mesh.distributed and tr.learner_gen is tr.gen
    metrics, _ = tr.iteration()
    first = one["iters"][0]
    assert torch.equal(first["obs"], tr.obs)
    assert torch.equal(first["pos"], tr.env_states.dyn.pos)
    assert one["groups"] == 1
    for k, v in tr.model.state_dict().items():
        np.testing.assert_allclose(first["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)
    for k, v in metrics.items():
        np.testing.assert_allclose(first["metrics"][k], float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# Reductions over ranks against the joined batch
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reductions(tmp_path_factory):
    return launch("reductions", tmp_path_factory.mktemp("reductions"))


def _close_dicts(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   err_msg=k, **tol)


def test_normalizers_over_ranks_equal_the_joined_batch(reductions):
    b = joined_batch(0)
    start = RunningMeanStd.create(5).update(torch.ones(3, 5) * 0.5)
    want = {"obs": start.update(b["x"]),
            "masked": start.update_masked(b["x"], b["w"]),
            "ret": RunningMeanStd.create().update(b["ret"])}
    for out in reductions:
        for name, rms in want.items():
            _close_dicts(out[name], dataclasses.asdict(rms), **NORM_TOL)


def test_episode_stats_over_ranks_equal_the_joined_batch(reductions):
    want = t_ppo.Trainer.episode_stats(
        SimpleNamespace(mesh=t_mesh.local_mesh("cpu")),
        joined_batch(0)["infos"])
    assert want["num_episodes"] > 0
    for out in reductions:
        _close_dicts(out["stats"], want, rtol=1e-6)


def test_advantage_statistics_over_ranks_equal_the_joined_batch(reductions):
    """Sync PPO's (mean, std) and mixed PBT's per-policy masked (mean, std,
    denominator) of the global minibatch, and the policies' objectives."""
    b = joined_batch(0)
    adv, assign = b["adv"], b["assign"]
    masked = []
    for p in range(3):
        mask = (assign == p).float()
        denom = torch.clamp(mask.sum(), min=1.0)
        mean = torch.sum(adv * mask) / denom
        std = torch.sqrt(torch.sum(mask * (adv - mean) ** 2) / denom)
        masked.append((mean, std, denom))
    obj = policy_objectives(b["infos"], b["assignment"], 3)
    for out in reductions:
        np.testing.assert_allclose([float(x) for x in out["adv"]],
                                   [float(adv.mean()),
                                    float(adv.std(correction=0))], rtol=1e-6)
        for i, want in enumerate(zip(*masked)):
            np.testing.assert_allclose(out["masked_adv"][i].numpy(),
                                       torch.stack(want).numpy(), rtol=1e-6)
        for got, want in zip(out["objectives"], obj):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


# --------------------------------------------------------------------------
# In one process
# --------------------------------------------------------------------------

def test_mesh_without_a_group_runs_no_collective():
    mesh = t_mesh.local_mesh("cpu")
    assert (mesh.world, mesh.rank, mesh.distributed) == (1, 0, False)
    x = torch.arange(6.0)
    assert t_mesh.all_sum(mesh, x) is x
    grads = [torch.ones(2), torch.ones(3)]
    t_mesh.all_reduce_grads_(mesh, grads)
    assert all(torch.equal(g, torch.ones_like(g)) for g in grads)
    two = dataclasses.replace(mesh, world=2, rank=1)
    assert t_mesh.env_range(two, 8) == (4, 8)
    traj = t_ppo.Transition(*(torch.arange(24.0).reshape(2, 4, 3)
                              for _ in range(6)))
    part = t_mesh.shard_env_batch(two, traj, axis=1)
    assert torch.equal(part.obs, traj.obs[:, 2:])
    with pytest.raises(ValueError, match="split evenly"):
        t_mesh.env_range(dataclasses.replace(mesh, world=3), 8)


def test_init_distributed_without_a_launch_is_a_world_of_one(monkeypatch):
    for name in ("MASTER_ADDR", "WORLD_SIZE", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    t_dist.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    assert t_dist.global_data_mesh("cpu").world == 1
    assert t_dist.local_batch_size(8) == 8


@pytest.mark.parametrize("device,ranks,cards,backend", [
    ("cpu", 2, 0, "gloo"), ("cuda", 2, 2, "nccl"), ("cuda", 2, 1, "gloo"),
    ("cuda", 1, 1, "nccl")])
def test_backend_follows_the_layout(device, ranks, cards, backend):
    assert t_dist.choose_backend(device, ranks, cards)[0] == backend


def test_a_world_must_divide_the_env_groups():
    """(8, 4, 4) at batch 32 with 32 shuffle groups has 4 env groups:
    2 and 4 ranks share them, 3 cannot (and 4 envs do not split over 3)."""
    for world in (2, 4):
        t_ppo.check_layout(LEARNER_DIMS, 32, 32, world)
    with pytest.raises(ValueError, match="do not divide"):
        t_ppo.check_layout(LEARNER_DIMS, 32, 32, 3)
    with pytest.raises(ValueError, match="do not divide"):
        t_ppo.shuffled_minibatches((torch.zeros(LEARNER_DIMS),),
                                   LEARNER_DIMS, 32, None, 32,
                                   shard=(0, 3))
    assert t_ppo.resolve_groups(t_ppo.PPOConfig(), 1).sgd_shuffle_groups == 1
    assert t_ppo.resolve_groups(t_ppo.PPOConfig(), 2).sgd_shuffle_groups == 32


def test_rank_zero_draws_the_one_card_stream():
    assert t_ppo.rank_seed(7, 0) == 7
    seeds = {t_ppo.rank_seed(7, r) for r in range(4)} | {
        t_ppo.learner_seed(7)}
    assert len(seeds) == 5
