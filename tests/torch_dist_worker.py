"""Ranks of gloo worlds on the CPU for tests/test_torch_distributed*.py.

    python -m tests.torch_dist_worker <case> <workdir> <rank> <world>

joins a world of `world` processes through `file://<workdir>/pg` (no port,
so parallel test workers never collide), runs `<case>` and saves what the
tests compare to `<workdir>/<case>_<rank>.pt`.  `launch` starts a world and
returns every rank's output.  Imports nothing of JAX: a rank starts in
about two seconds.
"""
from __future__ import annotations

import copy
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
K = 2                                   # visible neighbours
OBS_DIM = 18 + 6 * K
MODEL_KW = dict(action_dim=4, self_obs_dim=18, neighbor_obs_dim=6,
                num_neighbors=K, neighbor_hidden=32, rnn_size=32)
PPO_KW = dict(ppo_clip_ratio=0.1, ppo_clip_value=0.5, value_loss_coeff=0.5,
              exploration_loss_coeff=0.01, max_entropy_coeff=0.002)
# The learner against the JAX package's sgd_epochs: (T, E, N), batch 32 and
# 32 shuffle groups give g = gcd(E, 32, 32) = 4 env groups, 2 a rank.
LEARNER_DIMS = (8, 4, 4)
LEARNER_PPO = dict(PPO_KW, batch_size=32, num_epochs=2, sgd_shuffle_groups=32,
                   learning_rate=1e-3)


def launch(case: str, workdir, world: int = 2, timeout: int = 120,
           argv: list | None = None, env: dict | None = None) -> list:
    """Run `case` on a world of `world` ranks and return each rank's saved
    output; with `argv`, each rank runs that command instead (with
    torchrun's variables in `env`) and the outputs are its stdout."""
    workdir = Path(workdir)
    base = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
            **(env or {})}
    base.pop("JAX_PLATFORMS", None)
    # a file a rank: a pipe read one rank at a time could fill and stall a
    # rank inside a collective
    logs = [workdir / f"{case}_{rank}.log" for rank in range(world)]
    procs = []
    for rank, log in enumerate(logs):
        cmd = argv or [sys.executable, "-m", "tests.torch_dist_worker", case,
                       str(workdir), str(rank), str(world)]
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                env={**base, "RANK": str(rank), "LOCAL_RANK": str(rank)}))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"rank {rank} exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
    if argv:
        return outs
    return [torch.load(workdir / f"{case}_{rank}.pt", weights_only=False)
            for rank in range(world)]


def model(seed: int = 0):
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    torch.manual_seed(seed)
    return ActorCritic(**MODEL_KW, device="cpu")


def joined_batch(seed: int, rows: int = 24) -> dict:
    """The global batch of the reduction cases, from a numpy seed."""
    rng = np.random.default_rng(seed)
    t, e, n = 3, 4, 3
    f = lambda *s: torch.from_numpy(rng.normal(0.3, 2.0, s).astype(
        np.float32))
    return {
        "x": f(rows, 5), "w": torch.from_numpy(
            (rng.uniform(0, 1, rows) < 0.4).astype(np.float32)),
        "ret": f(rows), "adv": f(rows),
        "assign": torch.from_numpy(rng.integers(0, 3, rows)),
        "infos": {
            "episode_done": torch.from_numpy(rng.uniform(0, 1, (t, e)) < 0.5),
            "scenario_mode": torch.from_numpy(rng.integers(0, 3, (t, e))),
            "true_reward": f(t, e, n),
            "metric/agent_success_rate": f(t, e, n),
            "rewards/rew_main": f(t, e, n)},
        "assignment": torch.from_numpy(rng.integers(0, 3, (t, e, n))),
    }


def tiny_trainer(mesh=None, seed: int = 0):
    """The training tests' tiny Trainer: 4 envs x 4 drones, rollout 8,
    batch 32, replay 0.75, both normalizers, annealing."""
    from quadswarm_tpu_torch.env.multi import EnvConfig
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig, Trainer
    cfg = EnvConfig(num_agents=4, quads_mode="mix",
                    neighbor_obs_type="pos_vel", neighbor_visible_num=K,
                    use_downwash=True, ep_time=0.08)
    ppo = PPOConfig(rollout=8, batch_size=32, num_envs=4,
                    replay_sample_prob=0.75, normalize_input=True,
                    normalize_returns=True)
    return Trainer(cfg, ppo, model(seed), make_dynamics_params(dt=cfg.dt),
                   seed=seed, anneal_schedules={"quadcol_bin": (5.0, 300)},
                   device="cpu", mesh=mesh)


def tiny_appo_cfg():
    from quadswarm_tpu_torch.env.multi import EnvConfig
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig
    cfg = EnvConfig(num_agents=3, quads_mode="mix",
                    neighbor_obs_type="pos_vel", neighbor_visible_num=K,
                    ep_time=0.08)
    ppo = PPOConfig(rollout=4, batch_size=8, num_envs=4, with_vtrace=True,
                    normalize_input=True, normalize_returns=True)
    return cfg, ppo


def _params(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _norm(norm) -> dict:
    from quadswarm_tpu_torch.utils.struct import leaves
    return {k: v.clone() for k, v in leaves(norm) if v is not None}


# --------------------------------------------------------------------------
# Cases: each returns the dict its rank saves.
# --------------------------------------------------------------------------

def case_learner(mesh, workdir: Path) -> dict:
    """This rank's part of the learner on the trajectory and permutations
    in `learner_inputs.pt`: the first global minibatch's loss and averaged
    gradient, then sgd_epochs from the same weights."""
    from quadswarm_tpu_torch.parallel import ppo as P
    from quadswarm_tpu_torch.parallel.mesh import shard_env_batch
    inp = torch.load(workdir / "learner_inputs.pt", weights_only=False)
    cfg = P.PPOConfig(**LEARNER_PPO)
    traj = shard_env_batch(mesh, P.Transition(*inp["traj"]), axis=1)
    adv, ret = (shard_env_batch(mesh, x, axis=1)
                for x in (inp["adv"], inp["ret"]))
    net = model()
    net.load_state_dict(inp["weights"])
    tree = (traj.obs, traj.actions, traj.log_prob, traj.value, adv, ret)
    batched = P.shuffled_minibatches(
        tree, LEARNER_DIMS, cfg.batch_size, None, cfg.sgd_shuffle_groups,
        perms=inp["perms"][0], shard=(mesh.rank, mesh.world))
    loss, metrics = P.ppo_loss(net, cfg, tuple(x[0] for x in batched),
                               mesh=mesh)
    loss.backward()
    grads = [p.grad for p in net.parameters()]
    P.all_reduce_grads_(mesh, grads)
    out = {"grads": {k: p.grad.clone() for k, p in net.named_parameters()},
           "metrics": P.mean_metrics(metrics, mesh),
           "rows": batched[0].shape[1]}
    net.zero_grad(set_to_none=True)
    net.load_state_dict(inp["weights"])
    metrics = P.sgd_epochs(net, P.make_optimizer(net, cfg), cfg, traj, adv,
                           ret, None, perms=inp["perms"], mesh=mesh)
    out.update(params=_params(net), sgd_metrics=metrics,
               sgd_rows=P.sgd_epochs.rows)
    return out


def case_trainer(mesh, workdir: Path) -> dict:
    """The tiny Trainer for 2 iterations: weights, normalizers, metrics and
    episode stats after each; the rank's env state after the first."""
    tr = tiny_trainer(mesh)
    out = {"init": _params(tr.model), "iters": []}
    for it in range(2):
        metrics, infos = tr.iteration()
        rec = {"params": _params(tr.model), "norm": _norm(tr.norm_state),
               "metrics": {k: float(v) for k, v in metrics.items()},
               "stats": tr.episode_stats(infos),
               "env_steps": tr.env_steps, "step": tr.step}
        if it == 0:
            rec["obs"] = tr.obs.clone()
            rec["pos"] = tr.env_states.dyn.pos.clone()
        out["iters"].append(rec)
    out["groups"] = tr.ppo_cfg.sgd_shuffle_groups
    return out


def case_reductions(mesh, workdir: Path) -> dict:
    """Normalizers, episode stats, the advantage statistics and mixed PBT's
    masked ones and objectives over this rank's share of `joined_batch`."""
    from quadswarm_tpu_torch.parallel.mesh import shard_env_batch
    from quadswarm_tpu_torch.parallel.normalize import RunningMeanStd
    from quadswarm_tpu_torch.parallel.pbt_mixed import (
        masked_advantage_stats, policy_objectives,
    )
    from quadswarm_tpu_torch.parallel.ppo import Trainer, advantage_stats
    b = joined_batch(0)
    rows = lambda x: shard_env_batch(mesh, x)
    start = RunningMeanStd.create(5).update(torch.ones(3, 5) * 0.5)
    infos = {k: shard_env_batch(mesh, v, axis=1)
             for k, v in b["infos"].items()}
    return {
        "obs": _norm(start.update(rows(b["x"]), mesh)),
        "masked": _norm(start.update_masked(rows(b["x"]), rows(b["w"]),
                                            mesh)),
        "ret": _norm(RunningMeanStd.create().update(rows(b["ret"]), mesh)),
        "stats": Trainer.episode_stats(SimpleNamespace(mesh=mesh), infos),
        "adv": advantage_stats(rows(b["adv"]), mesh),
        "masked_adv": masked_advantage_stats(rows(b["adv"]),
                                             rows(b["assign"]), 3, mesh),
        "objectives": policy_objectives(
            infos, shard_env_batch(mesh, b["assignment"], axis=1), 3, mesh),
    }


def case_appo_split(mesh, workdir: Path) -> dict:
    """APPO with split_mesh=(1, 1), 2 iterations: placement, losses, the
    weights each rank holds after each, and (on the learner rank) the
    learner against the one-process learner on the trajectory it got."""
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.parallel import appo as A
    from quadswarm_tpu_torch.parallel.mesh import local_mesh
    from quadswarm_tpu_torch.parallel.ppo import make_optimizer
    cfg, ppo = tiny_appo_cfg()
    seen = {}
    learn = A.appo_learn

    def spy(net, opt, ppo_cfg, traj, last_obs, gen, norm, mesh_):
        seen.update(weights=_params(net),
                    opt=copy.deepcopy(opt.state_dict()), traj=traj,
                    last_obs=last_obs, gen=gen.get_state(), norm=norm)
        return learn(net, opt, ppo_cfg, traj, last_obs, gen, norm, mesh_)

    A.appo_learn = spy
    tr = A.APPOTrainer(cfg, ppo, model(), make_dynamics_params(dt=cfg.dt),
                       seed=0, policy_lag=1, device="cpu",
                       split_mesh=(1, 1))
    out = {"optimizer": tr.optimizer is not None,
           "env": tr.env_states is not None,
           "queue": tr._param_queue is not None, "iters": []}
    for _ in range(2):
        metrics, infos = tr.iteration()
        out["iters"].append({
            "params": _params(tr.model), "norm": _norm(tr.norm_state),
            "loss": float(metrics["loss"]), "infos": infos is not None,
            "stats": tr.episode_stats(infos), "env_steps": tr.env_steps})
    if tr.optimizer is not None:
        net = model()
        net.load_state_dict(seen["weights"])
        ppo_cfg = tr.ppo_cfg
        opt = make_optimizer(net, ppo_cfg)
        opt.load_state_dict(seen["opt"])
        gen = torch.Generator().set_state(seen["gen"])
        learn(net, opt, ppo_cfg, seen["traj"], seen["last_obs"], gen,
              seen["norm"], local_mesh("cpu"))
        out["one_process"] = _params(net)
    return out


def case_pbt(mesh, workdir: Path) -> dict:
    """Separate PBT, 2 policies, rounds from the start: every rank's
    objectives, coefficients and weights after training."""
    from quadswarm_tpu_torch.env.multi import EnvConfig
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.parallel import pbt as B
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig
    cfg = EnvConfig(num_agents=3, quads_mode="mix",
                    neighbor_obs_type="pos_vel", neighbor_visible_num=K,
                    ep_time=0.08)
    ppo = PPOConfig(rollout=8, batch_size=24, num_envs=4)
    rounds = []
    pbt_round = B.PBTRunner._pbt_round

    def spy(self):
        rounds.append([s.objective() for s in self.policies])
        pbt_round(self)

    B.PBTRunner._pbt_round = spy
    runner = B.PBTRunner(
        cfg, ppo, lambda: model(), make_dynamics_params(dt=cfg.dt),
        B.PBTConfig(num_policies=2, period_env_steps=1, start_mutation=0,
                    replace_fraction=0.5, replace_reward_gap=0.0,
                    mutation_rate=1.0),
        seed=0, exp_dir=str(workdir / "pbt"), device="cpu", mesh=mesh)
    runner.train(2 * 2 * 8 * 4 * 3)
    return {"rounds": rounds,
            "coeffs": [s.trainer.base_rew_coeff for s in runner.policies],
            "params": [_params(s.trainer.model) for s in runner.policies],
            "objectives": [s.recent_true_rewards for s in runner.policies]}


def case_mixed(mesh, workdir: Path) -> dict:
    """Mixed-policy PBT, 3 policies, 2 iterations and a round: the stacked
    weights, objectives and coefficients on every rank."""
    from quadswarm_tpu_torch.env.multi import EnvConfig
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.parallel.pbt import PBTConfig
    from quadswarm_tpu_torch.parallel.pbt_mixed import MixedPBTRunner
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig
    cfg = EnvConfig(num_agents=4, quads_mode="mix",
                    neighbor_obs_type="pos_vel", neighbor_visible_num=K,
                    ep_time=0.08)
    ppo = PPOConfig(rollout=8, batch_size=32, num_envs=4,
                    normalize_input=True)
    runner = MixedPBTRunner(
        cfg, ppo, lambda: model(), make_dynamics_params(dt=cfg.dt),
        PBTConfig(num_policies=3, replace_reward_gap=0.0), seed=0,
        device="cpu", mesh=mesh)
    losses = []
    for _ in range(2):
        metrics, _ = runner.iteration()
        losses.append(metrics["loss"].clone())
    runner.pbt_round()
    return {"params": {k: v.detach().clone()
                       for k, v in runner.heads.params.items()},
            "norm": _norm(runner.norm_state), "losses": losses,
            "hist": runner.objective_hist, "coeffs": runner.coeffs,
            "envs": runner.obs.shape[0]}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main(argv) -> None:
    case, workdir, rank, world = argv[0], Path(argv[1]), int(argv[2]), \
        int(argv[3])
    torch.set_num_threads(1)
    from quadswarm_tpu_torch.parallel.distributed import init_distributed
    from quadswarm_tpu_torch.parallel.mesh import make_mesh
    init_distributed(init_method=f"file://{workdir}/pg_{case}",
                     num_processes=world, process_id=rank, device="cpu")
    out = CASES[case](make_mesh(device="cpu"), workdir)
    torch.save(out, workdir / f"{case}_{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
