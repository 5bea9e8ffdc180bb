"""Training CLI: `python -m quadswarm_tpu_torch.training.train ...`

Port of quadswarm_tpu/training/train.py: it takes the flags of `train.sh`,
`train_local_obst.sh` and the run files (`runs/`) unchanged and trains on
the CUDA device (`--device=cpu` runs the kernels' plain versions on the
CPU).  Its branches, tested in the JAX CLI's order:
- `--with_pbt=True --num_policies>1`: population-based training, one
  `checkpoint_p{p}` a policy; `--async_rl` is then ignored, as in the JAX
  CLI.  With `--pbt_mix_policies_in_one_env=True` the policies share one
  env batch (`parallel/pbt_mixed.py`): `metrics.jsonl` logs
  `policy{p}/loss`, `policy{p}/pbt_objective` and `reward_mean`, a round
  runs every `--pbt_period_env_steps` from `--pbt_start_mutation` on, the
  run saves every --save_every_sec seconds and at exit (with
  `pbt_state.json`) and resumes; it takes no annealing schedule, as in the
  JAX CLI, and warns when `--anneal_collision_steps` asks for one.  Else
  the policies train apart (`parallel/pbt.py`), one `p{p}/metrics.jsonl`
  a policy;
- `--async_rl=True`: APPO (`parallel/appo.py`) with `--policy_lag` and
  `--with_vtrace`;
- else synchronous PPO.
The last two resume from the experiment's latest checkpoint, log windowed
`perf/sps` and the episode stats every --log_every_iters iterations to
`metrics.jsonl`, keep a `best` checkpoint by the windowed mean of the
episode `true_reward`, and save every --save_every_sec seconds and at exit.

`--multi_host=True` trains one job over a torch.distributed world, one
rank a card (`parallel/distributed.py`), every branch on the same mesh:
    torchrun --nproc_per_node=<cards> -m quadswarm_tpu_torch.training.train \
        --multi_host=True <train.sh's flags>
`--num_envs` and `--batch_size` stay global.  Every rank loads a
checkpoint on resume; rank 0 logs, and the rank that holds the optimizer's
first copy writes (rank 0, or rank R under `--appo_split_devices=R,L`).

Example (the 8-drone mix baseline):
    python -m quadswarm_tpu_torch.training.train \\
        --train_for_env_steps=1000000000 --num_envs=1024 --rollout=128 \\
        --batch_size=1024 --quads_num_agents=8 --quads_mode=mix \\
        --quads_neighbor_encoder_type=attention --quads_neighbor_visible_num=6 \\
        --quads_neighbor_obs_type=pos_vel --quads_collision_reward=5.0 \\
        --quads_collision_falloff_radius=4.0 --quads_use_downwash=True \\
        --replay_buffer_sample_prob=0.75 --anneal_collision_steps=300000000
"""
from __future__ import annotations

import os
import sys
import time
import warnings

import numpy as np
import torch


def main(argv=None) -> int:
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.parallel.appo import APPOTrainer
    from quadswarm_tpu_torch.parallel.pbt import PBTRunner
    from quadswarm_tpu_torch.parallel.ppo import Trainer
    from quadswarm_tpu_torch.parallel.mesh import make_mesh
    from quadswarm_tpu_torch.training.config import (
        anneal_schedules_from_args, appo_split_from_args,
        base_rew_coeff_from_args, env_config_from_args, model_from_args,
        parse_swarm_cfg, pbt_config_from_args, ppo_config_from_args,
        save_cfg,
    )
    from quadswarm_tpu_torch.utils.checkpoint import (
        checkpoint_dir, latest_checkpoint, load_checkpoint, save_checkpoint,
    )
    from quadswarm_tpu_torch.utils.metrics import MetricLogger
    from quadswarm_tpu_torch.utils.struct import resolve_device

    args = parse_swarm_cfg(argv)
    if args.multi_host:
        # before anything touches the card: each rank takes its own
        from quadswarm_tpu_torch.parallel.distributed import init_distributed
        init_distributed(device=args.device)
    device = resolve_device(args.device)
    mesh = make_mesh(device=device)
    is_main = mesh.is_main          # the only rank that logs and prints
    if args.multi_host:
        print(f"multi-host: process {mesh.rank}/{mesh.world}, "
              f"{mesh.world} ranks on {mesh.device}", flush=True)
    device = mesh.device
    exp_dir = os.path.join(args.train_dir, args.experiment)
    if is_main:
        save_cfg(args, exp_dir)

    env_cfg = env_config_from_args(args)
    ppo_cfg = ppo_config_from_args(args)
    dyn = make_dynamics_params(dt=env_cfg.dt)
    anneal = anneal_schedules_from_args(args)
    base_coeff = base_rew_coeff_from_args(args)
    if args.with_pbt and args.num_policies > 1:
        if args.pbt_mix_policies_in_one_env:
            return _train_mixed(args, env_cfg, ppo_cfg, dyn, base_coeff,
                                exp_dir, mesh)
        runner = PBTRunner(env_cfg, ppo_cfg,
                           lambda: model_from_args(args, env_cfg,
                                                   device=device),
                           dyn, pbt_config_from_args(args), seed=args.seed,
                           anneal_schedules=anneal, exp_dir=exp_dir,
                           base_rew_coeff=base_coeff, device=device,
                           mesh=mesh)
        runner.train(args.train_for_env_steps)
        return 0

    torch.manual_seed(args.seed)
    model = model_from_args(args, env_cfg, device=device)
    if args.async_rl:
        trainer = APPOTrainer(env_cfg, ppo_cfg, model, dyn, seed=args.seed,
                              anneal_schedules=anneal,
                              policy_lag=args.policy_lag,
                              base_rew_coeff=base_coeff, device=device,
                              mesh=mesh,
                              split_mesh=appo_split_from_args(args))
    else:
        trainer = Trainer(env_cfg, ppo_cfg, model, dyn, seed=args.seed,
                          anneal_schedules=anneal, base_rew_coeff=base_coeff,
                          device=device, mesh=mesh)
    cp_dir = checkpoint_dir(args.train_dir, args.experiment)
    cp = latest_checkpoint(cp_dir)
    if cp is not None:
        trainer.step, trainer.env_steps, trainer.norm_state = load_checkpoint(
            cp, trainer.model, trainer.optimizer, extra=trainer.norm_state,
            device=device)
        if args.async_rl:
            # the JAX CLI keeps the fresh weights in its behaviour queue
            # here, so its first rollouts after a resume use them
            trainer.restart_behavior_queue()
        if is_main:
            print(f"resumed from {cp} at {trainer.env_steps} env steps",
                  flush=True)

    def save(tag="checkpoint", keep=3):
        if trainer.writes:
            save_checkpoint(cp_dir, trainer.model, trainer.optimizer,
                            trainer.step, trainer.env_steps, keep=keep,
                            tag=tag, extra=trainer.norm_state)

    logger = MetricLogger(
        exp_dir, use_wandb=args.with_wandb,
        wandb_kwargs=dict(project=args.wandb_project, entity=args.wandb_user,
                          group=args.wandb_group, name=args.experiment)
    ) if is_main else None
    if args.debug_checks:
        torch.autograd.set_detect_anomaly(True)
    last_save = time.time()
    it = 0
    last_t, last_steps = time.time(), trainer.env_steps
    profiler = None
    # Best checkpoint: windowed mean of the episode true_reward.
    best_objective = -float("inf")
    recent_true_rewards: list[float] = []
    try:
        while trainer.env_steps < args.train_for_env_steps:
            metrics, infos = trainer.iteration()
            it += 1
            if args.profile_dir and it == 1 and is_main:
                # from the second iteration on: the first holds the warm-up
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU] + (
                    [torch.profiler.ProfilerActivity.CUDA]
                    if device.type == "cuda" else []))
                profiler.start()
            if profiler is not None and it == 1 + args.profile_iters:
                profiler.stop()
                _export_trace(profiler, args.profile_dir)
                profiler = None
            if it % args.log_every_iters == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(trainer.episode_stats(infos))
                if "true_reward" in m:
                    recent_true_rewards = (recent_true_rewards
                                           + [m["true_reward"]])[-10:]
                    objective = float(np.mean(recent_true_rewards))
                    if (len(recent_true_rewards) >= 3
                            and objective > best_objective):
                        best_objective = objective
                        save(tag="best", keep=1)
                now = time.time()
                # windowed: the first window absorbs the warm-up
                m["perf/sps"] = ((trainer.env_steps - last_steps)
                                 / max(now - last_t, 1e-9))
                m["perf/rollout_s"] = trainer.seconds["rollout"]
                m["perf/learner_s"] = trainer.seconds["learner"]
                if "recompute" in trainer.seconds:          # APPO's learner
                    m["perf/recompute_s"] = trainer.seconds["recompute"]
                last_t, last_steps = now, trainer.env_steps
                if is_main:
                    logger.log(trainer.env_steps, m)
                    print(f"steps={trainer.env_steps:,} "
                          f"sps={m['perf/sps']:,.0f} "
                          f"loss={m['loss']:.4f} "
                          f"rew={m['reward_mean']:.4f}", flush=True)
            if time.time() - last_save > args.save_every_sec:
                save()
                last_save = time.time()
    finally:
        if profiler is not None:
            profiler.stop()
            _export_trace(profiler, args.profile_dir)
        save()
        if logger is not None:
            logger.close()
    return 0


def _train_mixed(args, env_cfg, ppo_cfg, dyn, base_coeff, exp_dir,
                 mesh) -> int:
    """The mixed-policy PBT branch, in the JAX CLI's order."""
    from quadswarm_tpu_torch.parallel.pbt_mixed import MixedPBTRunner
    from quadswarm_tpu_torch.training.config import (
        model_from_args, pbt_config_from_args,
    )
    from quadswarm_tpu_torch.utils.metrics import MetricLogger

    if args.anneal_collision_steps > 0:
        # the JAX package's MixedPBTRunner takes no schedule either
        warnings.warn("--anneal_collision_steps is ignored under "
                      "--pbt_mix_policies_in_one_env=True: the mixed PBT "
                      "runner takes no annealing schedule (as in the JAX "
                      "package)")
    pbt_cfg = pbt_config_from_args(args)
    runner = MixedPBTRunner(
        env_cfg, ppo_cfg, lambda: model_from_args(args, env_cfg,
                                                  device=mesh.device),
        dyn, pbt_cfg, seed=args.seed, exp_dir=exp_dir,
        base_rew_coeff=base_coeff, device=mesh.device, mesh=mesh)
    is_main = mesh.is_main
    if runner.restore(args.train_dir, args.experiment) and is_main:
        print(f"resumed mixed PBT at {runner.env_steps} env steps",
              flush=True)
    logger = MetricLogger(exp_dir) if is_main else None
    it, last_round = 0, 0
    last_save = time.time()
    try:
        while runner.env_steps < args.train_for_env_steps:
            metrics, _ = runner.iteration()
            it += 1
            if it % args.log_every_iters == 0 and is_main:
                m = {f"policy{p}/loss": float(v)
                     for p, v in enumerate(metrics["loss"].tolist())}
                m["reward_mean"] = float(metrics["reward_mean"])
                for p, h in enumerate(runner.objective_hist):
                    if h:
                        m[f"policy{p}/pbt_objective"] = h[-1]
                m["perf/rollout_s"] = runner.seconds["rollout"]
                m["perf/learner_s"] = runner.seconds["learner"]
                logger.log(runner.env_steps, m)
                print(f"steps={runner.env_steps:,} "
                      f"rew={m['reward_mean']:.4f}", flush=True)
            if (runner.env_steps >= pbt_cfg.start_mutation
                    and runner.env_steps - last_round
                    >= pbt_cfg.period_env_steps):
                last_round = runner.env_steps
                runner.pbt_round()
            if time.time() - last_save > args.save_every_sec and is_main:
                runner.save(args.train_dir, args.experiment)
                last_save = time.time()
    finally:
        if is_main:
            runner.save(args.train_dir, args.experiment)
            logger.close()
    return 0


def _export_trace(profiler, profile_dir: str) -> None:
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"profiler trace written to {path}", flush=True)


if __name__ == "__main__":
    code = main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    sys.exit(code)
