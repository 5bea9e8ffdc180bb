"""Per-phase timing of one training iteration (rollout vs GAE+SGD).

Port of quadswarm_tpu/analysis/profile_train.py: the halves of a training
iteration, timed apart on the card with the JAX tool's delta method, so
that perf work can see where the iteration's time goes.

Usage:
    python -m quadswarm_tpu_torch.analysis.profile_train \\
        --num_envs 1024 --iters 5 [--no_replay] [--device cpu]

Prints one JSON line per phase: rollout-only (`collect_rollout`), GAE+SGD
only (`compute_gae` and `sgd_epochs` on a trajectory collected once), and
the full `Trainer.iteration`.  The model computes in float32, the JAX
tool's default off a TPU; `--model_f32` is accepted for the JAX tool's
command lines.  `--sgd_unroll` (the JAX learner's scan unroll factor) is
accepted only at 1: the port's learner runs its minibatches one by one.
"""
from __future__ import annotations

import argparse
import copy
import json
import time

import torch


def _barrier(device: torch.device) -> None:
    """Wait for the device: the timed work ends when the card has done
    it, not when the host has queued it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, n, device):
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _barrier(device)
    return time.perf_counter() - t0


def _delta(fn, iters, device):
    """Run 1 and 1 + iters repetitions; the difference removes the fixed
    cost of a call and its barrier.  The warm-up call takes the first
    call's costs (the kernels' load, the allocator's growth)."""
    fn()
    _barrier(device)
    t_short = _timed(fn, 1, device)
    t_long = _timed(fn, 1 + iters, device)
    return max(t_long - t_short, 1e-9) / iters


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--num_agents", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--model_f32", action="store_true",
                   help="accepted: the model computes in float32")
    p.add_argument("--no_replay", action="store_true")
    p.add_argument("--rollout", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--sgd_unroll", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.sgd_unroll != 1:
        p.error("--sgd_unroll is the JAX learner's scan unroll factor; the "
                "port's learner runs its minibatches one by one, so only 1 "
                "is accepted")

    from quadswarm_tpu_torch.env.multi import EnvConfig
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.parallel.ppo import (
        PPOConfig, Trainer, collect_rollout, compute_gae, make_optimizer,
        sgd_epochs,
    )
    from quadswarm_tpu_torch.utils.struct import resolve_device

    device = resolve_device(args.device)
    env_cfg = EnvConfig(
        num_agents=args.num_agents, neighbor_obs_type="pos_vel",
        neighbor_visible_num=min(6, args.num_agents - 1), quads_mode="mix",
        use_pallas_dynamics=True)
    ppo_cfg = PPOConfig(
        rollout=args.rollout, batch_size=args.batch_size,
        num_envs=args.num_envs,
        replay_sample_prob=0.0 if args.no_replay else 0.75)
    torch.manual_seed(0)
    model = ActorCritic(
        self_obs_dim=18, neighbor_obs_dim=6,
        num_neighbors=env_cfg.neighbor_visible_num, encoder_type="corl",
        neighbor_encoder_type="attention", rnn_size=256,
        neighbor_hidden=256, device=device)
    dyn = make_dynamics_params(dt=env_cfg.dt)
    trainer = Trainer(env_cfg, ppo_cfg, model, dyn, seed=0, device=device)
    steps_per_iter = ppo_cfg.rollout * args.num_envs * args.num_agents
    rew_coeff = trainer.current_rew_coeff()
    gen = torch.Generator(device).manual_seed(1)

    def rollout():
        return collect_rollout(env_cfg, dyn, trainer.model, ppo_cfg,
                               trainer.env_states, trainer.obs, gen,
                               rew_coeff, trainer.replay_states,
                               norm=trainer.norm_state)

    # one trajectory for the GAE+SGD phase, learned on copies of the model
    # and optimizer so that the full iteration starts from the trainer's
    _, _, _, traj, last_value, _ = rollout()
    learner = copy.deepcopy(trainer.model)
    optimizer = make_optimizer(learner, ppo_cfg)

    def gae_sgd():
        with torch.no_grad():
            advantages, returns = compute_gae(
                traj, last_value, ppo_cfg.gamma, ppo_cfg.gae_lambda)
        sgd_epochs(learner, optimizer, ppo_cfg, traj, advantages, returns,
                   gen)

    results = []
    for phase, fn in (("rollout", rollout), ("gae+sgd", gae_sgd),
                      ("full_iteration", trainer.iteration)):
        t = _delta(fn, args.iters, device)
        results.append({"phase": phase, "ms_per_iter": round(t * 1e3, 2),
                        "agent_steps_per_s": round(steps_per_iter / t)})
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    for r in results:
        r.update(num_envs=args.num_envs, rollout=args.rollout,
                 batch_size=args.batch_size, model_dtype="float32",
                 replay=not args.no_replay, device=name)
        print(json.dumps(r))
    return results


if __name__ == "__main__":
    main()
