"""CLI flag surface of the port's training CLI.

Port of quadswarm_tpu/training/config.py: the same flags, names, defaults
and choices (the reference's `--quads_*` flags plus the Sample Factory
training flags its baselines set), so the command lines of `train.sh`,
`train_local_obst.sh` and the run files (`runs/`) parse unchanged, plus
`--device` (default `cuda`);
with `evaluation=True` also the eval CLI's flags.  Settings the port does
not run (`--quads_use_pallas=false` on the card, recurrent policies) raise
rather than train something else.
"""
from __future__ import annotations

import argparse
import json
import os
import warnings


def str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


def add_quadrotors_env_args(p: argparse.ArgumentParser) -> None:
    # Quadrotor features
    p.add_argument("--quads_num_agents", default=8, type=int)
    p.add_argument("--quads_obs_repr", default="xyz_vxyz_R_omega",
                   choices=["xyz_vxyz_R_omega", "xyz_vxyz_R_omega_floor",
                            "xyz_vxyz_R_omega_wall"])
    p.add_argument("--quads_episode_duration", default=15.0, type=float)
    p.add_argument("--quads_encoder_type", default="corl", type=str)
    # Neighbor
    p.add_argument("--quads_neighbor_visible_num", default=-1, type=int)
    p.add_argument("--quads_neighbor_obs_type", default="none",
                   choices=["none", "pos_vel"])
    p.add_argument("--quads_neighbor_hidden_size", default=256, type=int)
    p.add_argument("--quads_neighbor_encoder_type", default="attention",
                   choices=["attention", "mean_embed", "mlp", "no_encoder"])
    p.add_argument("--quads_collision_reward", default=0.0, type=float)
    p.add_argument("--quads_collision_hitbox_radius", default=2.0, type=float)
    p.add_argument("--quads_collision_falloff_radius", default=-1.0, type=float)
    p.add_argument("--quads_collision_smooth_max_penalty", default=10.0,
                   type=float)
    # Obstacle
    p.add_argument("--quads_use_obstacles", default=False, type=str2bool)
    p.add_argument("--quads_obstacle_obs_type", default="none",
                   choices=["none", "octomap"])
    p.add_argument("--quads_obst_density", default=0.2, type=float)
    p.add_argument("--quads_obst_size", default=1.0, type=float)
    p.add_argument("--quads_obst_spawn_area", nargs="+", default=[6.0, 6.0],
                   type=float)
    p.add_argument("--quads_domain_random", default=False, type=str2bool)
    p.add_argument("--quads_obst_density_random", default=False, type=str2bool)
    p.add_argument("--quads_obst_density_min", default=0.05, type=float)
    p.add_argument("--quads_obst_density_max", default=0.2, type=float)
    p.add_argument("--quads_obst_size_random", default=False, type=str2bool)
    p.add_argument("--quads_obst_size_min", default=0.3, type=float)
    p.add_argument("--quads_obst_size_max", default=0.6, type=float)
    p.add_argument("--quads_obst_hidden_size", default=256, type=int)
    p.add_argument("--quads_obst_encoder_type", default="mlp", type=str)
    p.add_argument("--quads_obst_collision_reward", default=0.0, type=float)
    # Aerodynamics
    p.add_argument("--quads_use_downwash", default=False, type=str2bool)
    p.add_argument("--quads_use_pallas", default="auto",
                   choices=["auto", "true", "false"],
                   help="the fused dynamics kernel K1 on the card (auto and "
                        "true); false, the plain version on the card, is "
                        "refused")
    p.add_argument("--quads_use_pallas_pairs", default="false",
                   choices=["true", "false"],
                   help="the pair kernels K2 (collisions, packed pair "
                        "history) and K3 (k-nearest neighbour observation)")
    p.add_argument("--quads_use_numba", default=False, type=str2bool,
                   help="ignored (reference compatibility); see "
                        "--quads_use_pallas")
    # Scenarios
    p.add_argument("--quads_mode", default="static_same_goal",
                   choices=["static_same_goal", "static_diff_goal",
                            "dynamic_same_goal", "dynamic_diff_goal",
                            "ep_lissajous3D", "ep_rand_bezier", "swarm_vs_swarm",
                            "swap_goals", "dynamic_formations", "run_away", "mix",
                            "o_random", "o_dynamic_same_goal",
                            "o_static_same_goal", "o_swap_goals",
                            "o_ep_rand_bezier", "o_uniform_same_goal_spawn",
                            "o_diagonal", "o_static_diff_goal",
                            "o_dynamic_diff_goal", "o_test"])
    # Room
    p.add_argument("--quads_room_dims", nargs="+", default=[10.0, 10.0, 10.0],
                   type=float)
    # Replay buffer
    p.add_argument("--replay_buffer_sample_prob", default=0.0, type=float)
    # Annealing
    p.add_argument("--anneal_collision_steps", default=0.0, type=float)
    # Rendering
    p.add_argument("--quads_view_mode", nargs="+",
                   default=["topdown", "chase", "global"],
                   choices=["topdown", "chase", "side", "global", "corner0",
                            "corner1", "corner2", "corner3", "topdownfollow"])
    p.add_argument("--quads_render", default=False, type=str2bool)
    p.add_argument("--visualize_v_value", default=False, type=str2bool,
                   nargs="?", const=True)
    # Sim2Real
    p.add_argument("--quads_sim2real", default=False, type=str2bool)


def add_training_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--experiment", default="quad_swarm_tpu", type=str)
    p.add_argument("--train_dir", default="train_dir", type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="the device to train on; cpu runs the kernels' "
                        "plain versions")
    p.add_argument("--multi_host", default=False, type=str2bool,
                   help="one job over every rank of a torch.distributed "
                        "world (torchrun's variables, or the JAX package's "
                        "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                        "JAX_PROCESS_ID), one rank a card")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--train_for_env_steps", default=1_000_000_000, type=int)
    p.add_argument("--num_envs", default=0, type=int,
                   help="env batch on the device (0 = num_workers x "
                        "num_envs_per_worker, or 1024)")
    p.add_argument("--num_workers", default=0, type=int,
                   help="reference compat: folded into --num_envs")
    p.add_argument("--num_envs_per_worker", default=4, type=int,
                   help="reference compat: folded into --num_envs")
    # Reference model/trainer flags: only the baselines' values are
    # implemented, the others are refused.
    p.add_argument("--use_rnn", default=False, type=str2bool)
    p.add_argument("--recurrence", default=1, type=int)
    p.add_argument("--actor_critic_share_weights", default=False,
                   type=str2bool)
    p.add_argument("--policy_initialization", default="xavier_uniform",
                   type=str)
    p.add_argument("--adaptive_stddev", default=False, type=str2bool)
    p.add_argument("--max_policy_lag", default=100000000, type=int,
                   help="reference compat: accepted")
    p.add_argument("--normalize_input", default=False, type=str2bool,
                   help="running mean-std observation normalization")
    p.add_argument("--normalize_returns", default=False, type=str2bool,
                   help="the critic learns running-normalized returns")
    p.add_argument("--save_milestones_sec", default=-1, type=int,
                   help="reference compat: caps --save_every_sec when set")
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--gamma", default=0.99, type=float)
    p.add_argument("--gae_lambda", default=1.00, type=float)
    p.add_argument("--ppo_clip_ratio", default=0.1, type=float)
    p.add_argument("--ppo_clip_value", default=5.0, type=float)
    p.add_argument("--value_loss_coeff", default=0.5, type=float)
    p.add_argument("--exploration_loss_coeff", default=0.0, type=float)
    p.add_argument("--max_entropy_coeff", default=0.0, type=float)
    p.add_argument("--max_grad_norm", default=5.0, type=float)
    p.add_argument("--rollout", default=128, type=int)
    p.add_argument("--batch_size", default=1024, type=int)
    p.add_argument("--num_epochs", default=1, type=int)
    p.add_argument("--reward_clip", default=10.0, type=float)
    p.add_argument("--sgd_unroll", default=8, type=int,
                   help="accepted (an XLA knob of the JAX package)")
    # APPO
    p.add_argument("--appo_split_devices", default="", type=str,
                   help="R,L: APPO's rollout on ranks 0..R-1 and its "
                        "learner on the next L, a world of R + L ranks")
    p.add_argument("--async_rl", default=False, type=str2bool)
    p.add_argument("--policy_lag", default=1, type=int)
    p.add_argument("--with_vtrace", default=False, type=str2bool)
    p.add_argument("--vtrace_rho", default=1.0, type=float)
    p.add_argument("--vtrace_c", default=1.0, type=float)
    p.add_argument("--rnn_size", default=256, type=int)
    p.add_argument("--nonlinearity", default="tanh", type=str)
    p.add_argument("--initial_stddev", default=1.0, type=float)
    p.add_argument("--save_every_sec", default=300, type=int)
    p.add_argument("--debug_checks", default=False, type=str2bool,
                   help="autograd anomaly detection: raise at the backward "
                        "operation that makes a NaN")
    p.add_argument("--profile_dir", default="", type=str,
                   help="write a torch.profiler Chrome trace of "
                        "--profile_iters iterations after the first here")
    p.add_argument("--profile_iters", default=3, type=int)
    p.add_argument("--log_every_iters", default=10, type=int)
    p.add_argument("--with_wandb", default=False, type=str2bool)
    p.add_argument("--wandb_project", default="quadswarm-tpu", type=str)
    p.add_argument("--wandb_user", default=None, type=str)
    p.add_argument("--wandb_group", default=None, type=str)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the env state's dtype; the dynamics kernel reads "
                        "it as float32 and writes it back in this dtype, "
                        "the scenario's event table stays float32")
    p.add_argument("--model_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="model COMPUTE dtype (params and optimizer stay "
                        "float32; loss, GAE and V-trace math is float32). "
                        "auto = bfloat16 on a TPU, float32 elsewhere (the "
                        "JAX package's rule), so float32 on a CUDA card")
    # PBT
    p.add_argument("--with_pbt", default=False, type=str2bool)
    p.add_argument("--num_policies", default=1, type=int)
    p.add_argument("--pbt_period_env_steps", default=5_000_000, type=int)
    p.add_argument("--pbt_start_mutation", default=20_000_000, type=int)
    p.add_argument("--pbt_mix_policies_in_one_env", default=False,
                   type=str2bool)
    p.add_argument("--pbt_replace_fraction", default=0.3, type=float)
    p.add_argument("--pbt_mutation_rate", default=0.15, type=float)
    p.add_argument("--pbt_replace_reward_gap", default=0.1, type=float)
    p.add_argument("--pbt_replace_reward_gap_absolute", default=1e-6,
                   type=float)
    p.add_argument("--pbt_optimize_gamma", default=False, type=str2bool)
    p.add_argument("--pbt_perturb_max", default=1.2, type=float)


def add_evaluation_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--load_checkpoint_kind", default="latest",
                   choices=["latest", "best"])
    p.add_argument("--max_num_episodes", default=1, type=int)
    p.add_argument("--eval_envs", default=1, type=int,
                   help="envs run side by side in a round (episodes are "
                        "fixed-length, so a round ends eval_envs episodes); "
                        "1 = the single-env loop, which can render and "
                        "dump")
    p.add_argument("--render_mode", default="plot",
                   choices=["plot", "dump", "none", "human", "rgb_array",
                            "live"],
                   help="with --eval_envs=1: plot (human, rgb_array) draws "
                        "every 10th tick's frame after the episode, live "
                        "streams frames while it runs, dump writes the "
                        "trajectory as .npz; drawing needs matplotlib")
    p.add_argument("--render_out", default="render_out", type=str)
    p.add_argument("--render_every_nth", default=5, type=int)
    p.add_argument("--realtime", default=False, type=str2bool, nargs="?",
                   const=True)


def parse_swarm_cfg(argv=None, evaluation: bool = False
                    ) -> argparse.Namespace:
    p = argparse.ArgumentParser("quadswarm_tpu_torch")
    p.add_argument("--env", default="quadrotor_multi", type=str)
    p.add_argument("--algo", default="APPO", type=str)
    add_quadrotors_env_args(p)
    add_training_args(p)
    if evaluation:
        add_evaluation_args(p)
    return _resolve_compat_flags(p.parse_args(argv))


def _resolve_compat_flags(args) -> argparse.Namespace:
    """Fold Sample-Factory-style flags into their native equivalents and
    refuse settings the port does not implement."""
    if args.num_envs <= 0:
        args.num_envs = (args.num_workers * args.num_envs_per_worker
                         if args.num_workers > 0 else 1024)
    if args.save_milestones_sec > 0:
        args.save_every_sec = min(args.save_every_sec, args.save_milestones_sec)
    if args.use_rnn or args.recurrence > 1:
        raise ValueError("recurrent policies are not implemented; the "
                         "reference baselines train with --use_rnn=False "
                         "--recurrence=1 (train.sh)")
    if args.actor_critic_share_weights:
        raise ValueError("shared actor/critic weights are not implemented")
    if args.adaptive_stddev:
        raise ValueError("adaptive (state-dependent) stddev is not "
                         "implemented")
    if args.policy_initialization != "xavier_uniform":
        warnings.warn(f"policy_initialization={args.policy_initialization!r} "
                      "ignored; the model uses xavier_uniform")
    if args.quads_obstacle_obs_type == "octomap" and not args.quads_use_obstacles:
        raise ValueError("--quads_obstacle_obs_type=octomap requires "
                         "--quads_use_obstacles=True")
    if args.quads_use_obstacles and args.quads_obstacle_obs_type == "none":
        warnings.warn("obstacles are on but --quads_obstacle_obs_type=none: "
                      "the model ignores the SDF observation")
    if ((args.quads_obst_density_random or args.quads_obst_size_random)
            and not args.quads_domain_random):
        warnings.warn("--quads_obst_density_random/--quads_obst_size_random "
                      "have no effect without --quads_domain_random=True")
    if args.quads_use_pallas == "false":
        raise ValueError("--quads_use_pallas=false names the plain dynamics "
                         "on the card, which the port does not run: its "
                         "dynamics on CUDA go through the kernel K1 (auto, "
                         "true); --device=cpu runs the plain version")
    if args.appo_split_devices:
        # the JAX CLI reads it without a check
        try:
            split = tuple(int(x) for x in args.appo_split_devices.split(","))
        except ValueError:
            split = ()
        if len(split) != 2 or min(split) < 1:
            raise ValueError("--appo_split_devices takes R,L: two positive "
                             "rank counts, got "
                             f"{args.appo_split_devices!r}")
        if not args.async_rl:
            warnings.warn("--appo_split_devices has no effect without "
                          "--async_rl=True")
    return args


def appo_split_from_args(args) -> tuple | None:
    """(R, L) of --appo_split_devices, or None."""
    if not args.appo_split_devices:
        return None
    return tuple(int(x) for x in args.appo_split_devices.split(","))


def base_rew_coeff_from_args(args) -> dict:
    """Collision reward-shaping coefficients from the CLI.  With
    --anneal_collision_steps > 0 the annealing schedule overrides them."""
    return dict(
        quadcol_bin=args.quads_collision_reward,
        quadcol_bin_smooth_max=args.quads_collision_smooth_max_penalty,
        quadcol_bin_obst=args.quads_obst_collision_reward,
    )


def env_config_from_args(args):
    import torch

    from quadswarm_tpu_torch.env.multi import EnvConfig

    return EnvConfig(
        num_agents=args.quads_num_agents,
        ep_time=args.quads_episode_duration,
        room_dims=tuple(args.quads_room_dims),
        obs_repr=args.quads_obs_repr,
        neighbor_obs_type=args.quads_neighbor_obs_type,
        neighbor_visible_num=args.quads_neighbor_visible_num,
        collision_hitbox_radius=args.quads_collision_hitbox_radius,
        collision_falloff_radius=args.quads_collision_falloff_radius,
        use_obstacles=args.quads_use_obstacles,
        obst_density=args.quads_obst_density,
        obst_size=args.quads_obst_size,
        obst_spawn_area=tuple(args.quads_obst_spawn_area),
        obst_density_random=(args.quads_domain_random
                             and args.quads_obst_density_random),
        obst_density_min=args.quads_obst_density_min,
        obst_density_max=args.quads_obst_density_max,
        obst_size_random=(args.quads_domain_random
                          and args.quads_obst_size_random),
        obst_size_min=args.quads_obst_size_min,
        obst_size_max=args.quads_obst_size_max,
        use_downwash=args.quads_use_downwash,
        quads_mode=args.quads_mode,
        use_pallas_pairs=args.quads_use_pallas_pairs == "true",
        use_pallas_dynamics=True,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
    )


def model_dtype_from_args(args):
    """The model's compute dtype: --model_dtype, with auto resolved by the
    JAX package's rule, bfloat16 only on a TPU backend: the port runs on a
    CUDA card or the CPU, so auto is float32 here."""
    import torch

    return (torch.bfloat16 if getattr(args, "model_dtype", "auto")
            == "bfloat16" else torch.float32)


def model_kwargs_from_args(args, env_cfg) -> dict:
    """The ActorCritic's constructor arguments (the JAX package's module
    fields), dtype aside (`model_dtype_from_args`)."""
    from quadswarm_tpu_torch.env.obs import NEIGHBOR_OBS_SIZES, OBS_REPR_SIZES

    return dict(
        action_dim=4,
        self_obs_dim=OBS_REPR_SIZES[args.quads_obs_repr],
        neighbor_obs_dim=NEIGHBOR_OBS_SIZES[args.quads_neighbor_obs_type],
        num_neighbors=env_cfg.num_use_neighbor_obs,
        encoder_type=args.quads_encoder_type,
        neighbor_encoder_type=args.quads_neighbor_encoder_type,
        neighbor_hidden=args.quads_neighbor_hidden_size,
        use_obstacles=args.quads_obstacle_obs_type == "octomap",
        obstacle_hidden=args.quads_obst_hidden_size,
        rnn_size=args.rnn_size,
        act=args.nonlinearity,
        sim2real=args.quads_sim2real,
        initial_stddev=args.initial_stddev,
    )


def model_from_args(args, env_cfg, device="cuda"):
    """The model with fresh weights from torch's global generator.  Its
    `obstacle_obs_dim` is the width of the observation after the neighbour
    slice: the SDF's whenever the env has obstacles, which the 'attention'
    encoder type embeds whatever --quads_obstacle_obs_type says."""
    from quadswarm_tpu_torch.env.obs import OBSTACLE_OBS_SIZES
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic

    return ActorCritic(
        **model_kwargs_from_args(args, env_cfg),
        dtype=model_dtype_from_args(args),
        obstacle_obs_dim=(OBSTACLE_OBS_SIZES["octomap"]
                          if env_cfg.use_obstacles else 0),
        device=device)


def ppo_config_from_args(args):
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig

    return PPOConfig(
        learning_rate=args.learning_rate,
        gamma=args.gamma,
        gae_lambda=args.gae_lambda,
        ppo_clip_ratio=args.ppo_clip_ratio,
        ppo_clip_value=args.ppo_clip_value,
        value_loss_coeff=args.value_loss_coeff,
        exploration_loss_coeff=args.exploration_loss_coeff,
        max_entropy_coeff=args.max_entropy_coeff,
        max_grad_norm=args.max_grad_norm,
        rollout=args.rollout,
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        reward_clip=args.reward_clip,
        sgd_unroll=args.sgd_unroll,
        num_envs=args.num_envs,
        replay_sample_prob=args.replay_buffer_sample_prob,
        normalize_input=args.normalize_input,
        normalize_returns=args.normalize_returns,
        with_vtrace=args.with_vtrace,
        vtrace_rho=args.vtrace_rho,
        vtrace_c=args.vtrace_c,
    )


def pbt_config_from_args(args):
    from quadswarm_tpu_torch.parallel.pbt import PBTConfig

    return PBTConfig(
        num_policies=args.num_policies,
        period_env_steps=args.pbt_period_env_steps,
        start_mutation=args.pbt_start_mutation,
        replace_fraction=args.pbt_replace_fraction,
        mutation_rate=args.pbt_mutation_rate,
        replace_reward_gap=args.pbt_replace_reward_gap,
        replace_reward_gap_absolute=args.pbt_replace_reward_gap_absolute,
        perturb_range=(1.0 / args.pbt_perturb_max, args.pbt_perturb_max),
        optimize_gamma=args.pbt_optimize_gamma,
    )


def anneal_schedules_from_args(args) -> dict:
    """Linear ramps of the collision coefficients over
    --anneal_collision_steps env steps."""
    if args.anneal_collision_steps <= 0:
        return {}
    return {
        "quadcol_bin": (args.quads_collision_reward,
                        args.anneal_collision_steps),
        "quadcol_bin_smooth_max": (args.quads_collision_smooth_max_penalty,
                                   args.anneal_collision_steps),
        "quadcol_bin_obst": (args.quads_obst_collision_reward,
                             args.anneal_collision_steps),
    }


def save_cfg(args, exp_dir: str) -> None:
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)


def load_cfg(exp_dir: str) -> argparse.Namespace:
    with open(os.path.join(exp_dir, "config.json")) as f:
        return argparse.Namespace(**json.load(f))
