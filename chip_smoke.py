#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quadswarm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each raising on failure:
  1. build: every CUDA source of the port from csrc/ with nvcc (sm_90a),
     one nvcc per source, all started together;
  2. kernels: each kernel against its plain PyTorch version on the card.
     K1 (dynamics) on branch-covering batches at the main paths' widths
     and a ragged one; K2, K3, K4 (the pair kernels) on dense clouds with
     a jittered previous tick at the swarm's shape (256 envs x 128), at
     the cap (4 x 2048), at ragged sizes (3 x 150, 3 x 200, 3 x 300) and
     at the flagship's (1024 x 8).  Masks, partners and packed words must be
     equal, and the same on a second call; floats agree within the stated
     tolerance.  An empty kernel at each kernel's grid gives the card's
     launch floor beside the bounds;
  3. agree: the env step on the card against the CPU at a small size, on
     the dense and on the pairs route; the pairs route against the dense
     route on the card in lockstep at 128 drones;
  4. rollout: `collect_rollout` at the flagship run's width (1024 envs x 8
     drones, the 256-wide CoRL attention actor-critic, rollout 128), with
     every kernel's launch count reset just before and read just after;
  5. swarm: the large-swarm path (`use_pallas_pairs`) at 256 envs x 128
     drones: `collect_rollout` for 128 ticks with the same policy, counts
     reset before and read after (K1, K2, K3 once per tick); then the
     simulator alone with random actions on the pairs route and on the
     dense route, in turns, each with its rate, ms per tick and peak memory;
  6. sim: `batched_env_step` with random actions at 4096 envs x 8 (mix) for
     ep_len + 2 ticks, through one auto-reset of every env; then K1 alone
     on the drone state the simulator reached;
  7. surface: the rest of the env.  K1's per-drone form (an 8-row table
     from a RelativeSampler fleet and from a RandomQuad fleet) against its
     plain version at B=8,192, in turns with the shared form; each control
     mode for one tick of a 1024 x 8 fleet on the card against the CPU;
     Mellinger flying 1024 x 8 drones to their goal for 400 ticks; the gym
     API (`env/gym_api.py`) for one whole episode with auto-reset at
     train.sh's config and with a per-drone fleet, one K1 launch a step,
     the done step's stats keys equal to the CPU env's; the nine scenario
     modes beyond the two mixes at 1024 x 8 with obstacles for 700 ticks
     (events and obstacle hits by mode, one sync a tick); the env step on
     the card against the CPU for 20 ticks spanning each new mode's first
     event, and for a per-drone fleet;
  8. train: the main path, train.sh's training: a `Trainer` built from
     train.sh's flags (1024 envs x 8, rollout 128, batch 1024, replay 0.75,
     annealing, downwash, the 256-wide attention model, TF32 off) for 3
     iterations, each with its rollout/learner split, losses, launches,
     device-to-host syncs (one a tick, for the episode ends) and peak
     memory; then `batched_replay_step` on the card against the CPU on the
     dense route (16 x 8) and the pairs route (16 x 128), every branch
     fired; the
     learner on the card against the CPU; the train CLI with train.sh's
     flags for 1 iteration and a resume for a second;
  9. obst: train_local_obst.sh's training, a `Trainer` built from its flags
     (1024 envs x 8 on the 8 x 8 obstacle grid, the SDF observation and the
     obstacle encoder, rollout 128, batch 1024, replay 0.75) for 2
     iterations with the same lines plus the obstacle hits; a reset tick of
     every env with obstacles, timed; `batched_replay_step` with obstacles
     on the card against the CPU (16 x 8); K1 on the state it reached;
 10. eval: the eval CLI's `evaluate` with train.sh's flags plus
     `--eval_envs=32 --quads_mode=static_diff_goal --max_num_episodes=32
     --load_checkpoint_kind=best`, from a `best` checkpoint the train CLI
     wrote at a small width, each round with its wall time, ticks/s,
     launches, syncs and the success and deadlock rates; then one round
     with train_local_obst.sh's flags from the obst phase's checkpoint (or
     fresh weights); K1 on each round's final state;
 11. runs: the run files.  Each port file's code is the JAX file's with
     the training module swapped (the JAX file parsed as text, never
     imported), and the launcher's dry backend expands every one; the final
     obstacle run (the first command of runs/obstacles/quads_multi_obstacles:
     the 'attention' encoder type, 2 visible neighbours, the 8 x 8 grid,
     1024 envs x 8 x 128, batch 1024, replay 0.75) for 2 iterations at full
     width with the train phase's lines; the new encoders (attention, its
     sim2real variant, corl with mean_embed and with mlp, with obstacles)
     on the card against the CPU; one iteration of each other run file at
     its own width with --rollout=16 (the depth cut is printed); the
     refusal of quad_multi_mix_baseline_attn_8; K1 on the final run's state;
 12. appo: train.sh's flags plus --async_rl=True --policy_lag=1
     --with_vtrace=True, full width, 3 iterations with the learner's
     recompute time, in turns with 2 of train.sh's sync-PPO iterations;
     the third iteration rolls out with the weights after the first; the
     learner's targets (V-trace and GAE) on the card against the CPU; K1
     on the state it reached;
 13. pbt: runs/pbt_quads_multi_obstacles' command at full width (8 policies
     x 512 envs x 8 x 128): one iteration of each, a round with injected
     objectives (policy p scores p) after which each adoptee's parameters
     and Adam state equal its source's bit for bit and differ after one
     more iteration of each, peak memory with 8 policies resident; K1 on a
     policy's state; then the CLI's PBT branch with 2 policies at a small
     width, which writes checkpoint_p0 and checkpoint_p1;
 14. bf16: bfloat16 compute.  train.sh's actor-critic at B = 8,192 with
     --model_dtype=bfloat16 on the card against the same in bfloat16 on
     the CPU and against float32 on the card, the forwards timed in turns;
     train.sh's Trainer with --model_dtype=bfloat16 for 2 iterations in
     turns with 2 float32 ones (the train phase's lines); --dtype=bfloat16
     with train.sh's flags at 1024 x 8: ms a tick in turns with float32,
     the event table float32, K1 on the bfloat16 state against its plain
     version, the env step on the card against the CPU for 20 ticks;
 15. mixed: mixed-policy PBT, runs/pbt_quads_multi_obstacles' flags plus
     --pbt_mix_policies_in_one_env=True at full width (8 stacked policies
     sharing 512 envs x 8 x 128): 2 iterations (split, agent-steps/s, K1
     128 an iteration, syncs, peak memory), a round with injected
     objectives copying weights and Adam moments bit for bit, the routed
     heads on the card against the CPU, K1 on the state reached; the CLI's
     mixed branch at a small width, 8 checkpoints and pbt_state.json, and
     a resume;
 16. tools: the last modules at full model width.  (a) sim2real: one
     iteration (--rollout=16) of runs/single_quad_baseline and of the
     final obstacle run with --quads_sim2real=True through the train CLI,
     each exported by the sim2real CLI, built with g++ -O2 and loaded with
     ctypes: networkEvaluate on 1,000 observations against the port's
     mean action on the card (atol 1e-4, TF32 off), the C's size and the
     g++ seconds; (b) `checked_env_step` at train.sh's env, 1024 x 8: 10
     healthy ticks with one sync and one K1 launch each, then a NaN in one
     drone's position raises; (c) the weight recycler on train.sh's actor's
     self encoder at B = 8,192 with 16 units silenced: the mask equal to
     the CPU's, the recycled layer exact; (d) `episode_attention` with
     train.sh's model over a whole episode (1,500 ticks, K1 once a tick,
     rows summing to 1, a zero diagonal); (e) the eval CLI's single-env
     loop with train.sh's flags, --render_mode=plot
     --visualize_v_value=True, one 5 s episode (cut from 15; K1 once a
     tick), the episode's and the rendering's seconds apart; without
     matplotlib the CLI's refusal, then --render_mode=dump and the value
     maps' batched critic forward on the recording; (f)
     analysis/profile_train at 1024 x 8 x 128, batch 1024, --iters 1: its
     three JSON lines beside the train phase's iterations;
 17. dist: training on more than one rank, each world in processes of its
     own started with torchrun's variables and train.sh's flags plus
     --multi_host=True, as the train CLI starts: (a) a 1-rank NCCL world at
     full width (1024 x 8 x 128) for 2 iterations in turns with the
     one-card Trainer (K1 128 an iteration, one sync a tick, the first
     rollout equal bit for bit, the learner within the learner check's bounds
     of the one-card learner on it: the first minibatch's gradients, the
     parameters after 4 steps); (b) 2 ranks sharing the card over gloo at
     2 x 512 envs for 2 iterations, the weights equal bit for bit across
     the ranks after each, K1 128 an iteration on each rank, then the
     2-rank learner against one process on a fixed trajectory; (c) APPO
     with --appo_split_devices=1,1 at --rollout=16 on 2 ranks (env state
     only on rank 0, the optimizer only on rank 1, the trajectory received
     equal to the one sent, the learner against the one-process learner on
     it); (d) analysis/scaling.py --mode fixed --devices 1,2 at rollout 16.

    python3 chip_smoke.py --phases build,profile --trace out/trace.json
    python3 chip_smoke.py --phases build,profile --profile_path swarm
    python3 chip_smoke.py --phases build,profile --profile_path train
    python3 chip_smoke.py --phases build,profile --profile_path final
    python3 chip_smoke.py --phases build,profile --profile_path bf16
    python3 chip_smoke.py --phases build,profile --profile_path mixed

adds a torch.profiler breakdown of the flagship rollout, of the swarm
rollout, or of train.sh's Trainer (in float32 or bfloat16), the final
obstacle run's or the PBT run's mixed runner (rollout ticks, then
minibatch steps): device time by kernel, the device's busy share; with
--trace it writes the Chrome trace.

    python3 chip_smoke.py --phases build,dist

runs the multi-rank paths alone (about 3 minutes).

    python3 chip_smoke.py --phases build,sweep

times K1's wrapper on the host by part at 32,768 drones, K2's at 256 envs
x 128, and K3 on the device at k = 1, 6 and 16 at 256 envs x 128.

Every line with a number carries the card's name and power limit.  The
second-to-last line is the kernels' JSON record (all four kernels and
K1's per-drone form), the last line
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
port's package beside this script, it exits non-zero and prints no result.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# rate outside the tensor cores; both assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# K1 against its plain version: the per-tick tolerance of the JAX
# package's own kernel test (tests/test_pallas_dynamics.py).  omega_dot is a
# diagnostic the env never reads: it divides torque sums that cancel to
# ~1e-4 N m by the ~1.4e-5 kg m^2 inertia, so a last-bit difference in the
# torque terms (FMA contraction) moves it by up to ~1e-4 rad/s^2.
DYN_TOL = dict(rtol=2e-4, atol=2e-5)
DYN_TOL_FIELD = {"omega_dot": dict(rtol=2e-4, atol=1e-3)}
# On a state the rollout reached (drones sliding to rest on the floor, where
# the friction direction atan2(-vy, -vx) of a near-zero velocity amplifies
# last-bit differences), the JAX package's tolerance for its kernel along a
# real trajectory (tests/test_pallas_dynamics.py, trajectory test).
TRAJ_TOL = dict(rtol=1e-3, atol=1e-4)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Device time of fn() per call with the host out of the way: iters
    calls captured in a CUDA graph, replayed reps times, timed by events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def launch_floor_ms(card: str, label: str, blocks: int, threads: int) -> float:
    """Device time of an empty kernel of this grid in a CUDA graph: the
    least a launch of that grid takes on this card, whatever it computes."""
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
    ms = graph_time_ms(lambda: dk.launch_floor(blocks, threads))
    print(f"[{card}] launch floor, {label}, grid {blocks} x {threads}: "
          f"{ms * 1e3:.2f} us (empty kernel, CUDA-graph replay)")
    return ms


def random_drone_batch(b: int, cfg, gen, device):
    """Branch-covering flat drone batch: free flight, floor crashes (some
    inverted, for the random-yaw branch), drones settled on the floor, and
    step counts at the re-orthonormalization trigger."""
    import torch
    from quadswarm_tpu_torch.env.dynamics import init_state

    f32 = dict(dtype=torch.float32, device=device)
    a = torch.eye(3, **f32) + 0.3 * torch.randn((b, 3, 3), generator=gen, **f32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    q[: b // 16] = -q[: b // 16]  # improper flips keep R22 < 0 on a few
    q[: b // 16, :, 0] = -q[: b // 16, :, 0]
    pos = torch.rand((b, 3), generator=gen, **f32) * 8 - 4
    pos[:, 2] = pos[:, 2].abs()
    pos[: b // 4, 2] = cfg.floor_threshold * 0.5
    pos[b // 4: b // 2, 2] = cfg.floor_threshold * 0.9
    on_floor = torch.zeros(b, dtype=torch.bool, device=device)
    on_floor[b // 4: b // 2] = True
    vel = torch.rand((b, 3), generator=gen, **f32) * 4 - 2
    vel[b // 4: b // 4 + b // 16] = 0.0  # settled and still: static friction
    step = torch.randint(cfg.orthonormalize_every - 3,
                         cfg.orthonormalize_every + 1, (b,), generator=gen,
                         device=device, dtype=torch.int32)
    state = init_state((b,), torch.float32, device).replace(
        pos=pos, vel=vel, rot=q.contiguous(),
        omega=torch.rand((b, 3), generator=gen, **f32) * 10 - 5,
        thrust_cmds_damp=torch.rand((b, 4), generator=gen, **f32),
        thrust_rot_damp=torch.rand((b, 4), generator=gen, **f32),
        on_floor=on_floor, step_count=step,
        ou_state=0.02 * torch.randn((b, 4), generator=gen, **f32))
    cmds = torch.rand((b, 4), generator=gen, **f32)
    ou = 0.02 * torch.randn((b, 4), generator=gen, **f32)
    yaw = torch.rand((b,), generator=gen, **f32) * (2 * math.pi) - math.pi
    return state, cmds, ou, yaw


# Bytes one drone moves through K1 per tick (csrc/dynamics_kernel.cu):
# reads 26 f32 state + bool + int32 + 4 cmds + 4 OU + 1 yaw = 145 B,
# writes 38 f32 + 4 bool + int32 = 160 B.
K1_BYTES_PER_DRONE = 305
# On a bfloat16 state (--dtype=bfloat16) the same fields are 2 bytes each:
# reads 26 + 4 + 4 + 1 bfloat16 + bool + int32 = 75 B, writes 38 bfloat16 +
# 4 bool + int32 = 84 B (the wrapper's float32 staging is its own cost).
K1_BYTES_PER_DRONE_BF16 = 159
# Float operations per drone per sub-step without the data-dependent
# branches (motor filter 40, torques 36, Rodrigues 150 counting sincos as
# 20, omega 30, position 9, force and acceleration 20, velocity and
# accelerometer 30), plus 230 for each re-orthonormalization and 70 for
# each drone below the floor threshold.
K1_FLOPS_PER_SUBSTEP = 315
K1_FLOPS_ORTHO = 230
K1_FLOPS_FLOOR = 70


def k1_bound_ms(state, sim_steps: int, ortho_every: int,
                table_bytes: int = 0) -> tuple:
    """Least time for one K1 launch on these inputs: the larger of bytes
    over HBM bandwidth and operations over the float32 peak.  The
    per-drone form also reads its parameter table once (`table_bytes`)."""
    import torch
    b = state.pos.shape[0]
    n_ortho = int(torch.sum(state.step_count + 1 >= ortho_every))
    n_floor = int(torch.sum(state.pos[:, 2] <= 0.1))
    flops = (sim_steps * b * K1_FLOPS_PER_SUBSTEP + n_ortho * K1_FLOPS_ORTHO
             + sim_steps * n_floor * K1_FLOPS_FLOOR)
    per_drone = (K1_BYTES_PER_DRONE_BF16
                 if state.pos.dtype == torch.bfloat16 else K1_BYTES_PER_DRONE)
    t_bytes = (b * per_drone + table_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_dynamics_kernel(card: str, label: str, params, cfg, state, cmds,
                          ou, yaw, tol_all=None) -> dict:
    """K1 against its plain version on one flat batch; then both timed.
    `ms` and `plain_ms` are per call, back to back, as the env step pays
    them; `device_ms` is K1's device time alone (CUDA graph replay)."""
    import torch
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
    from quadswarm_tpu_torch.utils.struct import leaves

    b = state.pos.shape[0]
    dynamics_tick = dk.dynamics_tick_flat     # per-drone rows b % N
    before = (dk.dynamics_tick_fused.launches,
              dk.dynamics_tick_fused.per_drone_launches)
    got = dk.dynamics_tick_fused(params, cfg, state, cmds, ou, yaw)
    torch.cuda.synchronize()
    want = dynamics_tick(params, cfg, state, cmds, ou, yaw)
    max_err = 0.0
    bf16 = state.pos.dtype == torch.bfloat16
    for (name, g), (_, w) in zip(leaves(got), leaves(want)):
        if g.dtype in (torch.bool, torch.int32):
            n_bad = int(torch.sum(g != w))
            if n_bad:
                raise AssertionError(f"K1 {name}: {n_bad} of {g.numel()} "
                                     "entries differ from the plain version")
            continue
        tol = tol_all or DYN_TOL_FIELD.get(name, DYN_TOL)
        if bf16:
            # both round float32 results to bfloat16: one ulp apart
            if g.dtype != torch.bfloat16:
                raise AssertionError(f"K1 {name}: {g.dtype} on a bfloat16 "
                                     "state")
            g, w = g.float(), w.float()
            tol = dict(rtol=max(tol["rtol"], BF16_K1_RTOL), atol=tol["atol"])
        if not torch.allclose(g, w, **tol):
            bad = (g - w).abs() - tol["atol"] - tol["rtol"] * w.abs()
            i = int(bad.reshape(b, -1).max(-1).values.argmax())
            raise AssertionError(
                f"K1 {name}: max excess {float(bad.max())} over "
                f"rtol {tol['rtol']} atol {tol['atol']} at drone {i}: "
                f"kernel {g[i].tolist()} plain {w[i].tolist()} pos "
                f"{state.pos[i].tolist()} vel {state.vel[i].tolist()} "
                f"on_floor {bool(state.on_floor[i])}")
        max_err = max(max_err, float((g - w).abs().max()))
    ms = cuda_time_ms(
        lambda: dk.dynamics_tick_fused(params, cfg, state, cmds, ou, yaw), 200)
    device_ms = graph_time_ms(
        lambda: dk.dynamics_tick_fused(params, cfg, state, cmds, ou, yaw))
    plain_ms = cuda_time_ms(
        lambda: dynamics_tick(params, cfg, state, cmds, ou, yaw), 20)
    # comparisons do not count
    (dk.dynamics_tick_fused.launches,
     dk.dynamics_tick_fused.per_drone_launches) = before
    table_bytes = (dk.param_table(params, cfg).nbytes if params.per_drone
                   else 0)
    bound_ms, bound_by = k1_bound_ms(state, cfg.sim_steps,
                                     cfg.orthonormalize_every, table_bytes)
    threads = dk.block_threads()
    floor_ms = launch_floor_ms(card, f"K1 at B={b}", -(-b // threads), threads)
    tol = dict(tol_all or DYN_TOL)
    if bf16:
        tol["rtol"] = max(tol["rtol"], BF16_K1_RTOL)
    print(f"[{card}] K1 dynamics, {label}, B={b}"
          + (", bfloat16 state" if bf16 else "")
          + f": max_abs_err={max_err:.3g} "
          f"(rtol {tol['rtol']:.3g}, atol {tol['atol']}"
          + ("" if tol_all else f"; omega_dot atol "
             f"{DYN_TOL_FIELD['omega_dot']['atol']}")
          + f") per call {ms * 1e3:.2f} us, device {device_ms * 1e3:.2f} us, "
          f"plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by})")
    return dict(b=b, max_abs_err=max_err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                launch_floor_ms=floor_ms)


def check_on_env_state(card: str, label: str, states, cfg, params) -> dict:
    """K1 on a state the main path reached (its (E, N) drones flattened),
    at hover thrust with fresh draws for this tick."""
    import torch
    from quadswarm_tpu_torch.utils.struct import map_fields

    dyn = map_fields(lambda x: x.reshape((-1,) + x.shape[2:]), states.dyn)
    b = dyn.pos.shape[0]
    gen = torch.Generator("cuda").manual_seed(2)
    dt = dyn.pos.dtype          # a bfloat16 env's inputs are bfloat16
    cmds = torch.full((b, 4), 0.5, device="cuda", dtype=dt)
    ou = (0.01 * torch.randn((b, 4), generator=gen, device="cuda")).to(dt)
    yaw = (torch.rand((b,), generator=gen, device="cuda") * 2 * math.pi
           - math.pi).to(dt)
    return check_dynamics_kernel(card, label, params,
                                 cfg.dynamics_config(params.arm), dyn, cmds,
                                 ou, yaw, tol_all=TRAJ_TOL)


SOURCES = ("dynamics_kernel.cu", "swarm_interactions.cu")


def phase_build(card: str) -> None:
    """One nvcc per source, all started together; prints ptxas's registers
    and spills per kernel."""
    from concurrent.futures import ThreadPoolExecutor
    from quadswarm_tpu_torch.ops.kernels import build

    def one(source):
        t0 = time.perf_counter()
        log = []
        path = build.build(source, log=log)
        return source, path, log, time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        for source, path, log, secs in pool.map(one, SOURCES):
            for line in log:
                print(f"[{card}] {source}: {line.strip()}")
            print(f"[{card}] built {path.name} in {secs:.1f} s")
    print(f"[{card}] build of {len(SOURCES)} sources took "
          f"{time.perf_counter() - t0:.1f} s")


def phase_kernels(card: str) -> tuple:
    """K1 on branch-covering batches at the rollouts' and the simulator's
    widths and at a ragged one; K2, K3, K4 at PAIR_SHAPES.  Returns (K1's
    checks, the pair kernels' checks by shape)."""
    import torch
    from quadswarm_tpu_torch.env.dynamics import DynamicsConfig
    from quadswarm_tpu_torch.env.params import make_dynamics_params

    params = make_dynamics_params()
    cfg = DynamicsConfig(floor_threshold=float(params.arm))
    out = []
    for seed, b in enumerate((1024 * 8, 4096 * 8, 1000 + 37)):
        gen = torch.Generator("cuda").manual_seed(seed)
        batch = random_drone_batch(b, cfg, gen, torch.device("cuda"))
        out.append(check_dynamics_kernel(card, "branch-covering batch",
                                         params, cfg, *batch))
    pair_checks = []
    for seed, (e, n, label) in enumerate(PAIR_SHAPES):
        gen = torch.Generator("cuda").manual_seed(100 + seed)
        pos, pos0, vel = pair_cloud(e, n, gen)
        prev = pair_history(pos0)
        pair_checks.append(check_pair_kernels(
            card, label, pos, prev, vel, *PAIR_SCALARS,
            k=min(SWARM_NEIGHBORS, n - 1), need_all_cases=True))
    return out, pair_checks


def phase_sweep(card: str) -> None:
    """The host time of K1's wrapper by part on a branch-covering batch of
    32,768 drones, K3's device time by k at the swarm's shape, and the host
    time of K2's wrapper by part there."""
    import torch
    from quadswarm_tpu_torch.env.dynamics import DynamicsConfig
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk

    params = make_dynamics_params()
    cfg = DynamicsConfig(floor_threshold=float(params.arm))
    batch = random_drone_batch(4096 * 8, cfg,
                               torch.Generator("cuda").manual_seed(1),
                               torch.device("cuda"))

    # Where K1's per-call time goes on the host: host clock around 2,000
    # calls of the whole wrapper and of its parts, the device kept busy by
    # nothing else (the kernel is shorter than the wrapper).
    def host_us(fn, n=2000):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per_call = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return per_call
    count = dk.dynamics_tick_fused.launches
    b, device = batch[0].pos.shape[0], batch[0].pos.device
    inputs = dk.kernel_inputs(*batch)
    threads = dk.block_threads()
    parts = {
        "whole wrapper": lambda: dk.dynamics_tick_fused(params, cfg, *batch),
        "input checks": lambda: dk.check_inputs(inputs, b, device),
        "3 arenas and 15 views": lambda: dk.output_arenas(b, device),
        "empty-kernel launch through ctypes": lambda: dk.launch_floor(
            -(-b // threads), threads),
    }
    print(f"[{card}] K1 wrapper on the host, B={b}, us per call: "
          + ", ".join(f"{name} {host_us(fn):.1f}"
                      for name, fn in parts.items()))
    dk.dynamics_tick_fused.launches = count

    # K3 by k at the swarm's shape: k = 1 is the metric pass, the staging
    # and one pick; each further pick is one sweep over the stored keys.
    from quadswarm_tpu_torch.ops.kernels import swarm_interactions as si
    count = si.neighbor_topk_obs.launches
    pos, _, vel = pair_cloud(SWARM_ENVS, 128,
                             torch.Generator("cuda").manual_seed(100))
    by_k = {}
    for k in (1, 6, 16, 16, 6, 1):
        _same("K3", f"obs at k={k}", si.neighbor_topk_obs(pos, vel, k),
              si.neighbor_topk_obs_plain(pos, vel, k))
        by_k.setdefault(k, []).append(graph_time_ms(
            lambda: si.neighbor_topk_obs(pos, vel, k)))
    si.neighbor_topk_obs.launches = count
    print(f"[{card}] K3 by k, E={SWARM_ENVS} N=128, device us per launch (two "
          "turns each): " + ", ".join(
              f"k={k} {a * 1e3:.2f} / {b * 1e3:.2f}"
              for k, (a, b) in by_k.items()))

    # K2's wrapper on the host by part at the swarm's shape.
    from quadswarm_tpu_torch.ops.kernels import build
    count = si.pair_collisions.launches
    e, n = SWARM_ENVS, 128
    pos, pos0, _ = pair_cloud(e, n, torch.Generator("cuda").manual_seed(100))
    prev = pair_history(pos0)
    shape = si.pair_launch_shape(e, n)
    out = si.pair_outputs(e, n, device)
    hitbox, falloff, max_pen = PAIR_SCALARS
    args = (pos.data_ptr(), prev.data_ptr(), e, n, shape.rows, shape.slices,
            si.square_within(hitbox), si.square_within(falloff),
            si._slope(falloff, max_pen), si._f32(max_pen),
            *(t.data_ptr() for t in out))
    parts = {
        "whole wrapper": lambda: si.pair_collisions(pos, prev, *PAIR_SCALARS),
        "input checks": lambda: (
            si._fleet_shape("pos", pos),
            build.check_tensor("pos", pos, (e, n, 3), torch.float32, device),
            build.check_tensor("prev_packed", prev, (e, n, si.PACK_LANES),
                               torch.int32, device)),
        "5 allocations": lambda: si.pair_outputs(e, n, device),
        "launch shape and thresholds (cached)": lambda: (
            si.pair_launch_shape(e, n), si.square_within(hitbox),
            si.square_within(falloff)),
        "launch through ctypes": lambda: si._launch(
            "pair_collisions", "qs_pair_collisions", device, *args),
    }
    print(f"[{card}] K2 wrapper on the host, E={e} N={n}, us per call: "
          + ", ".join(f"{name} {host_us(fn):.1f}"
                      for name, fn in parts.items()))
    si.pair_collisions.launches = count


# --------------------------------------------------------------------------
# K2, K3, K4: the pair kernels against their plain versions
# --------------------------------------------------------------------------

# (envs, drones, label): the swarm path's shape, the cap of the packed
# history, three ragged sizes (150 and 200: K3 with 8 keys a lane in
# registers; 300: K3's shared-memory route under 48 KB; the cap takes it
# above 48 KB), and the flagship's.
PAIR_SHAPES = ((256, 128, "swarm shape"), (4, 2048, "cap"),
               (3, 150, "ragged"), (3, 200, "ragged"), (3, 300, "ragged"),
               (1024, 8, "flagship shape"))
PAIR_SCALARS = (0.35, 1.0, 10.0)      # hitbox, falloff, max_penalty
SWARM_NEIGHBORS = 6
# Penalty sums (K2, K4): each 16-column word's terms are added in column
# order, then the row's word sums in word order, however the row is split
# among threads, the same bits on every run; the plain version adds in
# torch.sum's order.  The terms themselves are the plain version's bits.
# Everything else the pair kernels put out must equal the plain version's:
# both take sqrt((dx*dx + dy*dy) + dz*dz) with nothing contracted (the
# kernels test the thresholds on the squared distance against the largest
# square whose root is within them, which decides alike).
PEN_TOL = dict(rtol=1e-4, atol=1e-5)
# Float operations per pair of drones: 3 subtractions, 5 for the squared
# norm, the root, 2 threshold compares and 2 for the penalty are 13, called
# 15 with the history test and the partner minimum (K2) or the running
# minimum (K4); K3 adds 3 subtractions, 5 for the dot product, the clamp, a
# division and an addition, and the compares of the selection: 25.
PAIR_FLOPS = {"K2": 15, "K3": 25, "K4": 15}


def pair_cloud(e: int, n: int, gen):
    """Positions of a cloud about two hitbox-neighbours dense per drone
    whatever n, the previous tick's jittered positions, and velocities."""
    import torch
    f32 = dict(dtype=torch.float32, device="cuda")
    half = 1.2 * (n / 150) ** (1 / 3)
    pos = (torch.rand((e, n, 3), generator=gen, **f32) * 2 - 1) * half
    pos0 = pos + 0.05 * torch.randn((e, n, 3), generator=gen, **f32)
    vel = torch.rand((e, n, 3), generator=gen, **f32) * 4 - 2
    return pos, pos0, vel


def pair_history(pos0):
    """The packed pair bits of a previous tick at positions pos0 (through
    the plain version, so that K2's input does not come from K2)."""
    import torch
    from quadswarm_tpu_torch.ops.kernels import swarm_interactions as si
    e, n = pos0.shape[:2]
    zeros = torch.zeros((e, n, si.PACK_LANES), dtype=torch.int32,
                        device=pos0.device)
    return si.pair_collisions_plain(pos0, zeros, *PAIR_SCALARS)[4]


def pair_bound_ms(kernel: str, e: int, n: int, k: int) -> tuple:
    """Least time for one launch at this shape.  Bytes per drone: K2 reads
    12 B of position and the 2 * ceil(n / 32) live words of its history
    row and writes the whole 512 B row plus 10 B of results; K3 reads 24 B
    and writes 24 k B; K4 reads 12 B and writes 13 B."""
    per_drone = {"K2": 12 + 8 * math.ceil(n / 32) + 512 + 10,
                 "K3": 24 + 24 * k, "K4": 12 + 13}[kernel]
    t_bytes = e * n * per_drone / HBM_BYTES_PER_S * 1e3
    t_ops = e * n * (n - 1) * PAIR_FLOPS[kernel] / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _same(kernel: str, name: str, got, want) -> None:
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{kernel} {name}: {got.dtype} {tuple(got.shape)}"
                             f" against {want.dtype} {tuple(want.shape)}")
    if not torch.equal(got, want):
        bad = int(torch.sum(got != want))
        raise AssertionError(f"{kernel} {name}: {bad} of {got.numel()} "
                             "entries differ from the plain version")


def _close(kernel: str, name: str, got, want, tol) -> float:
    import torch
    if not torch.allclose(got, want, **tol):
        raise AssertionError(
            f"{kernel} {name}: max error {float((got - want).abs().max())} "
            f"over rtol {tol['rtol']} atol {tol['atol']}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_pair_kernels(card: str, label: str, pos, prev, vel, hitbox,
                       falloff, max_pen, k: int,
                       need_all_cases: bool = False) -> dict:
    """K2, K3 and K4 against their plain versions on one fleet, then each
    timed: per call (back to back), device only (CUDA-graph replay) and
    the plain version.  Returns {"K2": record, "K3": ..., "K4": ...}."""
    import torch
    from quadswarm_tpu_torch.ops.kernels import swarm_interactions as si

    e, n = pos.shape[:2]
    counts = (si.pair_collisions.launches, si.neighbor_topk_obs.launches,
              si.swarm_interactions.launches)
    calls = {
        "K2": (lambda: si.pair_collisions(pos, prev, hitbox, falloff, max_pen),
               lambda: si.pair_collisions_plain(pos, prev, hitbox, falloff,
                                                max_pen)),
        "K3": (lambda: si.neighbor_topk_obs(pos, vel, k),
               lambda: si.neighbor_topk_obs_plain(pos, vel, k)),
        "K4": (lambda: si.swarm_interactions(pos, hitbox, falloff, max_pen),
               lambda: si.swarm_interactions_plain(pos, hitbox, falloff,
                                                   max_pen)),
    }
    errs = {}
    got = calls["K2"][0]()
    torch.cuda.synchronize()
    want = calls["K2"][1]()
    names = ("col_any", "penalty", "resp_any", "resp_partner", "curr_packed")
    for name, g, w in zip(names, got, want):
        if name == "penalty":
            errs["K2"] = _close("K2", name, g, w, PEN_TOL)
        else:
            _same("K2", name, g, w)
    for name, g, a in zip(names, got, calls["K2"][0]()):
        _same("K2", f"{name} on a second call", a, g)
    was = si.unpack_pairs(prev, n)
    now = si.unpack_pairs(got[4], n)
    cases = {"new": int((now & ~was).sum()), "repeated": int((now & was).sum()),
             "ended": int((~now & was).sum()),
             "absent": int((~now & ~was).sum()) - e * n}
    if need_all_cases and min(cases.values()) <= 0:
        raise AssertionError(f"pair cloud {label} lacks a case: {cases}")

    got = calls["K3"][0]()
    torch.cuda.synchronize()
    _same("K3", "obs", got, calls["K3"][1]())
    errs["K3"] = 0.0

    got = calls["K4"][0]()
    torch.cuda.synchronize()
    want = calls["K4"][1]()
    errs["K4"] = 0.0
    names = ("col_any", "partner", "penalty", "min_dist")
    for name, g, w in zip(names, got, want):
        if name == "penalty":
            errs["K4"] = _close("K4", name, g, w, PEN_TOL)
        else:
            _same("K4", name, g, w)
    for name, g, a in zip(names, got, calls["K4"][0]()):
        _same("K4", f"{name} on a second call", a, g)

    print(f"[{card}] pair kernels, {label}, E={e} N={n} k={k}: masks, "
          f"partners, packed words, picks and min_dist equal the plain "
          f"versions', and K2's and K4's outputs are the same bits on a "
          f"second call; pairs {cases}")
    out = {}
    iters = 200 if e * n * n <= 1 << 23 else 50
    for kernel, (fused, plain) in calls.items():
        ms = cuda_time_ms(fused, iters)
        device_ms = graph_time_ms(fused, iters=min(iters, 100))
        plain_ms = cuda_time_ms(plain, 5, warmup=1)
        bound_ms, bound_by = pair_bound_ms(kernel, e, n, k)
        print(f"[{card}] {kernel}, {label}, E={e} N={n}: max_abs_err="
              f"{errs[kernel]:.3g}"
              + (f" (penalty rtol {PEN_TOL['rtol']}, atol {PEN_TOL['atol']};"
                 " the rest exact)" if kernel != "K3" else " (exact)")
              + f" per call {ms * 1e3:.2f} us, device {device_ms * 1e3:.2f} us,"
              f" plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
              f"({bound_by})")
        out[kernel] = dict(e=e, n=n, max_abs_err=errs[kernel], ms=ms,
                           device_ms=device_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
    rows = si.topk_launch_shape(n)[1]
    out["K3"]["launch_floor_ms"] = launch_floor_ms(
        card, f"K3 at E={e} N={n}", e * -(-n // rows), 32 * rows)
    for kid, history in (("K2", True), ("K4", False)):
        shape = si.pair_launch_shape(e, n, history)
        out[kid]["launch_floor_ms"] = launch_floor_ms(
            card, f"{kid} at E={e} N={n} ({shape.rows} rows x "
            f"{shape.slices} slices)", shape.blocks, shape.threads)
    # comparisons and timings do not count as launches of a main path
    (si.pair_collisions.launches, si.neighbor_topk_obs.launches,
     si.swarm_interactions.launches) = counts
    return out


# The flagship run (train.sh): 8 drones, mix, raw control, downwash, the
# CoRL attention encoder over 6 neighbors, 1024 envs x rollout 128, with
# the collision rewards at their annealed end values.
FLAGSHIP_ENV = dict(num_agents=8, quads_mode="mix", ep_time=15.0,
                    neighbor_obs_type="pos_vel", neighbor_visible_num=6,
                    collision_hitbox_radius=2.0, collision_falloff_radius=4.0,
                    use_downwash=True)
FLAGSHIP_REWARD = dict(quadcol_bin=5.0, quadcol_bin_smooth_max=10.0)
# bench.py's simulator configuration: 8 drones, mix, no downwash.
SIM_ENV = dict(num_agents=8, quads_mode="mix", neighbor_obs_type="pos_vel",
               neighbor_visible_num=6)
# The large swarm (bench.py --num_agents 128 --num_envs 256 --pallas_pairs):
# 128 drones, mix, 6 visible neighbours, the pair kernels K2 and K3 on.
SWARM_ENV = dict(num_agents=128, quads_mode="mix",
                 neighbor_obs_type="pos_vel",
                 neighbor_visible_num=SWARM_NEIGHBORS, use_pallas_pairs=True)
SWARM_ENVS = 256
# Whole env step, GPU (through K1) against CPU (plain) on a small input,
# both started from the CPU state each tick with the same draws: the
# dynamics tolerance on the state and obs, and on rewards.
STEP_TOL = dict(rtol=2e-4, atol=2e-5)


def _draws(e: int, n: int, gen, obstacles: bool = False) -> dict:
    """Every random draw of one env tick, as batched_env_step takes them
    (with `obstacles`, the obstacle response's too)."""
    import torch
    u = lambda *s: torch.rand((e, n) + s, generator=gen)
    g = lambda *s: torch.randn((e, n) + s, generator=gen)
    d = {"ou": g(4), "yaw": u() * (2 * math.pi) - math.pi,
         "downwash": {"acc": u(1), "omega": u(1), "axis": u(3),
                      "dir": u(3)},
         "drone_normals": g(3, 3, 3), "drone_uniforms": u(6),
         "wall": u(11), "ceiling": u(10),
         "sensor": {"pos_n": g(3), "vel_n": g(3), "omega_n": g(3),
                    "acc_n": g(3), "acc_dyn_n": g(3)}}
    if obstacles:
        d.update(obst_normals=g(3, 2, 3), obst_uniforms=u(5))
    return d


def _to_cuda(x):
    from quadswarm_tpu_torch.utils.struct import map_fields
    if isinstance(x, dict):
        return {k: _to_cuda(v) for k, v in x.items()}
    return map_fields(lambda t: t.cuda(), x)


def _agree_ticks(card: str, label: str, cfg, params, states, ticks: int,
                 gen, obstacles: bool = False) -> tuple:
    """`ticks` ticks of the env step on the card against the CPU, both
    started from the CPU state each tick with the same draws (random
    actions of the config's action width).  Returns the largest float
    difference and the CPU's last (state, info)."""
    import torch
    from quadswarm_tpu_torch.env.multi import batched_env_step
    from quadswarm_tpu_torch.utils.struct import leaves

    e, n = states.tick.shape[0], cfg.num_agents
    worst, info = 0.0, None
    for _ in range(ticks):
        actions = torch.rand((e, n, cfg.action_dim), generator=gen) * 2 - 1
        draws = _draws(e, n, gen, obstacles)
        cpu = batched_env_step(cfg, params, states, actions, None, draws)
        gpu = batched_env_step(cfg, params, _to_cuda(states), actions.cuda(),
                               None, _to_cuda(draws))
        pairs = (list(zip(leaves(gpu[0]), leaves(cpu[0])))
                 + [(("obs", gpu[1]), ("obs", cpu[1])),
                    (("reward", gpu[2]), ("reward", cpu[2]))])
        for (name, g), (_, c) in pairs:
            g = g.cpu()
            if g.dtype.is_floating_point:
                tol = DYN_TOL_FIELD.get(name.split(".")[-1], STEP_TOL)
                if not torch.allclose(g, c, **tol):
                    raise AssertionError(
                        f"{label}: env step {name}: GPU and CPU differ by "
                        f"{float((g - c).abs().max())}")
                worst = max(worst, float((g - c).abs().max()))
            elif not torch.equal(g, c):
                raise AssertionError(f"{label}: env step {name}: GPU and CPU "
                                     "differ")
        states, info = cpu[0], cpu[4]
    return worst, states, info


def _agree_env_step(card: str, label: str, env_kw: dict, e: int,
                    touch: bool, params=None) -> None:
    """6 ticks of the env step on the card against the CPU, both started
    from the CPU state each tick with the same draws.  With `touch`, drone
    1 of every env starts inside drone 0's hitbox.  `params`: the
    config's shared Crazyflie parameters unless given."""
    import torch
    from quadswarm_tpu_torch.env.multi import EnvConfig, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params

    cfg = EnvConfig(**env_kw)
    n = cfg.num_agents
    if params is None:
        params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator().manual_seed(7)
    states, _ = env_reset(cfg, params, gen, e, device="cpu")
    if touch:
        pos = states.dyn.pos.clone()
        pos[:, 1] = pos[:, 0] + torch.tensor([0.05, 0.0, 0.0])
        states = states.replace(dyn=states.dyn.replace(pos=pos))
    worst, _, info = _agree_ticks(card, label, cfg, params, states, 6, gen)
    collisions = int(info["num_collisions"].sum())
    if touch and collisions < e:
        raise AssertionError(f"{label}: {collisions} collisions in {e} envs")
    print(f"[{card}] env step GPU vs CPU, {label}, {e}x{n}, 6 ticks: "
          f"max_abs_err {worst:.3g} (rtol {STEP_TOL['rtol']}, atol "
          f"{STEP_TOL['atol']}), {collisions} collisions")


# Pairs route against dense route on the card: every state leaf,
# observations and rewards within this; collision counts and the final pair
# bits equal.  The two routes rank neighbours by the same metric computed in
# a different operation order, so two neighbours whose metrics tie to the
# last bits may swap slots: such rows are counted, and at most ROUTE_SWAPS
# of the rows may differ.
ROUTE_TOL = 2e-5
ROUTE_SWAPS = 1e-3


def _agree_routes(card: str, e: int = 16, ticks: int = 20) -> None:
    """The pairs route (K2, K3) against the dense route, both on the card,
    in lockstep at 128 drones under generators of one seed."""
    import torch
    from quadswarm_tpu_torch.env.multi import (
        EnvConfig, batched_env_step, env_reset)
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.ops.kernels import swarm_interactions as si
    from quadswarm_tpu_torch.utils.struct import leaves

    cfgs = [EnvConfig(**SWARM_ENV),
            EnvConfig(**{**SWARM_ENV, "use_pallas_pairs": False})]
    n = cfgs[0].num_agents
    params = make_dynamics_params(dt=cfgs[0].dt)
    gens = [torch.Generator("cuda").manual_seed(3) for _ in cfgs]
    states = [env_reset(c, params, g, e, device="cuda")[0]
              for c, g in zip(cfgs, gens)]
    act_gen = torch.Generator("cuda").manual_seed(4)
    worst, swapped, rows = 0.0, 0, 0
    for tick in range(ticks):
        actions = torch.rand((e, n, 4), generator=act_gen, device="cuda") \
            * 2 - 1
        outs = [batched_env_step(c, params, s, actions, g)
                for c, s, g in zip(cfgs, states, gens)]
        (sp, op, rp, _, ip), (sd, od, rd, _, idd) = outs
        states = [sp, sd]
        if not torch.equal(ip["num_collisions"], idd["num_collisions"]):
            raise AssertionError(f"tick {tick}: collision counts differ")
        checks = [("reward", rp, rd), ("self obs", op[..., :18], od[..., :18])]
        checks += [(name, a, b) for (name, a), (_, b)
                   in zip(leaves(sp), leaves(sd)) if name != "prev_coll_pairs"]
        for name, a, b in checks:
            if a.dtype.is_floating_point:
                err = float((a - b).abs().max())
                if not err <= ROUTE_TOL:
                    raise AssertionError(f"tick {tick} {name}: routes differ "
                                         f"by {err}")
                worst = max(worst, err)
            elif not torch.equal(a, b):
                raise AssertionError(f"tick {tick} {name}: routes differ")
        bad = ((op[..., 18:] - od[..., 18:]).abs() > ROUTE_TOL).any(-1)
        swapped += int(bad.sum())
        rows += bad.numel()
    if not torch.equal(si.unpack_pairs(sp.prev_coll_pairs, n),
                       sd.prev_coll_pairs):
        raise AssertionError("final pair bits differ from the dense mask")
    collisions = int(ip["num_collisions"].sum())
    if collisions == 0:
        raise AssertionError("the lockstep run saw no collision")
    if swapped > ROUTE_SWAPS * rows:
        raise AssertionError(f"{swapped} of {rows} neighbour rows differ")
    print(f"[{card}] pairs route vs dense route on the card, {e}x{n}, {ticks} "
          f"ticks: max_abs_err {worst:.3g} (atol {ROUTE_TOL}), {collisions} "
          f"collisions counted alike, pair bits equal, {swapped} of {rows} "
          f"neighbour rows with swapped slots")


def phase_agree(card: str) -> None:
    """The env step (dense route at 4x8, pairs route at 4x16) and the
    policy on the card agree with the CPU; the pairs route agrees with the
    dense route on the card at 128 drones."""
    import torch
    from quadswarm_tpu_torch.env.multi import EnvConfig, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.models.actor_critic import (
        ActorCritic, apply_fused)

    _agree_env_step(card, "dense route", FLAGSHIP_ENV, 4, touch=False)
    _agree_env_step(card, "pairs route",
                    {**SWARM_ENV, "num_agents": 16, "use_downwash": True}, 4,
                    touch=True)
    _agree_routes(card)
    cfg = EnvConfig(**FLAGSHIP_ENV)
    _, obs = env_reset(cfg, make_dynamics_params(dt=cfg.dt),
                       torch.Generator().manual_seed(7), 4, device="cpu")
    torch.manual_seed(0)
    model = ActorCritic(num_neighbors=6, device="cpu")
    x = obs.reshape(32, -1)
    with torch.no_grad():
        want = apply_fused(model, x)
        got = apply_fused(model.cuda(), x.cuda())
    model_err = max(float((g.detach().cpu() - w.detach()).abs().max())
                    for g, w in zip(got, want))
    if model_err > 2e-5:
        raise AssertionError(f"policy GPU vs CPU max error {model_err}")
    print(f"[{card}] policy GPU vs CPU: max_abs_err {model_err:.3g} "
          f"(atol 2e-5)")


def _finite(name: str, x) -> None:
    import torch
    if not bool(torch.isfinite(x.float()).all()):
        raise AssertionError(f"{name} has non-finite values")


def phase_rollout(card: str) -> tuple:
    """The main path: collect_rollout at the flagship run's width.  Returns
    K1's launch count in that run and the rollout's final drone state."""
    import torch
    from quadswarm_tpu_torch.env.multi import EnvConfig, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.env.reward import RewardCoeffs
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig, collect_rollout

    e, n, t = 1024, 8, 128
    cfg = EnvConfig(**FLAGSHIP_ENV)
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator("cuda").manual_seed(0)
    torch.manual_seed(0)
    model = ActorCritic(num_neighbors=cfg.num_use_neighbor_obs, rnn_size=256,
                        neighbor_hidden=256, device="cuda")
    ppo = PPOConfig(rollout=t)
    rew = RewardCoeffs(**FLAGSHIP_REWARD)
    states, obs = env_reset(cfg, params, gen, e, device="cuda")
    # Warm-up (lazy CUDA/cuBLAS/cuRAND initialisation), not timed or counted.
    states, obs, *_ = collect_rollout(
        cfg, params, model, PPOConfig(rollout=2), states, obs,
        gen, rew)
    torch.cuda.synchronize()

    _reset_counts()
    t0 = time.perf_counter()
    states, obs, _, traj, last_value, infos = collect_rollout(
        cfg, params, model, ppo, states, obs, gen, rew)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = _read_counts()
    launches = counts["K1"]

    if counts != _counts(K1=t):
        raise AssertionError(f"flagship rollout launches {counts} in {t} "
                             "ticks (dense route: K1 only)")
    for name, x in traj._asdict().items():
        _finite(f"rollout {name}", x)
    _finite("last_value", last_value)
    if traj.obs.shape != (t, e, n, cfg.obs_dim) or traj.actions.shape != (
            t, e, n, 4):
        raise AssertionError(f"rollout shapes {tuple(traj.obs.shape)}")
    sps = t * e * n / elapsed
    print(f"[{card}] rollout {e}x{n} x {t} ticks (CoRL attention 256): "
          f"{elapsed:.3f} s, {sps:,.0f} agent-steps/s, K1 launches {launches} "
          f"({launches / t:.0f} per tick)")

    # Where a rollout tick goes: the policy forward alone and the env step
    # alone, host clock around synchronised loops of 20.
    from quadswarm_tpu_torch.env.multi import batched_env_step
    from quadswarm_tpu_torch.models.actor_critic import apply_fused
    flat = obs.reshape(e * n, -1)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            apply_fused(model, flat)
        torch.cuda.synchronize()
        policy_ms = (time.perf_counter() - t0) / 20 * 1e3
        actions = torch.zeros((e, n, 4), device="cuda")
        s = states
        t0 = time.perf_counter()
        for _ in range(20):
            s, *_ = batched_env_step(cfg, params, s, actions, gen)
        torch.cuda.synchronize()
        env_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"[{card}] rollout tick {elapsed / t * 1e3:.2f} ms: policy forward "
          f"{policy_ms:.2f} ms, env step {env_ms:.2f} ms")
    return counts, states, cfg, params


def _profile(card: str, label: str, fn, count: int, unit: str,
             trace: str | None) -> None:
    """torch.profiler over one call of fn, which does `count` units of
    work: wall and device-busy time per unit, device time by kernel, and
    the host time of the synchronising calls.  With `trace`, the Chrome
    trace is written to that path."""
    from pathlib import Path

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = lambda ev: ev.self_device_time_total
    avgs = prof.key_averages()
    # Device-side events only (kernels, copies, fills): an aten operator
    # also reports the device time of the kernels it launched, and counting
    # both would count that time twice.
    kernels = sorted((ev for ev in avgs if ev.device_type == DeviceType.CUDA
                      and dev(ev) > 0), key=dev, reverse=True)
    busy_us = sum(dev(ev) for ev in kernels)
    launches = sum(ev.count for ev in kernels)
    print(f"[{card}] profile, {label}: wall {wall_us / count / 1e3:.2f} "
          f"ms/{unit}, device busy {busy_us / count / 1e3:.2f} ms/{unit} "
          f"({busy_us / wall_us:.1%}), {launches / count:.0f} device "
          f"ops/{unit}")
    ours = ("dynamics_kernel", "pair_collision_kernel",
            "neighbor_topk_kernel", "interaction_kernel")
    for ev in kernels[:12] + [ev for ev in kernels[12:]
                              if any(name in ev.key for name in ours)]:
        print(f"[{card}]   {dev(ev) / count:9.1f} us/{unit}  "
              f"{ev.count / count:6.1f}/{unit}  {ev.key[:90]}")
    for ev in avgs:
        if ev.key in ("cudaStreamSynchronize", "aten::is_nonzero",
                      "aten::_local_scalar_dense", "cudaMemcpyAsync"):
            print(f"[{card}]   host {ev.self_cpu_time_total / count:8.1f} "
                  f"us/{unit}  {ev.count / count:5.1f}/{unit}  {ev.key}")
    # where the host's time goes (the profiler's own cost included)
    host = sorted((ev for ev in avgs if ev.self_cpu_time_total > 0),
                  key=lambda ev: ev.self_cpu_time_total, reverse=True)
    for ev in host[:10]:
        print(f"[{card}]   host self {ev.self_cpu_time_total / count:8.1f} "
              f"us/{unit}  {ev.count / count:6.1f}/{unit}  {ev.key[:70]}")
    if trace:
        Path(trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(trace)


def phase_profile(card: str, trace: str | None, path: str) -> None:
    """torch.profiler over 8 rollout ticks at the flagship width (`path`
    "flagship": 1024 x 8) or on the large-swarm path ("swarm": 256 x 128,
    pair kernels on); or ("train") over train.sh's Trainer, ("bf16") over
    it with --model_dtype=bfloat16 --dtype=bfloat16, ("final") over the
    final obstacle run's: 8 rollout ticks with collision replay, then 64 of
    its minibatch steps; or ("mixed") over the PBT run file's mixed-policy
    runner: 8 rollout ticks, then 32 stacked minibatch steps of its 8
    policies."""
    import torch
    from quadswarm_tpu_torch.env.multi import EnvConfig, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.env.reward import RewardCoeffs
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.parallel import ppo as P

    t = 8
    if path == "mixed":
        _profile_mixed(card, trace, t)
        return
    if path in ("train", "bf16", "final"):
        tr = _flagship_trainer(argv={
            "train": None,
            "final": _run_flags("obstacles.quads_multi_obstacles"),
            "bf16": train_sh_flags() + ["--model_dtype=bfloat16",
                                        "--dtype=bfloat16"]}[path])
        tr.set_ppo_cfg(tr.ppo_cfg.replace(rollout=t))
        tr.iteration()                                   # warm-up
        rollout = lambda: P.collect_rollout(
            tr.env_cfg, tr.dyn_params, tr.model, tr.ppo_cfg, tr.env_states,
            tr.obs, tr.gen, tr.current_rew_coeff(), tr.replay_states,
            tr.norm_state)
        _, _, _, traj, last_value, _ = rollout()
        adv, ret = P.compute_gae(traj, last_value, tr.ppo_cfg.gamma,
                                 tr.ppo_cfg.gae_lambda)
        steps = P.minibatch_layout(tuple(traj.reward.shape),
                                   tr.ppo_cfg.batch_size).num_minibatches
        _profile(card, f"{t} rollout ticks with replay at 1024x8 ({path})",
                 rollout, t, "tick", None)
        _profile(card, f"{steps} minibatch steps of 1024 ({path})",
                 lambda: P.sgd_epochs(tr.model, tr.optimizer, tr.ppo_cfg,
                                      traj, adv, ret, tr.gen),
                 steps, "step", trace)
        return
    e, env_kw = {"flagship": (1024, FLAGSHIP_ENV),
                 "swarm": (SWARM_ENVS, SWARM_ENV)}[path]
    cfg = EnvConfig(**env_kw)
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator("cuda").manual_seed(0)
    torch.manual_seed(0)
    model = ActorCritic(num_neighbors=6, device="cuda")
    rew = RewardCoeffs(**FLAGSHIP_REWARD)
    states, obs = env_reset(cfg, params, gen, e, device="cuda")
    ppo = P.PPOConfig(rollout=t)
    states, obs, *_ = P.collect_rollout(cfg, params, model, ppo, states, obs,
                                        gen, rew)
    _profile(card, f"{t} rollout ticks at {e}x{cfg.num_agents} ({path})",
             lambda: P.collect_rollout(cfg, params, model, ppo, states, obs,
                                       gen, rew), t, "tick", trace)


def _profile_mixed(card: str, trace: str | None, t: int) -> None:
    """The mixed-policy runner at the PBT run file's width (8 policies, 512
    envs x 8, rollout `t`): `t` rollout ticks, then 32 stacked minibatch
    steps on that rollout's trajectory."""
    import shlex
    import torch
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.parallel import pbt_mixed as M
    from quadswarm_tpu_torch.parallel.ppo import (
        compute_gae, shuffled_minibatches)
    from quadswarm_tpu_torch.runs import pbt_quads_multi_obstacles as run
    from quadswarm_tpu_torch.training import config as C

    (_, cmd), = run.RUN_DESCRIPTION.commands("unused")
    args = C.parse_swarm_cfg(shlex.split(cmd)[3:] + [
        "--pbt_mix_policies_in_one_env=True", f"--rollout={t}"])
    env_cfg = C.env_config_from_args(args)
    r = M.MixedPBTRunner(
        env_cfg, C.ppo_config_from_args(args),
        lambda: C.model_from_args(args, env_cfg, device="cuda"),
        make_dynamics_params(dt=env_cfg.dt), C.pbt_config_from_args(args),
        device="cuda")
    r.iteration()                                        # warm-up
    rollout = lambda: M.mixed_rollout(
        r.env_cfg, r.dyn_params, r.heads, r.ppo_cfg, r.env_states, r.obs,
        r.assignment, r.coeff_table(), r.gen, r.replay_states, r.norm_state)
    *_, traj, last_value, _ = rollout()
    adv, ret = compute_gae(traj, last_value, r.ppo_cfg.gamma,
                           r.ppo_cfg.gae_lambda)
    mbs = shuffled_minibatches(
        (traj.obs, traj.actions, traj.log_prob, traj.value, adv, ret,
         traj.assignment), tuple(traj.reward.shape), r.ppo_cfg.batch_size,
        r.gen)
    steps = mbs[0].shape[0]

    def learn():
        for i in range(steps):
            mb = tuple(x[i] for x in mbs)
            M.stacked_sgd_step(r.heads, r.optimizer, r.ppo_cfg, mb[:6],
                               mb[6], r.norm_state)

    _profile(card, f"{t} mixed rollout ticks at 512x8, 8 policies", rollout,
             t, "tick", None)
    _profile(card, f"{steps} stacked minibatch steps of 1024, 8 policies",
             learn, steps, "step", trace)


def _reset_counts() -> None:
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
    from quadswarm_tpu_torch.ops.kernels import swarm_interactions as si
    for fn in (dk.dynamics_tick_fused, si.pair_collisions,
               si.neighbor_topk_obs, si.swarm_interactions):
        fn.launches = 0
    dk.dynamics_tick_fused.per_drone_launches = 0


def _read_counts() -> dict:
    """Every kernel's launches since `_reset_counts`: K1 by its two forms
    (K1 shared parameters, K1pd the per-drone table), K2, K3, K4."""
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
    from quadswarm_tpu_torch.ops.kernels import swarm_interactions as si
    return {"K1": dk.dynamics_tick_fused.launches,
            "K1pd": dk.dynamics_tick_fused.per_drone_launches,
            "K2": si.pair_collisions.launches,
            "K3": si.neighbor_topk_obs.launches,
            "K4": si.swarm_interactions.launches}


def _counts(**launches) -> dict:
    """A launch-count record with the given counts and 0 elsewhere."""
    return {kid: launches.get(kid, 0) for kid in KERNELS}


def _swarm_sim(card: str, label: str, env_kw: dict, ticks: int) -> None:
    """The simulator alone at the swarm's width with random actions: rate,
    ms per tick and peak allocated memory of one route."""
    import torch
    from quadswarm_tpu_torch.env.multi import (
        EnvConfig, batched_env_step, env_reset)
    from quadswarm_tpu_torch.env.params import make_dynamics_params

    cfg = EnvConfig(**env_kw)
    e, n = SWARM_ENVS, cfg.num_agents
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator("cuda").manual_seed(1)
    states, _ = env_reset(cfg, params, gen, e, device="cuda")
    actions = torch.rand((e, n, 4), generator=gen, device="cuda") * 2 - 1
    for _ in range(5):
        states, *_ = batched_env_step(cfg, params, states, actions, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reward_sum = torch.zeros((), device="cuda")
    t0 = time.perf_counter()
    for _ in range(ticks):
        actions = torch.rand((e, n, 4), generator=gen, device="cuda") * 2 - 1
        states, obs, rew, _, info = batched_env_step(cfg, params, states,
                                                     actions, gen)
        reward_sum += rew.sum()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _finite(f"swarm sim {label} obs", obs)
    _finite(f"swarm sim {label} reward sum", reward_sum)
    print(f"[{card}] swarm sim {e}x{n} mix, {label}, {ticks} ticks: "
          f"{elapsed:.2f} s, {ticks * e * n / elapsed:,.0f} agent-steps/s, "
          f"{elapsed / ticks * 1e3:.2f} ms/tick, peak allocated "
          f"{peak / 2**20:,.0f} MiB ({(peak - base) / 2**20:,.0f} MiB above "
          f"the state held between ticks), "
          f"{int(info['num_collisions'].sum())} collisions so far")


def phase_swarm(card: str) -> tuple:
    """The large-swarm path at full width: collect_rollout at 256 envs x
    128 drones with the pair kernels on and the flagship's policy, then
    the simulator alone on the pairs route and on the dense route.  Returns
    the launch counts of the rollout and the pair kernels' check on the
    fleet it reached."""
    import torch
    from quadswarm_tpu_torch.env.multi import EnvConfig, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.env.reward import RewardCoeffs
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig, collect_rollout

    e, t = SWARM_ENVS, 128
    cfg = EnvConfig(**SWARM_ENV)
    n = cfg.num_agents
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator("cuda").manual_seed(0)
    torch.manual_seed(0)
    model = ActorCritic(num_neighbors=cfg.num_use_neighbor_obs, rnn_size=256,
                        neighbor_hidden=256, device="cuda")
    rew = RewardCoeffs(**FLAGSHIP_REWARD)
    states, obs = env_reset(cfg, params, gen, e, device="cuda")
    states, obs, *_ = collect_rollout(cfg, params, model, PPOConfig(rollout=2),
                                      states, obs, gen, rew)     # warm-up
    torch.cuda.synchronize()

    _reset_counts()
    t0 = time.perf_counter()
    states, obs, _, traj, last_value, infos = collect_rollout(
        cfg, params, model, PPOConfig(rollout=t), states, obs, gen, rew)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = _read_counts()

    want = _counts(K1=t, K2=t, K3=t)
    if counts != want:
        raise AssertionError(f"swarm rollout launches {counts}, expected "
                             f"{want} in {t} ticks")
    for name, x in traj._asdict().items():
        _finite(f"swarm rollout {name}", x)
    _finite("swarm last_value", last_value)
    if traj.obs.shape != (t, e, n, cfg.obs_dim) or last_value.shape != (e, n):
        raise AssertionError(f"swarm rollout shapes {tuple(traj.obs.shape)}")
    if states.prev_coll_pairs.shape != (e, n, 128):
        raise AssertionError("the pair history is not packed")
    collisions = int(infos["num_collisions"][-1].sum())
    print(f"[{card}] swarm rollout {e}x{n} x {t} ticks (CoRL attention 256, "
          f"pair kernels on): {elapsed:.3f} s, {t * e * n / elapsed:,.0f} "
          f"agent-steps/s, {elapsed / t * 1e3:.2f} ms/tick; launches K1 "
          f"{counts['K1']}, K2 {counts['K2']}, K3 {counts['K3']}, K4 "
          f"{counts['K4']}; {collisions} collisions so far")
    del traj, infos

    # The pair kernels on the fleet the rollout reached (formations, real
    # pair history), against their plain versions.
    arm = float(params.arm)
    reached = check_pair_kernels(
        card, "swarm rollout state", states.dyn.pos.contiguous(),
        states.prev_coll_pairs, states.dyn.vel.contiguous(),
        cfg.collision_hitbox_radius * arm, cfg.collision_falloff_radius * arm,
        1.0, k=cfg.num_use_neighbor_obs)

    del states, obs

    # In turns (pairs, dense, dense, pairs): the rates are host-bound, and
    # the host's speed drifts within a run.
    dense_env = {**SWARM_ENV, "use_pallas_pairs": False}
    for label, env_kw in (("pairs route (K2, K3)", SWARM_ENV),
                          ("dense route", dense_env),
                          ("dense route", dense_env),
                          ("pairs route (K2, K3)", SWARM_ENV)):
        _swarm_sim(card, label, env_kw, ticks=200)
    return counts, reached


def phase_sim(card: str) -> dict:
    """The simulator at bench.py's width, through one auto-reset; then K1
    alone on the state it reached."""
    import torch
    from quadswarm_tpu_torch.env.multi import (
        EnvConfig, batched_env_step, env_reset)
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk

    e, n = 4096, 8
    cfg = EnvConfig(**SIM_ENV)
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator("cuda").manual_seed(1)
    states, _ = env_reset(cfg, params, gen, e, device="cuda")
    ticks = cfg.ep_len + 2
    before = dk.dynamics_tick_fused.launches
    reward_sum = torch.zeros((), device="cuda")
    done_ticks, stats = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ticks):
        actions = torch.rand((e, n, 4), generator=gen, device="cuda") * 2 - 1
        states, obs, rew, dones, info = batched_env_step(
            cfg, params, states, actions, gen)
        reward_sum += rew.sum()
        if i == cfg.ep_len:
            done_ticks.append(bool(dones.all()))
            stats = info
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dk.dynamics_tick_fused.launches - before
    dk.dynamics_tick_fused.launches = before
    if launches != ticks:
        raise AssertionError(f"K1 launched {launches} times in {ticks} ticks")
    if done_ticks != [True] or not bool((states.tick == 1).all()):
        raise AssertionError("not every env passed exactly one auto-reset")
    _finite("sim obs", obs)
    _finite("sim reward sum", reward_sum)
    for key in ("metric/agent_success_rate", "distance_to_goal_1s",
                "num_collisions"):
        _finite(f"episode stat {key}", stats[key])
    rate = float(stats["metric/agent_success_rate"].mean())
    print(f"[{card}] sim {e}x{n} mix, {ticks} ticks through one auto-reset: "
          f"{elapsed:.2f} s, {ticks * e * n / elapsed:,.0f} agent-steps/s, "
          f"{elapsed / ticks * 1e3:.2f} ms/tick; random-action episode "
          f"success rate {rate:.3f}")
    return check_on_env_state(card, "sim state", states, cfg, params)


# ---------------------------------------------------------------------------
# The training path (train.sh)
# ---------------------------------------------------------------------------

TRAIN_ITERS = 3
# One iteration of train.sh: rollout 128 x 1024 envs x 8 drones.
TRAIN_ITER_STEPS = 128 * 1024 * 8


def train_sh_flags(script: str = "train.sh") -> list:
    """A training script's flags (train.sh's, or train_local_obst.sh's),
    read from the script beside this one."""
    import shlex
    from pathlib import Path
    text = (Path(__file__).resolve().parent / script).read_text()
    line = next(ln for ln in text.replace("\\\n", " ").splitlines()
                if "training.train" in ln)
    words = shlex.split(line)
    start = next(i for i, w in enumerate(words) if w.endswith(
        "training.train")) + 1
    return [w for w in words[start:] if w != "$@"]


class SyncCounter:
    """Counts the device-to-host synchronisations of the CUDA calls made
    inside it (torch.cuda.set_sync_debug_mode), apart from explicit
    torch.cuda.synchronize() calls, which it counts separately."""

    def __enter__(self):
        import warnings
        import torch
        self._catch = warnings.catch_warnings(record=True)
        self.records = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import collections
        import os
        import torch
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        syncs = [r for r in self.records
                 if "synchronizing" in str(r.message)]
        explicit = os.path.join("torch", "cuda", "__init__.py")
        self.explicit = sum(r.filename.endswith(explicit) for r in syncs)
        self.implicit = len(syncs) - self.explicit
        self.where = sorted({f"{r.filename}:{r.lineno}" for r in syncs
                             if not r.filename.endswith(explicit)})
        self.by_site = collections.Counter(
            f"{os.path.basename(r.filename)}:{r.lineno}" for r in syncs
            if not r.filename.endswith(explicit))
        return False


def _flagship_trainer(device="cuda", script: str = "train.sh",
                      argv: list | None = None, mesh=None):
    """A Trainer at a training script's settings (train.sh's by default),
    or at the flags `argv`, built as the CLI builds it (an APPOTrainer under
    --async_rl, split by --appo_split_devices), on `mesh` (the CLI's: the
    job's world, one rank without a process group)."""
    import torch
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.parallel.appo import APPOTrainer
    from quadswarm_tpu_torch.parallel.ppo import Trainer
    from quadswarm_tpu_torch.training import config

    args = config.parse_swarm_cfg(train_sh_flags(script) if argv is None
                                  else argv)
    env_cfg = config.env_config_from_args(args)
    ppo = config.ppo_config_from_args(args)
    torch.manual_seed(args.seed)
    model = config.model_from_args(args, env_cfg, device=device)
    kwargs = dict(seed=args.seed,
                  anneal_schedules=config.anneal_schedules_from_args(args),
                  base_rew_coeff=config.base_rew_coeff_from_args(args),
                  device=device, mesh=mesh)
    if args.async_rl:
        return APPOTrainer(env_cfg, ppo, model,
                           make_dynamics_params(dt=env_cfg.dt),
                           policy_lag=args.policy_lag,
                           split_mesh=config.appo_split_from_args(args),
                           **kwargs)
    return Trainer(env_cfg, ppo, model, make_dynamics_params(dt=env_cfg.dt),
                   **kwargs)


def _iterations(card: str, label: str, trainer, iters: int) -> tuple:
    """`iters` iterations of a trainer, each counted and timed on one line:
    rollout/learner split (and APPO's recompute), ms a minibatch,
    agent-steps/s, losses (finite), parameters that moved, K1 launches (one
    a tick, the dense route), device-to-host syncs (one a tick: the episode
    ends), peak memory.  Returns (summed launch counts, the iterations'
    wall times, the last iteration's infos)."""
    import torch

    ppo, cfg = trainer.ppo_cfg, trainer.env_cfg
    e, n, t = ppo.num_envs, cfg.num_agents, ppo.rollout
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = _counts()
    walls = []
    for it in range(iters):
        before = [p.detach().clone() for p in trainer.model.parameters()]
        _reset_counts()
        t0 = time.perf_counter()
        with SyncCounter() as syncs:
            metrics, infos = trainer.iteration()
        wall = time.perf_counter() - t0
        walls.append(wall)
        counts = _read_counts()
        for kid in total:
            total[kid] += counts[kid]
        if counts != _counts(K1=t):
            raise AssertionError(f"{label} iteration {it}: launches {counts},"
                                 f" expected K1 {t}")
        m = {k: float(v) for k, v in metrics.items()}
        for k in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl"):
            if not math.isfinite(m[k]):
                raise AssertionError(f"{label} iteration {it}: {k} = {m[k]}")
        changed = max(float((p.detach() - b).abs().max())
                      for p, b in zip(trainer.model.parameters(), before))
        if not changed > 0:
            raise AssertionError(f"{label} iteration {it}: the parameters "
                                 "did not change")
        if syncs.implicit != t:
            raise AssertionError(f"{label} iteration {it}: {syncs.implicit} "
                                 f"syncs in {t} ticks, at {syncs.where}")
        sec = trainer.seconds
        recompute = (f"; of it the recompute {sec['recompute']:.3f} s"
                     if "recompute" in sec else "")
        steps = e * n * t // ppo.batch_size
        print(f"[{card}] {label} iteration {it} ({e}x{n} x {t}, batch "
              f"{ppo.batch_size}, replay {ppo.replay_sample_prob}): "
              f"{wall:.3f} s = rollout {sec['rollout']:.3f} s + learner "
              f"{sec['learner']:.3f} s "
              f"({sec['learner'] / steps * 1e3:.3f} ms per minibatch"
              f"{recompute}); "
              f"{e * n * t / wall:,.0f} agent-steps/s; loss {m['loss']:.5g} "
              f"pg_loss {m['pg_loss']:.5g} v_loss {m['v_loss']:.5g} entropy "
              f"{m['entropy']:.5g} approx_kl {m['approx_kl']:.3g}; "
              f"parameters moved up to {changed:.3g}; K1 "
              f"launches {counts['K1']}; {syncs.implicit} device-to-host "
              f"syncs ({syncs.implicit / t:.3f} per tick; {syncs.explicit} "
              f"explicit); peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:,.0f} MiB")
    return total, walls, infos


def _train_flagship(card: str) -> tuple:
    """TRAIN_ITERS iterations of the Trainer at train.sh's settings, each
    with its launches, syncs, losses, times and peak memory.  Returns the
    launch counts of all iterations and the final env state."""
    import torch

    trainer = _flagship_trainer()
    ppo, cfg = trainer.ppo_cfg, trainer.env_cfg
    e, n, t = ppo.num_envs, cfg.num_agents, ppo.rollout
    if (e, n, t, ppo.batch_size, ppo.replay_sample_prob, cfg.use_downwash,
            trainer.model.action_head.in_features) != (
            1024, 8, 128, 1024, 0.75, True, 512):
        raise AssertionError("the trainer is not at train.sh's settings")
    if trainer.anneal_schedules["quadcol_bin"] != (5.0, 3e8):
        raise AssertionError(f"annealing {trainer.anneal_schedules}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on")
    total, walls, infos = _iterations(card, "train", trainer, TRAIN_ITERS)
    stats = trainer.episode_stats(infos)
    print(f"[{card}] train: {trainer.env_steps:,} env steps, "
          f"{trainer.step} optimizer steps, collision coefficient "
          f"{trainer.current_rew_coeff().quadcol_bin:.5g}, "
          f"{int(stats.get('num_episodes', 0))} episodes ended in the last "
          "rollout")
    return total, trainer.env_states, cfg, trainer.dyn_params, walls


def _replay_draws(e: int, n: int, gen, obstacles: bool = False) -> dict:
    """A replay tick's draws: the env tick's, the replayed observation's
    sensor noise and the replay uniforms (each sample one below 0.5, so
    every eligible episode end replays at sample_prob 0.75)."""
    import torch
    d = _draws(e, n, gen, obstacles)
    d["replay_sensor"] = {k: torch.randn((e, n, 3), generator=gen)
                          for k in d["sensor"]}
    d["replay_u"] = torch.rand((e,), generator=gen) * 0.5
    d["replay_choice"] = torch.rand((e,), generator=gen)
    return d


def _close_trees(label: str, pairs, tol) -> float:
    """Float leaves within tol, the rest equal; returns the largest float
    difference."""
    import torch
    worst = 0.0
    for name, g, c in pairs:
        g = g.cpu()
        if g.dtype.is_floating_point:
            t = DYN_TOL_FIELD.get(name.split(".")[-1], tol)
            if not torch.allclose(g, c, **t):
                raise AssertionError(f"{label} {name}: card and CPU differ "
                                     f"by {float((g - c).abs().max())}")
            worst = max(worst, float((g - c).abs().max()))
        elif not torch.equal(g, c):
            raise AssertionError(f"{label} {name}: card and CPU differ")
    return worst


def _replay_agree(card: str, label: str, env_kw: dict, e: int,
                  ticks: int = 20, reward: dict = FLAGSHIP_REWARD) -> dict:
    """batched_replay_step on the card against the CPU for `ticks` ticks,
    both from the CPU's state and replay state each tick, with the same
    draws.  The start is prepared so that every branch fires: all envs can
    fly and hold 3 checkpoints; the first half of them is 5 ticks or less
    from a checkpoint tick and has two drones inside the hitbox; the second
    half ends its episode within 13 ticks, half of those with a buffer to
    replay, half with an empty one (a fresh reset).  With obstacles, drone
    2 of every env of the first half sits on an active obstacle, and an
    obstacle hit must fire too."""
    import torch
    from quadswarm_tpu_torch.env.multi import EnvConfig, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.env.replay import (
        batched_replay_step, init_replay_state)
    from quadswarm_tpu_torch.env.reward import RewardCoeffs
    from quadswarm_tpu_torch.utils.struct import leaves

    cfg = EnvConfig(**env_kw)
    n = cfg.num_agents
    params = make_dynamics_params(dt=cfg.dt)
    gen_cpu = torch.Generator().manual_seed(21)
    gen_gpu = torch.Generator("cuda").manual_seed(21)
    draw_gen = torch.Generator().manual_seed(22)
    states, _ = env_reset(cfg, params, gen_cpu, e, device="cpu",
                          rew_coeff=RewardCoeffs(**reward))
    half = e // 2
    idx = torch.arange(e, dtype=torch.int32)
    tick = torch.where(idx < half, 1445 + idx % 5,
                       cfg.ep_len - 12 + idx % 10).to(torch.int32)
    pos = states.dyn.pos.clone()
    pos[..., 2] = pos[..., 2].clamp(min=1.5)
    pos[:half, 1] = pos[:half, 0] + torch.tensor([0.05, 0.0, 0.0])
    if cfg.use_obstacles:
        first = torch.argmax(states.obst_active[:half].to(torch.uint8), -1)
        pos[:half, 2, :2] = states.obst_pos[torch.arange(half), first, :2] \
            + 0.1
    states = states.replace(tick=tick, dyn=states.dyn.replace(pos=pos))
    rstates = init_replay_state(states)
    zi = torch.zeros(e, dtype=torch.int32)
    filled = (idx >= half) & (idx < half + half // 2)
    rstates = rstates.replace(
        activated=torch.ones(e, dtype=torch.bool), ep_cp_count=zi + 3,
        buffer_count=torch.where(filled, 3, 0).to(torch.int32),
        buffer_idx=torch.where(filled, 3, 0).to(torch.int32))
    fired = dict(checkpoint=0, collision_write=0, replay=0, fresh_reset=0)
    if cfg.use_obstacles:
        fired["obstacle_hit"] = 0
    _reset_counts()
    worst = 0.0
    for _ in range(ticks):
        actions = torch.rand((e, n, 4), generator=draw_gen) * 2 - 1
        draws = _replay_draws(e, n, draw_gen, cfg.use_obstacles)
        s_gpu, r_gpu = _to_cuda(states), _to_cuda(rstates)
        cpu = batched_replay_step(cfg, params, 0.75, states, rstates,
                                  actions, gen_cpu, draws)
        gpu = batched_replay_step(cfg, params, 0.75, s_gpu, r_gpu,
                                  actions.cuda(), gen_gpu, _to_cuda(draws))
        ns, nr = cpu[0], cpu[1]
        done = cpu[4][:, 0]
        fresh = done & ~nr.saved_in_replay_buffer
        keep = ~fresh
        fired["checkpoint"] += int((nr.ep_cp_count
                                    > rstates.ep_cp_count).sum())
        fired["collision_write"] += int((nr.buffer_count
                                         > rstates.buffer_count).sum())
        fired["replay"] += int((nr.replayed_events
                                > rstates.replayed_events).sum())
        fired["fresh_reset"] += int(fresh.sum())
        if cfg.use_obstacles:
            fired["obstacle_hit"] += int(
                (ns.prev_obst_hits & ~states.prev_obst_hits).sum())
        pairs = [(f"replay.{a}", g, c) for (a, g), (_, c)
                 in zip(leaves(gpu[1]), leaves(nr))]
        pairs += [(f"state.{a}", g[keep.cuda()], c[keep]) for (a, g), (_, c)
                  in zip(leaves(gpu[0]), leaves(ns))]
        pairs += [("obs", gpu[2][keep.cuda()], cpu[2][keep]),
                  ("reward", gpu[3], cpu[3]), ("dones", gpu[4], cpu[4])]
        pairs += [(f"info.{k}", gpu[5][k], cpu[5][k]) for k in cpu[5]
                  if not k.startswith("rewards/") and cpu[5][k].dim()
                  and cpu[5][k].shape[0] == e and k != "true_reward"]
        worst = max(worst, _close_trees(label, pairs, TRAJ_TOL))
        g = gpu[0]
        if fresh.any():
            f = fresh.cuda()
            if not (bool((g.tick[f] == 0).all())
                    and not bool(g.prev_coll_pairs[f].any())
                    and bool((g.dyn.vel[f] == 0).all())
                    and bool((g.collisions_per_episode[f] == 0).all())):
                raise AssertionError(f"{label}: a fresh reset on the card "
                                     "is not a fresh episode")
        states, rstates = ns, nr
    counts = _read_counts()
    _reset_counts()
    if not all(fired.values()):
        raise AssertionError(f"{label}: replay branches fired {fired}")
    if counts["K1"] != ticks or (cfg.use_pallas_pairs and not (
            counts["K2"] == ticks and counts["K3"] >= ticks)):
        raise AssertionError(f"{label}: launches {counts} in {ticks} ticks")
    print(f"[{card}] replay step card vs CPU, {label}, {e}x{n}, {ticks} "
          f"ticks: rings, counters, masks equal, floats max_abs_err "
          f"{worst:.3g} (rtol {TRAJ_TOL['rtol']}, atol {TRAJ_TOL['atol']}); "
          f"fired {fired}; launches {counts}")
    return counts


# The learner on the card against the CPU.  Gradients of one minibatch:
# each tensor within GRAD_RTOL of its largest entry, plus GRAD_ATOL of the
# model's largest gradient entry (float32 rounding of terms that size: the
# bias of the attention logits has a gradient that is zero in exact
# arithmetic, the softmax being shift-invariant, and is rounding residue on
# both devices).  Parameters after the
# Adam steps: within the learning rate, since Adam's first steps move a
# parameter by about +-lr whatever its gradient's size, and a gradient
# component that is zero to rounding can take either sign on either device.
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6


def _learner_agree(card: str) -> None:
    """The loss and gradients of one minibatch, then one sgd_epochs call (4
    minibatches of 256), on the card and on the CPU from the same
    flagship-width weights, trajectory and chunk permutation."""
    import copy
    import torch
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.parallel import ppo as P

    gen = torch.Generator().manual_seed(31)
    t, e, n, dim = 8, 16, 8, 54
    cfg = P.PPOConfig(batch_size=256)
    torch.manual_seed(31)
    cpu_model = ActorCritic(num_neighbors=6, rnn_size=256, neighbor_hidden=256,
                            device="cpu")
    gpu_model = copy.deepcopy(cpu_model).cuda()
    f = lambda *s: torch.randn((t, e, n) + s, generator=gen)
    traj = P.Transition(obs=f(dim), actions=f(4), log_prob=f() - 5.0,
                        value=f(), reward=f(), done=f() > 1.5)
    adv, ret = f(), f()
    flat = lambda x: x.reshape((t * e * n,) + x.shape[3:])[: cfg.batch_size]
    batch = tuple(flat(x) for x in (traj.obs, traj.actions, traj.log_prob,
                                    traj.value, adv, ret))
    losses, grad_err = [], 0.0
    for model, move in ((cpu_model, lambda x: x),
                        (gpu_model, lambda x: x.cuda())):
        loss, _ = P.ppo_loss(model, cfg, tuple(move(x) for x in batch))
        loss.backward()
        losses.append(float(loss.detach()))
    top = max(float(c.grad.abs().max()) for c in cpu_model.parameters())
    for (name, g), c in zip(gpu_model.named_parameters(),
                            cpu_model.parameters()):
        err = float((g.grad.cpu() - c.grad).abs().max())
        scale = float(c.grad.abs().max())
        if err > GRAD_RTOL * scale + GRAD_ATOL * top:
            raise AssertionError(f"learner: gradient of {name} differs by "
                                 f"{err} (largest entry {scale}, of the "
                                 f"model {top})")
        grad_err = max(grad_err, err / (scale + top))
    cpu_model.zero_grad(set_to_none=True)
    gpu_model.zero_grad(set_to_none=True)

    lay = P.minibatch_layout((t, e, n), cfg.batch_size)
    perms = [torch.randperm(lay.num_chunks, generator=gen)[None]]
    P.sgd_epochs(cpu_model, P.make_optimizer(cpu_model, cfg), cfg, traj, adv,
                 ret, None, perms=perms)
    P.sgd_epochs(gpu_model, P.make_optimizer(gpu_model, cfg), cfg,
                 P.Transition(*(x.cuda() for x in traj)), adv.cuda(),
                 ret.cuda(), None, perms=perms)
    diffs = torch.cat([(g.detach().cpu() - c.detach()).abs().flatten()
                       for g, c in zip(gpu_model.parameters(),
                                       cpu_model.parameters())])
    worst = float(diffs.max())
    print(f"[{card}] learner card vs CPU, flagship width: one minibatch's "
          f"loss {losses[1]:.7g} / {losses[0]:.7g}, gradients within "
          f"{grad_err:.3g} of each tensor's largest entry plus the model's "
          f"(rtol {GRAD_RTOL}, atol {GRAD_ATOL} of {top:.3g}); "
          f"after sgd_epochs (4 x 256) parameters max_abs_err {worst:.3g} "
          f"(atol lr = {cfg.learning_rate}), {int((diffs > 1e-6).sum())} of "
          f"{diffs.numel()} beyond 1e-6")
    if worst > cfg.learning_rate:
        raise AssertionError(f"learner: parameters differ by {worst}")


def _train_cli(flags: list, timeout: int = 600):
    """The train CLI in its own process; returns (its stdout, seconds)."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "quadswarm_tpu_torch.training.train", *flags],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode:
        raise AssertionError(f"train CLI exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return out.stdout, time.perf_counter() - t0


def _cli_twice(card: str, train_dir: str) -> None:
    """The train CLI with train.sh's flags for 1 iteration into
    `train_dir`, then again for a second: it resumes, and env_steps go
    on."""
    from pathlib import Path

    flags = train_sh_flags() + [f"--train_dir={train_dir}",
                                "--experiment=smoke", "--log_every_iters=1"]
    outs = [_train_cli(flags + [
        f"--train_for_env_steps={iters * TRAIN_ITER_STEPS}"])
        for iters in (1, 2)]
    exp = Path(train_dir) / "smoke"
    config = json.loads((exp / "config.json").read_text())
    lines = [json.loads(x) for x in
             (exp / "metrics.jsonl").read_text().splitlines()]
    cps = sorted(p.name for p in (exp / "checkpoint_p0").iterdir())
    steps = [r["env_steps"] for r in lines]
    if config["device"] != "cuda" or steps != [
            i * TRAIN_ITER_STEPS for i in (1, 2)]:
        raise AssertionError(f"CLI metrics at env steps {steps}")
    if "resumed from" not in outs[1][0] or cps != [
            f"checkpoint_{i * TRAIN_ITER_STEPS:012d}.pt" for i in (1, 2)]:
        raise AssertionError(f"CLI resume: checkpoints {cps}")
    if not all(math.isfinite(r["loss"]) for r in lines):
        raise AssertionError("CLI losses are not finite")
    print(f"[{card}] train CLI with train.sh's flags: 1 iteration in "
          f"{outs[0][1]:.1f} s, then resumed for a second in "
          f"{outs[1][1]:.1f} s (processes, start-up included); "
          f"perf/sps {[round(r['perf/sps']) for r in lines]}, checkpoints "
          f"{cps}")


def phase_train(card: str, train_dir: str) -> tuple:
    """The training path: the flagship Trainer (the main path), collision
    replay on the card against the CPU on both routes, the learner on the
    card against the CPU, and the CLI with a resume into `train_dir`.
    Returns the main path's launch counts, its K1 check on the state it
    reached and its iterations' wall times."""
    t0 = time.perf_counter()
    counts, states, cfg, params, walls = _train_flagship(card)
    check = check_on_env_state(card, "train state", states, cfg, params)
    del states
    _replay_agree(card, "dense route (K1)", {**FLAGSHIP_ENV}, 16)
    _replay_agree(card, "pairs route (K1, K2, K3)",
                  {**SWARM_ENV, "use_downwash": True}, 16)
    _learner_agree(card)
    _cli_twice(card, train_dir)
    print(f"[{card}] train phase: {time.perf_counter() - t0:.1f} s")
    return counts, check, walls


# ---------------------------------------------------------------------------
# The obstacle path (train_local_obst.sh)
# ---------------------------------------------------------------------------

OBST_ITERS = 2
# train_local_obst.sh's env: 8 drones, the obstacle mix on the 8 x 8 grid
# at density 0.2 (12 obstacles of size 0.6), the floor observation, 2
# visible neighbours, the 9-point SDF, downwash.
OBST_ENV = dict(num_agents=8, quads_mode="mix", ep_time=15.0,
                obs_repr="xyz_vxyz_R_omega_floor", neighbor_obs_type="pos_vel",
                neighbor_visible_num=2, collision_hitbox_radius=2.0,
                collision_falloff_radius=4.0, use_obstacles=True,
                obst_spawn_area=(8.0, 8.0), obst_density=0.2, obst_size=0.6,
                use_downwash=True)
OBST_REWARD = dict(quadcol_bin=5.0, quadcol_bin_smooth_max=4.0,
                   quadcol_bin_obst=5.0)


def _reset_tick(card: str, trainer) -> None:
    """A replay tick on which every env's episode ends and starts afresh
    (as all of the run's envs do together every 1501 ticks): its host time
    beside an ordinary tick's, and its device-to-host syncs."""
    import torch
    from quadswarm_tpu_torch.env.replay import batched_replay_step

    cfg, params = trainer.env_cfg, trainer.dyn_params
    e, n = trainer.ppo_cfg.num_envs, cfg.num_agents
    actions = torch.zeros((e, n, 4), device="cuda")
    ending = trainer.env_states.replace(
        tick=torch.full_like(trainer.env_states.tick, cfg.ep_len))
    times = {}
    for label, states in (("ordinary", trainer.env_states),
                          ("reset", ending), ("ordinary", trainer.env_states),
                          ("reset", ending)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SyncCounter() as syncs:
            out = batched_replay_step(cfg, params, 0.75, states,
                                      trainer.replay_states, actions,
                                      trainer.gen)
            torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t0, syncs.implicit)
    if not bool((out[0].tick == 0).all()):
        raise AssertionError("the reset tick did not reset every env")
    _finite("reset tick obs", out[2])
    print(f"[{card}] obstacle reset tick, all {e} envs x {n}: "
          f"{times['reset'][0] * 1e3:.2f} ms ({times['reset'][1]} implicit "
          f"syncs), an ordinary tick {times['ordinary'][0] * 1e3:.2f} ms "
          f"({times['ordinary'][1]} syncs); second of two calls each")


def phase_obst(card: str, train_dir: str) -> tuple:
    """train_local_obst.sh's training path: OBST_ITERS iterations of its
    Trainer, a reset tick with obstacles, the obstacle replay step on the
    card against the CPU, and K1 on the state the run reached.  Saves the
    trainer's checkpoint into `train_dir` for the eval phase.  Returns the
    launch counts of the iterations and the K1 check."""
    from quadswarm_tpu_torch.training import config as C
    from quadswarm_tpu_torch.utils.checkpoint import (
        checkpoint_dir, save_checkpoint)

    t0_phase = time.perf_counter()
    flags = train_sh_flags("train_local_obst.sh")
    args = C.parse_swarm_cfg(flags)
    trainer = _flagship_trainer(script="train_local_obst.sh")
    ppo, cfg = trainer.ppo_cfg, trainer.env_cfg
    e, n, t = ppo.num_envs, cfg.num_agents, ppo.rollout
    enc = trainer.model.actor_encoder
    want_env = {k: getattr(cfg, k) for k in OBST_ENV}
    if want_env != OBST_ENV or (e, t, ppo.batch_size,
                                ppo.replay_sample_prob, cfg.obs_dim) != (
            1024, 128, 1024, 0.75, 40) or enc.obstacle_encoder is None \
            or enc.neighbor_encoder is not None:
        raise AssertionError("the trainer is not at train_local_obst.sh's "
                             f"settings: {want_env}")
    print(f"[{card}] obst: train_local_obst.sh's Trainer, weights from seed "
          f"{args.seed} (torch.manual_seed), {int(trainer.env_states.obst_active.sum(-1).float().mean())} "
          f"obstacles an env")
    total, _, infos = _iterations(card, "obst", trainer, OBST_ITERS)
    # no episode ends within these ticks: the counters hold every hit
    hits = int(infos["num_collisions_obst_quad"][-1].sum())
    print(f"[{card}] obst: obstacle hits after {OBST_ITERS} iterations "
          f"{hits}")
    if hits <= 0:
        raise AssertionError("no obstacle hit in the obst iterations")
    exp = f"{train_dir}/obst"
    C.save_cfg(args, exp)
    save_checkpoint(checkpoint_dir(train_dir, "obst"), trainer.model,
                    trainer.optimizer, trainer.step, trainer.env_steps,
                    extra=trainer.norm_state)
    check = check_on_env_state(card, "obstacle train state",
                               trainer.env_states, cfg, trainer.dyn_params)
    _reset_tick(card, trainer)
    del trainer
    _replay_agree(card, "obstacle route (K1)", OBST_ENV, 16,
                  reward=OBST_REWARD)
    print(f"[{card}] obst phase: {time.perf_counter() - t0_phase:.1f} s")
    return total, check


# ---------------------------------------------------------------------------
# The eval CLI (train.sh's quality protocol)
# ---------------------------------------------------------------------------

EVAL_ENVS = 32
EVAL_FLAGS = [f"--eval_envs={EVAL_ENVS}", f"--max_num_episodes={EVAL_ENVS}"]


def _eval_round(card: str, label: str, argv: list) -> tuple:
    """The eval CLI's `evaluate` over `argv`, counted and timed: one round
    of EVAL_ENVS full episodes.  Returns (launch counts, the K1 check on the
    round's final state)."""
    import contextlib
    import io
    import torch
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.training import config as C
    from quadswarm_tpu_torch.training import enjoy

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        args = enjoy.load_args(argv)
    cfg = C.env_config_from_args(args)
    ticks = cfg.ep_len + 1
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with SyncCounter() as syncs, contextlib.redirect_stdout(out):
        result = enjoy.evaluate(args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    print("\n".join(f"[{card}] enjoy> {ln}" for ln in
                    out.getvalue().splitlines()
                    if not ln.startswith("  ") or "metric/" in ln
                    or "episode_reward" in ln))
    stats = result.stats
    if len(result.episodes) != EVAL_ENVS or stats["episode_done"] != 1.0:
        raise AssertionError(f"{label}: {len(result.episodes)} episodes, "
                             f"episode_done {stats['episode_done']}")
    if not all(math.isfinite(v) for ep in result.episodes
               for v in ep.values()):
        raise AssertionError(f"{label}: a stat is not finite")
    if counts != _counts(K1=ticks):
        raise AssertionError(f"{label}: launches {counts} in {ticks} ticks")
    rnd = result.round_seconds[0]
    print(f"[{card}] eval {label}: {len(result.episodes)} episodes of "
          f"{ticks} ticks ({EVAL_ENVS}x{cfg.num_agents}); round "
          f"{rnd:.3f} s, {ticks / rnd:,.1f} ticks/s, "
          f"{ticks * EVAL_ENVS * cfg.num_agents / rnd:,.0f} agent-steps/s; "
          f"call {wall:.3f} s; K1 launches {counts['K1']}; "
          f"{syncs.implicit} implicit device-to-host syncs in the call "
          f"({syncs.implicit / ticks:.4f} per tick; by site "
          f"{dict(syncs.by_site.most_common(6))}); "
          f"agent_success_rate {stats['metric/agent_success_rate']:.4f}, "
          f"agent_deadlock_rate {stats['metric/agent_deadlock_rate']:.4f} "
          f"(an under-trained policy)")
    check = check_on_env_state(card, f"eval {label} final state",
                               result.states, cfg,
                               make_dynamics_params(dt=cfg.dt))
    return counts, check


def phase_eval(card: str, train_dir: str) -> tuple:
    """train.sh's quality protocol through the eval CLI, from a `best`
    checkpoint the train CLI writes at a small width (64 envs, 1 s
    episodes, so that episodes end and a best is kept); then one round of
    train_local_obst.sh's configuration from the obst phase's checkpoint
    (fresh weights if that phase did not run).  Returns the launch counts
    and K1 checks of both."""
    from pathlib import Path

    t0 = time.perf_counter()
    iters = 4
    out, secs = _train_cli(train_sh_flags() + [
        f"--train_dir={train_dir}", "--experiment=eval_src",
        "--num_envs=64", "--quads_episode_duration=1.0",
        "--log_every_iters=1", f"--train_for_env_steps={iters * 128 * 64 * 8}"])
    cps = sorted(p.name for p in
                 (Path(train_dir) / "eval_src" / "checkpoint_p0").iterdir())
    if not any(c.startswith("best_") for c in cps):
        raise AssertionError(f"the train CLI kept no best checkpoint: {cps}")
    print(f"[{card}] eval: train CLI at 64 envs x 8, 1 s episodes, {iters} "
          f"iterations in {secs:.1f} s: {cps}")
    flagship = _eval_round(card, "train.sh static_diff_goal", train_sh_flags()
                           + [f"--train_dir={train_dir}",
                              "--experiment=eval_src",
                              "--quads_mode=static_diff_goal",
                              "--load_checkpoint_kind=best", *EVAL_FLAGS])
    obst = _eval_round(card, "train_local_obst.sh", train_sh_flags(
        "train_local_obst.sh") + [f"--train_dir={train_dir}",
                                  "--experiment=obst", *EVAL_FLAGS])
    print(f"[{card}] eval phase: {time.perf_counter() - t0:.1f} s")
    return flagship, obst


# ---------------------------------------------------------------------------
# The run files (runs/), APPO and PBT
# ---------------------------------------------------------------------------

RUN_MODULES = (
    "quad_multi_mix_baseline", "quad_multi_mix_baseline_attn_8",
    "single_quad_baseline", "single_quad", "pbt_quads_multi_obstacles",
    "obstacles.quads_multi_obstacles", "obstacles.obst_density_random",
    "obstacles.obst_size_random", "obstacles.obst_domain_random",
    "obstacles.quads_multi_obstacles_nei_encoder_search")
# The run files trained one iteration each in the runs phase, at the file's
# own width with the rollout cut to RUNS_ROLLOUT ticks.
OTHER_RUNS = ("obstacles.obst_density_random", "obstacles.obst_domain_random",
              "obstacles.obst_size_random",
              "obstacles.quads_multi_obstacles_nei_encoder_search",
              "quad_multi_mix_baseline", "single_quad_baseline")
RUNS_ROLLOUT = 16
FINAL_ITERS = 2
APPO_ITERS = 3
JAX_TRAIN = "quadswarm_tpu.training.train"
PORT_TRAIN = "quadswarm_tpu_torch.training.train"
# The card against the CPU on the same weights and inputs: |card - cpu| <=
# rtol |cpu| + top * (the largest |cpu| entry), TF32 off.
CARD_RTOL = 1e-5
CARD_TOP = 1e-6


def _close_to_cpu(label: str, got, want) -> float:
    """The elementwise bound above; returns the largest difference over
    the largest entry."""
    got = got.detach().cpu()
    top = float(want.abs().max())
    err = (got - want).abs()
    if bool((err > CARD_RTOL * want.abs() + CARD_TOP * top).any()):
        raise AssertionError(f"{label}: the card differs from the CPU by "
                             f"{float(err.max())} (largest entry {top})")
    return float(err.max()) / max(top, 1e-30)


def _run_file_code(path, swap: bool) -> str:
    """A run file's code as an AST dump, its docstring dropped; with
    `swap`, the JAX package's training and run modules named as the
    port's.  The file is parsed, never imported."""
    import ast
    tree = ast.parse(path.read_text())
    if tree.body and isinstance(tree.body[0], ast.Expr) and isinstance(
            tree.body[0].value, ast.Constant):
        tree.body = tree.body[1:]
    if swap:
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                node.value = node.value.replace(JAX_TRAIN, PORT_TRAIN)
            elif isinstance(node, ast.ImportFrom) and node.module:
                node.module = node.module.replace("quadswarm_tpu.runs",
                                                  "quadswarm_tpu_torch.runs")
    return ast.dump(tree)


def _run_flags(module: str) -> list:
    """The first command of a port run file (`runs/obstacles/
    quads_multi_obstacles` is the final obstacle run) as CLI flags, without
    its experiment and train dir."""
    import importlib
    import shlex
    run = importlib.import_module(f"quadswarm_tpu_torch.runs.{module}")
    (_, cmd), *_ = run.RUN_DESCRIPTION.commands("td")
    return [w for w in shlex.split(cmd)[3:]
            if not w.startswith(("--experiment=", "--train_dir="))]


def _run_commands(card: str) -> dict:
    """Every port run file's code is the JAX file's with the training
    module swapped (the JAX file read as text); the launcher's dry
    expansion of each prints its commands.  Returns run name -> [(name,
    argv)]."""
    import contextlib
    import importlib
    import io
    import shlex
    from pathlib import Path
    from quadswarm_tpu_torch.runs import launcher

    root = Path(__file__).resolve().parent
    files = sorted(p.relative_to(root / "quadswarm_tpu" / "runs")
                   for p in (root / "quadswarm_tpu" / "runs").rglob("*.py")
                   if p.name not in ("launcher.py", "__init__.py"))
    for rel in files:
        if _run_file_code(root / "quadswarm_tpu" / "runs" / rel, True) != \
                _run_file_code(root / "quadswarm_tpu_torch" / "runs" / rel,
                               False):
            raise AssertionError(f"runs/{rel}: the port's code is not the "
                                 "JAX file's with the module swapped")
    out = {}
    for name in RUN_MODULES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = launcher.main([f"--run=quadswarm_tpu_torch.runs.{name}",
                                "--backend=dry", "--train_dir=td"])
        cmds = list(importlib.import_module(
            f"quadswarm_tpu_torch.runs.{name}").RUN_DESCRIPTION.commands("td"))
        printed = [ln.strip() for ln in buf.getvalue().splitlines()[1:]]
        if rc or printed != [f"{n}: {c}" for n, c in cmds] or not all(
                shlex.split(c)[:3] == ["python", "-m", PORT_TRAIN]
                for _, c in cmds):
            raise AssertionError(f"dry expansion of {name}: {printed[:2]}")
        out[name] = [(n, shlex.split(c)[3:]) for n, c in cmds]
    print(f"[{card}] runs: {len(files)} run files hold the JAX files' code "
          f"with {JAX_TRAIN} -> {PORT_TRAIN}; the dry launcher expands "
          f"{len(out)} of them into "
          f"{sum(len(v) for v in out.values())} commands")
    return out


def _free() -> None:
    """Return the memory of the trainers the caller dropped to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _encoders_agree(card: str) -> None:
    """One forward of each new encoder (the final obstacle run's widths:
    19 + 2 x 6 + 9 inputs, 256 wide) on the card against the CPU on the same
    weights and 8,192 rows."""
    import copy
    import torch
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on")
    base = dict(self_obs_dim=19, neighbor_obs_dim=6, num_neighbors=2,
                neighbor_hidden=256, obstacle_hidden=256, rnn_size=256,
                use_obstacles=True)
    cases = {"attention": dict(encoder_type="attention"),
             "attention sim2real": dict(encoder_type="attention",
                                        sim2real=True),
             "corl mean_embed": dict(neighbor_encoder_type="mean_embed"),
             "corl mlp": dict(neighbor_encoder_type="mlp")}
    gen = torch.Generator().manual_seed(41)
    obs = 2 * torch.randn((8192, 19 + 12 + 9), generator=gen)
    worst = {}
    for label, kw in cases.items():
        torch.manual_seed(41)
        cpu = ActorCritic(**base, **kw, device="cpu")
        gpu = copy.deepcopy(cpu).cuda()
        with torch.no_grad():
            want, got = cpu(obs), gpu(obs.cuda())
        worst[label] = max(_close_to_cpu(f"encoder {label} {name}", g, w)
                           for name, g, w in zip(("mean", "log_std", "value"),
                                                 got, want))
    print(f"[{card}] encoders on the card against the CPU (8,192 rows, 256 "
          f"wide, TF32 off; rtol {CARD_RTOL} + {CARD_TOP} of the largest "
          "entry): largest difference over the largest entry "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def phase_runs(card: str) -> tuple:
    """The run files: their dry expansion against the JAX files; the final
    obstacle run (the first command of runs/obstacles/quads_multi_obstacles)
    at full width for FINAL_ITERS iterations; the new encoders on the card
    against the CPU; one iteration of each other run file at its own width
    with the rollout cut to RUNS_ROLLOUT; attn_8's refusal.  Returns the
    final run's launch counts and K1's check on the state it reached."""
    import torch
    from quadswarm_tpu_torch.models.encoders import (
        QuadMultiHeadAttentionEncoder)
    from quadswarm_tpu_torch.training import config as C

    t0 = time.perf_counter()
    cmds = _run_commands(card)
    name, argv = cmds["obstacles.quads_multi_obstacles"][0]
    trainer = _flagship_trainer(argv=argv)
    ppo, cfg = trainer.ppo_cfg, trainer.env_cfg
    if not isinstance(trainer.model.actor_encoder,
                      QuadMultiHeadAttentionEncoder) or (
            ppo.num_envs, cfg.num_agents, ppo.rollout, ppo.batch_size,
            ppo.replay_sample_prob, cfg.neighbor_visible_num,
            cfg.use_obstacles, cfg.obst_spawn_area, cfg.obs_dim) != (
            1024, 8, 128, 1024, 0.75, 2, True, (8.0, 8.0), 40):
        raise AssertionError(f"{name} is not the final obstacle run")
    size = sum(p.numel() for p in trainer.model.parameters())
    print(f"[{card}] final obstacle run ({name}): 'attention' encoder type, "
          f"{size:,} parameters, obstacles {cfg.obst_spawn_area} at "
          f"{cfg.obst_density}, weights from seed 0")
    counts, _, _ = _iterations(card, "final obstacle run", trainer,
                               FINAL_ITERS)
    check = check_on_env_state(card, "final obstacle run state",
                               trainer.env_states, cfg, trainer.dyn_params)
    del trainer
    _free()
    _encoders_agree(card)
    for run in OTHER_RUNS:
        name, argv = cmds[run][0]
        trainer = _flagship_trainer(argv=argv + [f"--rollout={RUNS_ROLLOUT}"])
        _iterations(card, f"{run} ({name}, depth cut: --rollout="
                    f"{RUNS_ROLLOUT})", trainer, 1)
        del trainer
        _free()
    name, argv = cmds["quad_multi_mix_baseline_attn_8"][0]
    args = C.parse_swarm_cfg(argv)
    env_cfg = C.env_config_from_args(args)
    try:
        C.model_from_args(args, env_cfg, device="cuda")
    except ValueError as e:
        if "ZeroDivisionError" not in str(e):
            raise
        print(f"[{card}] quad_multi_mix_baseline_attn_8 ({name}) is refused "
              f"at model build: {e}")
    else:
        raise AssertionError("quad_multi_mix_baseline_attn_8 was not refused")
    torch.cuda.synchronize()
    print(f"[{card}] runs phase: {time.perf_counter() - t0:.1f} s")
    return counts, check


def _appo_targets_agree(card: str) -> None:
    """APPO's learner targets (the per-step recompute and V-trace) on the
    card against the CPU: train.sh's model, one trajectory of 16 envs x 8 x
    rollout 8, the same weights."""
    import copy
    import torch
    from quadswarm_tpu_torch.models.actor_critic import (
        ActorCritic, gaussian_log_prob)
    from quadswarm_tpu_torch.parallel import appo as A
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig, Transition

    t, e, n, dim = 8, 16, 8, 54
    gen = torch.Generator().manual_seed(43)
    torch.manual_seed(43)
    cpu = ActorCritic(num_neighbors=6, rnn_size=256, neighbor_hidden=256,
                      device="cpu")
    gpu = copy.deepcopy(cpu).cuda()
    obs = 2 * torch.randn((t, e, n, dim), generator=gen)
    with torch.no_grad():
        mean, log_std, value = cpu(obs.reshape(-1, dim))
    actions = mean + log_std.exp() * torch.randn(mean.shape, generator=gen)
    # the behaviour's log-probs a lag away from the learner's
    log_prob = gaussian_log_prob(mean, log_std, actions) + 0.3 * torch.randn(
        (t * e * n,), generator=gen)
    traj = Transition(obs=obs, actions=actions.reshape(t, e, n, 4),
                      log_prob=log_prob.reshape(t, e, n),
                      value=value.reshape(t, e, n),
                      reward=torch.randn((t, e, n), generator=gen),
                      done=torch.rand((t, e, n), generator=gen) < 0.1)
    last_obs = 2 * torch.randn((e, n, dim), generator=gen)
    worst = 0.0
    for cfg in (PPOConfig(with_vtrace=True), PPOConfig()):
        want = A.learner_targets(cpu, cfg, traj, last_obs)
        got = A.learner_targets(gpu, cfg, Transition(*(x.cuda() for x in traj)),
                                last_obs.cuda())
        for name, g, w in zip(("advantages", "returns"), got, want):
            worst = max(worst, _close_to_cpu(
                f"APPO targets ({'V-trace' if cfg.with_vtrace else 'GAE'}) "
                f"{name}", g, w))
    print(f"[{card}] APPO learner targets on the card against the CPU "
          f"({e}x{n} x {t}, V-trace and GAE): largest difference over the "
          f"largest entry {worst:.3g} (rtol {CARD_RTOL} + {CARD_TOP} of the "
          "largest entry)")


def phase_appo(card: str) -> tuple:
    """train.sh's flags plus --async_rl=True --policy_lag=1
    --with_vtrace=True, full width, APPO_ITERS iterations in turns with
    train.sh's sync-PPO Trainer (appo, sync, appo, sync, appo: the two in
    one call, on one host): the third APPO iteration rolls out with the
    weights after the first.  Then the learner's targets on the card
    against the CPU.  Returns APPO's launch counts and K1's check."""
    import torch
    from quadswarm_tpu_torch.parallel.appo import APPOTrainer

    t0 = time.perf_counter()
    trainer = _flagship_trainer(argv=train_sh_flags() + [
        "--async_rl=True", "--policy_lag=1", "--with_vtrace=True"])
    if not isinstance(trainer, APPOTrainer) or trainer.policy_lag != 1 or \
            not trainer.ppo_cfg.with_vtrace:
        raise AssertionError("not train.sh's APPO with V-trace at lag 1")
    sync = _flagship_trainer()
    counts = _counts()
    walls = {"appo": [], "sync": []}
    after_first = {}
    for it in range(APPO_ITERS):
        c, w, _ = _iterations(card, f"appo (lag 1, V-trace) #{it}", trainer,
                              1)
        counts = {k: counts[k] + c[k] for k in counts}
        walls["appo"] += w
        if it == 0:
            after_first.update({k: v.clone() for k, v in
                                trainer.model.state_dict().items()})
        if it == 2:
            same = all(torch.equal(v, after_first[k]) for k, v in
                       trainer.behavior.state_dict().items())
            if trainer.behavior_version != 1 or not same:
                raise AssertionError("APPO's third iteration did not roll "
                                     "out with the first one's weights")
            print(f"[{card}] appo: the third iteration rolled out with the "
                  "weights after the first (behaviour version "
                  f"{trainer.behavior_version}, every tensor equal)")
        if it < APPO_ITERS - 1:
            walls["sync"] += _iterations(
                card, f"sync PPO in turns #{it}", sync, 1)[1]
    appo_s, sync_s = (sum(v[1:]) / len(v[1:]) if len(v) > 1 else v[0]
                      for v in (walls["appo"], walls["sync"]))
    print(f"[{card}] appo against sync PPO in turns (train.sh, 1024x8 x "
          f"128): APPO {[round(x, 3) for x in walls['appo']]} s, sync "
          f"{[round(x, 3) for x in walls['sync']]} s; without each one's "
          f"first, APPO {appo_s:.3f} s against {sync_s:.3f} s "
          f"({appo_s / sync_s - 1:+.1%})")
    check = check_on_env_state(card, "appo state", trainer.env_states,
                               trainer.env_cfg, trainer.dyn_params)
    del trainer, sync
    _free()
    _appo_targets_agree(card)
    print(f"[{card}] appo phase: {time.perf_counter() - t0:.1f} s")
    return counts, check


def phase_pbt(card: str, train_dir: str) -> tuple:
    """runs/pbt_quads_multi_obstacles' command at full width (8 policies x
    512 envs x 8 x 128): one iteration of each policy; a round with injected
    objectives (policy p scores p), after which each adoptee's parameters
    and Adam state equal its source's bit for bit, and differ after one
    more iteration of each; then the CLI's PBT branch with 2 policies at a
    small width.  Returns the launch counts of the round of iterations and
    K1's check."""
    import shlex
    import torch
    from pathlib import Path
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.parallel.pbt import PBTRunner
    from quadswarm_tpu_torch.runs import pbt_quads_multi_obstacles as run
    from quadswarm_tpu_torch.training import config as C

    t0 = time.perf_counter()
    (name, cmd), = run.RUN_DESCRIPTION.commands(train_dir)
    args = C.parse_swarm_cfg(shlex.split(cmd)[3:])
    env_cfg = C.env_config_from_args(args)
    ppo = C.ppo_config_from_args(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner = PBTRunner(
        env_cfg, ppo, lambda: C.model_from_args(args, env_cfg, device="cuda"),
        make_dynamics_params(dt=env_cfg.dt), C.pbt_config_from_args(args),
        seed=args.seed, anneal_schedules=C.anneal_schedules_from_args(args),
        exp_dir=str(Path(train_dir) / name),
        base_rew_coeff=C.base_rew_coeff_from_args(args), device="cuda")
    trainers = [s.trainer for s in runner.policies]
    enc = trainers[0].model.actor_encoder
    e, n, t = ppo.num_envs, env_cfg.num_agents, ppo.rollout
    if (len(trainers), e, n, t, ppo.batch_size, env_cfg.obs_repr,
            env_cfg.obs_dim) != (8, 512, 8, 128, 1024,
                                 "xyz_vxyz_R_omega_wall", 69) or \
            enc.obstacle_encoder is None or enc.neighbor_encoder is None:
        raise AssertionError(f"{name} is not the PBT run's configuration")
    print(f"[{card}] pbt: {name}, {len(trainers)} policies resident, "
          f"{torch.cuda.memory_allocated() / 2**20:,.0f} MiB allocated "
          "after their construction")

    def turn(label, policies):
        _reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for p in policies:
            metrics, _ = trainers[p].iteration()
            for k, v in metrics.items():
                if not math.isfinite(float(v)):
                    raise AssertionError(f"pbt policy {p}: {k} = {float(v)}")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = _read_counts()
        if counts != _counts(K1=len(policies) * t):
            raise AssertionError(f"pbt {label}: launches {counts}")
        print(f"[{card}] pbt {label}: {len(policies)} iterations of "
              f"{e}x{n} x {t} in {secs:.3f} s "
              f"({len(policies) * e * n * t / secs:,.0f} agent-steps/s); K1 "
              f"launches {counts['K1']}; peak allocated with "
              f"{len(trainers)} policies resident "
              f"{torch.cuda.max_memory_allocated() / 2**20:,.0f} MiB")
        return counts

    counts = turn("round of iterations", range(len(trainers)))
    for p, slot in enumerate(runner.policies):
        slot.recent_true_rewards = [float(p)]
    runner._pbt_round()

    def state(tr):
        params = list(tr.model.parameters())
        return params, [tr.optimizer.state[q] for q in params]

    def equal(a, b):
        (ap, ao), (bp, bo) = state(a), state(b)
        return all(torch.equal(x, y) for x, y in zip(ap, bp)) and all(
            torch.equal(x[k], y[k]) for x, y in zip(ao, bo)
            for k in ("exp_avg", "exp_avg_sq", "step"))

    pairs = []
    for b in (0, 1):
        src = [s for s in (6, 7) if equal(trainers[s], trainers[b])]
        if len(src) != 1:
            raise AssertionError(f"pbt: policy {b} adopted from {src}")
        (bp, bo), (sp, so) = state(trainers[b]), state(trainers[src[0]])
        if any(x.data_ptr() == y.data_ptr() for x, y in zip(bp, sp)) or any(
                x[k].data_ptr() == y[k].data_ptr() for x, y in zip(bo, so)
                for k in ("exp_avg", "exp_avg_sq")):
            raise AssertionError(f"pbt: policy {b} aliases its source")
        pairs.append((b, src[0]))
    print(f"[{card}] pbt round (objectives 0..7, replace fraction "
          f"{runner.pbt_cfg.replace_fraction}): adoptee <- source {pairs}; "
          "parameters and Adam moments and step equal bit for bit, in "
          "tensors of their own")
    turn("iterations after the round",
         sorted({p for pair in pairs for p in pair}))
    for b, s in pairs:
        if equal(trainers[b], trainers[s]):
            raise AssertionError(f"pbt: policy {b} still equals {s}")
    print(f"[{card}] pbt: after one more iteration of each, every adoptee "
          "differs from its source")
    check = check_on_env_state(card, "pbt policy 0 state",
                               trainers[0].env_states, env_cfg,
                               trainers[0].dyn_params)
    del runner, trainers
    _free()

    small = ["--num_policies=2", "--num_envs=32", "--rollout=16",
             f"--train_for_env_steps={2 * 32 * 8 * 16}"]
    out, secs = _train_cli(shlex.split(cmd)[3:] + small)
    exp = Path(train_dir) / name
    cps = {p: sorted(x.name for x in (exp / f"checkpoint_p{p}").iterdir())
           for p in (0, 1)}
    if cps != {p: [f"checkpoint_{32 * 8 * 16:012d}.pt"] for p in (0, 1)} or \
            not all((exp / f"p{p}" / "metrics.jsonl").exists()
                    for p in (0, 1)):
        raise AssertionError(f"pbt CLI: checkpoints {cps}")
    print(f"[{card}] pbt CLI (the run's command, 2 policies x 32 envs x 16 "
          f"ticks, one iteration each): {secs:.1f} s (start-up included); "
          f"checkpoints {cps}")
    print(f"[{card}] pbt phase: {time.perf_counter() - t0:.1f} s")
    return counts, check


# ---------------------------------------------------------------------------
# The rest of the env: per-drone fleets through K1, the controllers, the gym
# API, the scenario modes beyond the two mixes
# ---------------------------------------------------------------------------

SURFACE_B = 8192
PER_DRONE_FLEETS = (("RelativeSampler 0.2",
                     {"class": "RelativeSampler", "noise_ratio": 0.2}),
                    ("RandomQuad", {"class": "RandomQuad"}))
NEW_MODES = ("run_away", "o_dynamic_same_goal", "o_swap_goals",
             "o_ep_rand_bezier", "o_uniform_same_goal_spawn", "o_diagonal",
             "o_static_diff_goal", "o_dynamic_diff_goal", "o_test")
# The new modes with events, and those with an obstacle grid at reset.
EVENT_MODES = ("run_away", "o_dynamic_same_goal", "o_swap_goals",
               "o_ep_rand_bezier", "o_dynamic_diff_goal", "o_test")
MODE_ENVS = 1024
MODE_TICKS = 700
PROBE_TICKS = 400


def _k1_forms(card: str) -> tuple:
    """K1's per-drone form at B=8,192 (an 8-row table from each fleet of
    PER_DRONE_FLEETS) against its plain version, in turns with the shared
    form on the same batch: shared, per-drone, per-drone, shared."""
    import torch
    from quadswarm_tpu_torch.env.dynamics import DynamicsConfig
    from quadswarm_tpu_torch.env.params import make_dynamics_params

    shared = make_dynamics_params()
    cfg = DynamicsConfig(floor_threshold=float(shared.arm))
    gen = torch.Generator("cuda").manual_seed(40)
    batch = random_drone_batch(SURFACE_B, cfg, gen, torch.device("cuda"))
    shared_checks = [check_dynamics_kernel(
        card, "shared form, in turns with the per-drone form (1 of 2)",
        shared, cfg, *batch)]
    per_drone = []
    for label, sampler in PER_DRONE_FLEETS:
        fleet = make_dynamics_params(num_agents=8, per_drone=True, seed=1,
                                     dyn_sampler_1=sampler)
        per_drone.append(check_dynamics_kernel(
            card, f"per-drone form, {label} table of 8 rows", fleet, cfg,
            *batch))
    shared_checks.append(check_dynamics_kernel(
        card, "shared form, in turns with the per-drone form (2 of 2)",
        shared, cfg, *batch))
    us = lambda cs: ", ".join(f"{c['device_ms'] * 1e3:.2f}" for c in cs)
    print(f"[{card}] K1 at B={SURFACE_B} in turns: shared form device "
          f"{us(shared_checks)} us, per-drone form device {us(per_drone)} us")
    return shared_checks, per_drone


def _control_modes(card: str) -> None:
    """Each control mode for one tick of a 1024 x 8 fleet on the card
    against the CPU; then Mellinger flying the fleet to its goal at
    static_same_goal for PROBE_TICKS ticks on the card."""
    import torch
    from quadswarm_tpu_torch.env.controls import CONTROL_MODES
    from quadswarm_tpu_torch.env.multi import (
        EnvConfig, batched_env_step, env_reset)
    from quadswarm_tpu_torch.env.params import make_dynamics_params

    for mode in CONTROL_MODES:
        cfg = EnvConfig(**{**FLAGSHIP_ENV, "control_mode": mode})
        params = make_dynamics_params(dt=cfg.dt)
        gen = torch.Generator().manual_seed(9)
        states, _ = env_reset(cfg, params, gen, 1024, device="cpu")
        worst, _, _ = _agree_ticks(card, f"control mode {mode}", cfg, params,
                                   states, 1, gen)
        print(f"[{card}] control mode {mode}: env step GPU vs CPU at "
              f"1024x8, 1 tick: max_abs_err {worst:.3g} (rtol "
              f"{STEP_TOL['rtol']}, atol {STEP_TOL['atol']})")

    cfg = EnvConfig(**{**FLAGSHIP_ENV, "quads_mode": "static_same_goal",
                       "control_mode": "mellinger"})
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator("cuda").manual_seed(11)
    states, _ = env_reset(cfg, params, gen, 1024, device="cuda")
    dist = lambda s: float(torch.linalg.vector_norm(
        s.dyn.pos - s.scenario.goals, dim=-1).mean())
    d0 = dist(states)
    zero = torch.zeros((1024, 8, 4), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROBE_TICKS):
        states, *_ = batched_env_step(cfg, params, states, zero, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d1 = dist(states)
    print(f"[{card}] Mellinger probe, static_same_goal, 1024x8: mean goal "
          f"distance {d0:.3f} m -> {d1:.3f} m in {PROBE_TICKS} ticks "
          f"({secs / PROBE_TICKS * 1e3:.2f} ms a tick)")
    # the mean falls by a quarter at least (8 drones crowd one goal point,
    # so collisions and downwash keep them apart)
    if not d1 < 0.75 * d0:
        raise AssertionError("Mellinger did not bring the fleet to its goal")


def _stats_keys(stats: dict) -> tuple:
    """(the unprefixed keys, the keys of the scenario-prefixed copies with
    the prefix taken off) of an `episode_extra_stats` dict."""
    from quadswarm_tpu_torch.env.scenarios import MODES
    prefixed = {k.split("/", 1)[1] for k in stats
                if k.split("/", 1)[0] in MODES}
    plain = {k for k in stats if k.split("/", 1)[0] not in MODES}
    return plain, prefixed


def _gym_episode(card: str, label: str, make, form: str) -> dict:
    """One whole episode of random actions through `step(list)` on the
    card, of the env `make(device)` builds: ep_len + 1 steps (the last one
    ends the episode and auto-resets) and one more.  Checks one launch of
    K1's `form` a step and that the done step's stats keys equal those of
    the same env on the CPU at a done.  Returns the launch counts."""
    import numpy as np
    import torch

    env = make("cuda")
    cfg = env.cfg
    steps = cfg.ep_len + 2
    rng = np.random.default_rng(0)
    acts = rng.uniform(-1, 1, (steps, cfg.num_agents, cfg.action_dim)).astype(
        np.float32)
    env.reset(seed=0)
    torch.cuda.synchronize()
    _reset_counts()
    done_at, stats = [], None
    t0 = time.perf_counter()
    with SyncCounter() as syncs:
        for k in range(steps):
            obs, rew, done, infos = env.step(list(acts[k]))
            if any(done):
                done_at.append(k + 1)
                stats = infos[0]["episode_extra_stats"]
    secs = time.perf_counter() - t0
    counts = _read_counts()
    if counts != _counts(**{form: steps}):
        raise AssertionError(f"gym API {label}: launches {counts} in {steps} "
                             "steps")
    if done_at != [cfg.ep_len + 1] or not np.isfinite(np.stack(obs)).all():
        raise AssertionError(f"gym API {label}: done at steps {done_at}")
    # the CPU env of the same config, one step from its episode's end
    cpu = make("cpu")
    cpu.reset(seed=0)
    cpu._state = cpu._state.replace(
        tick=torch.full_like(cpu._state.tick, cfg.ep_len))
    _, _, cpu_done, cpu_infos = cpu.step(list(acts[0]))
    plain, prefixed = _stats_keys(stats)
    cpu_plain, cpu_prefixed = _stats_keys(cpu_infos[0]["episode_extra_stats"])
    if not (all(cpu_done) and plain == prefixed == cpu_plain == cpu_prefixed):
        raise AssertionError(f"gym API {label}: stats keys {sorted(plain)} "
                             f"against the CPU's {sorted(cpu_plain)}")
    print(f"[{card}] gym API, {label}: {steps} steps of 1x{cfg.num_agents} "
          f"in {secs:.3f} s ({steps / secs:.1f} steps/s), done at step "
          f"{done_at[0]} with auto-reset; {form} launches {counts[form]}; "
          f"{syncs.implicit} device-to-host syncs "
          f"({syncs.implicit / steps:.2f} a step); {len(stats)} "
          f"episode_extra_stats keys, equal to the CPU env's "
          f"({len(plain)} and their scenario-prefixed copies)")
    return counts


def _new_modes(card: str) -> dict:
    """The nine modes beyond the two mixes at MODE_ENVS x 8 with obstacles
    (train_local_obst.sh's grid), a mode per env, MODE_TICKS ticks of
    random actions: events fired by mode (each event mode's above 0) and
    obstacle hits (each obstacle mode's above 0), goals in the room, one
    device-to-host sync a tick.  Returns the launch counts."""
    import torch
    from quadswarm_tpu_torch.env.multi import (
        EnvConfig, batched_env_step, env_reset)
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.env.scenarios import MODE_IDS

    cfg = EnvConfig(**OBST_ENV)
    params = make_dynamics_params(dt=cfg.dt)
    ids = torch.tensor([MODE_IDS[m] for m in NEW_MODES], device="cuda")
    modes = ids[torch.arange(MODE_ENVS, device="cuda") % len(NEW_MODES)]
    gen = torch.Generator("cuda").manual_seed(12)
    t0 = time.perf_counter()
    states, obs = env_reset(cfg, params, gen, MODE_ENVS, device="cuda",
                            mode=modes)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    with SyncCounter() as syncs:
        for _ in range(MODE_TICKS):
            actions = torch.rand((MODE_ENVS, 8, 4), generator=gen,
                                 device="cuda") * 2 - 1
            states, obs, rew, done, info = batched_env_step(
                cfg, params, states, actions, gen)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _read_counts()
    if counts != _counts(K1=MODE_TICKS):
        raise AssertionError(f"new modes: launches {counts}")
    if syncs.implicit != MODE_TICKS:
        raise AssertionError(f"new modes: {syncs.implicit} syncs in "
                             f"{MODE_TICKS} ticks at {syncs.by_site}")
    goals = states.scenario.goals
    lo = torch.tensor(cfg.room_box[0], device="cuda")
    hi = torch.tensor(cfg.room_box[1], device="cuda")
    if not (torch.isfinite(goals).all() and (goals >= lo).all()
            and (goals <= hi).all() and torch.isfinite(obs).all()):
        raise AssertionError("new modes: goals outside the room")
    events = torch.zeros(len(NEW_MODES), dtype=torch.int64, device="cuda")
    hits = torch.zeros_like(events)
    slot = torch.arange(MODE_ENVS, device="cuda") % len(NEW_MODES)
    events.index_add_(0, slot, states.scenario.event_count.long())
    hits.index_add_(0, slot, states.obst_collisions_per_episode.long())
    envs = torch.bincount(slot.cpu(), minlength=len(NEW_MODES)).tolist()
    events, hits = events.tolist(), hits.tolist()
    for name, n_env, ev, hit in zip(NEW_MODES, envs, events, hits):
        print(f"[{card}] mode {name}: {n_env} envs, {ev} events fired, {hit} "
              f"obstacle hits in {MODE_TICKS} ticks")
        if (n_env < 100 or (name in EVENT_MODES and ev <= 0)
                or (name.startswith("o_") and hit <= 0)):
            raise AssertionError(f"mode {name}: {n_env} envs, {ev} events, "
                                 f"{hit} hits")
    print(f"[{card}] new modes at {MODE_ENVS}x8 with obstacles: reset "
          f"{reset_s:.3f} s, {MODE_TICKS} ticks in {secs:.3f} s "
          f"({secs / MODE_TICKS * 1e3:.2f} ms a tick, "
          f"{MODE_TICKS * MODE_ENVS * 8 / secs:,.0f} agent-steps/s); K1 "
          f"launches {counts['K1']}; {syncs.implicit} device-to-host syncs "
          f"({syncs.implicit / MODE_TICKS:.2f} a tick); goals in the room")
    return counts


def _agree_new_modes(card: str) -> None:
    """The env step on the card against the CPU for 20 ticks spanning each
    new mode's first event (2 envs a mode, each env started 10 ticks
    before its event), with the obstacle response's draws; then a
    per-drone fleet at train.sh's env for 6 ticks."""
    import torch
    from quadswarm_tpu_torch.env.multi import EnvConfig, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.env.scenarios import MODE_IDS

    cfg = EnvConfig(**OBST_ENV)
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator().manual_seed(13)
    modes = torch.tensor([MODE_IDS[m] for m in NEW_MODES]).repeat(2)
    states, _ = env_reset(cfg, params, gen, modes.shape[0], device="cpu",
                          mode=modes)
    iv = states.scenario.interval
    first = torch.where(modes == MODE_IDS["run_away"], 100, torch.where(
        modes == MODE_IDS["o_test"], iv + 1, torch.where(
            (modes == MODE_IDS["o_dynamic_same_goal"])
            | (modes == MODE_IDS["o_ep_rand_bezier"]), 1, iv)))
    start = torch.clamp(first - 10, min=0).to(torch.int32)
    states = states.replace(tick=start)
    before = states.scenario.event_count.clone()
    worst, states, _ = _agree_ticks(card, "new modes", cfg, params, states,
                                    20, gen, obstacles=True)
    fired = states.scenario.event_count - before
    for name in EVENT_MODES:
        if int(fired[modes == MODE_IDS[name]].min()) < 1:
            raise AssertionError(f"{name}: no event in the 20 ticks")
    print(f"[{card}] env step GPU vs CPU, the nine new modes with obstacles, "
          f"{modes.shape[0]}x8, 20 ticks spanning each mode's first event: "
          f"max_abs_err {worst:.3g} (rtol {STEP_TOL['rtol']}, atol "
          f"{STEP_TOL['atol']}), events fired {fired.tolist()}")
    fleet = make_dynamics_params(
        num_agents=8, per_drone=True, seed=3,
        dyn_sampler_1={"class": "RelativeSampler", "noise_ratio": 0.2})
    _agree_env_step(card, "per-drone fleet (RelativeSampler 0.2)",
                    FLAGSHIP_ENV, 16, touch=True, params=fleet)


def phase_surface(card: str) -> tuple:
    """The rest of the env: K1's per-drone form against its plain version,
    in turns with the shared form; every control mode on the card against
    the CPU and the Mellinger probe; the gym API through one whole episode
    at train.sh's config and with a per-drone fleet; the nine new scenario
    modes at 1024 x 8; the env step on the card against the CPU for the
    new modes and a per-drone fleet.  Returns (launch counts by path,
    K1's checks by form)."""
    import torch
    from quadswarm_tpu_torch.env.gym_api import (
        QuadrotorEnvMulti, make_quadrotor_env_multi)
    from quadswarm_tpu_torch.training import config as C

    t0 = time.perf_counter()
    shared, per_drone = _k1_forms(card)
    _control_modes(card)
    launches = {}
    env = make_quadrotor_env_multi(C.parse_swarm_cfg(train_sh_flags()))
    if (env.cfg.num_agents, env.cfg.quads_mode, env.cfg.use_downwash,
            env.device.type) != (8, "mix", True, "cuda"):
        raise AssertionError("the gym API's env is not train.sh's on the card")
    launches["gym-1x8"] = _gym_episode(
        card, "train.sh's config", lambda d: make_quadrotor_env_multi(
            C.parse_swarm_cfg(train_sh_flags() + [f"--device={d}"])).env,
        "K1")
    fleet = lambda d: QuadrotorEnvMulti(
        num_agents=8, quads_mode="mix", neighbor_visible_num=6,
        use_downwash=True, seed=1, device=d,
        dyn_sampler_1={"class": "RelativeSampler", "noise_ratio": 0.2})
    if not fleet("cpu").params.per_drone:
        raise AssertionError("not a per-drone fleet")
    launches["gym-perdrone-1x8"] = _gym_episode(
        card, "per-drone fleet (RelativeSampler 0.2)", fleet, "K1pd")
    launches["modes-1024x8"] = _new_modes(card)
    _agree_new_modes(card)
    torch.cuda.synchronize()
    print(f"[{card}] surface phase: {time.perf_counter() - t0:.1f} s")
    return launches, {"K1": shared, "K1pd": per_drone}


# ---------------------------------------------------------------------------
# bfloat16 compute (--model_dtype, --dtype) and mixed-policy PBT
# ---------------------------------------------------------------------------

# A bfloat16 model on the card against the same model in bfloat16 on the
# CPU: cuBLAS and the CPU sum their products in another order and round
# once or twice per layer, so a few bfloat16 ulps apart (the CPU tests hold
# the port to flax within the same bound).  The bfloat16 model against the
# float32 one on the card: bfloat16's rounding through the layers.
BF16_RTOL = 2e-2
BF16_F32_RTOL = 1e-1
# K1 on a bfloat16 state: kernel and plain version each compute in float32
# (within DYN_TOL of each other) and round to bfloat16, so one ulp apart.
BF16_K1_RTOL = 2.0 ** -7
BF16_ITERS = 2
BF16_TICKS = 100          # a turn of the env; 2 turns a dtype
BF16_AGREE_TICKS = 20


def _bf16_close(label: str, got, want, rtol: float = BF16_RTOL) -> float:
    """|got - want| <= rtol |want| + rtol max|want|, as floats; returns the
    largest difference over the largest entry."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    top = float(want.abs().max())
    err = (got - want).abs()
    if bool((err > rtol * want.abs() + rtol * top).any()):
        raise AssertionError(f"{label}: differs by {float(err.max())} "
                             f"(largest entry {top}, rtol {rtol})")
    return float(err.max()) / max(top, 1e-30)


def _bf16_model(card: str) -> None:
    """train.sh's actor-critic at B = 8,192: bfloat16 on the card against
    bfloat16 on the CPU and against float32 on the card; the two forwards
    timed in turns."""
    import copy
    import torch
    from quadswarm_tpu_torch.models.encoders import set_compute_dtype
    from quadswarm_tpu_torch.training import config as C

    args = C.parse_swarm_cfg(train_sh_flags() + ["--model_dtype=bfloat16"])
    env_cfg = C.env_config_from_args(args)
    torch.manual_seed(0)
    cpu = C.model_from_args(args, env_cfg, device="cpu")
    if cpu.dtype != torch.bfloat16 or {p.dtype for p in cpu.parameters()} \
            != {torch.float32}:
        raise AssertionError("the bfloat16 model's parameters are not float32")
    gpu = copy.deepcopy(cpu).cuda()
    gpu32 = copy.deepcopy(gpu)
    set_compute_dtype(gpu32, torch.float32)
    obs = 2 * torch.randn((8192, env_cfg.obs_dim),
                          generator=torch.Generator().manual_seed(3))
    obs_gpu = obs.cuda()
    with torch.no_grad():
        want, got, ref = cpu(obs), gpu(obs_gpu), gpu32(obs_gpu)
        if (got[0].dtype, got[1].dtype, got[2].dtype) != (
                torch.bfloat16, torch.float32, torch.bfloat16):
            raise AssertionError("the bfloat16 model's output dtypes")
        vs_cpu = max(_bf16_close(f"bf16 model {k} card vs CPU", g, w)
                     for k, g, w in zip(("mean", "log_std", "value"), got,
                                        want))
        vs_f32 = max(_bf16_close(f"bf16 model {k} vs float32", g, w,
                                 BF16_F32_RTOL)
                     for k, g, w in zip(("mean", "log_std", "value"), got,
                                        ref))
        times = {"bf16": [], "f32": []}
        for which in ("bf16", "f32", "f32", "bf16"):
            model = gpu if which == "bf16" else gpu32
            times[which].append(cuda_time_ms(lambda: model(obs_gpu), 50))
    print(f"[{card}] bf16 actor-critic (train.sh's, B=8,192): card vs CPU "
          f"largest difference {vs_cpu:.3g} of the largest entry (bound "
          f"rtol {BF16_RTOL} + {BF16_RTOL} of it); vs float32 on the card "
          f"{vs_f32:.3g} (bound {BF16_F32_RTOL}); forward in turns "
          f"bf16/f32/f32/bf16: bf16 {times['bf16'][0]:.3f}, "
          f"{times['bf16'][1]:.3f} ms, float32 {times['f32'][0]:.3f}, "
          f"{times['f32'][1]:.3f} ms (CUDA events, 50 calls)")


def _bf16_trainer(card: str) -> dict:
    """train.sh's Trainer with --model_dtype=bfloat16 for BF16_ITERS
    iterations in turns with BF16_ITERS float32 ones (bf16 alone first,
    then f32, f32, bf16): split, ms a minibatch, finite losses, K1 128 an
    iteration, one sync a tick, peak memory.  Returns the bfloat16
    iterations' launch counts."""
    import torch

    bf16 = _flagship_trainer(argv=train_sh_flags()
                             + ["--model_dtype=bfloat16"])
    if bf16.model.dtype != torch.bfloat16 or bf16.env_cfg.dtype != \
            torch.float32:
        raise AssertionError("the bf16 trainer is not at --model_dtype=bf16")
    total = _counts()
    walls = {"bf16": [], "f32": []}

    def turn(which, trainer):
        counts, wall, _ = _iterations(card, f"train {which}", trainer, 1)
        walls[which] += wall
        if which == "bf16":
            for kid in total:
                total[kid] += counts[kid]

    turn("bf16", bf16)
    f32 = _flagship_trainer()
    turn("f32", f32)
    turn("f32", f32)
    turn("bf16", bf16)
    if not all(p.dtype == torch.float32 for p in bf16.model.parameters()):
        raise AssertionError("bf16 trainer: parameters left float32")
    print(f"[{card}] train bf16 against float32 in turns (bf16 first alone,"
          f" then both resident): bf16 {walls['bf16']} s, float32 "
          f"{walls['f32']} s an iteration")
    del bf16, f32
    _free()
    return total


def _bf16_agree(card: str, cfg, params, states) -> None:
    """BF16_AGREE_TICKS ticks of the bfloat16 env step on the card against
    the CPU, both from the CPU state each tick with the same draws (in
    bfloat16, as the env's generator makes them).  Every float leaf within
    BF16_RTOL of its largest entry; neighbour slots of two drones whose
    bfloat16 metrics tie may swap, so up to ROUTE_SWAPS of the observation
    rows may differ beyond that."""
    import torch
    from quadswarm_tpu_torch.env.multi import batched_env_step
    from quadswarm_tpu_torch.utils.struct import leaves, map_fields

    e, n = states.tick.shape[0], cfg.num_agents
    gen = torch.Generator().manual_seed(9)
    bf = lambda x: x.to(torch.bfloat16)
    worst, swapped = 0.0, 0
    for _ in range(BF16_AGREE_TICKS):
        actions = torch.rand((e, n, 4), generator=gen) * 2 - 1
        draws = {k: ({kk: bf(vv) for kk, vv in v.items()}
                     if isinstance(v, dict) else bf(v))
                 for k, v in _draws(e, n, gen).items()}
        cpu = batched_env_step(cfg, params, states, actions, None, draws)
        gpu = batched_env_step(cfg, params, _to_cuda(states), actions.cuda(),
                               None, _to_cuda(draws))
        for (name, g), (_, c) in zip(leaves(gpu[0]), leaves(cpu[0])):
            g = g.cpu()
            if g.dtype != c.dtype:
                raise AssertionError(f"bf16 env {name}: dtype {g.dtype} on "
                                     f"the card, {c.dtype} on the CPU")
            if g.is_floating_point():
                worst = max(worst, _bf16_close(f"bf16 env {name}", g, c))
            elif not torch.equal(g, c):
                raise AssertionError(f"bf16 env {name}: card and CPU differ")
        g_obs, c_obs = gpu[1].cpu().float(), cpu[1].float()
        top = float(c_obs.abs().max())
        bad = ((g_obs - c_obs).abs() > BF16_RTOL * (c_obs.abs() + top)).any(
            -1)
        swapped += int(bad.sum())
        if bad.sum() > ROUTE_SWAPS * bad.numel():
            raise AssertionError(f"bf16 env obs: {int(bad.sum())} of "
                                 f"{bad.numel()} rows differ")
        worst = max(worst, _bf16_close("bf16 env reward", gpu[2], cpu[2]))
        states = cpu[0]
    print(f"[{card}] bf16 env step card vs CPU, {e}x{n}, "
          f"{BF16_AGREE_TICKS} ticks: largest difference {worst:.3g} of a "
          f"leaf's largest entry (bound rtol {BF16_RTOL} + {BF16_RTOL} of "
          f"it); observation rows beyond it (neighbour slots swapped at a "
          f"bfloat16 tie) {swapped}")


def _bf16_env(card: str) -> tuple:
    """--dtype=bfloat16 with train.sh's flags at 1024 x 8: ms a tick in
    turns with float32 (bf16, f32, f32, bf16, BF16_TICKS ticks each), the
    event table float32, K1 on the bfloat16 state against its plain
    version, the env step on the card against the CPU.  Returns (the
    bfloat16 turns' launch counts, K1's check)."""
    import torch
    from quadswarm_tpu_torch.env.multi import batched_env_step, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.training import config as C

    envs = {}
    for which, extra in (("bf16", ["--dtype=bfloat16"]), ("f32", [])):
        cfg = C.env_config_from_args(C.parse_swarm_cfg(
            train_sh_flags() + extra))
        params = make_dynamics_params(dt=cfg.dt)
        gen = torch.Generator("cuda").manual_seed(4)
        states, _ = env_reset(cfg, params, gen, 1024, device="cuda")
        envs[which] = [cfg, params, gen, states]
    cfg16, params16, _, states16 = envs["bf16"]
    if states16.dyn.pos.dtype != torch.bfloat16 or \
            states16.scenario.goals.dtype != torch.bfloat16:
        raise AssertionError("the bf16 env's state is not bfloat16")
    if states16.scenario.events.dtype != torch.float32:
        raise AssertionError("the event table is not float32")
    total = _counts()
    ms = {"bf16": [], "f32": []}
    for which in ("bf16", "f32", "f32", "bf16"):
        cfg, params, gen, states = envs[which]
        act = torch.zeros((1024, 8, 4), device="cuda")
        torch.cuda.synchronize()
        _reset_counts()
        with SyncCounter() as syncs:
            t0 = time.perf_counter()
            for _ in range(BF16_TICKS):
                actions = act.uniform_(-1, 1, generator=gen)
                states, obs, rew, *_ = batched_env_step(
                    cfg, params, states, actions, gen)
            torch.cuda.synchronize()
        ms[which].append((time.perf_counter() - t0) / BF16_TICKS * 1e3)
        counts = _read_counts()
        if counts != _counts(K1=BF16_TICKS) or syncs.implicit != BF16_TICKS:
            raise AssertionError(f"bf16 env {which}: launches {counts}, "
                                 f"{syncs.implicit} syncs")
        if (obs.dtype, rew.dtype) != ((torch.bfloat16, torch.float32)
                                      if which == "bf16"
                                      else (torch.float32, torch.float32)):
            raise AssertionError(f"bf16 env {which}: obs {obs.dtype}, "
                                 f"reward {rew.dtype}")
        _finite(f"{which} env obs", obs)
        envs[which][3] = states
        if which == "bf16":
            for kid in total:
                total[kid] += counts[kid]
    states16 = envs["bf16"][3]
    if states16.scenario.events.dtype != torch.float32 or \
            states16.dyn.pos.dtype != torch.bfloat16:
        raise AssertionError("the bf16 env's dtypes changed on the way")
    print(f"[{card}] bf16 env (--dtype=bfloat16, train.sh's flags, 1024x8, "
          f"{BF16_TICKS} random-action ticks a turn, one sync a tick): bf16 "
          f"{ms['bf16'][0]:.2f}, {ms['bf16'][1]:.2f} ms a tick; float32 "
          f"{ms['f32'][0]:.2f}, {ms['f32'][1]:.2f} ms a tick (in turns "
          "bf16/f32/f32/bf16); event table float32, goals bfloat16")
    check = check_on_env_state(card, "bf16 env state", states16, cfg16,
                               params16)
    cpu_states = _to_cpu(states16)
    _bf16_agree(card, cfg16, params16, cpu_states)
    return total, check


def _to_cpu(x):
    from quadswarm_tpu_torch.utils.struct import map_fields
    return map_fields(lambda t: t.cpu(), x)


def phase_bf16(card: str) -> tuple:
    """bfloat16 compute: the model (--model_dtype=bfloat16), train.sh's
    Trainer with it in turns with float32, and the bfloat16 env
    (--dtype=bfloat16).  Returns (launch counts by path, K1's check on the
    bfloat16 state)."""
    t0 = time.perf_counter()
    _bf16_model(card)
    launches = {"train-bf16-1024x8": _bf16_trainer(card)}
    launches["env-bf16-1024x8"], check = _bf16_env(card)
    print(f"[{card}] bf16 phase: {time.perf_counter() - t0:.1f} s")
    return launches, check


MIXED_ITERS = 2


def _mixed_round(card: str, runner) -> None:
    """A round with injected objectives (policy p scores p): each of the
    bottom two adopts a top policy's slices, equal bit for bit, in storage
    of its own."""
    import torch

    runner.objective_hist = [[float(p)] for p in range(8)]
    params = list(runner.heads.params.values())
    before = [p.detach().clone() for p in params]
    runner.pbt_round()
    pairs = []
    for b in (0, 1):
        src = [s for s in (6, 7) if all(torch.equal(p[b], p[s])
                                        for p in params)]
        if len(src) != 1:
            raise AssertionError(f"mixed round: policy {b} from {src}")
        s = src[0]
        for p, old in zip(params, before):
            st = runner.optimizer.state[p]
            if not (torch.equal(st["exp_avg"][b], st["exp_avg"][s])
                    and torch.equal(st["exp_avg_sq"][b], st["exp_avg_sq"][s])
                    and torch.equal(p[s], old[s])):
                raise AssertionError(f"mixed round: policy {b}'s moments")
            if p[b].data_ptr() == p[s].data_ptr():
                raise AssertionError("mixed round: shared storage")
        if runner.norm_state is not None and not torch.equal(
                runner.norm_state.obs.mean[b], runner.norm_state.obs.mean[s]):
            raise AssertionError("mixed round: normalizer")
        pairs.append((b, s))
    print(f"[{card}] mixed round (objectives 0..7): adoptee <- source "
          f"{pairs}; weights and Adam moments equal bit for bit, each in "
          "its own slice; coefficients "
          f"{[runner.coeffs[b] for b, _ in pairs]}")


def _mixed_heads_agree(card: str, runner) -> None:
    """The rollout's routed heads (8 policies, each on its own group of
    the 4,096 agents of the env batch) on the card against the CPU on the
    same weights."""
    import copy
    import torch
    from quadswarm_tpu_torch.parallel.pbt_mixed import (
        group_rows, select_grouped)

    cpu = copy.copy(runner.heads)
    cpu.params = {k: v.detach().cpu() for k, v in runner.heads.params.items()}
    cpu.buffers = {k: v.cpu() for k, v in runner.heads.buffers.items()}
    obs = runner.obs.reshape(-1, runner.obs.shape[-1])
    sel = runner.assignment.reshape(-1)
    p_count = runner.num_policies
    with torch.no_grad():
        groups = group_rows(sel, p_count)
        got = runner.heads.forward_routed(obs, groups)
        cpu_groups = group_rows(sel.cpu(), p_count)
        want = cpu.forward_routed(obs.cpu(), cpu_groups)
    worst = max(_close_to_cpu(f"mixed heads {k}", select_grouped(g, groups),
                              select_grouped(w, cpu_groups))
                for k, g, w in zip(("mean", "log_std", "value"), got, want))
    print(f"[{card}] mixed routed heads (8 policies, groups of "
          f"{list(groups.counts)} rows in a capacity of {groups.cap}) on the "
          f"card against the CPU: largest difference {worst:.3g} of the "
          f"largest entry (rtol {CARD_RTOL} + {CARD_TOP} of it)")


def phase_mixed(card: str, train_dir: str) -> tuple:
    """runs/pbt_quads_multi_obstacles' flags plus
    --pbt_mix_policies_in_one_env=True at full width (8 policies sharing
    512 envs x 8 x 128): MIXED_ITERS iterations (split, agent-steps/s, K1
    128 an iteration, syncs, peak with 8 stacked policies), a round with
    injected objectives, the routed heads on the card against the CPU, K1
    on the state reached; then the CLI's mixed branch at a small width,
    which writes 8 checkpoints and pbt_state.json and resumes.  Returns
    the iterations' launch counts and K1's check."""
    import inspect
    import shlex
    import torch
    from pathlib import Path
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.parallel import pbt_mixed as M
    from quadswarm_tpu_torch.parallel.pbt_mixed import MixedPBTRunner
    from quadswarm_tpu_torch.runs import pbt_quads_multi_obstacles as run
    from quadswarm_tpu_torch.training import config as C

    t0 = time.perf_counter()
    (name, cmd), = run.RUN_DESCRIPTION.commands(train_dir)
    flags = shlex.split(cmd)[3:] + ["--pbt_mix_policies_in_one_env=True"]
    args = C.parse_swarm_cfg(flags)
    env_cfg = C.env_config_from_args(args)
    ppo = C.ppo_config_from_args(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner = MixedPBTRunner(
        env_cfg, ppo, lambda: C.model_from_args(args, env_cfg, device="cuda"),
        make_dynamics_params(dt=env_cfg.dt), C.pbt_config_from_args(args),
        seed=args.seed, exp_dir=str(Path(train_dir) / name),
        base_rew_coeff=C.base_rew_coeff_from_args(args), device="cuda")
    e, n, t = ppo.num_envs, env_cfg.num_agents, ppo.rollout
    if (runner.num_policies, e, n, t, ppo.batch_size,
            ppo.replay_sample_prob, env_cfg.obs_dim) != (
            8, 512, 8, 128, 1024, 0.75, 69):
        raise AssertionError(f"{name} is not the PBT run's configuration")
    print(f"[{card}] mixed: {name} + --pbt_mix_policies_in_one_env=True, 8 "
          f"stacked policies, {torch.cuda.memory_allocated() / 2**20:,.0f} "
          "MiB allocated after construction")
    src, first = inspect.getsourcelines(M.group_rows)
    read_site = "pbt_mixed.py:%d" % (
        first + next(i for i, x in enumerate(src) if ".tolist()" in x))
    total = _counts()
    for it in range(MIXED_ITERS):
        _reset_counts()
        t1 = time.perf_counter()
        with SyncCounter() as syncs:
            metrics, infos = runner.iteration()
        wall = time.perf_counter() - t1
        counts = _read_counts()
        for kid in total:
            total[kid] += counts[kid]
        if counts != _counts(K1=t):
            raise AssertionError(f"mixed iteration {it}: launches {counts}")
        losses = metrics["loss"].tolist()
        if len(losses) != 8 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"mixed iteration {it}: losses {losses}")
        # one a tick (the episode ends), one an iteration (the objectives
        # read for the PBT window), and the grouping's read of the counts:
        # at the rollout's start and after each tick some episode ended
        ends = int(infos["episode_done"].any(-1).sum())
        grouping = syncs.by_site[read_site]
        if syncs.implicit != t + 2 + ends or grouping != 1 + ends:
            raise AssertionError(f"mixed iteration {it}: {syncs.implicit} "
                                 f"syncs with {ends} ticks ending episodes, "
                                 f"at {dict(syncs.by_site)}")
        sec = runner.seconds
        steps = e * n * t // ppo.batch_size
        print(f"[{card}] mixed iteration {it} (8 policies, {e}x{n} x {t}, "
              f"batch {ppo.batch_size}, replay {ppo.replay_sample_prob}): "
              f"{wall:.3f} s = rollout {sec['rollout']:.3f} s + learner "
              f"{sec['learner']:.3f} s ({sec['learner'] / steps * 1e3:.3f} ms "
              f"per stacked minibatch step of 8 policies); "
              f"{e * n * t / wall:,.0f} training agent-steps/s; losses "
              f"{[round(x, 4) for x in losses]}; K1 launches {counts['K1']}; "
              f"{syncs.implicit} device-to-host syncs ("
              f"{syncs.implicit / t:.3f} per tick; {ends} ticks ended "
              f"episodes; by site {dict(syncs.by_site)}); peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:,.0f} MiB with 8 "
              "stacked policies")
    _mixed_round(card, runner)
    _mixed_heads_agree(card, runner)
    check = check_on_env_state(card, "mixed state", runner.env_states,
                               env_cfg, runner.dyn_params)
    del runner
    _free()

    small = ["--num_envs=32", "--rollout=16", "--log_every_iters=1",
             f"--train_dir={train_dir}", "--experiment=mixed"]
    step = 32 * 8 * 16
    outs = [_train_cli(flags + small + [f"--train_for_env_steps={k * step}"])
            for k in (1, 2)]
    exp = Path(train_dir) / "mixed"
    cps = {p: sorted(x.name for x in (exp / f"checkpoint_p{p}").iterdir())
           for p in range(8)}
    meta = json.loads((exp / "pbt_state.json").read_text())
    if cps != {p: [f"checkpoint_{k * step:012d}.pt" for k in (1, 2)]
               for p in range(8)} or meta["env_steps"] != 2 * step or \
            "resumed mixed PBT" not in outs[1][0]:
        raise AssertionError(f"mixed CLI: checkpoints {cps}")
    print(f"[{card}] mixed CLI (the run's flags, 8 policies x 32 envs x 16 "
          f"ticks): {outs[0][1]:.1f} s, then resumed for a second iteration "
          f"in {outs[1][1]:.1f} s (processes, start-up included); "
          f"checkpoint_p0..p7 and pbt_state.json at {meta['env_steps']} env "
          "steps")
    print(f"[{card}] mixed phase: {time.perf_counter() - t0:.1f} s")
    return total, check


# ---------------------------------------------------------------------------
# Training on more than one rank (parallel/mesh.py, parallel/distributed.py)
# ---------------------------------------------------------------------------

DIST_ITERS = 2
DIST_STEPS = 4            # learner steps checked, as `_learner_agree`'s
DIST_APPO_ROLLOUT = 16    # the split's depth, cut from 128
DIST_RESULT = "DIST_RESULT "
SCALING_ARGS = ["--mode", "fixed", "--devices", "1,2", "--total_envs", "1024",
                "--rollout", "16", "--iters", "2", "--repeats", "2"]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(card: str, part: str, world: int, timeout: int = 300) -> list:
    """`world` ranks of `chip_smoke.py --dist_worker <part>`, started with
    torchrun's variables on this host; their lines are echoed, and each
    rank's result (its DIST_RESULT line) returned.  Each rank writes to a
    file of its own (a pipe read one rank at a time could fill and stall
    a rank inside a collective), echoed also when a rank fails."""
    import os
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root), "PYTHONUNBUFFERED": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
           "QS_CARD": card}
    with tempfile.TemporaryDirectory() as tmp:
        logs = [Path(tmp) / f"rank{r}.log" for r in range(world)]
        procs = []
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--dist_worker", part], cwd=root, stdout=f,
                    stderr=subprocess.STDOUT,
                    env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = [log.read_text() for log in logs]
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = out.splitlines()
        for line in lines:
            if not line.startswith(DIST_RESULT):
                print(line if line.startswith("[") else f"  rank {r}: {line}")
        if p.returncode:
            raise AssertionError(f"dist {part} rank {r} exited "
                                 f"{p.returncode} (killed after {timeout} s "
                                 "if negative)")
        results.append(json.loads(next(
            ln for ln in lines if ln.startswith(DIST_RESULT))[
                len(DIST_RESULT):]))
    return results


def _dist_init(flags: list):
    """The train CLI's start of a multi-rank job: the flags with
    --multi_host=True, `init_distributed` before the card is touched, the
    world's mesh."""
    from quadswarm_tpu_torch.parallel.distributed import init_distributed
    from quadswarm_tpu_torch.parallel.mesh import make_mesh
    from quadswarm_tpu_torch.training import config

    argv = flags + ["--multi_host=True"]
    args = config.parse_swarm_cfg(argv)
    if not args.multi_host:
        raise AssertionError("--multi_host did not parse")
    init_distributed(device=args.device)
    return argv, make_mesh(device=args.device)


def _params_equal_across_ranks(mesh, model) -> bool:
    """Whether every rank of a gloo mesh holds rank 0's parameters bit for
    bit."""
    import torch
    import torch.distributed as dist
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=mesh.ranks[0], group=mesh.group)
    same = torch.tensor([int(torch.equal(flat, ref))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(same.item())


def _learner_vs_one_process(card: str, label: str, mesh, weights: dict,
                            cfg, traj, adv, ret) -> None:
    """DIST_STEPS minibatch steps of the mesh's learner (each rank its envs
    of `traj`, the global layout, one set of permutations) against the
    learner of one process over the whole `traj` from the same weights:
    the first minibatch's averaged gradient within rtol GRAD_RTOL plus
    GRAD_ATOL of the model's largest entry, the parameters after
    DIST_STEPS steps within the learning rate (the learner check's bounds).
    Every rank takes part; rank 0 compares."""
    import copy
    import torch
    from quadswarm_tpu_torch.parallel import ppo as P
    from quadswarm_tpu_torch.parallel.mesh import shard_env_batch

    dims = tuple(traj.reward.shape)
    lay = P.minibatch_layout(dims, cfg.batch_size, cfg.sgd_shuffle_groups)
    gen = torch.Generator(traj.obs.device).manual_seed(31)
    perms = torch.stack([torch.randperm(lay.num_chunks, generator=gen,
                                        device=traj.obs.device)
                         for _ in range(lay.groups)])
    full = (traj.obs, traj.actions, traj.log_prob, traj.value, adv, ret)
    part = tuple(shard_env_batch(mesh, x, axis=1) for x in full)
    runs = [("mesh", mesh, P.shuffled_minibatches(
        part, dims, cfg.batch_size, None, cfg.sgd_shuffle_groups, perms,
        shard=(mesh.rank, mesh.world)))]
    if mesh.is_main:
        runs.append(("one", None, P.shuffled_minibatches(
            full, dims, cfg.batch_size, None, cfg.sgd_shuffle_groups, perms)))
    models, grads = {}, {}
    for name, m, batched in runs:
        model = models[name] = copy.deepcopy(weights["model"])
        model.load_state_dict(weights["state"])
        opt = P.make_optimizer(model, cfg)
        for i in range(DIST_STEPS):
            loss, _ = P.ppo_loss(model, cfg, tuple(x[i] for x in batched),
                                 mesh=m)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            g = [p.grad for p in model.parameters()]
            if m is not None:
                P.all_reduce_grads_(m, g)
            if i == 0:
                grads[name] = [x.clone() for x in g]
            P.clip_by_global_norm_(g, cfg.max_grad_norm)
            opt.step()
    if not mesh.is_main:
        return
    top = max(float(g.abs().max()) for g in grads["one"])
    grad_err = 0.0
    for (pname, _), g, w in zip(models["one"].named_parameters(),
                                grads["mesh"], grads["one"]):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        if err > GRAD_RTOL * scale + GRAD_ATOL * top:
            raise AssertionError(f"{label}: gradient of {pname} differs by "
                                 f"{err} (largest entry {scale}, of the "
                                 f"model {top})")
        grad_err = max(grad_err, err / (scale + top))
    diffs = torch.cat([(a.detach() - b.detach()).abs().flatten() for a, b in
                       zip(models["mesh"].parameters(),
                           models["one"].parameters())])
    worst = float(diffs.max())
    print(f"[{card}] {label}: the {mesh.world}-rank learner against one "
          f"process on the same trajectory {dims} (batch {cfg.batch_size}, "
          f"{lay.groups} env groups, the same permutations): the first "
          f"minibatch's gradients within {grad_err:.3g} of each tensor's "
          f"largest entry plus the model's (rtol {GRAD_RTOL}, atol "
          f"{GRAD_ATOL} of {top:.3g}); after {DIST_STEPS} steps parameters "
          f"max_abs_err {worst:.3g} (atol lr = {cfg.learning_rate}), "
          f"{int((diffs > 1e-6).sum())} of {diffs.numel()} beyond 1e-6")
    if worst > cfg.learning_rate:
        raise AssertionError(f"{label}: parameters differ by {worst}")


def _weights(model) -> dict:
    import copy
    return {"model": copy.deepcopy(model),
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()}}


def _dist_world_of_one(card: str) -> dict:
    """(a) A 1-rank NCCL world at train.sh's full width, in turns with the
    one-card Trainer from the same seed: K1, syncs and times of each
    iteration, the first rollout bit for bit, the learner within PR 5's
    bounds on that rollout."""
    import torch
    import torch.distributed as dist
    from quadswarm_tpu_torch.parallel import ppo as P
    from quadswarm_tpu_torch.parallel.mesh import local_mesh

    argv, mesh = _dist_init(train_sh_flags())
    if (mesh.world, dist.get_backend()) != (1, "nccl"):
        raise AssertionError(f"world {mesh.world}, {dist.get_backend()}")
    rollouts = []
    collect = P.collect_rollout

    def spy(*a, **k):
        out = collect(*a, **k)
        if len(rollouts) < 2:
            rollouts.append(out[3])
        return out

    P.collect_rollout = spy
    one = _flagship_trainer(argv=argv, mesh=local_mesh())
    ranked = _flagship_trainer(argv=argv, mesh=mesh)
    if ranked.ppo_cfg.num_envs != 1024 or ranked.env_states.dyn.pos.shape[
            0] != 1024 or one.mesh.distributed or not ranked.mesh.distributed:
        raise AssertionError("not train.sh's width on a world of one")
    weights = _weights(one.model)
    counts, walls = _counts(), {"one": [], "nccl": []}
    for it in range(DIST_ITERS):
        walls["one"] += _iterations(card, f"dist one card #{it}", one, 1)[1]
        c, w, _ = _iterations(card, f"dist NCCL world of one #{it}", ranked,
                              1)
        counts = {k: counts[k] + c[k] for k in counts}
        walls["nccl"] += w
        if it == 0:
            a, b = rollouts
            same = [f for f, x, y in zip(a._fields, a, b)
                    if torch.equal(x, y)]
            if len(same) != len(a):
                raise AssertionError(f"first rollouts differ: equal {same}")
            print(f"[{card}] dist world of one: the first rollout equals the "
                  f"one-card Trainer's bit for bit ({', '.join(same)}; "
                  f"{tuple(a.obs.shape)} observations)")
    P.collect_rollout = collect
    print(f"[{card}] dist world of one against one card, in turns "
          f"(train.sh, 1024x8 x 128): NCCL "
          f"{[round(x, 3) for x in walls['nccl']]} s, one card "
          f"{[round(x, 3) for x in walls['one']]} s")
    traj, cfg = rollouts[1], ranked.ppo_cfg
    del one, ranked
    _free()
    with torch.no_grad():
        last = torch.zeros_like(traj.value[0])
        adv, ret = P.compute_gae(traj, last, cfg.gamma, cfg.gae_lambda)
    _learner_vs_one_process(card, "dist world of one (NCCL)", mesh, weights,
                            cfg, traj, adv, ret)
    return {"counts": counts, "walls": walls}


def _collective_ms(card: str, mesh, model, iters: int = 50) -> dict:
    """Host ms of a learner step's collectives on this mesh, each timed
    over `iters` calls that end in a device sync: the flat all-reduce of
    the model's gradients (`all_reduce_grads_`) and a scalar all-reduce
    (`all_sum`, as the advantage statistics take two a step)."""
    import torch
    from quadswarm_tpu_torch.parallel.mesh import all_reduce_grads_, all_sum
    grads = [torch.ones_like(p) for p in model.parameters()]
    scalar = torch.ones((), device=mesh.device)
    out = {}
    for name, fn in (("grads", lambda: all_reduce_grads_(mesh, grads)),
                     ("scalar", lambda: all_sum(mesh, scalar))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / iters * 1e3
    n = sum(g.numel() for g in grads)
    print(f"[{card}] dist {mesh.world} ranks sharing the card, rank "
          f"{mesh.rank}: the gradient all-reduce of {n:,} float32 "
          f"{out['grads']:.3f} ms, a scalar all-reduce {out['scalar']:.3f} "
          f"ms (gloo over CUDA tensors, {iters} calls each)")
    return out


def _fixed_trajectory(device):
    """_learner_agree's flagship-width trajectory, made on the card from a
    seed: (8, 16, 8) with 54-wide observations."""
    import torch
    from quadswarm_tpu_torch.parallel import ppo as P
    gen = torch.Generator(device).manual_seed(31)
    t, e, n, dim = 8, 16, 8, 54
    f = lambda *s: torch.randn((t, e, n) + s, generator=gen, device=device)
    traj = P.Transition(obs=f(dim), actions=f(4), log_prob=f() - 5.0,
                        value=f(), reward=f(), done=f() > 1.5)
    return traj, f(), f()


def _dist_shared(card: str) -> dict:
    """(b) 2 ranks sharing the card (gloo over CUDA tensors), train.sh's
    flags at 2 x 512 envs: DIST_ITERS iterations with the weights equal bit
    for bit across the ranks after each, K1 128 launches an iteration on
    each rank; then the 2-rank learner against one process on a fixed
    trajectory."""
    import torch
    import torch.distributed as dist
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.parallel import ppo as P

    argv, mesh = _dist_init(train_sh_flags())
    if (mesh.world, dist.get_backend()) != (2, "gloo"):
        raise AssertionError(f"world {mesh.world}, {dist.get_backend()}")
    trainer = _flagship_trainer(argv=argv, mesh=mesh)
    ppo, t = trainer.ppo_cfg, trainer.ppo_cfg.rollout
    e = trainer.env_states.dyn.pos.shape[0]
    if (ppo.num_envs, e, ppo.sgd_shuffle_groups) != (1024, 512, 32):
        raise AssertionError(f"{e} of {ppo.num_envs} envs, groups "
                             f"{ppo.sgd_shuffle_groups}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, walls, equal = _counts(), [], []
    for it in range(DIST_ITERS):
        # no sync counter here: gloo's worker threads copy CUDA tensors to
        # the host, and the debug mode would report each copy on stderr
        _reset_counts()
        t0 = time.perf_counter()
        metrics, infos = trainer.iteration()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        c = _read_counts()
        counts = {k: counts[k] + c[k] for k in counts}
        if c != _counts(K1=t):
            raise AssertionError(f"rank {mesh.rank} iteration {it}: {c}")
        m = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"rank {mesh.rank} iteration {it}: {m}")
        equal.append(_params_equal_across_ranks(mesh, trainer.model))
        sec = trainer.seconds
        print(f"[{card}] dist 2 ranks sharing the card, rank {mesh.rank} "
              f"iteration {it} ({e}x8 x {t} a rank, global batch "
              f"{ppo.batch_size}): {walls[-1]:.3f} s = rollout "
              f"{sec['rollout']:.3f} s + learner {sec['learner']:.3f} s "
              f"({sec['learner'] / (1024 * 8 * t // ppo.batch_size) * 1e3:.3f}"
              f" ms per minibatch step); {2 * e * 8 * t / walls[-1]:,.0f} "
              f"training agent-steps/s of the world; loss {m['loss']:.5g}; "
              f"K1 launches {c['K1']}; weights equal across the ranks: "
              f"{equal[-1]}; peak "
              f"allocated {torch.cuda.max_memory_allocated() / 2**20:,.0f} "
              "MiB")
        if not equal[-1]:
            raise AssertionError(f"iteration {it}: the ranks' weights differ")
    stats = trainer.episode_stats(infos)
    collectives = _collective_ms(card, mesh, trainer.model)
    del trainer
    _free()
    traj, adv, ret = _fixed_trajectory(mesh.device)
    torch.manual_seed(31)
    model = ActorCritic(num_neighbors=6, rnn_size=256, neighbor_hidden=256,
                        device=mesh.device)
    _learner_vs_one_process(
        card, "dist 2 ranks sharing the card (gloo)", mesh, _weights(model),
        P.PPOConfig(batch_size=256, sgd_shuffle_groups=32), traj, adv, ret)
    return {"counts": counts, "walls": walls, "equal": equal,
            "episodes": stats.get("num_episodes", 0),
            "collectives_ms": collectives}


def _field_sums(traj, last_obs) -> list:
    """Each field's sum and sum of squares in float64, in one layout."""
    return [float(f(x.double().contiguous()).sum()) for x in (*traj, last_obs)
            for f in (lambda y: y, lambda y: y * y)]


def _dist_appo_split(card: str) -> dict:
    """(c) --async_rl=True --appo_split_devices=1,1 on 2 ranks sharing the
    card at --rollout=DIST_APPO_ROLLOUT: DIST_ITERS iterations; the env
    state only on rank 0 and the optimizer only on rank 1; the trajectory
    rank 1 received equals what rank 0 rolled out; the loss finite; on that
    trajectory the learner against the one-process APPO learner."""
    import torch
    import torch.distributed as dist
    from quadswarm_tpu_torch.parallel import appo as A
    from quadswarm_tpu_torch.parallel import ppo as P

    argv, mesh = _dist_init(train_sh_flags() + [
        "--async_rl=True", "--policy_lag=1", "--with_vtrace=True",
        "--appo_split_devices=1,1", f"--rollout={DIST_APPO_ROLLOUT}"])
    seen = {}
    learn, collect = A.appo_learn, A.collect_rollout

    def spy_learn(model, opt, cfg, traj, last_obs, gen, norm, m):
        seen.update(traj=traj, last=last_obs, weights=_weights(model),
                    norm=norm)
        return learn(model, opt, cfg, traj, last_obs, gen, norm, m)

    def spy_collect(*a, **k):
        out = collect(*a, **k)
        seen.update(traj=out[3], last=out[1])
        return out

    A.appo_learn, A.collect_rollout = spy_learn, spy_collect
    trainer = _flagship_trainer(argv=argv, mesh=mesh)
    rolls = mesh.rank == 0
    placed = (trainer.env_states is not None, trainer.optimizer is not None)
    if placed != ((True, False) if rolls else (False, True)):
        raise AssertionError(f"rank {mesh.rank}: env state, optimizer "
                             f"{placed}")
    counts, walls, t = _counts(), [], DIST_APPO_ROLLOUT
    for it in range(DIST_ITERS):
        _reset_counts()
        t0 = time.perf_counter()
        metrics, infos = trainer.iteration()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        c = _read_counts()
        counts = {k: counts[k] + c[k] for k in counts}
        if c != (_counts(K1=t) if rolls else _counts()):
            raise AssertionError(f"rank {mesh.rank} iteration {it}: {c}")
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"iteration {it}: loss {loss}")
        sums = [_field_sums(seen["traj"], seen["last"])]
        box = [sums[0] if rolls else None]
        dist.broadcast_object_list(box, src=0)
        if not rolls and box[0] != sums[0]:
            raise AssertionError(f"iteration {it}: the trajectory rank 1 "
                                 "received differs from rank 0's rollout")
        sec = trainer.seconds
        role = ("rollout: env state, behaviour queue" if rolls
                else "learner: optimizer, normalizer")
        print(f"[{card}] dist APPO split 1,1 rank {mesh.rank} ({role}) "
              f"iteration {it} ({trainer.ppo_cfg.num_envs}x8 x {t}): "
              f"{walls[-1]:.3f} s = "
              f"{sec['rollout']:.3f} s to the trajectory's arrival + "
              f"{sec['learner']:.3f} s to the weights' broadcast; loss "
              f"{loss:.5g}; K1 launches {c['K1']}; trajectory received "
              f"equal to the one sent: {rolls or box[0] == sums[0]}")
    if not rolls:
        cfg = trainer.ppo_cfg
        w = seen["weights"]
        model = w["model"]
        model.load_state_dict(w["state"])
        adv, ret = A.learner_targets(model, cfg, seen["traj"], seen["last"],
                                     seen["norm"])
        _learner_vs_one_process(card, "dist APPO split 1,1 learner",
                                trainer.mesh, w, cfg, seen["traj"], adv, ret)
    A.appo_learn, A.collect_rollout = learn, collect
    return {"counts": counts, "walls": walls}


def _dist_scaling(card: str) -> None:
    """(d) analysis/scaling.py at a small rollout: worlds of 1 and 2 ranks
    on the card, its JSON lines."""
    import os
    from pathlib import Path
    root = Path(__file__).resolve().parent
    out = subprocess.run(
        [sys.executable, "-m", "quadswarm_tpu_torch.analysis.scaling",
         *SCALING_ARGS], cwd=root, capture_output=True, text=True,
        timeout=400, env={**os.environ, "PYTHONPATH": str(root)})
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    for line in lines:
        print(f"[{card}] scaling {json.dumps(line)}")
    if out.returncode or len(lines) != 3 or lines[2][
            "learner_rows_scaling"] != {"1": 1.0, "2": 2.0}:
        raise AssertionError(f"scaling exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")


DIST_PARTS = {"one": _dist_world_of_one, "shared": _dist_shared,
              "split": _dist_appo_split}


def dist_worker(part: str) -> int:
    """One rank of a `dist` phase world (started by `_run_ranks`)."""
    import os
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = DIST_PARTS[part](os.environ["QS_CARD"])
    print(DIST_RESULT + json.dumps(result), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def phase_dist(card: str) -> dict:
    """Training on more than one rank: (a) a 1-rank NCCL world at train.sh's
    full width in turns with the one-card Trainer, (b) 2 ranks sharing the
    card over gloo, (c) APPO's split 1,1 on 2 ranks, (d) the scaling tool
    at worlds of 1 and 2.  Returns the launch counts of each path (rank 0's;
    each rank's are checked)."""
    t0 = time.perf_counter()
    _free()
    (one,) = _run_ranks(card, "one", 1)
    shared = _run_ranks(card, "shared", 2)
    split = _run_ranks(card, "split", 2)
    _dist_scaling(card)
    print(f"[{card}] dist phase: {time.perf_counter() - t0:.1f} s")
    return {"dist-1x1024x8": one["counts"],
            "dist-2x512x8-shared": shared[0]["counts"],
            "dist-appo-split-1+1": split[0]["counts"]}


# ---------------------------------------------------------------------------
# The tools: sim2real, debug checks, weight recycler, attention, rendering,
# profile_train
# ---------------------------------------------------------------------------

TOOLS_ROLLOUT = 16        # the sim2real sources' training depth, cut from 128
# The C forward against the card's: float32 both, TF32 off; the C sums in
# order, cuBLAS in blocks, and a 256-wide actor's layers sum up to 768
# products, so the 1e-5 / 2e-5 of the width-16 tests become 1e-4.
S2R_ATOL = 1e-4
S2R_ROWS = 1000
RECYCLE_B = 8192
RECYCLE_DORMANT = 16      # units of the self encoder's first layer silenced
RENDER_EPISODE_S = 5.0    # the render episode, cut from train.sh's 15 s
PROFILE_ARGS = ["--num_envs=1024", "--num_agents=8", "--rollout=128",
                "--batch_size=1024", "--iters=1"]
# profile_train's rollouts: one for the SGD phase's trajectory, then the
# delta method's warm-up, 1 and 1 + iters; and as many full iterations
PROFILE_ROLLOUTS = 5
PROFILE_ITERATIONS = 4


def _c_actor(src: str, workdir: str):
    """g++ -O2 -shared -fPIC of an exported source, loaded with ctypes;
    returns (evaluate(obs) -> (B, 4) numpy, g++ seconds)."""
    import ctypes
    import os
    import numpy as np

    lib_path = os.path.join(workdir, os.path.basename(src) + ".so")
    t0 = time.perf_counter()
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", lib_path, src],
                   check=True, capture_output=True, timeout=300)
    secs = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)

    class control(ctypes.Structure):        # the C's control_t_n
        _fields_ = [(f"thrust_{i}", ctypes.c_float) for i in range(4)]

    lib.networkEvaluate.argtypes = [ctypes.POINTER(control),
                                    ctypes.POINTER(ctypes.c_float)]
    lib.networkEvaluate.restype = None

    def evaluate(obs):
        out = np.zeros((obs.shape[0], 4), np.float32)
        for i, row in enumerate(obs.astype(np.float32)):
            ctrl = control()
            lib.networkEvaluate(ctypes.byref(ctrl),
                                (ctypes.c_float * row.size)(*row))
            out[i] = [getattr(ctrl, f"thrust_{j}") for j in range(4)]
        return out
    return evaluate, secs


def _together(commands: dict, timeout: int = 600) -> dict:
    """Python modules of the port, each in its own process, all started
    together (they share the card); name -> its wall seconds.  Raises if
    one exits non-zero."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=root, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, argv in commands.items()}
    secs = {}
    try:
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=timeout)
            secs[name] = time.perf_counter() - t0
            if proc.returncode:
                raise AssertionError(f"{name} exited {proc.returncode}: "
                                     f"{err[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return secs


def _tools_sim2real(card: str, train_dir: str) -> None:
    """(a) One training iteration (--rollout=16) of each sim2real source
    through the train CLI (both processes at once), the sim2real CLI's
    export (both at once), a g++ build, and networkEvaluate on S2R_ROWS
    observations against the port's mean action on the card."""
    import os
    import numpy as np
    import torch
    from quadswarm_tpu_torch.training import config as C
    from quadswarm_tpu_torch.utils.checkpoint import latest_checkpoint

    sources = {
        "single": ("single_quad_baseline", _run_flags("single_quad_baseline")),
        "attention": ("final obstacle run, --quads_sim2real=True",
                      _run_flags("obstacles.quads_multi_obstacles")
                      + ["--quads_sim2real=True"]),
    }
    exp_dir = {t: os.path.join(train_dir, f"s2r_{t}") for t in sources}
    out_dir = {t: os.path.join(train_dir, f"c_{t}") for t in sources}
    trains = {}
    for model_type, (_, flags) in sources.items():
        args = C.parse_swarm_cfg(flags)
        steps = TOOLS_ROLLOUT * args.num_envs * args.quads_num_agents
        trains[model_type] = ["quadswarm_tpu_torch.training.train", *flags,
                              f"--rollout={TOOLS_ROLLOUT}",
                              f"--train_for_env_steps={steps}",
                              f"--train_dir={train_dir}",
                              f"--experiment=s2r_{model_type}",
                              "--with_wandb=False"]
    train_s = _together(trains)
    export_s = _together({t: [
        "quadswarm_tpu_torch.sim2real.codegen", "--model_dir", exp_dir[t],
        "--output_dir", out_dir[t], "--model_type", t, "--testing", "True"]
        for t in sources}, timeout=300)
    for model_type, (label, _) in sources.items():
        src = os.path.join(out_dir[model_type], "model.c")
        evaluate, gxx_s = _c_actor(src, out_dir[model_type])
        cfg = C.load_cfg(exp_dir[model_type])
        env_cfg = C.env_config_from_args(cfg)
        model = C.model_from_args(cfg, env_cfg, device="cuda")
        model.load_state_dict(torch.load(
            latest_checkpoint(os.path.join(exp_dir[model_type],
                                           "checkpoint_p0")),
            map_location="cuda", weights_only=True)["model"])
        obs = np.random.default_rng(7).uniform(
            -1, 1, (S2R_ROWS, env_cfg.obs_dim)).astype(np.float32)
        t0 = time.perf_counter()
        c_out = evaluate(obs)
        c_s = time.perf_counter() - t0
        with torch.no_grad():
            mean, _, _ = model(torch.from_numpy(obs).cuda())
        err = float(np.abs(c_out - mean.cpu().numpy()).max())
        if not err <= S2R_ATOL:
            raise AssertionError(f"sim2real {model_type}: the C actor is "
                                 f"{err:.3g} from the card's (atol "
                                 f"{S2R_ATOL})")
        size = sum(p.numel() for p in model.actor_encoder.parameters()) + \
            sum(p.numel() for p in model.action_head.parameters())
        print(f"[{card}] sim2real {model_type} ({label}; obs "
              f"{env_cfg.obs_dim} wide, actor {size:,} parameters): train "
              f"CLI 1 iteration at --rollout={TOOLS_ROLLOUT} in "
              f"{train_s[model_type]:.1f} s (a process, beside the other "
              f"model type's); export CLI {export_s[model_type]:.2f} s (the "
              f"same), C source {os.path.getsize(src):,} bytes; g++ -O2 "
              f"{gxx_s:.2f} s; networkEvaluate on {S2R_ROWS} observations "
              f"{c_s * 1e3 / S2R_ROWS:.3f} ms each on the host; largest "
              f"difference from the port's mean action on the card "
              f"{err:.3g} (atol {S2R_ATOL}, TF32 off)")


def _tools_debug(card: str) -> None:
    """(b) checked_env_step at train.sh's env, 1024 x 8: healthy ticks pass
    with one sync each; a NaN written into one drone's position raises."""
    import torch
    from quadswarm_tpu_torch.env.multi import env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.training import config as C
    from quadswarm_tpu_torch.utils.debug import checked_env_step

    args = C.parse_swarm_cfg(train_sh_flags())
    cfg = C.env_config_from_args(args)
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator("cuda").manual_seed(3)
    e, ticks = args.num_envs, 10
    states, _ = env_reset(cfg, params, gen, e, device="cuda")
    step = checked_env_step(cfg, params)
    acts = torch.zeros((e, cfg.num_agents, 4), device="cuda")
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with SyncCounter() as syncs:
        for _ in range(ticks):
            err, (states, *_) = step(states, acts, gen)
            err.throw()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    if counts != _counts(K1=ticks) or syncs.implicit != ticks:
        raise AssertionError(f"checked step: launches {counts}, "
                             f"{syncs.implicit} syncs in {ticks} ticks at "
                             f"{syncs.where}")
    pos = states.dyn.pos.clone()
    pos[e // 2, 3, 1] = float("nan")
    err, _ = step(states.replace(dyn=states.dyn.replace(pos=pos)), acts, gen)
    try:
        err.throw()
    except ValueError as raised:
        message = str(raised)
    else:
        raise AssertionError("checked step: a NaN position did not raise")
    if "Debug this!" not in message:
        raise AssertionError(f"checked step raised {message!r}")
    nan_fields = _k1_keeps_nan(cfg, params, states.replace(
        dyn=states.dyn.replace(pos=pos)))
    print(f"[{card}] debug checked_env_step at {e}x{cfg.num_agents}: "
          f"{ticks} healthy ticks passed in {wall:.3f} s "
          f"({wall / ticks * 1e3:.2f} ms a tick), K1 launches {counts['K1']}, "
          f"{syncs.implicit} device-to-host syncs "
          f"({syncs.implicit / ticks:.0f} a tick: the finiteness checks and "
          f"the auto-reset's test in one read); a NaN in env {e // 2} "
          f"drone 3's position raised "
          f"ValueError({message!r}); K1 on that state keeps the NaN where "
          f"its plain version does ({nan_fields}), the other entries within "
          f"{TRAJ_TOL}")


def _k1_keeps_nan(cfg, params, states) -> str:
    """K1 against its plain version on a state with a NaN position, at
    hover thrust: NaN in the same entries, the rest within TRAJ_TOL.
    Returns the fields with a NaN.  The launch does not count."""
    import torch
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
    from quadswarm_tpu_torch.utils.struct import leaves, map_fields

    dyn = map_fields(lambda x: x.reshape((-1,) + x.shape[2:]), states.dyn)
    b = dyn.pos.shape[0]
    cmds = torch.full((b, 4), 0.5, device="cuda")
    ou = torch.zeros((b, 4), device="cuda")
    yaw = torch.zeros((b,), device="cuda")
    dcfg = cfg.dynamics_config(params.arm)
    before = dk.dynamics_tick_fused.launches
    got = dk.dynamics_tick_fused(params, dcfg, dyn, cmds, ou, yaw)
    dk.dynamics_tick_fused.launches = before
    want = dk.dynamics_tick_flat(params, dcfg, dyn, cmds, ou, yaw)
    with_nan = []
    for (name, g), (_, w) in zip(leaves(got), leaves(want)):
        if not g.is_floating_point():
            continue
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"K1 {name}: NaN in {int(g.isnan().sum())} "
                                 f"entries, the plain version in "
                                 f"{int(w.isnan().sum())}")
        if bool(w.isnan().any()):
            with_nan.append(name)
        if not torch.allclose(g, w, equal_nan=True, **TRAJ_TOL):
            raise AssertionError(f"K1 {name} on a NaN state: "
                                 f"{float((g - w).abs().nan_to_num().max())}"
                                 " from the plain version")
    if "pos" not in with_nan:
        raise AssertionError("K1 on a NaN state: no NaN position")
    return ", ".join(with_nan)


def _tools_recycler(card: str) -> None:
    """(c) The weight recycler on the flagship actor's self encoder: scores
    of its first layer over RECYCLE_B observations, the mask against the
    CPU's on the same activations, a recycle on the card."""
    import torch
    from quadswarm_tpu_torch.models import weight_recycler as R
    from quadswarm_tpu_torch.training import config as C

    args = C.parse_swarm_cfg(train_sh_flags())
    env_cfg = C.env_config_from_args(args)
    torch.manual_seed(args.seed)
    model = C.model_from_args(args, env_cfg, device="cuda")
    first, second = model.actor_encoder.self_encoder.layers[:2]
    with torch.no_grad():       # silence some units: they become dormant
        first.weight[:RECYCLE_DORMANT] = 0.0
        first.bias[:RECYCLE_DORMANT] = 0.0
    gen = torch.Generator("cuda").manual_seed(4)
    obs = torch.randn((RECYCLE_B, env_cfg.obs_dim), generator=gen,
                      device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        act = torch.tanh(first(obs[:, :model.actor_encoder.self_obs_dim]))
        score = R.estimate_neuron_score(act, normalize=True)
        mask = R.dormant_mask(act)
        w_in, b_in, w_out = R.recycle_dense_pair(
            gen, first.weight, first.bias, second.weight, mask)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu_mask = R.dormant_mask(act.cpu())
    if not torch.equal(mask.cpu(), cpu_mask):
        raise AssertionError("recycler: the card's mask differs from the "
                             "CPU's")
    n = int(mask.sum())
    if n != RECYCLE_DORMANT:
        raise AssertionError(f"recycler: {n} dormant units, expected "
                             f"{RECYCLE_DORMANT}")
    keep = ~mask
    if not (bool((b_in[mask] == 0).all()) and bool((w_out[:, mask] == 0)
                                                   .all())
            and torch.equal(w_in[keep], first.weight[keep])
            and torch.equal(w_out[:, keep], second.weight[:, keep])):
        raise AssertionError("recycler: the recycled layer is not exact")
    fan_in = first.weight.shape[1]
    fresh = w_in[mask]
    std = float(fresh.std()) / math.sqrt(1.0 / fan_in)
    bound = 2 * math.sqrt(1.0 / fan_in) / 0.87962566103423978
    if not float(fresh.abs().max()) <= bound:
        raise AssertionError("recycler: a fresh weight beyond 2 std")
    print(f"[{card}] weight recycler on the flagship actor's self encoder "
          f"(first layer {tuple(first.weight.shape)}, B={RECYCLE_B}): "
          f"{n} dormant of {mask.numel()} (the {RECYCLE_DORMANT} silenced), "
          f"the mask equal to the CPU's on the same activations, zeroed "
          f"rows and biases exact, untouched units equal; fresh weights' std "
          f"{std:.3f} x sqrt(1/fan_in) (fan_in {fan_in}); smallest live "
          f"score {float(score[keep].min()):.3g}; scored and recycled in "
          f"{wall * 1e3:.2f} ms (first call)")


def _tools_attention(card: str, train_dir: str) -> dict:
    """(d) episode_attention with the flagship model over a whole episode
    on the card; returns its launch counts."""
    import importlib.util
    import os
    import numpy as np
    import torch
    from quadswarm_tpu_torch.analysis.attention import (
        episode_attention, plot_heatmap,
    )
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.training import config as C

    args = C.parse_swarm_cfg(train_sh_flags())
    env_cfg = C.env_config_from_args(args)
    torch.manual_seed(args.seed)
    model = C.model_from_args(args, env_cfg, device="cuda")
    gen = torch.Generator("cuda").manual_seed(5)
    dyn = make_dynamics_params(dt=env_cfg.dt)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with SyncCounter() as syncs:
        mat = episode_attention(env_cfg, dyn, model, gen, device="cuda")
    wall = time.perf_counter() - t0
    counts = _read_counts()
    n, ticks = env_cfg.num_agents, env_cfg.ep_len
    if counts != _counts(K1=ticks):
        raise AssertionError(f"attention: launches {counts} in {ticks} "
                             "ticks")
    if mat.shape != (n, n) or not np.allclose(mat.sum(1), 1.0, atol=1e-12) \
            or np.any(np.diag(mat) != 0):
        raise AssertionError(f"attention: not row-stochastic with a zero "
                             f"diagonal: {mat}")
    where = "not drawn (matplotlib is not installed here)"
    if importlib.util.find_spec("matplotlib") is not None:
        out = os.path.join(train_dir, "attn_heatmap.png")
        plot_heatmap(mat, out)
        where = f"drawn, {os.path.getsize(out):,} bytes"
    print(f"[{card}] attention heat-map (train.sh's model, "
          f"{n} drones, {env_cfg.num_use_neighbor_obs} neighbours, 256 wide, "
          f"weights from seed {args.seed}): {ticks} ticks of one env in "
          f"{wall:.2f} s ({wall / ticks * 1e3:.2f} ms a tick); K1 launches "
          f"{counts['K1']}; {syncs.implicit} implicit device-to-host syncs "
          f"(by site {dict(syncs.by_site.most_common(4))}); "
          f"rows sum to 1, diagonal 0, largest weight {mat.max():.4f}; the "
          f"heat-map {where}")
    return counts


def _tools_render(card: str, train_dir: str) -> dict:
    """(e) The eval CLI's single-env loop with train.sh's flags,
    --render_mode=plot --visualize_v_value=True, one episode of
    RENDER_EPISODE_S s (cut from 15).  Without matplotlib the CLI refuses
    plot up front; the same loop then runs with --render_mode=dump and
    the value panels' batched critic forward is timed on the recording.
    Returns the episode's launch counts."""
    import contextlib
    import importlib.util
    import io
    import os
    import torch
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.training import config as C
    from quadswarm_tpu_torch.training import enjoy

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    out_dir = os.path.join(train_dir, "render")
    argv = train_sh_flags() + [
        f"--train_dir={train_dir}", "--experiment=eval_src",
        "--eval_envs=1", "--max_num_episodes=1", "--visualize_v_value=True",
        f"--quads_episode_duration={RENDER_EPISODE_S}",
        f"--render_out={out_dir}"]
    log = io.StringIO()
    if not has_mpl:
        with contextlib.redirect_stdout(log):
            args = enjoy.load_args(argv + ["--render_mode=plot"])
        try:
            enjoy.evaluate(args)
        except ImportError as e:
            print(f"[{card}] render: matplotlib is not installed on this "
                  f"machine; the eval CLI refuses --render_mode=plot before "
                  f"the episode ({e}); running --render_mode=dump instead")
        else:
            raise AssertionError("plot ran without matplotlib")
    mode = "plot" if has_mpl else "dump"
    with contextlib.redirect_stdout(log):
        args = enjoy.load_args(argv + [f"--render_mode={mode}"])
    cfg = C.env_config_from_args(args)
    forwards = []            # the rows of each actor-critic forward

    def hook(module, inp, out):
        if isinstance(module, ActorCritic):
            forwards.append(inp[0].shape[0])

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        return _render_episode(card, args, cfg, out_dir, log, has_mpl, mode,
                               forwards)
    finally:
        handle.remove()


def _render_episode(card: str, args, cfg, out_dir: str, log, has_mpl: bool,
                    mode: str, forwards: list) -> dict:
    """The render episode of `_tools_render`, its checks and its line;
    `forwards` collects the rows of each actor-critic forward."""
    import contextlib
    import os
    import numpy as np
    import torch
    from quadswarm_tpu_torch.training import enjoy
    from quadswarm_tpu_torch.utils.render import v_value_maps

    ticks = cfg.ep_len + 1
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        result = enjoy.evaluate(args)
    wall = time.perf_counter() - t0
    counts = _read_counts()
    if counts != _counts(K1=ticks):
        raise AssertionError(f"render: launches {counts} in {ticks} ticks")
    episode_s, render_s = result.round_seconds[0], result.render_seconds[0]
    rec = result.recorder
    frame_ticks = list(range(0, len(rec.obs), 10))
    if has_mpl:
        frames = sorted(f for f in os.listdir(os.path.join(out_dir, "ep000"))
                        if f.startswith("frame_"))
        if len(frames) != len(frame_ticks):
            raise AssertionError(f"render: {len(frames)} frames")
        drawn = f"{len(frames)} frames written"
        maps_note = "inside the rendering"
    else:
        obs_seq = np.stack([rec.obs[t] for t in frame_ticks])
        model = _render_model(args, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        maps = v_value_maps(model, obs_seq)
        maps_s = time.perf_counter() - t1
        if len(maps) != len(frame_ticks) or not all(
                np.isfinite(m).all() for m in maps.values()):
            raise AssertionError("render: value maps")
        drawn = ("no frames (matplotlib missing); written: "
                 + ", ".join(sorted(os.listdir(out_dir))
                             + sorted(os.listdir(os.path.join(out_dir,
                                                              "ep000")))))
        maps_note = (f"{len(frame_ticks)} maps of 30x30 in one forward of "
                     f"{len(frame_ticks) * 900:,} rows in {maps_s:.3f} s")
    batched = [b for b in forwards if b > cfg.num_agents]
    print(f"[{card}] render: eval CLI single-env loop, train.sh's flags, "
          f"--render_mode={mode} --visualize_v_value=True, one episode of "
          f"{RENDER_EPISODE_S} s (cut from 15): {ticks} ticks in "
          f"{episode_s:.2f} s ({episode_s / ticks * 1e3:.2f} ms a tick, the "
          f"recorder reads every tick); rendering after it {render_s:.2f} s "
          f"({drawn}); value maps {maps_note}; critic forwards wider than "
          f"the policy's {len(batched)} ({batched}); K1 launches "
          f"{counts['K1']}; call {wall:.2f} s")
    return counts


def _render_model(args, cfg):
    """The eval CLI's model with its checkpoint, on the card."""
    import torch
    from quadswarm_tpu_torch.training import config as C
    from quadswarm_tpu_torch.training.enjoy import choose_checkpoint
    torch.manual_seed(args.seed)
    model = C.model_from_args(args, cfg, device="cuda")
    cp = choose_checkpoint(args)
    if cp is not None:
        model.load_state_dict(torch.load(cp, map_location="cuda",
                                         weights_only=True)["model"])
    return model


def _tools_profile(card: str, train_walls: list) -> dict:
    """(f) analysis/profile_train at 1024 x 8 x 128, batch 1024, --iters 1;
    returns its launch counts."""
    import contextlib
    import io
    import torch
    from quadswarm_tpu_torch.analysis import profile_train

    out = io.StringIO()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = profile_train.main(PROFILE_ARGS)
    wall = time.perf_counter() - t0
    counts = _read_counts()
    want = 128 * (PROFILE_ROLLOUTS + PROFILE_ITERATIONS)
    if counts != _counts(K1=want):
        raise AssertionError(f"profile_train: launches {counts}, expected "
                             f"K1 {want}")
    if [r["phase"] for r in results] != ["rollout", "gae+sgd",
                                         "full_iteration"]:
        raise AssertionError(f"profile_train printed {results}")
    for line in out.getvalue().splitlines():
        print(f"[{card}] profile_train {line}")
    halves = results[0]["ms_per_iter"] + results[1]["ms_per_iter"]
    walls = ", ".join(f"{w:.3f}" for w in train_walls)
    beside = (f"the train phase's iterations {walls} s (train.sh's Trainer, "
              "with annealing and downwash)" if train_walls
              else "no train phase in this run")
    print(f"[{card}] profile_train ({' '.join(PROFILE_ARGS)}): "
          f"full_iteration {results[2]['ms_per_iter'] / 1e3:.3f} s beside "
          f"{beside}; rollout + gae+sgd {halves / 1e3:.3f} s; K1 launches "
          f"{counts['K1']} ({PROFILE_ROLLOUTS} rollouts and "
          f"{PROFILE_ITERATIONS} iterations of 128 ticks); call {wall:.1f} s")
    return counts


def phase_tools(card: str, train_dir: str, train_walls: list) -> dict:
    """The tools at full model width: (a) sim2real for both model types,
    (b) the debug checks, (c) the weight recycler, (d) the attention
    heat-map episode, (e) the eval CLI's render loop (from the eval phase's
    checkpoint, or one the train CLI writes here), (f) profile_train.
    Returns the launch counts of (d), (e) and (f)."""
    import os

    t0 = time.perf_counter()
    _free()
    _tools_sim2real(card, train_dir)
    _tools_debug(card)
    _tools_recycler(card)
    launches = {"tools-attention-1x8": _tools_attention(card, train_dir)}
    if not os.path.isdir(os.path.join(train_dir, "eval_src")):
        _train_cli(train_sh_flags() + [
            f"--train_dir={train_dir}", "--experiment=eval_src",
            "--num_envs=64", f"--train_for_env_steps={128 * 64 * 8}"])
    launches["tools-render-1x8"] = _tools_render(card, train_dir)
    _free()
    launches["tools-profile_train-1024x8"] = _tools_profile(card,
                                                            train_walls)
    print(f"[{card}] tools phase: {time.perf_counter() - t0:.1f} s")
    return launches


KERNELS = {
    "K1": ("dynamics", "quadswarm_tpu_torch/csrc/dynamics_kernel.cu",
           "quadswarm_tpu/ops/pallas/dynamics_kernel.py:98"),
    # K1's per-drone form (a table of per-drone parameters), which the TPU
    # kernel lacks: the JAX package integrates randomized fleets with XLA.
    "K1pd": ("dynamics_per_drone",
             "quadswarm_tpu_torch/csrc/dynamics_kernel.cu",
             "quadswarm_tpu/ops/pallas/dynamics_kernel.py:98"),
    "K2": ("pair_collisions",
           "quadswarm_tpu_torch/csrc/swarm_interactions.cu",
           "quadswarm_tpu/ops/pallas/swarm_interactions.py:188"),
    "K3": ("neighbor_topk_obs",
           "quadswarm_tpu_torch/csrc/swarm_interactions.cu",
           "quadswarm_tpu/ops/pallas/swarm_interactions.py:368"),
    "K4": ("swarm_interactions",
           "quadswarm_tpu_torch/csrc/swarm_interactions.cu",
           "quadswarm_tpu/ops/pallas/swarm_interactions.py:37"),
}


def kernel_records(checks: dict, launches: dict) -> list:
    """The JSON record of every kernel that was checked.  checks: kernel id
    -> its checks, the one at a main path's shape first; launches: main
    path -> the counts of that run.  `launches` is the count on the first
    main path that runs the kernel."""
    out = []
    for kid, (name, source, replaces) in KERNELS.items():
        if not checks.get(kid):
            continue
        main_check = checks[kid][0]
        by_path = {path: counts[kid] for path, counts in launches.items()}
        out.append({
            "name": name, "id": kid, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": next((c for c in by_path.values() if c), 0)
            if by_path else None,
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in checks[kid]),
            "ms": main_check["ms"], "device_ms": main_check["device_ms"],
            "plain_ms": main_check["plain_ms"],
            "bound_ms": main_check["bound_ms"],
            "bound_by": main_check["bound_by"],
            # an empty kernel at this kernel's grid
            "launch_floor_ms": main_check.get("launch_floor_ms"),
            # no single PyTorch call computes any of the four (torch.cdist
            # and torch.topk each cover only a part of K2-K4)
            "library_ms": None,
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,kernels,agree,rollout,swarm,sim,surface,"
                            "train,obst,eval,runs,appo,pbt,bf16,mixed,tools,"
                            "dist",
                    help="comma-separated subset of build,kernels,agree,"
                         "rollout,swarm,sim,surface,train,obst,eval,runs,"
                         "appo,pbt,bf16,mixed,tools,dist,profile,sweep "
                         "(off by "
                         "default: "
                         "profile, a torch.profiler breakdown of a rollout; "
                         "sweep, K1's and K2's wrappers by part, K3 by k)")
    ap.add_argument("--trace", default=None,
                    help="with the profile phase: write its Chrome trace "
                         "to this path")
    ap.add_argument("--profile_path", default="flagship",
                    choices=("flagship", "swarm", "train", "bf16", "final",
                             "mixed"),
                    help="with the profile phase: the rollout to profile, "
                         "1024 x 8 (flagship) or 256 x 128 with the pair "
                         "kernels (swarm); or train.sh's Trainer (train), "
                         "with bfloat16 model and env (bf16), or the final "
                         "obstacle run's (final), rollout ticks with replay "
                         "and minibatch steps; or the PBT run file's mixed "
                         "runner (mixed)")
    ap.add_argument("--dist_worker", default=None, choices=tuple(DIST_PARTS),
                    help="(internal) run as one rank of a dist phase world")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if args.dist_worker:
        return dist_worker(args.dist_worker)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import quadswarm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)

    checks = {kid: [] for kid in KERNELS}
    launches = {}
    if "build" in phases:
        phase_build(card)
    if "sweep" in phases:
        phase_sweep(card)
    if "kernels" in phases:
        k1_checks, pair_checks = phase_kernels(card)
        checks["K1"] += k1_checks
        for by_kernel in pair_checks:
            for kid, check in by_kernel.items():
                checks[kid].append(check)
    if "agree" in phases:
        phase_agree(card)
    if "rollout" in phases:
        launches["rollout-1024x8"], states, cfg, params = phase_rollout(card)
        checks["K1"].insert(0, check_on_env_state(card, "rollout state",
                                                  states, cfg, params))
        del states
    if "swarm" in phases:
        launches["swarm-256x128"], reached = phase_swarm(card)
        for kid, check in reached.items():
            checks[kid].insert(0, check)
    if "sim" in phases:
        checks["K1"].append(phase_sim(card))
    if "surface" in phases:
        surface_launches, by_form = phase_surface(card)
        launches.update(surface_launches)
        for kid, form_checks in by_form.items():
            checks[kid] += form_checks
    import tempfile
    workdir = tempfile.TemporaryDirectory()
    train_dir = workdir.name
    train_walls = []
    if "train" in phases:
        train_counts, check, train_walls = phase_train(card, train_dir)
        checks["K1"].insert(0, check)
        # the main path first: a kernel's `launches` is its count there
        launches = {"train-1024x8": train_counts, **launches}
    if "obst" in phases:
        launches["train-obst-1024x8"], check = phase_obst(card, train_dir)
        checks["K1"].append(check)
    if "eval" in phases:
        for path, (counts, check) in zip(
                ("eval-32x8", "eval-obst-32x8"), phase_eval(card, train_dir)):
            launches[path] = counts
            checks["K1"].append(check)
    if "runs" in phases:
        launches["train-attn-obst-1024x8"], check = phase_runs(card)
        checks["K1"].append(check)
    if "appo" in phases:
        launches["appo-1024x8"], check = phase_appo(card)
        checks["K1"].append(check)
    if "pbt" in phases:
        launches["pbt-8x512x8"], check = phase_pbt(card, train_dir)
        checks["K1"].append(check)
    if "bf16" in phases:
        bf16_launches, check = phase_bf16(card)
        launches.update(bf16_launches)
        checks["K1"].append(check)
    if "mixed" in phases:
        launches["mixed-8x512x8"], check = phase_mixed(card, train_dir)
        checks["K1"].append(check)
    if "tools" in phases:
        launches.update(phase_tools(card, train_dir, train_walls))
    workdir.cleanup()
    if "dist" in phases:
        launches.update(phase_dist(card))
    if "profile" in phases:
        phase_profile(card, args.trace, args.profile_path)

    records = kernel_records(checks, launches)
    if records:
        print(json.dumps({"kernels": records, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
