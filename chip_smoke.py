#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quadswarm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each raising on failure:
  1. build every CUDA kernel of the port from csrc/ with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, on
     branch-covering inputs at the main path's shapes and a ragged one;
  3. the main path: `collect_rollout` at the flagship run's width (1024
     envs x 8 drones, the 256-wide CoRL attention actor-critic, rollout
     128), with every kernel's launch count reset just before and read
     just after;
  4. the simulator: `batched_env_step` with random actions at 4096 envs x 8
     (mix) for ep_len + 2 ticks, through one auto-reset of every env; then
     K1 alone on the drone state the simulator reached.

    python3 chip_smoke.py --phases build,profile --trace out/trace.json

adds a torch.profiler breakdown of the rollout (device time by kernel,
the device's busy share) and writes its Chrome trace.

Every line with a number carries the card's name and power limit.  The
second-to-last line is the kernels' JSON record, the last line
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
# Float operations per drone per sub-step without the data-dependent
# branches (motor filter 40, torques 36, Rodrigues 150 counting sincos as
# 20, omega 30, position 9, force and acceleration 20, velocity and
# accelerometer 30), plus 230 for each re-orthonormalization and 70 for
# each drone below the floor threshold.
K1_FLOPS_PER_SUBSTEP = 315
K1_FLOPS_ORTHO = 230
K1_FLOPS_FLOOR = 70


def k1_bound_ms(state, sim_steps: int, ortho_every: int) -> tuple:
    """Least time for one K1 launch on these inputs: the larger of bytes
    over HBM bandwidth and operations over the float32 peak."""
    import torch
    b = state.pos.shape[0]
    n_ortho = int(torch.sum(state.step_count + 1 >= ortho_every))
    n_floor = int(torch.sum(state.pos[:, 2] <= 0.1))
    flops = (sim_steps * b * K1_FLOPS_PER_SUBSTEP + n_ortho * K1_FLOPS_ORTHO
             + sim_steps * n_floor * K1_FLOPS_FLOOR)
    t_bytes = b * K1_BYTES_PER_DRONE / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_dynamics_kernel(card: str, label: str, params, cfg, state, cmds,
                          ou, yaw, tol_all=None) -> dict:
    """K1 against its plain version on one flat batch; then both timed.
    `ms` and `plain_ms` are per call, back to back, as the env step pays
    them; `device_ms` is K1's device time alone (CUDA graph replay)."""
    import torch
    from quadswarm_tpu_torch.env.dynamics import dynamics_tick
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
    from quadswarm_tpu_torch.utils.struct import leaves

    b = state.pos.shape[0]
    before = dk.dynamics_tick_fused.launches
    got = dk.dynamics_tick_fused(params, cfg, state, cmds, ou, yaw)
    torch.cuda.synchronize()
    want = dynamics_tick(params, cfg, state, cmds, ou, yaw)
    max_err = 0.0
    for (name, g), (_, w) in zip(leaves(got), leaves(want)):
        if g.dtype in (torch.bool, torch.int32):
            n_bad = int(torch.sum(g != w))
            if n_bad:
                raise AssertionError(f"K1 {name}: {n_bad} of {g.numel()} "
                                     "entries differ from the plain version")
            continue
        tol = tol_all or DYN_TOL_FIELD.get(name, DYN_TOL)
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
    dk.dynamics_tick_fused.launches = before   # comparisons do not count
    bound_ms, bound_by = k1_bound_ms(state, cfg.sim_steps,
                                     cfg.orthonormalize_every)
    tol = tol_all or DYN_TOL
    print(f"[{card}] K1 dynamics, {label}, B={b}: max_abs_err={max_err:.3g} "
          f"(rtol {tol['rtol']}, atol {tol['atol']}"
          + ("" if tol_all else f"; omega_dot atol "
             f"{DYN_TOL_FIELD['omega_dot']['atol']}")
          + f") per call {ms * 1e3:.2f} us, device {device_ms * 1e3:.2f} us, "
          f"plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by})")
    return dict(b=b, max_abs_err=max_err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_on_env_state(card: str, label: str, states, cfg, params) -> dict:
    """K1 on a state the main path reached (its (E, N) drones flattened),
    at hover thrust with fresh draws for this tick."""
    import torch
    from quadswarm_tpu_torch.utils.struct import map_fields

    dyn = map_fields(lambda x: x.reshape((-1,) + x.shape[2:]), states.dyn)
    b = dyn.pos.shape[0]
    gen = torch.Generator("cuda").manual_seed(2)
    cmds = torch.full((b, 4), 0.5, device="cuda")
    ou = 0.01 * torch.randn((b, 4), generator=gen, device="cuda")
    yaw = torch.rand((b,), generator=gen, device="cuda") * 2 * math.pi \
        - math.pi
    return check_dynamics_kernel(card, label, params,
                                 cfg.dynamics_config(params.arm), dyn, cmds,
                                 ou, yaw, tol_all=TRAJ_TOL)


def phase_build(card: str) -> None:
    from quadswarm_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    log = []
    path = build.build("dynamics_kernel.cu", log=log)
    for line in log:
        print(f"[{card}] {line.strip()}")
    print(f"[{card}] built {path.name} in {time.perf_counter() - t0:.1f} s")


def phase_kernels(card: str) -> list:
    """K1 on branch-covering batches at the rollout's and the simulator's
    widths and at a ragged one."""
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
# Whole env step, GPU (through K1) against CPU (plain) on a small input,
# both started from the CPU state each tick with the same draws: the
# dynamics tolerance on the state and obs, and on rewards.
STEP_TOL = dict(rtol=2e-4, atol=2e-5)


def _draws(e: int, n: int, gen) -> dict:
    """Every random draw of one env tick, as batched_env_step takes them."""
    import torch
    u = lambda *s: torch.rand((e, n) + s, generator=gen)
    g = lambda *s: torch.randn((e, n) + s, generator=gen)
    return {"ou": g(4), "yaw": u() * (2 * math.pi) - math.pi,
            "downwash": {"acc": u(1), "omega": u(1), "axis": u(3),
                         "dir": u(3)},
            "drone_normals": g(3, 3, 3), "drone_uniforms": u(6),
            "wall": u(11), "ceiling": u(10),
            "sensor": {"pos_n": g(3), "vel_n": g(3), "omega_n": g(3),
                       "acc_n": g(3), "acc_dyn_n": g(3)}}


def phase_agree(card: str) -> None:
    """The env step and the policy on the card agree with the CPU path on a
    small input (4 envs x 8 drones, flagship config, 6 ticks)."""
    import torch
    from quadswarm_tpu_torch.env.multi import (
        EnvConfig, batched_env_step, env_reset)
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.models.actor_critic import (
        ActorCritic, apply_fused)
    from quadswarm_tpu_torch.utils.struct import leaves, map_fields

    cfg = EnvConfig(**FLAGSHIP_ENV)
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator().manual_seed(7)
    states, obs = env_reset(cfg, params, gen, 4, device="cpu")

    def to_cuda(x):
        if isinstance(x, dict):
            return {k: to_cuda(v) for k, v in x.items()}
        return map_fields(lambda t: t.cuda(), x)
    worst = 0.0
    for _ in range(6):
        actions = torch.rand((4, 8, 4), generator=gen) * 2 - 1
        draws = _draws(4, 8, gen)
        cpu = batched_env_step(cfg, params, states, actions, None, draws)
        gpu = batched_env_step(cfg, params, to_cuda(states), actions.cuda(),
                               None, to_cuda(draws))
        pairs = (list(zip(leaves(gpu[0]), leaves(cpu[0])))
                 + [(("obs", gpu[1]), ("obs", cpu[1])),
                    (("reward", gpu[2]), ("reward", cpu[2]))])
        for (name, g), (_, c) in pairs:
            g = g.cpu()
            if g.dtype.is_floating_point:
                tol = DYN_TOL_FIELD.get(name.split(".")[-1], STEP_TOL)
                if not torch.allclose(g, c, **tol):
                    raise AssertionError(
                        f"env step {name}: GPU and CPU differ by "
                        f"{float((g - c).abs().max())}")
                worst = max(worst, float((g - c).abs().max()))
            elif not torch.equal(g, c):
                raise AssertionError(f"env step {name}: GPU and CPU differ")
        states = cpu[0]
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
    print(f"[{card}] env step GPU vs CPU, 4x8, 6 ticks: max_abs_err "
          f"{worst:.3g} (rtol {STEP_TOL['rtol']}, atol {STEP_TOL['atol']}); "
          f"policy max_abs_err {model_err:.3g} (atol 2e-5)")


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
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
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

    dk.dynamics_tick_fused.launches = 0
    t0 = time.perf_counter()
    states, obs, _, traj, last_value, infos = collect_rollout(
        cfg, params, model, ppo, states, obs, gen, rew)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dk.dynamics_tick_fused.launches

    if launches != t:
        raise AssertionError(f"K1 launched {launches} times in {t} ticks")
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
    dk.dynamics_tick_fused.launches = launches
    print(f"[{card}] rollout tick {elapsed / t * 1e3:.2f} ms: policy forward "
          f"{policy_ms:.2f} ms, env step {env_ms:.2f} ms")
    return launches, states, cfg, params


def phase_profile(card: str, trace: str | None) -> None:
    """torch.profiler over 8 rollout ticks at the flagship width: device
    time by kernel, the device's busy share, and the host time of the
    per-tick auto-reset sync.  With `trace`, the Chrome trace is written
    to that path."""
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile
    from quadswarm_tpu_torch.env.multi import EnvConfig, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.env.reward import RewardCoeffs
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig, collect_rollout

    e, t = 1024, 8
    cfg = EnvConfig(**FLAGSHIP_ENV)
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator("cuda").manual_seed(0)
    torch.manual_seed(0)
    model = ActorCritic(num_neighbors=6, device="cuda")
    rew = RewardCoeffs(**FLAGSHIP_REWARD)
    states, obs = env_reset(cfg, params, gen, e, device="cuda")
    ppo = PPOConfig(rollout=t)
    states, obs, *_ = collect_rollout(cfg, params, model, ppo, states, obs,
                                      gen, rew)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        collect_rollout(cfg, params, model, ppo, states, obs, gen, rew)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType
    dev = lambda ev: ev.self_device_time_total
    avgs = prof.key_averages()
    # Device-side events only (kernels, copies, fills): an aten operator
    # also reports the device time of the kernels it launched, and counting
    # both would count that time twice.
    kernels = sorted((ev for ev in avgs if ev.device_type == DeviceType.CUDA
                      and dev(ev) > 0), key=dev, reverse=True)
    busy_us = sum(dev(ev) for ev in kernels)
    launches = sum(ev.count for ev in kernels)
    print(f"[{card}] profile, {t} rollout ticks at {e}x8: wall "
          f"{wall_us / t / 1e3:.2f} ms/tick, device busy "
          f"{busy_us / t / 1e3:.2f} ms/tick ({busy_us / wall_us:.1%}), "
          f"{launches / t:.0f} device ops/tick")
    for ev in kernels[:12]:
        print(f"[{card}]   {dev(ev) / t:9.1f} us/tick  {ev.count / t:6.1f}"
              f"/tick  {ev.key[:90]}")
    for ev in avgs:
        if ev.key in ("cudaStreamSynchronize", "aten::is_nonzero",
                      "aten::_local_scalar_dense", "cudaMemcpyAsync"):
            print(f"[{card}]   host {ev.self_cpu_time_total / t:8.1f} us/tick"
                  f"  {ev.count / t:5.1f}/tick  {ev.key}")
    if trace:
        Path(trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(trace)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,agree,rollout,sim",
                    help="comma-separated subset of build,kernels,agree,"
                         "rollout,sim,profile (profile: torch.profiler "
                         "breakdown of the rollout, off by default)")
    ap.add_argument("--trace", default=None,
                    help="with the profile phase: write its Chrome trace "
                         "to this path")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

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

    checks = []
    if "build" in phases:
        phase_build(card)
    if "kernels" in phases:
        checks = phase_kernels(card)
    if "agree" in phases:
        phase_agree(card)
    launches = None
    if "rollout" in phases:
        launches, states, cfg, params = phase_rollout(card)
        checks.insert(0, check_on_env_state(card, "rollout state", states,
                                            cfg, params))
    if "sim" in phases:
        checks.append(phase_sim(card))
    if "profile" in phases:
        phase_profile(card, args.trace)

    if checks:
        main_check = checks[0]
        print(json.dumps({"kernels": [{
            "name": "dynamics",
            "route": "cuda",
            "source": "quadswarm_tpu_torch/csrc/dynamics_kernel.cu",
            "replaces": "quadswarm_tpu/ops/pallas/dynamics_kernel.py:98",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": main_check["ms"],
            "device_ms": main_check["device_ms"],
            "plain_ms": main_check["plain_ms"],
            "bound_ms": main_check["bound_ms"],
            "bound_by": main_check["bound_by"],
            "library_ms": None,
        }], "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
