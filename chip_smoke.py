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
     on the drone state the simulator reached.

    python3 chip_smoke.py --phases build,profile --trace out/trace.json
    python3 chip_smoke.py --phases build,profile --profile_path swarm

adds a torch.profiler breakdown of the flagship rollout, or of the swarm
rollout (device time by kernel, the device's busy share), and writes its
Chrome trace.

    python3 chip_smoke.py --phases build,sweep

times K1's wrapper on the host by part at 32,768 drones, K2's at 256 envs
x 128, and K3 on the device at k = 1, 6 and 16 at 256 envs x 128.

Every line with a number carries the card's name and power limit.  The
second-to-last line is the kernels' JSON record (all four kernels), the
last line
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
    threads = dk.block_threads()
    floor_ms = launch_floor_ms(card, f"K1 at B={b}", -(-b // threads), threads)
    tol = tol_all or DYN_TOL
    print(f"[{card}] K1 dynamics, {label}, B={b}: max_abs_err={max_err:.3g} "
          f"(rtol {tol['rtol']}, atol {tol['atol']}"
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
    cmds = torch.full((b, 4), 0.5, device="cuda")
    ou = 0.01 * torch.randn((b, 4), generator=gen, device="cuda")
    yaw = torch.rand((b,), generator=gen, device="cuda") * 2 * math.pi \
        - math.pi
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


def _to_cuda(x):
    from quadswarm_tpu_torch.utils.struct import map_fields
    if isinstance(x, dict):
        return {k: _to_cuda(v) for k, v in x.items()}
    return map_fields(lambda t: t.cuda(), x)


def _agree_env_step(card: str, label: str, env_kw: dict, e: int,
                    touch: bool) -> None:
    """6 ticks of the env step on the card against the CPU, both started
    from the CPU state each tick with the same draws.  With `touch`, drone
    1 of every env starts inside drone 0's hitbox."""
    import torch
    from quadswarm_tpu_torch.env.multi import (
        EnvConfig, batched_env_step, env_reset)
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.utils.struct import leaves

    cfg = EnvConfig(**env_kw)
    n = cfg.num_agents
    params = make_dynamics_params(dt=cfg.dt)
    gen = torch.Generator().manual_seed(7)
    states, _ = env_reset(cfg, params, gen, e, device="cpu")
    if touch:
        pos = states.dyn.pos.clone()
        pos[:, 1] = pos[:, 0] + torch.tensor([0.05, 0.0, 0.0])
        states = states.replace(dyn=states.dyn.replace(pos=pos))
    worst, collisions = 0.0, 0
    for _ in range(6):
        actions = torch.rand((e, n, 4), generator=gen) * 2 - 1
        draws = _draws(e, n, gen)
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
                        f"env step {name}: GPU and CPU differ by "
                        f"{float((g - c).abs().max())}")
                worst = max(worst, float((g - c).abs().max()))
            elif not torch.equal(g, c):
                raise AssertionError(f"env step {name}: GPU and CPU differ")
        states = cpu[0]
        collisions = int(cpu[4]["num_collisions"].sum())
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

    if counts != {"K1": t, "K2": 0, "K3": 0, "K4": 0}:
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


def phase_profile(card: str, trace: str | None, path: str) -> None:
    """torch.profiler over 8 rollout ticks, at the flagship width (`path`
    "flagship": 1024 x 8) or on the large-swarm path ("swarm": 256 x 128,
    pair kernels on): device time by kernel, the device's busy share, and
    the host time of the per-tick auto-reset sync.  With `trace`, the
    Chrome trace is written to that path."""
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile
    from quadswarm_tpu_torch.env.multi import EnvConfig, env_reset
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.env.reward import RewardCoeffs
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig, collect_rollout

    t = 8
    e, env_kw = {"flagship": (1024, FLAGSHIP_ENV),
                 "swarm": (SWARM_ENVS, SWARM_ENV)}[path]
    cfg = EnvConfig(**env_kw)
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
    print(f"[{card}] profile, {t} rollout ticks at {e}x{cfg.num_agents} "
          f"({path}): wall {wall_us / t / 1e3:.2f} ms/tick, device busy "
          f"{busy_us / t / 1e3:.2f} ms/tick ({busy_us / wall_us:.1%}), "
          f"{launches / t:.0f} device ops/tick")
    ours = ("dynamics_kernel", "pair_collision_kernel",
            "neighbor_topk_kernel", "interaction_kernel")
    for ev in kernels[:12] + [ev for ev in kernels[12:]
                              if any(name in ev.key for name in ours)]:
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


def _reset_counts() -> None:
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
    from quadswarm_tpu_torch.ops.kernels import swarm_interactions as si
    for fn in (dk.dynamics_tick_fused, si.pair_collisions,
               si.neighbor_topk_obs, si.swarm_interactions):
        fn.launches = 0


def _read_counts() -> dict:
    from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
    from quadswarm_tpu_torch.ops.kernels import swarm_interactions as si
    return {"K1": dk.dynamics_tick_fused.launches,
            "K2": si.pair_collisions.launches,
            "K3": si.neighbor_topk_obs.launches,
            "K4": si.swarm_interactions.launches}


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

    want = {"K1": t, "K2": t, "K3": t, "K4": 0}
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


KERNELS = {
    "K1": ("dynamics", "quadswarm_tpu_torch/csrc/dynamics_kernel.cu",
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
    ap.add_argument("--phases", default="build,kernels,agree,rollout,swarm,sim",
                    help="comma-separated subset of build,kernels,agree,"
                         "rollout,swarm,sim,profile,sweep (off by default: "
                         "profile, a torch.profiler breakdown of a rollout; "
                         "sweep, K1's and K2's wrappers by part, K3 by k)")
    ap.add_argument("--trace", default=None,
                    help="with the profile phase: write its Chrome trace "
                         "to this path")
    ap.add_argument("--profile_path", default="flagship",
                    choices=("flagship", "swarm"),
                    help="with the profile phase: the rollout to profile, "
                         "1024 x 8 (flagship) or 256 x 128 with the pair "
                         "kernels (swarm)")
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
