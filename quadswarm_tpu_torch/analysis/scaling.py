"""Multi-rank scaling measurement of the flagship training step.

Port of quadswarm_tpu/analysis/scaling.py.  The JAX package compiles the
same train iteration over a 1/2/4/8-device mesh; the port runs the same
`Trainer` iteration over worlds of 1, 2, 4, ... ranks (one process a rank,
`parallel/distributed.py`), each world in subprocesses of its own, and
times it per rank count.

* ``fixed`` (default): the TOTAL env batch is constant and shards over the
  ranks; efficiency_D = t_1 / t_D.
* ``weak``: envs per rank constant, the total grows with D; ideal weak
  scaling keeps the iteration time flat.

On one card a world of D ranks shares it (gloo, `ranks_per_card` D), so
the times there measure the collectives' overhead, not a speed-up; on a
node of D cards each rank has its own (NCCL)::

    python -m quadswarm_tpu_torch.analysis.scaling --mode weak \\
        --devices 1,4,8 --envs_per_dev 512 --rnn_size 256

One JSON line per rank count (rank 0's), then a summary line.
`learner_rows_per_rank` takes the place of XLA's `flops_per_device`, which
torch has no counterpart for: the samples one rank fed the loss in an
iteration, total / D when the learner shards (`learner_rows_scaling` D).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def worker(args) -> None:
    """One rank of a world started by `main` (torchrun's variables)."""
    import numpy as np
    import torch

    from quadswarm_tpu_torch.env.multi import EnvConfig
    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.parallel.distributed import init_distributed
    from quadswarm_tpu_torch.parallel.mesh import make_mesh
    from quadswarm_tpu_torch.parallel.ppo import PPOConfig, Trainer, sgd_epochs

    init_distributed(device=args.device)
    mesh = make_mesh(device=args.device)
    d = mesh.world
    # the world's ranks share this host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // d))
    assert d == args.worker, f"expected {args.worker} ranks, got {d}"
    num_envs = (args.envs_per_dev * d if args.mode == "weak"
                else args.total_envs)
    env_cfg = EnvConfig(num_agents=8, neighbor_obs_type="pos_vel",
                        neighbor_visible_num=6, quads_mode="mix")
    ppo_cfg = PPOConfig(rollout=args.rollout, batch_size=args.batch_size,
                        num_envs=num_envs, replay_sample_prob=0.75)
    torch.manual_seed(0)
    model = ActorCritic(self_obs_dim=18, neighbor_obs_dim=6, num_neighbors=6,
                        encoder_type="corl", neighbor_encoder_type="attention",
                        rnn_size=args.rnn_size, neighbor_hidden=args.rnn_size,
                        device=mesh.device)
    trainer = Trainer(env_cfg, ppo_cfg, model,
                      make_dynamics_params(dt=env_cfg.dt), seed=0,
                      device=mesh.device, mesh=mesh)
    sync = (lambda: torch.cuda.synchronize(mesh.device)) \
        if mesh.device.type == "cuda" else (lambda: None)
    trainer.iteration()                                  # warm-up
    sync()

    def timed(n):
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.iteration()
        sync()
        return time.perf_counter() - t0

    runs = []
    for _ in range(args.repeats):
        t_short = timed(1)
        t_long = timed(1 + args.iters)
        runs.append(max(t_long - t_short, 1e-9) / args.iters)
    sec = float(np.median(runs))
    cards = torch.cuda.device_count() if mesh.device.type == "cuda" else 0
    if mesh.is_main:
        print(json.dumps({
            "devices": d,
            "ranks_per_card": math.ceil(d / cards) if cards else None,
            "backend": (torch.distributed.get_backend()
                        if mesh.distributed else None),
            "num_envs": num_envs, "sec_per_iter": sec,
            "agent_steps_per_s": ppo_cfg.rollout * num_envs * 8 / sec,
            "runs_sec": runs,
            "learner_rows_per_rank": sgd_epochs.rows,
        }), flush=True)
    if mesh.distributed:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(d: int, args) -> dict:
    """The measurement on a world of `d` ranks: rank 0's JSON line, or an
    error record."""
    port = _free_port()
    root = Path(__file__).resolve().parents[2]
    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(d), "LOCAL_WORLD_SIZE": str(d),
           "PYTHONPATH": str(root)}
    cmd = [sys.executable, "-m", "quadswarm_tpu_torch.analysis.scaling",
           "--worker", str(d), "--mode", args.mode,
           "--total_envs", str(args.total_envs),
           "--envs_per_dev", str(args.envs_per_dev),
           "--rollout", str(args.rollout),
           "--batch_size", str(args.batch_size),
           "--rnn_size", str(args.rnn_size), "--iters", str(args.iters),
           "--repeats", str(args.repeats), "--device", args.device]
    # a file a rank: a pipe read one rank at a time could fill and stall a
    # rank inside a collective
    procs, logs = [], []
    for r in range(d):
        logs.append(tempfile.TemporaryFile("w+"))
        procs.append(subprocess.Popen(
            cmd, cwd=root, stdout=logs[-1], stderr=subprocess.STDOUT,
            text=True, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}))
    try:
        for p in procs:
            p.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
    if any(p.returncode for p in procs) or not lines:
        return {"devices": d, "error": "".join(outs)[-800:]}
    return json.loads(lines[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worker", type=int, default=0,
                   help="(internal) run as one rank of a world of this "
                        "many ranks")
    p.add_argument("--devices", type=str, default="1,2,4,8",
                   help="the rank counts to measure")
    p.add_argument("--mode", choices=("fixed", "weak"), default="fixed")
    p.add_argument("--total_envs", type=int, default=128,
                   help="total env batch in fixed mode")
    p.add_argument("--envs_per_dev", type=int, default=64,
                   help="env batch per rank in weak mode")
    p.add_argument("--rollout", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--rnn_size", type=int, default=128)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (a card a rank where there are enough, else "
                        "shared) or cpu")
    p.add_argument("--timeout", type=int, default=1800,
                   help="seconds a world may take")
    args = p.parse_args(argv)

    if args.worker:
        worker(args)
        return 0

    results = []
    for d in [int(x) for x in args.devices.split(",")]:
        r = run_world(d, args)
        print(json.dumps(r), flush=True)
        if "error" not in r:
            results.append(r)

    if results and results[0]["devices"] == 1:
        t1 = results[0]["sec_per_iter"]
        rows1 = results[0]["learner_rows_per_rank"]
        print(json.dumps({
            "metric": f"{args.mode}-scaling efficiency (t_1/t_D, flagship "
                      "train step)",
            "efficiency": {str(r["devices"]): t1 / r["sec_per_iter"]
                           for r in results},
            # rows_1 / rows_D: D when the learner shards (no rank
            # recomputes another's samples)
            "learner_rows_scaling": {
                str(r["devices"]): rows1 / r["learner_rows_per_rank"]
                for r in results},
            "mode": args.mode, "num_envs": results[0]["num_envs"]}),
            flush=True)
    return 0 if len(results) == len(args.devices.split(",")) else 1


if __name__ == "__main__":
    sys.exit(main())
