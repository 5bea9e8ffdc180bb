"""Experiment launcher: run descriptions with parameter grids.

Port of quadswarm_tpu/runs/launcher.py (Sample Factory's launcher
concepts: RunDescription, Experiment, ParamGrid, consumed by the
reference's runs/**).  A run file exposes RUN_DESCRIPTION; the launcher
expands its parameter grid into training commands and runs them as
subprocesses (`processes`), writes sbatch scripts (`slurm`) or prints them
(`dry`).  The port's run files (`quadswarm_tpu_torch/runs/`) carry the
JAX package's commands with the training module swapped for
`quadswarm_tpu_torch.training.train`.

    python -m quadswarm_tpu_torch.runs.launcher \
        --run=quadswarm_tpu_torch.runs.quad_multi_mix_baseline \
        --backend=processes --max_parallel=1
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import os
import shlex
import subprocess
import sys


class ParamGrid:
    def __init__(self, params: list[tuple[str, list]]):
        self.params = params

    def generate_params(self, randomize: bool = False):
        names = [p[0] for p in self.params]
        for combo in itertools.product(*[p[1] for p in self.params]):
            yield dict(zip(names, combo))


class Experiment:
    def __init__(self, name: str, cmd: str, param_generator=None):
        self.name = name
        self.cmd = cmd
        self.params = list(param_generator) if param_generator else [{}]


class RunDescription:
    def __init__(self, run_name: str, experiments: list[Experiment]):
        self.run_name = run_name
        self.experiments = experiments

    def commands(self, train_dir: str):
        for exp in self.experiments:
            for i, params in enumerate(exp.params):
                suffix = "_".join(f"{k.split('_')[-1]}{v}" for k, v in params.items())
                name = f"{exp.name}_{suffix}" if suffix else exp.name
                extra = " ".join(f"--{k}={v}" for k, v in params.items())
                yield name, f"{exp.cmd} {extra} --experiment={name} --train_dir={train_dir}"


SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --output={train_dir}/{name}/slurm.out
#SBATCH --time={timeout}
#SBATCH {gres}
# auto-requeue on timeout (reference: runs/slurm/sbatch_timeout.sh)
timeout {timeout_cmd} {cmd}
if [[ $? -eq 124 ]]; then
  sbatch $0
fi
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--run", required=True,
                   help="module exposing RUN_DESCRIPTION")
    p.add_argument("--backend", default="processes",
                   choices=["processes", "slurm", "dry"])
    p.add_argument("--train_dir", default="train_dir")
    p.add_argument("--max_parallel", default=1, type=int)
    p.add_argument("--pause_between", default=1, type=float)
    p.add_argument("--slurm_timeout", default="23:59:00")
    p.add_argument("--slurm_gpus_per_job", default=0, type=int)
    # Reference launcher compatibility (SF launcher flags used by
    # train*.sh / README commands):
    p.add_argument("--experiment_suffix", default="",
                   help="appended to every experiment name")
    p.add_argument("--experiments_per_gpu", default=-1, type=int,
                   help="with --num_gpus, folds into --max_parallel")
    p.add_argument("--num_gpus", default=0, type=int,
                   help="accelerator-count scheduling hint; with "
                        "--experiments_per_gpu folds into --max_parallel")
    p.add_argument("--slurm_print_only", default=False,
                   type=lambda s: s.lower() in ("1", "true", "yes"),
                   help="write sbatch scripts without submitting "
                        "(implies dry submission)")
    p.add_argument("--slurm_workdir", default="",
                   help="directory for generated sbatch scripts "
                        "(default: train_dir)")
    p.add_argument("--slurm_sbatch_template", default="",
                   help="path to a custom sbatch template with {name}, "
                        "{train_dir}, {cmd}, {timeout}, {timeout_cmd}, "
                        "{gres} placeholders")
    p.add_argument("--slurm_cpus_per_gpu", default=0, type=int)
    args = p.parse_args(argv)
    if args.num_gpus > 0 and args.experiments_per_gpu > 0:
        args.max_parallel = max(args.max_parallel,
                                args.num_gpus * args.experiments_per_gpu)

    module = importlib.import_module(args.run)
    rd: RunDescription = module.RUN_DESCRIPTION
    cmds = list(rd.commands(args.train_dir))
    if args.experiment_suffix:
        cmds = [(f"{n}_{args.experiment_suffix}",
                 c.replace(f"--experiment={n}",
                           f"--experiment={n}_{args.experiment_suffix}"))
                for n, c in cmds]
    print(f"run {rd.run_name}: {len(cmds)} experiments")

    if args.backend == "dry":
        for name, cmd in cmds:
            print(f"  {name}: {cmd}")
        return 0

    if args.backend == "slurm":
        workdir = args.slurm_workdir or args.train_dir
        template = SBATCH_TEMPLATE
        if args.slurm_sbatch_template:
            with open(args.slurm_sbatch_template) as f:
                template = f.read()
        os.makedirs(args.train_dir, exist_ok=True)
        os.makedirs(workdir, exist_ok=True)
        for name, cmd in cmds:
            os.makedirs(os.path.join(args.train_dir, name), exist_ok=True)
            gres = (f"--gres=gpu:{args.slurm_gpus_per_job}"
                    if args.slurm_gpus_per_job else "--ntasks=1")
            if args.slurm_cpus_per_gpu and args.slurm_gpus_per_job:
                gres += ("\n#SBATCH --cpus-per-gpu="
                         f"{args.slurm_cpus_per_gpu}")
            script = template.format(
                name=name, train_dir=args.train_dir, cmd=cmd,
                timeout=args.slurm_timeout, timeout_cmd="23h", gres=gres)
            path = os.path.join(workdir, f"{name}.sbatch")
            with open(path, "w") as f:
                f.write(script)
            if args.slurm_print_only:
                print(f"  (print-only) {path}")
            else:
                subprocess.run(["sbatch", path], check=False)
        return 0

    # processes backend
    import time
    running: list[tuple[str, subprocess.Popen]] = []
    pending = list(cmds)
    failed = []
    while pending or running:
        while pending and len(running) < args.max_parallel:
            name, cmd = pending.pop(0)
            print(f"launching {name}")
            proc = subprocess.Popen(shlex.split(cmd))
            running.append((name, proc))
            time.sleep(args.pause_between)
        still = []
        for name, proc in running:
            ret = proc.poll()
            if ret is None:
                still.append((name, proc))
            elif ret != 0:
                failed.append(name)
                print(f"FAILED {name} (exit {ret})")
        running = still
        time.sleep(1.0)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
