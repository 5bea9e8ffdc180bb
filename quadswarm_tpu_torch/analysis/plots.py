"""Offline analysis and paper figures.

Port of quadswarm_tpu/analysis/plots.py (the reference's paper/*.py):
scalars from a training run's `metrics.jsonl` (utils/metrics.py), with a
TensorBoard event-file fallback (`<exp>/tb`) when the `tensorboard` package
is importable; mean +- std training curves over seed groups
(paper/mean_std_plots_quad_baseline.py:63-116); and the SPS bar chart
against the published numbers (paper/fps_compare.py:7-38).  Host-only.

    python -m quadswarm_tpu_torch.analysis.plots --experiments \
        train_dir/exp_s* --metrics metric/agent_success_rate --out curves.png
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

# Published reference numbers (paper/fps_compare.py:7-9): agent-steps/s of
# the original CPU simulators, by number of quadrotors.
REFERENCE_SPS = {1: 48589, 8: 62042, 32: 60241, 128: 38449}
PYBULLET_SPS = {1: 21883, 8: 31539, 32: 31457, 128: 32522}


def extract_scalars(exp_dir: str, metric: str):
    """Return (steps, values) for one metric of one experiment.

    Reads `<exp_dir>/metrics.jsonl` first; falls back to TensorBoard event
    files under `<exp_dir>/tb` (paper/mean_std_plots_quad_baseline.py:44-60).
    """
    jsonl = os.path.join(exp_dir, "metrics.jsonl")
    if os.path.exists(jsonl):
        steps, vals = [], []
        with open(jsonl) as f:
            for line in f:
                rec = json.loads(line)
                if metric in rec:
                    steps.append(rec["env_steps"])
                    vals.append(rec[metric])
        return np.asarray(steps, np.int64), np.asarray(vals, np.float64)
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )
    except ImportError as e:  # pragma: no cover
        raise FileNotFoundError(f"no metrics.jsonl in {exp_dir} and "
                                f"tensorboard unavailable: {e}") from e
    acc = EventAccumulator(os.path.join(exp_dir, "tb"))
    acc.Reload()
    events = acc.Scalars(metric)
    return (np.asarray([e.step for e in events], np.int64),
            np.asarray([e.value for e in events], np.float64))


def _align(runs, num_points: int = 200):
    """Interpolate each (steps, vals) run onto a common step grid."""
    lo = max(r[0][0] for r in runs)
    hi = min(r[0][-1] for r in runs)
    grid = np.linspace(lo, hi, num_points)
    mat = np.stack([np.interp(grid, s, v) for s, v in runs])
    return grid, mat


def mean_std_plot(exp_dirs: list[str], metrics: list[str], out: str,
                  labels: list[str] | None = None, smooth: int = 1,
                  group_by: str | None = "suffix") -> None:
    """Mean±std training curves across seed groups
    (paper/mean_std_plots_quad_baseline.py:63-116).

    Experiments whose basename differs only by a `_s<seed>`/`_seed<seed>`
    suffix form one group (group_by='suffix'); pass group_by=None to treat
    every directory as its own curve.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups: dict[str, list[str]] = {}
    for d in exp_dirs:
        name = os.path.basename(os.path.normpath(d))
        if group_by == "suffix":
            import re
            name = re.sub(r"_(s|seed)\d+$", "", name)
        groups.setdefault(name, []).append(d)

    fig, axes = plt.subplots(1, len(metrics), squeeze=False,
                             figsize=(6 * len(metrics), 4))
    for mi, metric in enumerate(metrics):
        ax = axes[0][mi]
        for gi, (gname, dirs) in enumerate(sorted(groups.items())):
            runs = [extract_scalars(d, metric) for d in dirs]
            runs = [r for r in runs if len(r[0]) >= 2]
            if not runs:
                continue
            grid, mat = _align(runs)
            if smooth > 1:
                k = np.ones(smooth) / smooth
                mat = np.apply_along_axis(
                    lambda v: np.convolve(v, k, mode="same"), 1, mat)
            mean, std = mat.mean(0), mat.std(0)
            label = labels[gi] if labels else gname
            ax.plot(grid, mean, label=label)
            ax.fill_between(grid, mean - std, mean + std, alpha=0.25)
        ax.set_xlabel("Env. steps")
        ax.set_ylabel(metric)
        ax.grid(alpha=0.3)
        ax.legend()
    fig.tight_layout()
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)


def fps_compare(measured_sps: dict[int, float] | None, out: str) -> None:
    """Grouped SPS bar chart vs the reference's published numbers
    (paper/fps_compare.py).  `measured_sps` maps num_agents -> agent-steps/s
    of this port, measured on the card."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ns = sorted(REFERENCE_SPS)
    x = np.arange(len(ns))
    width = 0.27
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(x - width, [PYBULLET_SPS[n] for n in ns], width,
           label="gym-pybullet-drones (published)")
    ax.bar(x, [REFERENCE_SPS[n] for n in ns], width,
           label="QuadSwarm (published)")
    if measured_sps:
        ax.bar(x + width, [measured_sps.get(n, 0) for n in ns], width,
               label="quadswarm_tpu_torch (measured)")
        ax.set_yscale("log")
    ax.set_xticks(x, [str(n) for n in ns])
    ax.set_xlabel("Number of Quadrotors")
    ax.set_ylabel("Simulation agent-steps per second")
    ax.legend()
    ax.grid(alpha=0.3, axis="y")
    fig.tight_layout()
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--experiments", nargs="+", default=[],
                   help="experiment dirs (glob patterns ok)")
    p.add_argument("--metrics", nargs="+",
                   default=["metric/agent_success_rate"])
    p.add_argument("--out", default="curves.png")
    p.add_argument("--smooth", type=int, default=1)
    p.add_argument("--fps_compare", action="store_true",
                   help="emit the SPS bar chart instead (reads --measured)")
    p.add_argument("--measured", type=str, default=None,
                   help='JSON dict {"8": sps, ...} of measured throughput')
    args = p.parse_args(argv)

    if args.fps_compare:
        measured = ({int(k): float(v) for k, v in
                     json.loads(args.measured).items()}
                    if args.measured else None)
        fps_compare(measured, args.out)
        return 0

    dirs = [d for pat in args.experiments for d in sorted(glob.glob(pat))]
    if not dirs:
        p.error("no experiment dirs matched")
    mean_std_plot(dirs, args.metrics, args.out, smooth=args.smooth)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
