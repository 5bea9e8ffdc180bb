"""Attention heat-map from a trained checkpoint.

    python -m quadswarm_tpu_torch.analysis.attention --train_dir=DIR
        --experiment=NAME [--device=cpu]

Port of quadswarm_tpu/analysis/attention.py: roll the deterministic policy
for one episode of one env, record the CoRL neighbour-attention softmax
(`models/encoders.py::recorded_attention`), map each neighbour slot back to
the drone it holds that tick (`env/neighbors.py::neighbor_indices`), and
average the (N, N) who-attends-to-whom matrix over the episode.  The
matrix adds up on the device; the host reads it once, at the end.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def episode_attention(env_cfg, dyn, model, gen, max_ticks: int = 0,
                      device="cuda") -> np.ndarray:
    """Mean (N, N) attention matrix over one episode: row i = how much
    drone i's neighbour encoder attends to each other drone (rows sum to 1;
    the diagonal is 0, self is not a neighbour token).  `max_ticks` 0 is
    the whole episode (ep_len ticks, as the JAX tool); the episode's done
    tick ends it in any case."""
    import torch

    from quadswarm_tpu_torch.env.multi import batched_env_step, env_reset
    from quadswarm_tpu_torch.env.neighbors import neighbor_indices
    from quadswarm_tpu_torch.models.encoders import recorded_attention
    from quadswarm_tpu_torch.utils.struct import resolve_device

    n, k = env_cfg.num_agents, env_cfg.num_use_neighbor_obs
    if k <= 0:
        raise ValueError("attention heat-map needs neighbor obs "
                         "(quads_neighbor_visible_num > 0)")
    device = resolve_device(device)
    states, obs = env_reset(env_cfg, dyn, gen, 1, device=device)
    ticks = min(max_ticks if max_ticks > 0 else env_cfg.ep_len,
                env_cfg.ep_len + 1)          # done at tick ep_len + 1
    acc = torch.zeros((n, n), dtype=torch.float64, device=device)
    rows = torch.arange(n, device=device)[:, None].expand(n, k)
    with torch.no_grad(), recorded_attention(model) as sinks:
        actor = sinks["actor_encoder.neighbor_encoder"]
        for _ in range(ticks):
            mean, _, _ = model(obs[0])
            attn = actor[-1]                                   # (N, k)
            for sink in sinks.values():
                sink.clear()
            idx = neighbor_indices(states.dyn.pos[0], states.dyn.vel[0], k)
            acc.index_put_((rows, idx), attn.double(), accumulate=True)
            states, obs, _, _, _ = batched_env_step(
                env_cfg, dyn, states, mean.to(env_cfg.dtype)[None], gen,
                auto_reset=False)
    acc = acc.cpu().numpy()
    return acc / np.maximum(acc.sum(axis=1, keepdims=True), 1e-12)


def plot_heatmap(matrix: np.ndarray, out: str,
                 title: str = "Attention weights"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from quadswarm_tpu_torch.utils.render import QUAD_COLORS

    n = matrix.shape[0]
    fig, ax = plt.subplots(figsize=(4.2, 3.6))
    im = ax.imshow(matrix, cmap="Reds", vmin=0.0,
                   vmax=max(0.66, float(matrix.max())))
    labels = [QUAD_COLORS[i % len(QUAD_COLORS)] for i in range(n)]
    ax.set_xticks(range(n), labels, rotation=45, ha="right", fontsize=7)
    ax.set_yticks(range(n), labels, fontsize=7)
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(out, bbox_inches="tight", pad_inches=0.02)
    plt.close(fig)


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from quadswarm_tpu_torch.env.params import make_dynamics_params
    from quadswarm_tpu_torch.training.config import (
        env_config_from_args, load_cfg, model_from_args,
    )
    from quadswarm_tpu_torch.utils.checkpoint import (
        checkpoint_dir, latest_checkpoint, load_checkpoint,
    )

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--train_dir", default="train_dir")
    parser.add_argument("--experiment", default="quad_swarm_tpu")
    parser.add_argument("--out", default="attn_heatmap.png")
    parser.add_argument("--max_ticks", default=0, type=int,
                        help="0 = one full episode")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = load_cfg(os.path.join(args.train_dir, args.experiment))
    env_cfg = env_config_from_args(cfg)
    if cfg.quads_neighbor_encoder_type != "attention":
        raise ValueError("attention heat-map needs "
                         "--quads_neighbor_encoder_type=attention "
                         f"(experiment used {cfg.quads_neighbor_encoder_type})")
    torch.manual_seed(args.seed)
    model = model_from_args(cfg, env_cfg, device=args.device)
    cp = latest_checkpoint(checkpoint_dir(args.train_dir, args.experiment))
    if cp is None:
        print("WARNING: no checkpoint found, using random init")
    else:
        model.load_state_dict(load_checkpoint(cp)["model"])
        print(f"checkpoint loaded from {cp}")
    gen = torch.Generator(args.device).manual_seed(args.seed)
    matrix = episode_attention(env_cfg, make_dynamics_params(dt=env_cfg.dt),
                               model, gen, max_ticks=args.max_ticks,
                               device=args.device)
    plot_heatmap(matrix, args.out,
                 title=f"Attention weights ({args.experiment})")
    print(json.dumps({"out": args.out,
                      "mean_offdiag": float(
                          matrix.sum() / (matrix.shape[0] ** 2
                                          - matrix.shape[0]))}))
    print(f"heat-map -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
