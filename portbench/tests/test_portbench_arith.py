"""The yardstick's arithmetic at known shapes: the model's float operations
against the products the port's actor-critic really runs, and the kernels'
least times against the bounds in PERF.md's kernel table."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import arith  # noqa: E402

H100 = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}


def _flags(**kw):
    f = dict(quads_obs_repr="xyz_vxyz_R_omega", quads_neighbor_obs_type="pos_vel",
             quads_neighbor_visible_num=6, rnn_size=32,
             quads_neighbor_hidden_size=24, quads_use_obstacles=False,
             quads_obstacle_obs_type="none", quads_obst_hidden_size=20,
             quads_encoder_type="corl", quads_neighbor_encoder_type="attention",
             quads_sim2real=False)
    f.update(kw)
    return f


def _counted_flops(flags) -> float:
    """2 * rows * in * out over every dense layer the port's model runs,
    per sample, by forward hooks."""
    from quadswarm_tpu_torch.models.actor_critic import ActorCritic
    from quadswarm_tpu_torch.models.encoders import Dense
    obst = flags["quads_use_obstacles"]
    model = ActorCritic(
        self_obs_dim=arith.SELF_OBS[flags["quads_obs_repr"]],
        neighbor_obs_dim=6, num_neighbors=flags["quads_neighbor_visible_num"],
        encoder_type=flags["quads_encoder_type"],
        neighbor_encoder_type=flags["quads_neighbor_encoder_type"],
        neighbor_hidden=flags["quads_neighbor_hidden_size"],
        use_obstacles=flags["quads_obstacle_obs_type"] == "octomap",
        obstacle_obs_dim=9 if obst else 0,
        obstacle_hidden=flags["quads_obst_hidden_size"],
        rnn_size=flags["rnn_size"], device="cpu")
    total = [0]

    def hook(mod, inp, out):
        rows = inp[0].numel() // inp[0].shape[-1]
        total[0] += 2 * rows * mod.in_features * mod.out_features
    for m in model.modules():
        if isinstance(m, Dense):
            m.register_forward_hook(hook)
    b = 5
    dim = (arith.SELF_OBS[flags["quads_obs_repr"]]
           + 6 * flags["quads_neighbor_visible_num"] + (9 if obst else 0))
    model(torch.randn(b, dim))
    return total[0] / b


@pytest.mark.parametrize("kind", ["attention", "mean_embed", "mlp",
                                  "no_encoder"])
@pytest.mark.parametrize("obstacles", [False, True])
def test_forward_flops_match_the_dense_products(kind, obstacles):
    f = _flags(quads_neighbor_encoder_type=kind,
               quads_use_obstacles=obstacles,
               quads_obstacle_obs_type="octomap" if obstacles else "none",
               quads_obs_repr="xyz_vxyz_R_omega_wall" if obstacles
               else "xyz_vxyz_R_omega")
    assert arith.forward_flops(f) == _counted_flops(f)


def test_attention_encoder_type_counts_its_score_products():
    f = _flags(quads_encoder_type="attention", quads_use_obstacles=True,
               quads_obstacle_obs_type="octomap",
               quads_obs_repr="xyz_vxyz_R_omega_wall")
    r, heads = f["rnn_size"], 4
    # q.k and attn.v over two tokens, each head, both encoders, 2 a MAC
    scores = 2 * 2 * heads * (2 * 2 * r + 2 * 2 * r)
    assert arith.forward_flops(f) == _counted_flops(f) + scores


def test_the_configurations_forward_flops():
    # train.sh's model at 256 wide: 10,925,056 operations a sample
    f = _flags(rnn_size=256, quads_neighbor_hidden_size=256)
    assert arith.forward_flops(f) == 10_925_056


def test_kernel_bounds_at_the_kernel_table_shapes():
    # PERF.md's table: K1 0.746 us at B = 8,192 (bytes), K3 1.643 us at
    # 256 x 128 with k = 6 (bytes)
    assert arith.k1_bound_s(8192, 2, H100) == pytest.approx(0.746e-6,
                                                            rel=1e-3)
    assert arith.k3_bound_s(256, 128, 6, H100) == pytest.approx(1.643e-6,
                                                                rel=1e-3)


def test_peaks_by_card_name():
    assert arith.peaks("NVIDIA H100 80GB HBM3") == {
        **H100, "source": arith.peaks("H100")["source"]}
    with pytest.raises(KeyError):
        arith.peaks("NVIDIA A100")
