"""Sim2real: a trained actor as dependency-free C for the Crazyflie firmware.

Port of quadswarm_tpu/sim2real/codegen.py.  The trained weights become
static C arrays walked by nested loops with tanhf activations, exposed as
`networkEvaluate(control_t_n*, const float* state_array)`:

  * `generate_c_model`           - the plain MLP chain (single-drone
    policies);
  * `generate_c_model_attention` - the self/neighbour/obstacle embeddings
    and a single-head attention block (the sim2real encoder variant).

The generators and C templates take numpy and emit text: for the same
float32 arrays they give the JAX package's bytes.  `actor_mlp_layers` and
`attention_actor_parts` read the port's `ActorCritic` (or its state dict)
to the host as float32 `(kernel (in, out), bias)` pairs; nothing runs on a
device.  `torch_to_c_model` is the export (the original reference's name,
swarm_rl/sim2real/sim2real.py:47-57).  It refuses, rather than emit C that
computes something other than the model, a 'corl' actor with a neighbour
or obstacle encoder (the MLP chain has no place for them) and an attention
block of more than one head (the C loops one head).

    python -m quadswarm_tpu_torch.sim2real.codegen --model_dir \\
        train_dir/<experiment> --output_dir c_models --model_type attention
"""
from __future__ import annotations

import os

import numpy as np

CONTROL_STRUCT = """
typedef struct control_t_n {
    float thrust_0;
    float thrust_1;
    float thrust_2;
    float thrust_3;
} control_t_n;
"""

HEADERS_FIRMWARE = """#include "network_evaluate.h"
#include <math.h>
"""

HEADERS_TESTING = """#include <math.h>
%s
extern "C" void networkEvaluate(control_t_n* control_n, const float* state_array);
""" % CONTROL_STRUCT


def _f(v: float) -> str:
    s = f"{v:.9g}"
    if "." not in s and "e" not in s and "inf" not in s and "nan" not in s:
        s += ".0"
    return s + "f"


def _c_array_2d(name: str, arr: np.ndarray) -> str:
    rows = ",\n    ".join(
        "{" + ", ".join(_f(v) for v in row) + "}" for row in arr)
    return (f"static const float {name}[{arr.shape[0]}][{arr.shape[1]}] = "
            + "{\n    " + rows + "\n};\n")


def _c_array_1d(name: str, arr: np.ndarray) -> str:
    vals = ", ".join(_f(v) for v in arr)
    return f"static const float {name}[{arr.shape[0]}] = {{{vals}}};\n"




def _host(t) -> np.ndarray:
    """A tensor's values as a float32 numpy array on the host."""
    return t.detach().cpu().float().numpy()


def _state_dict(model_or_state_dict) -> dict:
    sd = model_or_state_dict
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def _dense(sd: dict, prefix: str) -> tuple[np.ndarray, np.ndarray]:
    """One dense layer as (kernel (in, out), bias): `nn.Linear.weight` is
    (out, in)."""
    return _host(sd[prefix + ".weight"]).T, _host(sd[prefix + ".bias"])


def mlp_chain(sd: dict, prefix: str) -> list[tuple[np.ndarray, np.ndarray]]:
    """(kernel, bias) of each dense layer of the MLP at `prefix`, in order
    (`layers.0`, `layers.1`, ...)."""
    layers = []
    while f"{prefix}.layers.{len(layers)}.weight" in sd:
        layers.append(_dense(sd, f"{prefix}.layers.{len(layers)}"))
    return layers


def actor_mlp_layers(model_or_state_dict) -> list[tuple[np.ndarray,
                                                         np.ndarray]]:
    """The actor chain of a 'corl' ActorCritic without neighbour and
    obstacle encoders: self_encoder's two dense layers (tanh) ->
    feed_forward (tanh) -> action_head (linear).  Raises ValueError on an
    actor with a neighbour or obstacle encoder, whose feed_forward reads
    more than the self encoder's output."""
    sd = _state_dict(model_or_state_dict)
    extra = sorted({name for name in ("neighbor_encoder", "obstacle_encoder")
                    if any(k.startswith(f"actor_encoder.{name}.")
                           for k in sd)})
    if extra:
        raise ValueError(
            f"the actor has a {' and an '.join(extra)}: the single-model C "
            "export chains only self_encoder -> feed_forward -> action_head, "
            "and its feed_forward reads the other encoders' outputs too, so "
            "the emitted C would read past the self encoder's output (the "
            "JAX package's flax_to_c_model emits such C without a warning; "
            "ROADMAP.md Queue 3); export a model without neighbour and "
            "obstacle encoders, or use --model_type=attention on a "
            "--quads_sim2real=True attention model")
    return (mlp_chain(sd, "actor_encoder.self_encoder")
            + [_dense(sd, "actor_encoder.feed_forward"),
               _dense(sd, "action_head")])


def generate_c_model(layers: list[tuple[np.ndarray, np.ndarray]],
                     output_path: str | None = None,
                     testing: bool = False) -> str:
    """Emit the MLP-chain C source (reference generate_c_model,
    sim2real.py:570-673): all layers tanh except the last (linear)."""
    num_layers = len(layers)
    src = HEADERS_TESTING if testing else HEADERS_FIRMWARE
    structure = ("static const int structure[" + str(num_layers) + "][2] = {"
                 + ",".join("{%d, %d}" % (k.shape[0], k.shape[1])
                            for k, _ in layers) + "};\n")
    src += structure
    for i, (k, b) in enumerate(layers):
        src += _c_array_2d(f"layer_{i}_w", k)
        src += _c_array_1d(f"layer_{i}_b", b)
        src += f"static float output_{i}[{k.shape[1]}];\n"

    body = ""
    for i in range(num_layers):
        inp = "state_array" if i == 0 else f"output_{i - 1}"
        act = "" if i == num_layers - 1 else f"output_{i}[i] = tanhf(output_{i}[i]);"
        body += f"""
    for (int i = 0; i < structure[{i}][1]; i++) {{
        output_{i}[i] = 0;
        for (int j = 0; j < structure[{i}][0]; j++) {{
            output_{i}[i] += {inp}[j] * layer_{i}_w[j][i];
        }}
        output_{i}[i] += layer_{i}_b[i];
        {act}
    }}
"""
    last = num_layers - 1
    extern = 'extern "C" ' if testing else ""
    src += f"""
{extern}void networkEvaluate(control_t_n* control_n, const float* state_array) {{{body}
    control_n->thrust_0 = output_{last}[0];
    control_n->thrust_1 = output_{last}[1];
    control_n->thrust_2 = output_{last}[2];
    control_n->thrust_3 = output_{last}[3];
}}
"""
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with open(output_path, "w") as f:
            f.write(src)
    return src


# ---------------------------------------------------------------------------
# Attention (sim2real single-head) variant
# ---------------------------------------------------------------------------

def attention_actor_parts(model_or_state_dict) -> dict:
    """The sim2real attention actor's weight groups (the single-head
    QuadMultiHeadAttentionEncoder).  Raises ValueError on an attention
    block of more than one head: the C loops one head of width d, which
    a (d, heads * d) projection does not fit."""
    sd = _state_dict(model_or_state_dict)
    att = "actor_encoder.attention"
    w_qs = _host(sd[att + ".w_qs.weight"]).T
    if w_qs.shape[1] != w_qs.shape[0]:
        raise ValueError(
            f"the attention block has {w_qs.shape[1] // w_qs.shape[0]} heads "
            f"(w_qs is {w_qs.shape}): the C export computes one head of "
            "width d (the JAX package's generate_c_model_attention loops "
            "one head over a (d, 4d) w_qs without a warning; ROADMAP.md "
            "Queue 3); train with --quads_sim2real=True for the "
            "single-head encoder")
    return {
        "self_embed": mlp_chain(sd, "actor_encoder.self_embed"),
        "neighbor_embed": mlp_chain(sd, "actor_encoder.neighbor_embed"),
        "obstacle_embed": mlp_chain(sd, "actor_encoder.obstacle_embed"),
        "w_qs": w_qs,
        "w_ks": _host(sd[att + ".w_ks.weight"]).T,
        "w_vs": _host(sd[att + ".w_vs.weight"]).T,
        "fc": _host(sd[att + ".fc.weight"]).T,
        "ln_scale": _host(sd[att + ".layer_norm.weight"]),
        "ln_bias": _host(sd[att + ".layer_norm.bias"]),
        "feed_forward": _dense(sd, "actor_encoder.feed_forward"),
        "action_head": _dense(sd, "action_head"),
    }


def _emit_mlp(src_name: str, dst_name: str, layers, prefix: str) -> tuple[str, str]:
    decls, body = "", ""
    for i, (k, b) in enumerate(layers):
        decls += _c_array_2d(f"{prefix}_{i}_w", k)
        decls += _c_array_1d(f"{prefix}_{i}_b", b)
        out = dst_name if i == len(layers) - 1 else f"{prefix}_out_{i}"
        if out != dst_name:
            decls += f"static float {out}[{k.shape[1]}];\n"
        inp = src_name if i == 0 else f"{prefix}_out_{i - 1}"
        body += f"""
    for (int i = 0; i < {k.shape[1]}; i++) {{
        {out}[i] = 0;
        for (int j = 0; j < {k.shape[0]}; j++) {{
            {out}[i] += {inp}[j] * {prefix}_{i}_w[j][i];
        }}
        {out}[i] = tanhf({out}[i] + {prefix}_{i}_b[i]);
    }}
"""
    return decls, body


def generate_c_model_attention(parts: dict, self_dim: int, neighbor_dim: int,
                               obstacle_dim: int,
                               output_path: str | None = None,
                               testing: bool = False) -> str:
    """Emit the single-head-attention actor in fixed-size C (reference
    generate_c_model_attention, sim2real.py:493-567 + code_blocks.py:142-370).

    Token layout matches the model: tokens[0] = neighbor embed,
    tokens[1] = obstacle embed; self embed bypasses attention.
    """
    d = parts["w_qs"].shape[0]
    src = HEADERS_TESTING if testing else HEADERS_FIRMWARE
    src += f"""
static const int D_MODEL = {d};
static const int NUM_TOKENS = 2;
static float self_embed[{d}];
static float tokens[2][{d}];
static float q_out[2][{d}];
static float k_out[2][{d}];
static float v_out[2][{d}];
static float attn[2][2];
static float attn_out[2][{d}];
static float fc_out[2][{d}];
static float fused_in[{3 * d}];
"""
    decls_self, body_self = _emit_mlp("state_array", "self_embed",
                                      parts["self_embed"], "se")
    decls_nb, body_nb = _emit_mlp(f"(state_array + {self_dim})", "tokens[0]",
                                  parts["neighbor_embed"], "nb")
    decls_ob, body_ob = _emit_mlp(
        f"(state_array + {self_dim + neighbor_dim})", "tokens[1]",
        parts["obstacle_embed"], "ob")
    src += decls_self + decls_nb + decls_ob
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        src += _c_array_2d(name, parts[name])
    src += _c_array_1d("ln_scale", parts["ln_scale"])
    src += _c_array_1d("ln_bias", parts["ln_bias"])
    ff_k, ff_b = parts["feed_forward"]
    src += _c_array_2d("ff_w", ff_k) + _c_array_1d("ff_b", ff_b)
    ah_k, ah_b = parts["action_head"]
    src += _c_array_2d("ah_w", ah_k) + _c_array_1d("ah_b", ah_b)
    src += f"static float ff_out[{ff_k.shape[1]}];\n"
    src += f"static float action_out[{ah_k.shape[1]}];\n"

    extern = 'extern "C" ' if testing else ""
    src += f"""
{extern}void networkEvaluate(control_t_n* control_n, const float* state_array) {{
{body_self}{body_nb}{body_ob}
    // single-head attention over the 2 tokens
    for (int t = 0; t < 2; t++) {{
        for (int i = 0; i < D_MODEL; i++) {{
            q_out[t][i] = 0; k_out[t][i] = 0; v_out[t][i] = 0;
            for (int j = 0; j < D_MODEL; j++) {{
                q_out[t][i] += tokens[t][j] * w_qs[j][i];
                k_out[t][i] += tokens[t][j] * w_ks[j][i];
                v_out[t][i] += tokens[t][j] * w_vs[j][i];
            }}
        }}
    }}
    float scale = 1.0f / sqrtf((float)D_MODEL);
    for (int t = 0; t < 2; t++) {{
        float m = -1e30f;
        for (int u = 0; u < 2; u++) {{
            attn[t][u] = 0;
            for (int i = 0; i < D_MODEL; i++) attn[t][u] += q_out[t][i] * scale * k_out[u][i];
            if (attn[t][u] > m) m = attn[t][u];
        }}
        float s = 0;
        for (int u = 0; u < 2; u++) {{ attn[t][u] = expf(attn[t][u] - m); s += attn[t][u]; }}
        for (int u = 0; u < 2; u++) attn[t][u] /= s;
    }}
    for (int t = 0; t < 2; t++) {{
        for (int i = 0; i < D_MODEL; i++) {{
            attn_out[t][i] = 0;
            for (int u = 0; u < 2; u++) attn_out[t][i] += attn[t][u] * v_out[u][i];
        }}
    }}
    // fc + residual + layernorm
    for (int t = 0; t < 2; t++) {{
        for (int i = 0; i < D_MODEL; i++) {{
            fc_out[t][i] = 0;
            for (int j = 0; j < D_MODEL; j++) fc_out[t][i] += attn_out[t][j] * fc[j][i];
            fc_out[t][i] += tokens[t][i];
        }}
        float mean = 0;
        for (int i = 0; i < D_MODEL; i++) mean += fc_out[t][i];
        mean /= D_MODEL;
        float var = 0;
        for (int i = 0; i < D_MODEL; i++) var += (fc_out[t][i] - mean) * (fc_out[t][i] - mean);
        var /= D_MODEL;
        float inv = 1.0f / sqrtf(var + 1e-6f);
        for (int i = 0; i < D_MODEL; i++)
            fc_out[t][i] = (fc_out[t][i] - mean) * inv * ln_scale[i] + ln_bias[i];
    }}
    // fuse [self, token0, token1] -> feed_forward (tanh) -> action head
    for (int i = 0; i < D_MODEL; i++) {{
        fused_in[i] = self_embed[i];
        fused_in[D_MODEL + i] = fc_out[0][i];
        fused_in[2 * D_MODEL + i] = fc_out[1][i];
    }}
    for (int i = 0; i < {ff_k.shape[1]}; i++) {{
        ff_out[i] = 0;
        for (int j = 0; j < {ff_k.shape[0]}; j++) ff_out[i] += fused_in[j] * ff_w[j][i];
        ff_out[i] = tanhf(ff_out[i] + ff_b[i]);
    }}
    for (int i = 0; i < {ah_k.shape[1]}; i++) {{
        action_out[i] = 0;
        for (int j = 0; j < {ah_k.shape[0]}; j++) action_out[i] += ff_out[j] * ah_w[j][i];
        action_out[i] += ah_b[i];
    }}
    control_n->thrust_0 = action_out[0];
    control_n->thrust_1 = action_out[1];
    control_n->thrust_2 = action_out[2];
    control_n->thrust_3 = action_out[3];
}}
"""
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with open(output_path, "w") as f:
            f.write(src)
    return src



def torch_to_c_model(model_or_state_dict, output_path: str,
                     encoder_type: str = "corl", self_dim: int = 18,
                     neighbor_dim: int = 36, obstacle_dim: int = 9,
                     testing: bool = False) -> str:
    """The export (the JAX package's `flax_to_c_model`): the C source of
    the actor of an `ActorCritic` or its state dict, written to
    `output_path` and returned.  `encoder_type` 'attention' emits the
    single-head attention actor, which reads the neighbour slice at
    `state_array + self_dim` and the obstacle slice at `state_array +
    self_dim + neighbor_dim`; any other type the MLP chain."""
    if encoder_type == "attention":
        parts = attention_actor_parts(model_or_state_dict)
        return generate_c_model_attention(parts, self_dim, neighbor_dim,
                                          obstacle_dim, output_path, testing)
    layers = actor_mlp_layers(model_or_state_dict)
    return generate_c_model(layers, output_path, testing)


def export_dims(cfg) -> dict:
    """self_dim, neighbor_dim and obstacle_dim of a training config (the
    saved config.json as a namespace): the widths of the observation's
    three slices."""
    from quadswarm_tpu_torch.env.obs import (
        NEIGHBOR_OBS_SIZES, OBS_REPR_SIZES, OBSTACLE_OBS_SIZES,
    )
    from quadswarm_tpu_torch.training.config import env_config_from_args

    env_cfg = env_config_from_args(cfg)
    return {"self_dim": OBS_REPR_SIZES[env_cfg.obs_repr],
            "neighbor_dim": (NEIGHBOR_OBS_SIZES[env_cfg.neighbor_obs_type]
                             * env_cfg.num_use_neighbor_obs),
            "obstacle_dim": (OBSTACLE_OBS_SIZES["octomap"]
                             if env_cfg.use_obstacles else 0)}


def main(argv=None) -> int:
    """The CLI (the JAX package's flags): the C actor of an experiment's
    newest checkpoint, read on the host.  The slice widths come from the
    experiment's config.json."""
    import argparse

    import torch

    from quadswarm_tpu_torch.training.config import load_cfg, str2bool
    from quadswarm_tpu_torch.utils.checkpoint import latest_checkpoint

    p = argparse.ArgumentParser("quadswarm_tpu_torch.sim2real")
    p.add_argument("--model_dir", required=True,
                   help="experiment dir (train_dir/<experiment>) with "
                        "config.json + checkpoint_p0/")
    p.add_argument("--output_dir", default="c_models")
    p.add_argument("--output_model_name", default="model.c")
    p.add_argument("--model_type", choices=["single", "attention"],
                   default="single",
                   help="single: MLP-chain actor; attention: the sim2real "
                        "single-head-attention encoder")
    p.add_argument("--testing", default=False, type=str2bool)
    args = p.parse_args(argv)

    cfg = load_cfg(args.model_dir)
    cp = latest_checkpoint(os.path.join(args.model_dir, "checkpoint_p0"))
    if cp is None:
        raise SystemExit(f"no checkpoint under {args.model_dir}")
    state = torch.load(cp, map_location="cpu", weights_only=True)["model"]
    out = os.path.join(args.output_dir, args.output_model_name)
    torch_to_c_model(
        state, out,
        encoder_type="attention" if args.model_type == "attention" else "corl",
        testing=args.testing, **export_dims(cfg))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
