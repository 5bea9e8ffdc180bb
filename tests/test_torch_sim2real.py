"""The port's sim2real C export (quadswarm_tpu_torch/sim2real/codegen.py)
against the JAX package's on the CPU.

- The C text of `torch_to_c_model` on weights carried over from a flax
  tree (`utils/convert.py::actor_critic_from_flax`) is the JAX
  `flax_to_c_model`'s, byte for byte, for the no-neighbour 'corl' actor
  and the sim2real attention actor (no compile needed).
- One g++/ctypes build of each matches the port's forward (atol 1e-5 and
  2e-5, as tests/test_sim2real.py).
- The CLI exports the checkpoint of a tiny run of the port's train CLI,
  with the slice widths of its config, and the C compiles.
- The refusals: a 'corl' actor with a neighbour encoder and a 4-head
  attention block raise ValueError; on the same weights the JAX export
  emits C whose `structure` chain breaks, and a one-head loop over a
  (d, 4d) w_qs.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from quadswarm_tpu.models.actor_critic import ActorCritic as JActorCritic
from quadswarm_tpu.sim2real.codegen import flax_to_c_model
from quadswarm_tpu_torch.models.actor_critic import ActorCritic
from quadswarm_tpu_torch.sim2real import codegen
from quadswarm_tpu_torch.training import train
from quadswarm_tpu_torch.utils.convert import actor_critic_from_flax

from .flax_params import random_flax_params

RNN = 16
# name -> (JAX ActorCritic kwargs, obs width, the port's extra kwargs,
#          torch_to_c_model's kwargs, forward atol)
MODELS = {
    "corl": (dict(self_obs_dim=18, neighbor_obs_dim=0, num_neighbors=0,
                  encoder_type="corl", neighbor_encoder_type="no_encoder",
                  rnn_size=RNN), 18, {}, dict(encoder_type="corl"), 1e-5),
    "attention": (dict(self_obs_dim=18, neighbor_obs_dim=6, num_neighbors=6,
                       encoder_type="attention", sim2real=True, rnn_size=RNN,
                       use_obstacles=True), 63, dict(obstacle_obs_dim=9),
                  dict(encoder_type="attention", self_dim=18,
                       neighbor_dim=36, obstacle_dim=9), 2e-5),
}


class ControlTN(ctypes.Structure):
    _fields_ = [("thrust_0", ctypes.c_float), ("thrust_1", ctypes.c_float),
                ("thrust_2", ctypes.c_float), ("thrust_3", ctypes.c_float)]


def _both(name: str, seed: int = 0):
    """The flax tree and the port's model carrying its weights."""
    jkw, obs_dim, tkw, _, _ = MODELS[name]
    tree = random_flax_params(JActorCritic(**jkw), obs_dim, seed)
    kw = {k: v for k, v in jkw.items() if k != "use_obstacles"}
    model = ActorCritic(**kw, **tkw, device="cpu")
    model.load_state_dict(actor_critic_from_flax(tree))
    return tree, model


def _build(src_path, tmp_path):
    lib_path = tmp_path / "model.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                    str(src_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.networkEvaluate.argtypes = [ctypes.POINTER(ControlTN),
                                    ctypes.POINTER(ctypes.c_float)]
    lib.networkEvaluate.restype = None
    return lib


def _c_forward(lib, obs: np.ndarray) -> np.ndarray:
    out = np.zeros((obs.shape[0], 4), np.float32)
    for i, row in enumerate(obs.astype(np.float32)):
        ctrl = ControlTN()
        lib.networkEvaluate(ctypes.byref(ctrl),
                            (ctypes.c_float * row.size)(*row))
        out[i] = [ctrl.thrust_0, ctrl.thrust_1, ctrl.thrust_2, ctrl.thrust_3]
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_c_text_equals_jax_byte_for_byte(name, tmp_path):
    tree, model = _both(name)
    kw = MODELS[name][3]
    for testing in (True, False):
        want = flax_to_c_model(tree, str(tmp_path / "j.c"),
                               testing=testing, **kw)
        got = codegen.torch_to_c_model(model, str(tmp_path / "t.c"),
                                       testing=testing, **kw)
        assert got == want
        assert (tmp_path / "t.c").read_bytes() == (tmp_path / "j.c"
                                                   ).read_bytes()
    # the state dict exports the same text as the model
    assert codegen.torch_to_c_model(model.state_dict(), None, testing=False,
                                    **kw) == want


@pytest.mark.parametrize("name", list(MODELS))
def test_one_build_matches_the_port_forward(name, tmp_path):
    _, model = _both(name, seed=1)
    _, obs_dim, _, kw, atol = MODELS[name]
    src = tmp_path / "network_evaluate.c"
    codegen.torch_to_c_model(model, str(src), testing=True, **kw)
    lib = _build(src, tmp_path)
    obs = np.random.default_rng(1).uniform(-1, 1, (1000, obs_dim)).astype(
        np.float32)
    with torch.no_grad():
        mean, _, _ = model(torch.from_numpy(obs))
    np.testing.assert_allclose(_c_forward(lib, obs), mean.numpy(), atol=atol)


@pytest.mark.parametrize("model_type,flags,offsets", [
    ("single", ["--quads_num_agents=1", "--quads_neighbor_obs_type=none",
                "--quads_neighbor_visible_num=0",
                "--quads_neighbor_encoder_type=no_encoder"], ()),
    # the final obstacle run's layout: 2 of the neighbours visible, 12
    # wide, so the obstacle slice starts at 18 + 12
    ("attention", ["--quads_num_agents=3", "--quads_neighbor_obs_type=pos_vel",
                   "--quads_neighbor_visible_num=2",
                   "--quads_encoder_type=attention", "--quads_sim2real=True",
                   "--quads_use_obstacles=True", "--quads_mode=o_random",
                   "--quads_obstacle_obs_type=octomap"], (18, 30)),
])
def test_cli_exports_a_checkpoint_of_the_train_cli(model_type, flags,
                                                   offsets, tmp_path,
                                                   monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train.main([
        "--experiment=s2r", f"--train_dir={tmp_path}", "--device=cpu",
        "--train_for_env_steps=8", "--num_envs=2", "--rollout=4",
        "--batch_size=8", "--quads_episode_duration=1.0",
        f"--rnn_size={RNN}", *flags]) == 0
    out_dir = tmp_path / "c"
    assert codegen.main(["--model_dir", str(tmp_path / "s2r"),
                         "--output_dir", str(out_dir), "--testing", "True",
                         "--model_type", model_type]) == 0
    text = (out_dir / "model.c").read_text()
    assert re.findall(r"state_array \+ (\d+)", text) == [str(o)
                                                       for o in offsets]
    subprocess.run(["g++", "-c", str(out_dir / "model.c"), "-o",
                    str(out_dir / "m.o")], check=True, capture_output=True)


def _structure(text: str) -> list:
    row = re.search(r"structure\[\d+\]\[2\] = \{(.*)\};", text).group(1)
    return [tuple(map(int, r)) for r in re.findall(r"\{(\d+), (\d+)\}", row)]


def test_refuses_a_corl_actor_with_a_neighbour_encoder(tmp_path):
    """The JAX export chains self_encoder -> feed_forward -> action_head
    and emits a feed_forward row reading rnn + neighbour_hidden inputs
    from the self encoder's rnn outputs."""
    kw = dict(self_obs_dim=18, neighbor_obs_dim=6, num_neighbors=2,
              encoder_type="corl", neighbor_encoder_type="attention",
              rnn_size=RNN, neighbor_hidden=RNN)
    tree = random_flax_params(JActorCritic(**kw), 30, 2)
    rows = _structure(flax_to_c_model(tree, None))
    assert rows[1][1] == RNN and rows[2][0] == 2 * RNN
    model = ActorCritic(**kw, device="cpu")
    model.load_state_dict(actor_critic_from_flax(tree))
    with pytest.raises(ValueError, match="neighbor_encoder"):
        codegen.torch_to_c_model(model, str(tmp_path / "m.c"))
    assert not (tmp_path / "m.c").exists()


def test_refuses_a_multi_head_attention_block(tmp_path):
    """On the 4-head encoder the JAX export loops one head of width d over
    a (d, 4d) w_qs and a (4d, d) fc."""
    kw = dict(self_obs_dim=18, neighbor_obs_dim=6, num_neighbors=6,
              encoder_type="attention", rnn_size=RNN)
    tree = random_flax_params(JActorCritic(**kw, use_obstacles=True), 63, 3)
    text = flax_to_c_model(tree, None, encoder_type="attention")
    assert f"static const int D_MODEL = {RNN};" in text
    assert f"w_qs[{RNN}][{4 * RNN}]" in text and f"fc[{4 * RNN}][{RNN}]" in text
    assert "for (int j = 0; j < D_MODEL; j++)" in text
    model = ActorCritic(**kw, obstacle_obs_dim=9, device="cpu")
    model.load_state_dict(actor_critic_from_flax(tree))
    with pytest.raises(ValueError, match="4 heads"):
        codegen.torch_to_c_model(model, str(tmp_path / "m.c"),
                                 encoder_type="attention")
