"""The port's trainers and CLI over ranks: APPO's split, both PBT forms and
`--multi_host`.

Worlds of 2 gloo processes on the CPU (`tests/torch_dist_worker.py`):
- APPO with `split_mesh=(1, 1)`: the env state and the behaviour queue
  only on rank 0, the optimizer only on rank 1; the losses finite; rank 1
  broadcasts weights and normalizer that rank 0 holds bit for bit; on the
  trajectory rank 1 received, its learner equals the one-process APPO
  learner within the learner check's bound (parameters within the
  learning rate);
  R + L other than the world size raises, in the JAX package's words;
- separate PBT: every round's objectives, the coefficients and the
  weights are equal on both ranks;
- mixed-policy PBT: the stacked weights, normalizers, losses and
  objective histories are equal on both ranks, each rank holding half the
  envs;
- the train CLI with `--multi_host=True` on 2 ranks (torchrun's
  variables), then a resume, as the JAX package's
  `test_two_process_train_cli_with_resume`.
"""
from __future__ import annotations

import json
import socket
import sys

import numpy as np
import pytest
import torch

from quadswarm_tpu_torch.env.params import make_dynamics_params
from quadswarm_tpu_torch.parallel import appo as t_appo
from quadswarm_tpu_torch.utils import checkpoint as t_ckpt

from .test_torch_training import RUN_CLI, TINY, _train_sh_flags
from .torch_dist_worker import launch, model, tiny_appo_cfg


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def appo_split(tmp_path_factory):
    return launch("appo_split", tmp_path_factory.mktemp("appo_split"))


def test_appo_split_places_rollout_and_learner_apart(appo_split):
    roll, learn = appo_split
    assert (roll["env"], roll["queue"], roll["optimizer"]) == (
        True, True, False)
    assert (learn["env"], learn["queue"], learn["optimizer"]) == (
        False, False, True)
    for r, l in zip(roll["iters"], learn["iters"]):
        assert r["infos"] and not l["infos"]
        assert np.isfinite(r["loss"]) and r["loss"] == l["loss"]
        assert _equal(r["params"], l["params"]) and _equal(r["norm"],
                                                           l["norm"])
        assert r["stats"] == l["stats"]
        assert r["env_steps"] == l["env_steps"]
    assert [i["env_steps"] for i in roll["iters"]] == [48, 96]


def test_appo_split_learner_equals_the_one_process_learner(appo_split):
    """The second iteration's learner on rank 1 against `appo_learn`
    without a mesh from the same weights, Adam state, generator,
    normalizer and trajectory."""
    learn = appo_split[1]
    lr = tiny_appo_cfg()[1].learning_rate
    for k, v in learn["one_process"].items():
        np.testing.assert_allclose(learn["iters"][1]["params"][k].numpy(),
                                   v.numpy(), rtol=0, atol=lr, err_msg=k)


def test_appo_split_needs_a_world_of_r_plus_l():
    cfg, ppo = tiny_appo_cfg()
    with pytest.raises(ValueError,
                       match=r"split_mesh=\(1, 1\) needs 2 devices, have 1"):
        t_appo.APPOTrainer(cfg, ppo, model(), make_dynamics_params(dt=cfg.dt),
                           device="cpu", split_mesh=(1, 1))


def test_separate_pbt_takes_the_same_decisions_on_every_rank(tmp_path):
    a, b = launch("pbt", tmp_path)
    assert len(a["rounds"]) >= 2 and a["rounds"] == b["rounds"]
    assert any(np.isfinite(o).all() for o in a["rounds"])
    assert a["coeffs"] == b["coeffs"] and a["objectives"] == b["objectives"]
    for pa, pb in zip(a["params"], b["params"]):
        assert _equal(pa, pb)
    # only rank 0 writes
    assert sorted(p.name for p in (tmp_path / "pbt").iterdir()) == [
        "checkpoint_p0", "checkpoint_p1", "p0", "p1"]


def test_mixed_pbt_over_two_ranks_stays_in_step(tmp_path):
    a, b = launch("mixed", tmp_path)
    assert a["envs"] == b["envs"] == 2
    assert _equal(a["params"], b["params"]) and _equal(a["norm"], b["norm"])
    for la, lb in zip(a["losses"], b["losses"]):
        assert torch.equal(la, lb) and torch.isfinite(la).all()
    assert a["hist"] == b["hist"] and a["coeffs"] == b["coeffs"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_cli_multi_host_on_two_ranks_with_resume(tmp_path):
    steps = 8 * 4 * 4                                   # an iteration
    base = _train_sh_flags() + TINY + [
        f"--train_dir={tmp_path}", "--experiment=mh", "--log_every_iters=1",
        "--multi_host=True"]
    env = {"MASTER_ADDR": "localhost", "WORLD_SIZE": "2",
           "LOCAL_WORLD_SIZE": "2"}
    outs = []
    for iters in (1, 2):
        env["MASTER_PORT"] = str(_free_port())
        outs.append(launch("cli", tmp_path, argv=[
            sys.executable, "-c", RUN_CLI, *base,
            f"--train_for_env_steps={iters * steps}"], env=env))
    for out in outs:
        assert "process 0/2" in out[0] and "process 1/2" in out[1]
        assert "backend gloo (ranks on the CPU)" in out[0]
        assert "steps=" in out[0] and "steps=" not in out[1]
    assert "resumed from" in outs[1][0]
    exp = tmp_path / "mh"
    lines = [json.loads(x) for x in (exp / "metrics.jsonl").read_text()
             .splitlines()]
    assert [r["env_steps"] for r in lines] == [steps, 2 * steps]
    assert all(np.isfinite(r["loss"]) for r in lines)
    cps = t_ckpt.get_checkpoints(str(exp / "checkpoint_p0"))
    assert [t_ckpt.env_steps_of(p) for p in cps] == [steps, 2 * steps]
    assert torch.load(cps[-1], weights_only=True)["step"] == 2 * steps // 32


def test_scaling_tool_shards_the_learner_over_ranks(capsys):
    """analysis/scaling.py at a tiny fixed batch: a world of 1 and of 2
    ranks, each rank of the second feeding the loss half the samples."""
    from quadswarm_tpu_torch.analysis import scaling
    assert scaling.main([
        "--devices", "1,2", "--device", "cpu", "--total_envs", "8",
        "--rollout", "8", "--batch_size", "256", "--rnn_size", "16",
        "--iters", "1", "--repeats", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in lines[:2]] == [1, 2]
    assert [r["learner_rows_per_rank"] for r in lines[:2]] == [512, 256]
    assert all(r["sec_per_iter"] > 0 and r["num_envs"] == 8
               for r in lines[:2])
    assert lines[2]["learner_rows_scaling"] == {"1": 1.0, "2": 2.0}
