"""The port's eval CLI (quadswarm_tpu_torch/training/enjoy.py) on the CPU.

- The evaluation flags parse alike in both packages' `parse_swarm_cfg`.
- The port's train CLI writes a checkpoint of a 2-drone run with 1 s
  episodes and `--normalize_input`; `enjoy` then evaluates it:
  `--eval_envs=2 --max_num_episodes=3` reports exactly 3 episodes, with the
  JAX CLI's stat keys (the JAX package's `_episode_stats` keys, read by
  tracing it, plus `episode_reward`); the experiment's config.json applies
  unless a flag is given; `best` falls back to `latest` with the warning;
  the checkpoint's normalizer is the one the policy uses;
  `--render_mode=dump` writes (ep_len + 1, N, 3) positions; the render
  modes draw their files: the default plot every 10th tick's frame, live
  every `--render_every_nth` tick's frame and `latest.png`,
  `--visualize_v_value` the value map.
"""
from __future__ import annotations

import shlex
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.env import multi as j_multi
from quadswarm_tpu.training import config as j_config
from quadswarm_tpu_torch.env import multi as t_multi
from quadswarm_tpu_torch.env.params import make_dynamics_params
from quadswarm_tpu_torch.parallel import normalize as t_norm
from quadswarm_tpu_torch.training import config as t_config
from quadswarm_tpu_torch.training import enjoy, train
from quadswarm_tpu_torch.utils import checkpoint as t_ckpt

from .test_torch_env_parts import _jax_state

ROOT = Path(__file__).resolve().parents[1]
EVAL_FLAGS = ("load_checkpoint_kind", "max_num_episodes", "eval_envs",
              "render_mode", "render_out", "render_every_nth", "realtime")


def _train_sh_flags() -> list:
    text = (ROOT / "train.sh").read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "training.train" in ln)
    words = shlex.split(line)
    start = next(i for i, w in enumerate(words)
                 if w.endswith("training.train")) + 1
    return [w for w in words[start:] if w != "$@"]


def test_evaluation_flags_parse_alike_in_both_packages():
    flags = _train_sh_flags() + ["--eval_envs=32",
                                 "--quads_mode=static_diff_goal"]
    for extra in ([], ["--load_checkpoint_kind=best",
                       "--max_num_episodes=32", "--render_mode=dump",
                       "--render_out=out", "--render_every_nth=3",
                       "--realtime"]):
        ja = j_config.parse_swarm_cfg(flags + extra, evaluation=True)
        ta = t_config.parse_swarm_cfg(flags + extra, evaluation=True)
        for name in EVAL_FLAGS + ("quads_mode", "visualize_v_value"):
            assert getattr(ta, name) == getattr(ja, name), name
        assert ta.device == "cuda"
    assert ta.realtime is True and ta.render_mode == "dump"
    assert not hasattr(t_config.parse_swarm_cfg(flags[:-2]), "eval_envs")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The train CLI's experiment: 2 drones, 1 s episodes, 2 iterations
    of 2 envs x rollout 8, input normalization."""
    train_dir = tmp_path_factory.mktemp("train")
    flags = _train_sh_flags() + [
        "--num_envs=2", "--rollout=8", "--batch_size=16",
        "--quads_num_agents=2", "--quads_neighbor_visible_num=1",
        "--rnn_size=16", "--quads_neighbor_hidden_size=16",
        "--quads_episode_duration=1.0", "--normalize_input=True",
        "--device=cpu", f"--train_dir={train_dir}", "--experiment=ev",
        "--log_every_iters=1", f"--train_for_env_steps={2 * 8 * 2 * 2}"]
    with pytest.MonkeyPatch.context() as mp:
        # TensorBoard's package loads TensorFlow where it is installed
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        assert train.main(flags) == 0
    cp_dir = train_dir / "ev" / "checkpoint_p0"
    assert [p.name for p in cp_dir.iterdir()] == ["checkpoint_000000000064.pt"]
    return train_dir


def _eval(train_dir, *flags, experiment="ev"):
    return enjoy.main([f"--train_dir={train_dir}",
                       f"--experiment={experiment}", "--device=cpu", *flags])


def _table(out: str) -> dict:
    lines = out[out.index("=== mean over"):].splitlines()[1:]
    return {k.strip(): float(v) for k, v in
            (ln.split(":", 1) for ln in lines if ln.startswith("  "))}


def _jax_stat_keys() -> set:
    cfg = t_multi.EnvConfig(num_agents=2, ep_time=1.0)
    state, _ = t_multi.env_reset(cfg, make_dynamics_params(dt=cfg.dt),
                                 torch.Generator().manual_seed(0), 1,
                                 device="cpu")
    jcfg = j_multi.EnvConfig(num_agents=2, ep_time=1.0)
    shapes = jax.eval_shape(lambda s: j_multi._episode_stats(
        jcfg, s, jnp.asarray(True)), _jax_state(state))
    return set(shapes) | {"episode_reward"}


def test_batched_eval_reports_the_asked_episodes(trained, capsys):
    """ceil(3 / 2) = 2 rounds of 2 envs, of which the first 3 episodes are
    kept; the default --render_mode=plot does not stop the batched path,
    which never renders."""
    assert _eval(trained, "--eval_envs=2", "--max_num_episodes=3") == 0
    out = capsys.readouterr().out
    assert "config loaded from" in out and "loaded " in out
    assert "checkpoint_000000000064.pt" in out
    assert "round 0: 2 episodes" in out and "round 1: 2 episodes" in out
    assert "=== mean over 3 episodes ===" in out
    table = _table(out)
    assert set(table) == _jax_stat_keys()
    assert all(np.isfinite(v) for v in table.values())
    assert table["episode_done"] == 1.0
    assert 0.0 <= table["metric/agent_success_rate"] <= 1.0


def test_config_json_applies_unless_given_and_dump_writes_the_trajectory(
        trained, tmp_path, capsys):
    """config.json gives 2 drones (the default is 8); the episode length
    given on the command line wins over its 1 s: 0.5 s is 50 ticks, and the
    dump holds every one of the episode's 51 ticks."""
    assert _eval(trained, "--max_num_episodes=1", "--render_mode=dump",
                 f"--render_out={tmp_path}",
                 "--quads_episode_duration=0.5") == 0
    out = capsys.readouterr().out
    assert "episode 0: reward=" in out and "=== mean over episodes ===" in out
    dump = np.load(tmp_path / "ep000.npz", allow_pickle=True)
    assert dump["pos"].shape == (51, 2, 3) and dump["goals"].shape == (51, 2,
                                                                       3)
    assert dump["collisions"].shape == (51, 2)
    assert dump["rewards"].shape == (51, 2)
    assert np.isfinite(dump["pos"]).all()


def test_best_falls_back_to_latest_with_the_warning(trained, capsys):
    args = ("--eval_envs=2", "--max_num_episodes=2", "--load_checkpoint_kind=best",
            "--quads_episode_duration=0.1")
    assert _eval(trained, *args) == 0
    out = capsys.readouterr().out
    assert ("WARNING: no best_* checkpoint found, falling back to latest"
            in out)
    assert "checkpoint_000000000064.pt" in out
    # with a best checkpoint beside it, that one is loaded
    shutil.copytree(trained / "ev", trained / "ev_best")
    cp_dir = trained / "ev_best" / "checkpoint_p0"
    shutil.copy(cp_dir / "checkpoint_000000000064.pt",
                cp_dir / "best_000000000032.pt")
    assert _eval(trained, *args, experiment="ev_best") == 0
    out = capsys.readouterr().out
    assert "WARNING" not in out and "best_000000000032.pt" in out


def test_normalize_input_checkpoint_restores_its_normalizer(trained,
                                                            monkeypatch,
                                                            capsys):
    seen = []
    real = t_norm.normalize_obs

    def spy(norm, obs):
        seen.append(norm)
        return real(norm, obs)

    monkeypatch.setattr(t_norm, "normalize_obs", spy)
    assert _eval(trained, "--eval_envs=2", "--max_num_episodes=2",
                 "--quads_episode_duration=0.1") == 0
    assert "input normalization active" in capsys.readouterr().out
    saved = t_ckpt.load_checkpoint(
        str(trained / "ev" / "checkpoint_p0" / "checkpoint_000000000064.pt"))
    want = saved["extra"]["obs"]
    assert seen and float(want["count"]) > 64
    for norm in (seen[0], seen[-1]):
        for f in ("mean", "var", "count"):
            assert torch.equal(getattr(norm.obs, f), want[f])


@pytest.mark.parametrize("flags", [
    (), ("--render_mode=live",), ("--render_mode=none",
                                  "--visualize_v_value")])
def test_render_modes_not_ported_raise(trained, flags, tmp_path):
    """Each render mode of the single-env loop draws its files for an
    episode of 0.2 s (ticks 1 to 21; the recorder holds 21 ticks)."""
    assert _eval(trained, "--max_num_episodes=1", "--render_every_nth=5",
                 "--quads_episode_duration=0.2", f"--render_out={tmp_path}",
                 *flags) == 0
    files = sorted(str(p.relative_to(tmp_path))
                   for p in tmp_path.rglob("*.png"))
    want = {(): [f"ep000/frame_{t:05d}.png" for t in (0, 10, 20)],
            ("--render_mode=live",): [
                f"ep000/live/frame_{t:05d}.png" for t in (5, 10, 15, 20)]
            + ["ep000/live/latest.png"],
            ("--render_mode=none", "--visualize_v_value"): [
                "ep000/v_value_map.png"]}[flags]
    assert files == want
