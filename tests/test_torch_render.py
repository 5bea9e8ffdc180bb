"""The port's rendering (quadswarm_tpu_torch/utils/render.py) on the CPU,
against the JAX package's.

- `render_frame` gives the JAX package's RGB array bit for bit (the same
  matplotlib, the same inputs), with and without the value panel, the
  vel/acc arrows, traces and obstacles, and leaves the global backend
  alone; `render_trajectory` writes the same frames.
- `v_value_map` and `v_value_maps` on weights carried over from a flax
  tree match the JAX package's (rtol 1e-5 plus 1e-6 of the largest entry).
- `LiveRenderer` headless streams PNGs and `latest.png`, keeps no frame in
  memory, and its keys cycle views, toggle arrows and pause
  (tests/test_cli.py's checks).
- The eval CLI refuses a drawing render mode up front without matplotlib;
  `_write_mp4` returns False without ffmpeg.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import matplotlib
import matplotlib.animation as manim
from matplotlib import image as mpimg
import numpy as np
import pytest

from quadswarm_tpu.models.actor_critic import ActorCritic as JActorCritic
from quadswarm_tpu.utils import render as j_render
from quadswarm_tpu_torch.models.actor_critic import ActorCritic
from quadswarm_tpu_torch.training import enjoy
from quadswarm_tpu_torch.utils import render as t_render
from quadswarm_tpu_torch.utils.convert import actor_critic_from_flax

from .flax_params import random_flax_params


def _scene(seed: int = 0, n: int = 3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (n, 3)) + np.array([0.0, 0.0, 3.0])
    return dict(pos=pos, goals=pos + 0.4, collisions=np.arange(n) == 1,
                vel=rng.uniform(-1, 1, (n, 3)),
                acc=rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 9.81]),
                trace=pos[None] + rng.normal(0, 0.1, (5, n, 3)),
                v_map=rng.random((12, 12)),
                obstacles=rng.uniform(-3, 3, (2, 2)))


@pytest.mark.parametrize("extras", [
    (), ("v_map",), ("vel", "acc"), ("trace", "obstacles", "v_map", "vel")])
def test_render_frame_same_bits_as_jax(extras):
    s = _scene()
    kw = dict(views=("topdown", "chase"), figsize_per_view=2,
              **{k: s[k] for k in extras})
    before = matplotlib.get_backend()
    got = t_render.render_frame(s["pos"], s["goals"], s["collisions"], **kw)
    assert matplotlib.get_backend() == before
    want = j_render.render_frame(s["pos"], s["goals"], s["collisions"], **kw)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, want)


def test_render_trajectory_same_frames_as_jax(tmp_path):
    n, t = 2, 12
    rng = np.random.default_rng(1)
    recs = (t_render.TrajectoryRecorder(), j_render.TrajectoryRecorder())
    for rec in recs:
        rec.pos = list(rng.uniform(-2, 2, (t, n, 3)))
        rec.goals = [np.ones((n, 3))] * t
        rec.collisions = [np.zeros(n, bool)] * t
        rec.vel = [np.ones((n, 3))] * t
        rec.acc = [np.full((n, 3), 2.0)] * t
    v_maps = {0: rng.random((6, 6)), 10: rng.random((6, 6))}
    kw = dict(views=("global",), every_nth=10, save_mp4=False, v_maps=v_maps)
    got = t_render.render_trajectory(recs[0], str(tmp_path / "t"), **kw)
    recs[1].pos = recs[0].pos
    want = j_render.render_trajectory(recs[1], str(tmp_path / "j"), **kw)
    assert [os.path.basename(p) for p in got] == [
        "frame_00000.png", "frame_00010.png"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(mpimg.imread(g), mpimg.imread(w))


def test_v_value_maps_match_jax():
    kw = dict(self_obs_dim=18, neighbor_obs_dim=6, num_neighbors=2,
              neighbor_encoder_type="attention", rnn_size=16,
              neighbor_hidden=16)
    jmodel = JActorCritic(**kw)
    tree = random_flax_params(jmodel, 30, 4)
    model = ActorCritic(**kw, device="cpu")
    model.load_state_dict(actor_critic_from_flax(tree))
    obs_seq = np.random.default_rng(5).normal(0, 1, (3, 30)).astype(
        np.float32)

    def close(got, want):
        np.testing.assert_allclose(
            got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())

    got = t_render.v_value_map(model, obs_seq[0], resolution=9)
    want = j_render.v_value_map(jmodel, tree, obs_seq[0], obs_seq[0][:2],
                                resolution=9)
    assert got.shape == (9, 9)
    close(got, np.asarray(want))
    got = t_render.v_value_maps(model, obs_seq, extent=1.5, resolution=7)
    want = j_render.v_value_maps(jmodel, tree, obs_seq, extent=1.5,
                                 resolution=7)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for t in got:
        close(got[t], want[t])


def test_live_renderer_headless_and_keys(tmp_path, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    out = tmp_path / "live"
    live = t_render.LiveRenderer(views=("topdown",), out_dir=str(out),
                                 every_nth=2, control_dt=0.01)
    assert not live.interactive
    s = _scene()
    for tick in range(8):
        live.update(tick, s["pos"] + 0.01 * tick, s["goals"],
                    s["collisions"], vel=s["vel"], acc=s["acc"])
    frames = sorted(p.name for p in out.glob("frame_*.png"))
    assert frames == [f"frame_{t:05d}.png" for t in (0, 2, 4, 6)]
    assert (out / "latest.png").exists()
    assert not hasattr(live, "_frames")        # frames live on disk
    mp4 = live.close()
    if manim.FFMpegWriter.isAvailable():
        assert mp4 is not None and os.path.getsize(mp4) > 0
    else:
        assert mp4 is None
    keys = t_render.LiveRenderer(views=("global", "chase"),
                                 out_dir=str(tmp_path))
    keys._on_key(SimpleNamespace(key="right"))
    assert keys.views == ("chase", "chase")
    keys._on_key(SimpleNamespace(key="left"))
    assert keys.views == ("global", "chase")
    keys._on_key(SimpleNamespace(key="a"))
    assert not keys.show_arrows
    keys._on_key(SimpleNamespace(key="p"))
    assert keys._paused
    keys._on_key(SimpleNamespace(key="p"))
    assert not keys._paused


def test_drawing_needs_matplotlib_and_mp4_needs_ffmpeg(monkeypatch,
                                                       tmp_path):
    real = enjoy.importlib.util.find_spec
    monkeypatch.setattr(enjoy.importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    args = SimpleNamespace(eval_envs=1, render_mode="plot")
    with pytest.raises(ImportError, match="--render_mode=plot draws with "
                                          "matplotlib"):
        enjoy._check_render(args)
    for ok in (SimpleNamespace(eval_envs=1, render_mode="dump"),
               SimpleNamespace(eval_envs=4, render_mode="live")):
        enjoy._check_render(ok)
    monkeypatch.setattr(manim.FFMpegWriter, "isAvailable",
                        classmethod(lambda cls: False))
    frames = [np.zeros((8, 8, 3), np.uint8)] * 2
    assert t_render._write_mp4(frames, str(tmp_path / "a.mp4")) is False
    assert not (tmp_path / "a.mp4").exists()
