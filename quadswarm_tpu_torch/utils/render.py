"""Rendering and trajectory recording for evaluation.

Port of quadswarm_tpu/utils/render.py: a headless matplotlib renderer in
place of the reference's pyglet/OpenGL scene (the same camera views,
goal markers, per-drone traces, collision flashes and vel/acc arrows),
drawn from a trajectory recorded on the host (`TrajectoryRecorder`) or
streamed tick by tick (`LiveRenderer`); and the critic-value maps
(`v_value_map`, `v_value_maps`), one batched critic forward on the
model's device.  matplotlib is imported inside the functions that draw,
so that the recorder and the value maps run without it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from quadswarm_tpu_torch.utils.struct import to_numpy

QUAD_COLORS = [  # quad_utils.py:12-24
    (1.0, 0.0, 0.0), (1.0, 0.5, 0.0), (1.0, 1.0, 0.0), (0.0, 1.0, 1.0),
    (1.0, 1.0, 0.5), (0.0, 0.0, 1.0), (0.22, 0.2, 0.47), (1.0, 0.0, 1.0),
]


def _host(x) -> np.ndarray:
    return to_numpy(x)


@dataclass
class TrajectoryRecorder:
    """Accumulates one env's per-tick state on the host during an eval
    rollout."""

    pos: list = field(default_factory=list)         # [T] (N, 3)
    goals: list = field(default_factory=list)       # [T] (N, 3)
    collisions: list = field(default_factory=list)  # [T] (N,) bool
    rewards: list = field(default_factory=list)     # [T] (N,)
    obs: list = field(default_factory=list)         # [T] (N, obs_dim)
    vel: list = field(default_factory=list)         # [T] (N, 3)
    acc: list = field(default_factory=list)         # [T] (N, 3) world frame

    def record(self, state, reward=None, obs=None, env: int = 0) -> None:
        """Append env `env` of a batched EnvState (leading axis E); reward
        and obs, when given, are (E, N) and (E, N, D)."""
        self.pos.append(_host(state.dyn.pos[env]))
        self.goals.append(_host(state.scenario.goals[env]))
        self.collisions.append(_host(state.prev_coll_ids[env]))
        self.vel.append(_host(state.dyn.vel[env]))
        self.acc.append(_host(state.dyn.acc[env]))
        if reward is not None:
            self.rewards.append(_host(reward[env]))
        if obs is not None:
            self.obs.append(_host(obs[env]))

    def arrays(self):
        return (np.stack(self.pos), np.stack(self.goals),
                np.stack(self.collisions))

    def dump(self, path: str) -> None:
        pos, goals, cols = self.arrays()
        np.savez_compressed(path, pos=pos, goals=goals, collisions=cols,
                            rewards=np.stack(self.rewards) if self.rewards
                            else None)


def _set_view(ax, view: str, center, room_dims):
    follow = view in ("chase", "topdownfollow")
    if view in ("topdown", "topdownfollow"):
        ax.view_init(elev=90, azim=-90)
    elif view == "side":
        ax.view_init(elev=0, azim=-90)
    elif view == "chase":
        ax.view_init(elev=25, azim=-60)
    elif view.startswith("corner"):
        idx = int(view[-1]) if view[-1].isdigit() else 0
        ax.view_init(elev=35, azim=45 + 90 * idx)
    else:  # global
        ax.view_init(elev=40, azim=-70)
    if follow:
        # Follow cameras track the swarm center with a tight window
        # (ChaseCamera / TopDownFollow, quadrotor_multi_visualization.py)
        r = 2.5
        ax.set_xlim(center[0] - r, center[0] + r)
        ax.set_ylim(center[1] - r, center[1] + r)
        ax.set_zlim(max(0.0, center[2] - r), center[2] + r)
    else:
        half_l, half_w = room_dims[0] / 2, room_dims[1] / 2
        ax.set_xlim(-half_l, half_l)
        ax.set_ylim(-half_w, half_w)
        ax.set_zlim(0, room_dims[2])


def render_frame(pos, goals, collisions, room_dims=(10.0, 10.0, 10.0),
                 views=("topdown", "chase", "global"), trace=None,
                 obstacles=None, obst_size=1.0, figsize_per_view=4,
                 v_map=None, v_extent=2.0, vel=None, acc=None):
    """Render one tick to an RGB array (H, W, 3) with one panel per view.

    `v_map` (2D array) appends a critic-value heatmap panel beside the env
    views — the live side-panel of the reference's V_ValueMapWrapper.render
    (swarm_rl/env_wrappers/v_value_map.py:28-37).

    `vel` / `acc` (N, 3) draw per-drone velocity (red) and world-frame
    acceleration (green) arrow glyphs, the reference viewer's vel/acc arrows
    (quadrotor_visualization.py:91-150 arrow nodes;
    quadrotor_multi_visualization.py:426-458 vel/acc updates from dyn.acc).

    Renders on a private offscreen Agg canvas (matplotlib.figure.Figure, not
    pyplot), so it never switches the global backend — a LiveRenderer's
    interactive TkAgg window keeps working while frames render."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    n_views = len(views)
    n_panels = n_views + (1 if v_map is not None else 0)
    fig = Figure(figsize=(figsize_per_view * n_panels, figsize_per_view))
    canvas = FigureCanvasAgg(fig)
    for vi, view in enumerate(views):
        ax = fig.add_subplot(1, n_panels, vi + 1, projection="3d")
        _set_view(ax, view, pos.mean(axis=0), room_dims)
        for i in range(pos.shape[0]):
            color = "k" if collisions[i] else QUAD_COLORS[i % len(QUAD_COLORS)]
            ax.scatter(*pos[i], color=color, s=40, marker="o")
            ax.scatter(*goals[i], color=QUAD_COLORS[i % len(QUAD_COLORS)],
                       s=25, marker="x", alpha=0.6)
            if trace is not None and len(trace) > 1:
                tr = np.asarray(trace)[:, i]
                ax.plot(tr[:, 0], tr[:, 1], tr[:, 2],
                        color=QUAD_COLORS[i % len(QUAD_COLORS)], alpha=0.3,
                        linewidth=0.8)
        # vel/acc arrows.  `acc` is WORLD-frame net acceleration (dyn.acc),
        # matching the reference viewer's arrow source
        # (quadrotor_multi_visualization.py:446-458: averages dyn.acc and
        # scales magnitude /3); lengths here use vel/4, acc/8 with a 1 m cap
        # so arrows stay readable at the matplotlib panel scale.
        if vel is not None:
            v = np.asarray(vel) / 4.0
            ax.quiver(pos[:, 0], pos[:, 1], pos[:, 2],
                      v[:, 0], v[:, 1], v[:, 2], color="r", alpha=0.7,
                      linewidth=1.0, arrow_length_ratio=0.25)
        if acc is not None:
            a = np.asarray(acc) / 8.0
            norm = np.linalg.norm(a, axis=-1, keepdims=True)
            a = a * np.minimum(1.0, 1.0 / np.maximum(norm, 1e-9))
            ax.quiver(pos[:, 0], pos[:, 1], pos[:, 2],
                      a[:, 0], a[:, 1], a[:, 2], color="g", alpha=0.7,
                      linewidth=1.0, arrow_length_ratio=0.25)
        if obstacles is not None:
            for ob in obstacles:
                theta = np.linspace(0, 2 * np.pi, 16)
                r = obst_size / 2
                for z in (0.0, room_dims[2]):
                    ax.plot(ob[0] + r * np.cos(theta), ob[1] + r * np.sin(theta),
                            z, color="g", alpha=0.5, linewidth=0.8)
        ax.set_title(view, fontsize=8)
    if v_map is not None:
        ax = fig.add_subplot(1, n_panels, n_panels)
        ax.imshow(np.asarray(v_map), origin="lower",
                  extent=[-v_extent, v_extent, -v_extent, v_extent],
                  cmap="viridis")
        ax.plot(0.0, 0.0, marker="o", color="w", markersize=4)
        ax.set_title("V(s) around drone 0", fontsize=8)
    fig.tight_layout()
    canvas.draw()
    buf = np.asarray(canvas.buffer_rgba())[..., :3].copy()
    return buf


def _write_mp4(frames, path: str, fps: int = 10) -> bool:
    """Encode an iterable of RGB frames (uint8 or float) to mp4 via
    matplotlib's FFMpegWriter on an offscreen canvas.  Returns False (and
    writes nothing) when ffmpeg is unavailable or the iterable is empty."""
    import matplotlib.animation as anim

    if not anim.FFMpegWriter.isAvailable():
        return False
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    it = iter(frames)
    try:
        f0 = next(it)
    except StopIteration:
        return False
    fig = Figure(figsize=(f0.shape[1] / 100, f0.shape[0] / 100), dpi=100)
    FigureCanvasAgg(fig)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.axis("off")
    im = ax.imshow(f0)
    writer = anim.FFMpegWriter(fps=fps)
    try:
        with writer.saving(fig, path, dpi=100):
            writer.grab_frame()
            for f in it:
                im.set_data(f)
                writer.grab_frame()
    except Exception:
        return False
    return True


def render_trajectory(recorder: TrajectoryRecorder, out_dir: str,
                      room_dims=(10.0, 10.0, 10.0),
                      views=("topdown", "chase", "global"),
                      every_nth: int = 10, obstacles=None, obst_size=1.0,
                      viz_traces: int = 25, save_mp4: bool = True,
                      v_maps=None, v_extent: float = 2.0) -> list[str]:
    """Render a recorded trajectory to PNG frames (+ mp4 if ffmpeg exists).

    `v_maps`, a dict {tick: 2D array}, appends the per-tick critic-value
    heatmap panel (see render_frame)."""
    from matplotlib import image as mpimg

    os.makedirs(out_dir, exist_ok=True)
    pos, goals, cols = recorder.arrays()
    paths = []
    frames = []
    vel = np.stack(recorder.vel) if recorder.vel else None
    acc = np.stack(recorder.acc) if recorder.acc else None
    for t in range(0, pos.shape[0], every_nth):
        trace = pos[max(0, t - viz_traces):t + 1]
        frame = render_frame(pos[t], goals[t], cols[t], room_dims, views,
                             trace=trace, obstacles=obstacles,
                             obst_size=obst_size,
                             v_map=None if v_maps is None else v_maps.get(t),
                             v_extent=v_extent,
                             vel=None if vel is None else vel[t],
                             acc=None if acc is None else acc[t])
        path = os.path.join(out_dir, f"frame_{t:05d}.png")
        mpimg.imsave(path, frame)
        paths.append(path)
        frames.append(frame)
    if save_mp4 and len(frames) > 1:
        _write_mp4(frames, os.path.join(out_dir, "rollout.mp4"), fps=10)
    return paths


class LiveRenderer:
    """Per-tick streaming renderer: the realtime counterpart of the
    reference's pyglet viewer (quadrotor_multi_visualization.py:114-610 +
    the render pacing at quadrotor_multi.py:726-812).

    When an interactive matplotlib backend can open a window ($DISPLAY set),
    frames are shown live as the episode steps, with chase/topdown/global
    cameras, collision flashes, and vel/acc arrow glyphs, plus the
    reference viewer's interactive keys (quadrotor_multi_visualization.py
    :606+ key handlers): LEFT/RIGHT cycle the camera view of the first
    panel, 'a' toggles the arrows, 'p' pauses/resumes.  Headless (the
    normal case on a GPU server), frames stream to
    `out_dir/live/frame_XXXXX.png` AS THEY ARE PRODUCED (plus `latest.png`,
    atomically swapped, so a file watcher or `watch -n1` sees the run
    progressing), and `close()` assembles `live.mp4` by re-reading the
    streamed PNGs — memory stays O(1) in episode length.  `realtime=True`
    paces updates to wall-clock sim time like the reference's
    render_speed=1.0.
    """

    _VIEW_CYCLE = ("global", "chase", "topdown", "topdownfollow", "side",
                   "corner0", "corner1")

    def __init__(self, room_dims=(10.0, 10.0, 10.0),
                 views=("topdown", "chase", "global"), out_dir=None,
                 every_nth: int = 5, realtime: bool = False,
                 control_dt: float = 0.01, obstacles=None, obst_size=1.0,
                 viz_traces: int = 25, show_arrows: bool = True):
        import matplotlib

        self.room_dims = room_dims
        self.views = tuple(views)
        self.every_nth = max(1, every_nth)
        self.realtime = realtime
        self.control_dt = control_dt
        self.obstacles = obstacles
        self.obst_size = obst_size
        self.viz_traces = viz_traces
        self.show_arrows = show_arrows
        self._paused = False
        self._trace: list = []
        self._frame_paths: list[str] = []
        self._last_wall = None
        self.out_dir = out_dir
        self.interactive = bool(os.environ.get("DISPLAY"))
        if self.interactive:
            try:
                matplotlib.use("TkAgg")
                import matplotlib.pyplot as plt
                plt.ion()
                self._plt = plt
                self._im = None
            except Exception:
                self.interactive = False
        if not self.interactive:
            matplotlib.use("Agg")
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)

    def _on_key(self, event) -> None:
        """Interactive camera/glyph controls (reference:
        quadrotor_multi_visualization.py:606+ switches cameras on keys)."""
        if event.key in ("left", "right"):
            cyc = self._VIEW_CYCLE
            cur = cyc.index(self.views[0]) if self.views[0] in cyc else 0
            step = 1 if event.key == "right" else -1
            self.views = ((cyc[(cur + step) % len(cyc)],) + self.views[1:])
        elif event.key == "a":
            self.show_arrows = not self.show_arrows
        elif event.key == "p":
            self._paused = not self._paused

    def update(self, tick: int, pos, goals, collisions,
               vel=None, acc=None) -> None:
        """Called every control tick; renders on the every_nth grid."""
        import time

        pos = np.asarray(pos)
        self._trace.append(pos)
        if len(self._trace) > self.viz_traces:
            self._trace.pop(0)
        if tick % self.every_nth:
            return
        if self.realtime and self._last_wall is not None:
            lag = (self.control_dt * self.every_nth
                   - (time.perf_counter() - self._last_wall))
            if lag > 0:
                time.sleep(lag)
        self._last_wall = time.perf_counter()
        arrows = self.show_arrows
        frame = render_frame(pos, np.asarray(goals), np.asarray(collisions),
                             self.room_dims, self.views,
                             trace=np.asarray(self._trace),
                             obstacles=self.obstacles,
                             obst_size=self.obst_size,
                             vel=None if (vel is None or not arrows) else
                             np.asarray(vel),
                             acc=None if (acc is None or not arrows) else
                             np.asarray(acc))
        if self.interactive:
            plt = self._plt
            if self._im is None:
                fig = plt.figure("quadswarm live",
                                 figsize=(frame.shape[1] / 100,
                                          frame.shape[0] / 100), dpi=100)
                ax = fig.add_axes([0, 0, 1, 1])
                ax.axis("off")
                self._im = ax.imshow(frame)
                self._fig = fig
                fig.canvas.mpl_connect("key_press_event", self._on_key)
            else:
                self._im.set_data(frame)
            self._fig.canvas.draw_idle()
            plt.pause(0.001)
            while self._paused:
                plt.pause(0.1)
        if self.out_dir is not None:
            from matplotlib import image as mpimg
            path = os.path.join(self.out_dir, f"frame_{tick:05d}.png")
            mpimg.imsave(path, frame)
            self._frame_paths.append(path)
            tmp = os.path.join(self.out_dir, ".latest.tmp.png")
            mpimg.imsave(tmp, frame)
            os.replace(tmp, os.path.join(self.out_dir, "latest.png"))

    def close(self) -> str | None:
        """Finalize: assemble the streamed PNGs into `live.mp4` (best
        effort; the PNG stream remains either way).  Returns the mp4 path
        when written."""
        if self.interactive:
            try:
                self._plt.ioff()
            except Exception:
                pass
        if self.out_dir is None or len(self._frame_paths) < 2:
            return None
        from matplotlib import image as mpimg

        mp4 = os.path.join(self.out_dir, "live.mp4")
        fps = max(1, round(1.0 / (self.control_dt * self.every_nth)))
        ok = _write_mp4((mpimg.imread(p) for p in self._frame_paths),
                        mp4, fps=fps)
        return mp4 if ok else None


def _grid(extent: float, resolution: int) -> np.ndarray:
    """(R * R, 2) offsets of the value map's (x, y) grid."""
    xs = np.linspace(-extent, extent, resolution)
    ys = np.linspace(-extent, extent, resolution)
    return np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)


def _values(model, obs: np.ndarray) -> np.ndarray:
    """The critic's values of a (B, obs_dim) batch: one forward on the
    model's device, read back as float32."""
    import torch

    p = next(model.parameters())
    with torch.no_grad():
        _, _, values = model(torch.as_tensor(obs, dtype=p.dtype,
                                             device=p.device))
    return values.float().cpu().numpy()


def v_value_map(model, obs_template: np.ndarray, extent: float = 2.0,
                resolution: int = 30) -> np.ndarray:
    """Critic-value heatmap around a drone (swarm_rl/env_wrappers/
    v_value_map.py:47-62): sweep the (x, y) components of the self obs
    through a +-extent grid and evaluate the value head.  (The JAX
    function's `drone_xy` argument, which it does not read, is gone.)"""
    grid = _grid(extent, resolution)
    obs = np.tile(obs_template[None, :], (grid.shape[0], 1))
    obs[:, 0] = obs_template[0] + grid[:, 0]
    obs[:, 1] = obs_template[1] + grid[:, 1]
    return _values(model, obs).reshape(resolution, resolution)


def v_value_maps(model, obs_seq: np.ndarray, extent: float = 2.0,
                 resolution: int = 30) -> dict[int, np.ndarray]:
    """Per-tick critic-value heatmaps for a sequence of drone-0
    observations [T, obs_dim], in one batched forward for all ticks;
    returns {tick: map}.  Feeds the side panel of render_trajectory (the
    reference computes this sweep every rendered frame,
    v_value_map.py:47-62)."""
    t_dim = obs_seq.shape[0]
    grid = _grid(extent, resolution)                               # (R*R, 2)
    obs = np.repeat(obs_seq[:, None, :], grid.shape[0], axis=1)    # (T, R*R, D)
    obs[..., 0] += grid[None, :, 0]
    obs[..., 1] += grid[None, :, 1]
    maps = _values(model, obs.reshape(-1, obs.shape[-1])).reshape(
        t_dim, resolution, resolution)
    return dict(enumerate(maps))
