"""Goal scenarios, batched over envs.

Port of quadswarm_tpu/env/scenarios.py: all 20 modes, the nine free-space
modes of the multi-drone mix curriculum (MIX_MODES_MULTI), `run_away`, and
the obstacle modes, which spawn the drones on free cells of the obstacle
grid.  Every function works on a batch of E envs at once (the JAX package
writes one env and vmaps); the per-env mode is data, and each mode's
branch is a masked `torch.where`, computed only when some env of the batch
has that mode.

Where the randomness comes from.  The JAX package derives every scenario
draw from `fold_in(scen_key, tick)`, so that reset can presample the
episode's events.  The port draws at reset from the caller's generator:
`scenario_reset` samples the episode and `presample_events` fills the
packed (E, K * D) event table that `batched_scenario_step` plays back, in
the same layout.  The one per-tick draw, the dynamic_formations speed
resample, comes from a counter-based hash of the env's `scen_seed` and the
tick (`counter_uniform`), so it needs no generator on the hot path.  Where
JAX draws a categorical, a Bernoulli or a permutation with threefry (the
uniform spawn, the diagonal's corner, every shuffle), the port ranks or
compares uniforms from the caller's generator.  Such draws match the JAX
package in distribution, not bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from quadswarm_tpu_torch.env.formations import (
    formation_size_range, generate_goals_affine, get_z_value, is_circle,
    is_grid, npl_for_formation,
)
from quadswarm_tpu_torch.utils.struct import Struct

MODES = (
    "static_same_goal", "static_diff_goal", "dynamic_same_goal",
    "dynamic_diff_goal", "swap_goals", "dynamic_formations",
    "ep_lissajous3D", "ep_rand_bezier", "swarm_vs_swarm", "run_away",
    "o_random", "o_static_same_goal", "o_dynamic_same_goal", "o_swap_goals",
    "o_ep_rand_bezier", "o_uniform_same_goal_spawn", "o_diagonal",
    "o_static_diff_goal", "o_dynamic_diff_goal", "o_test",
)
MODE_IDS = {m: i for i, m in enumerate(MODES)}
MIX_MODES_MULTI = tuple(MODE_IDS[m] for m in (
    "static_same_goal", "static_diff_goal", "ep_lissajous3D", "ep_rand_bezier",
    "dynamic_same_goal", "dynamic_diff_goal", "dynamic_formations",
    "swap_goals", "swarm_vs_swarm"))
MIX_MODES_OBSTACLES = (MODE_IDS["o_random"], MODE_IDS["o_static_same_goal"])
MIX_MODES_OBSTACLES_SINGLE = (MODE_IDS["o_random"],)
SUPPORTED_MODES = frozenset(range(len(MODES)))

_ARM = 0.05
# (formation choices, dist_low, dist_high) of every mode.  As in the
# reference, the choice indexes the global formation list, so o_swap_goals
# (7 choices) can draw circle_horizontal and never cube.
MODE_TABLE = {
    "static_same_goal": (1, 0.0, 0.0),
    "static_diff_goal": (8, 5 * _ARM, 10 * _ARM),
    "dynamic_same_goal": (1, 0.0, 0.0),
    "dynamic_diff_goal": (8, 5 * _ARM, 10 * _ARM),
    "swap_goals": (8, 8 * _ARM, 16 * _ARM),
    "dynamic_formations": (8, 0.0, 20 * _ARM),
    "ep_lissajous3D": (1, 0.0, 0.0),
    "ep_rand_bezier": (1, 0.0, 0.0),
    "swarm_vs_swarm": (8, 5 * _ARM, 10 * _ARM),
    "run_away": (8, 5 * _ARM, 10 * _ARM),
    "o_random": (1, 0.0, 0.0),
    "o_static_same_goal": (1, 0.0, 0.0),
    "o_dynamic_same_goal": (1, 0.0, 0.0),
    "o_swap_goals": (7, 8 * _ARM, 16 * _ARM),
    "o_ep_rand_bezier": (1, 0.0, 0.0),
    "o_uniform_same_goal_spawn": (1, 0.0, 0.0),
    "o_diagonal": (1, 0.0, 0.0),
    "o_static_diff_goal": (8, 5 * _ARM, 10 * _ARM),
    "o_dynamic_diff_goal": (8, 5 * _ARM, 10 * _ARM),
    "o_test": (1, 0.0, 0.0),
}
_ROWS = [MODE_TABLE[m] for m in MODES]
MODE_NUM_CHOICES = np.array([r[0] for r in _ROWS], np.int64)
MODE_DIST_LOW = np.array([r[1] for r in _ROWS], np.float64)
MODE_DIST_HIGH = np.array([r[2] for r in _ROWS], np.float64)
# approach_goal_metric per mode: 0.5, and 1.0 for the obstacle modes but
# o_random.
MODE_APPROACH_METRIC = np.array(
    [1.0 if (m.startswith("o_") and m != "o_random") else 0.5 for m in MODES],
    np.float64)

BEZIER_ATTEMPTS = 20
CONTINUOUS_MODES = frozenset((MODE_IDS["dynamic_formations"],
                              MODE_IDS["ep_lissajous3D"],
                              MODE_IDS["ep_rand_bezier"],
                              MODE_IDS["o_ep_rand_bezier"]))
# Modes with an event every `interval` ticks: dynamic_same_goal,
# dynamic_diff_goal, swap_goals, swarm_vs_swarm, run_away (1 s),
# o_dynamic_same_goal (also at tick 1), o_swap_goals, o_dynamic_diff_goal.
_INTERVAL_MODES = frozenset((2, 3, 4, 8, 9, 12, 13, 18))
# The obstacle modes whose reset places the drones on the free cells.
_OBSTACLE_RESET_MODES = frozenset(range(MODE_IDS["o_random"],
                                        MODE_IDS["o_test"]))
# Each Bezier mode: (seconds between resamples, the control points' largest
# distance, and for the obstacle mode the z range of the points).
BEZIER_MODES = {MODE_IDS["ep_rand_bezier"]: (5, 30.0, None),
                MODE_IDS["o_ep_rand_bezier"]: (6, 5.0, (1.5, 3.0))}
# o_test: the goals start around O_TEST_START and move to O_TEST_END after
# a U(2, 4) s interval.
O_TEST_START = (0.0, 3.0, 2.0)
O_TEST_END = (0.0, -3.0, 2.0)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    num_agents: int = 8
    control_freq: float = 100.0
    ep_time: float = 15.0
    room_dims: tuple = (10.0, 10.0, 10.0)
    box: float = 2.0
    obst_area: tuple = (6, 6)
    grid_size: float = 1.0


# Packed event-table layout (leaf, per-agent shape, kind); identical to the
# JAX package's, so a table converts across unchanged.  Always float32;
# int leaves ("i") are stored as exact floats.
_EVENT_SPEC = (
    ("goals", ("n", 3), "f"),
    ("formation", (), "i"),
    ("num_agents_per_layer", (), "i"),
    ("lowest_size", (), "f"),
    ("highest_size", (), "f"),
    ("formation_size", (), "f"),
    ("layer_dist", (), "f"),
    ("formation_center", (3,), "f"),
    ("goal_center_1", (3,), "f"),
    ("goal_center_2", (3,), "f"),
    ("bezier_nodes", (3, 3), "f"),
    ("interval", (), "i"),
    ("end_point", (3,), "f"),
)
EVENT_WRITABLE = tuple(name for name, _, _ in _EVENT_SPEC)


def _leaf_shape(spec: tuple, n: int) -> tuple:
    return tuple(n if s == "n" else s for s in spec)


def event_table_width(n: int) -> int:
    """Packed floats per event slot: 3n + 28."""
    return sum(int(np.prod(_leaf_shape(s, n), dtype=np.int64))
               for _, s, _ in _EVENT_SPEC)


@dataclasses.dataclass
class ScenarioState(Struct):
    """Per-env scenario variables, leading axis E."""

    mode: torch.Tensor                  # int32
    formation: torch.Tensor             # int32
    formation_size: torch.Tensor
    lowest_size: torch.Tensor
    highest_size: torch.Tensor
    layer_dist: torch.Tensor
    num_agents_per_layer: torch.Tensor  # int32
    formation_center: torch.Tensor      # (E, 3)
    goals: torch.Tensor                 # (E, N, 3)
    spawn_points: torch.Tensor          # (E, N, 3)
    interval: torch.Tensor              # int32 ticks between events
    increase_formation: torch.Tensor    # bool
    control_speed: torch.Tensor
    bezier_nodes: torch.Tensor          # (E, 3 dims, 3 points)
    goal_center_1: torch.Tensor         # (E, 3)
    goal_center_2: torch.Tensor         # (E, 3)
    end_point: torch.Tensor             # (E, 3)
    approach_goal_metric: torch.Tensor
    goals_base: torch.Tensor            # (E, N, 3) goals at size 0
    goals_slope: torch.Tensor           # (E, N, 3) d goals / d size
    scen_seed: torch.Tensor             # int64 per-episode hash seed
    event_count: torch.Tensor           # int32 events played back so far
    events: torch.Tensor                # (E, K * D) packed float32


def check_modes(modes) -> None:
    bad = sorted(set(int(m) for m in modes) - SUPPORTED_MODES)
    if bad:
        raise ValueError(f"unknown scenario mode ids {bad}; there are "
                         f"{len(MODES)} modes")


def num_event_slots(cfg: ScenarioConfig, allowed_modes=None) -> int:
    """Upper bound (plus one spare) on scenario events in one episode."""
    ep_len = int(cfg.ep_time * cfg.control_freq)
    allowed = (set(range(len(MODES))) if allowed_modes is None
               else set(int(m) for m in allowed_modes))
    f = cfg.control_freq
    k = 1
    if MODE_IDS["run_away"] in allowed:
        k = max(k, ep_len // max(int(1 * f), 1))
    if allowed & _INTERVAL_MODES:
        k = max(k, ep_len // max(int(4 * f), 1))
    if MODE_IDS["o_dynamic_same_goal"] in allowed:
        k = max(k, 1 + ep_len // max(int(4 * f), 1))
    if MODE_IDS["ep_rand_bezier"] in allowed:
        k = max(k, 1 + ep_len // max(int(5 * f), 1))
    if MODE_IDS["o_ep_rand_bezier"] in allowed:
        k = max(k, 1 + ep_len // max(int(6 * f), 1))
    return k + 1


# --------------------------------------------------------------------------
# Randomness helpers
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer hash on int64 tensors holding values below 2^32; the
    multipliers stay below 2^31 so no product overflows int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x446CA68B) & _M32
    return x ^ (x >> 16)


def counter_uniform(seed: torch.Tensor, counter: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Unit uniform in [0, 1) from (seed, counter), per element: a stateless
    stream, so a tick's draw needs no generator and no host sync."""
    x = _mix32(_mix32(seed.to(torch.int64) & _M32)
               ^ (counter.to(torch.int64) & _M32))
    return (x >> 8).to(dtype) * (1.0 / (1 << 24))


def _uniform(gen, shape, lo, hi, dtype, device):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return u * (hi - lo) + lo


def _permute(gen, x: torch.Tensor) -> torch.Tensor:
    """Independent random permutation of axis -2 for every env."""
    keys = torch.rand(x.shape[:-1], generator=gen, device=x.device)
    order = torch.argsort(keys, dim=-1)
    return torch.gather(x, -2, order[..., None].expand(x.shape))


def _sel(mask, new, old):
    """Per-env select: mask (E,) broadcast over each leaf's trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _sample_formation_params(gen, cfg: ScenarioConfig, mode, dtype):
    dev = mode.device
    e = mode.shape[0]
    mode = mode.to(torch.int64)
    num_choices = torch.as_tensor(MODE_NUM_CHOICES, device=dev)[mode]
    fid = torch.floor(torch.rand(e, generator=gen, dtype=torch.float64,
                                 device=dev) * num_choices).to(torch.int32)
    npl = npl_for_formation(fid)
    low = torch.as_tensor(MODE_DIST_LOW, dtype=dtype, device=dev)[mode]
    high = torch.as_tensor(MODE_DIST_HIGH, dtype=dtype, device=dev)[mode]
    lo, hi = formation_size_range(mode == MODE_IDS["swarm_vs_swarm"], fid,
                                  cfg.num_agents, low, high, npl)
    size = _uniform(gen, (e,), 0.0, 1.0, dtype, dev) * (hi - lo) + lo
    layer_dist = _uniform(gen, (e,), 0.0, 1.0, dtype, dev) * (hi - lo) + lo
    return fid, npl, lo, hi, size, layer_dist


def _sample_bezier_nodes(gen, goal0, room_dims, formation_size,
                         max_dist_cap: float, z_range=None):
    """Degree-2 Bezier control points (E, 3 dims, 3 points) with the bounds
    check, by BEZIER_ATTEMPTS masked retries per env.  The points stay in
    the room less the formation's size, with z in [0, room height), or in
    `z_range` (the obstacle mode's)."""
    e, dev, dtype = goal0.shape[0], goal0.device, goal0.dtype
    room = torch.tensor(room_dims, dtype=dtype, device=dev) \
        - formation_size[:, None]
    if z_range is None:
        z_lo, z_hi = torch.zeros_like(room[:, 0]), room[:, 2]
    else:
        z_lo = torch.full_like(room[:, 0], z_range[0])
        z_hi = torch.full_like(room[:, 0], z_range[1])
    low = torch.stack([-room[:, 0] / 2, -room[:, 1] / 2, z_lo], -1)
    high = torch.stack([room[:, 0] / 2, room[:, 1] / 2, z_hi], -1)
    max_dist = torch.clamp(torch.max(room, -1).values, max=max_dist_cap)
    min_dist = max_dist / 2
    a = BEZIER_ATTEMPTS
    # The reference draws (2, 3) with per-dim bounds, then reshapes to (3, 2).
    raw = _uniform(gen, (e, a, 2, 3), 0.0, 1.0, dtype, dev)
    raw = (raw * (2 * high[:, None, None, :]) - high[:, None, None, :])
    raw = raw.reshape(e, a, 3, 2)
    u = _uniform(gen, (e, a), 0.0, 1.0, dtype, dev)
    dist = torch.floor(u * (max_dist[:, None] + 1.0 - min_dist[:, None])
                       + min_dist[:, None])
    pts = raw * dist[..., None, None] / torch.linalg.vector_norm(
        raw, dim=-2, keepdim=True)
    pts = goal0[:, None, :, None] + pts                      # (E, A, 3, 2)
    ok = torch.all((pts > low[:, None, :, None] + 0.5)
                   & (pts < high[:, None, :, None] - 0.5), dim=(-2, -1))
    first = torch.argmax(ok.to(torch.uint8), -1)
    chosen = pts[torch.arange(e, device=dev), first]
    fallback = torch.minimum(torch.maximum(
        goal0[:, :, None].expand(e, 3, 2), low[:, :, None] + 0.5),
        high[:, :, None] - 0.5)
    chosen = _sel(torch.any(ok, -1), chosen, fallback)
    return torch.cat([goal0[:, :, None], chosen], -1)


def _bezier_eval(nodes, t):
    """Quadratic Bezier B(t) for nodes (E, 3 dims, 3 points), t (E,)."""
    t = t[:, None]
    return ((1 - t) ** 2 * nodes[..., 0] + 2 * (1 - t) * t * nodes[..., 1]
            + t**2 * nodes[..., 2])


# --------------------------------------------------------------------------
# Obstacle-map helpers
# --------------------------------------------------------------------------

def sample_free_cells(gen, active: torch.Tensor, centers: torch.Tensor,
                      num: int, z_lo: float, z_hi: float, dtype=torch.float32):
    """`num` distinct free cells of every env, as (E, num, 3) points with a
    uniform z in [z_lo, z_hi).  Cells are ranked by random scores with the
    occupied ones last; past the grid's size the ranking wraps around."""
    e, c = active.shape
    scores = torch.rand((e, c), generator=gen, device=active.device)
    scores = torch.where(active, torch.full_like(scores, -float("inf")),
                         scores)
    order = torch.argsort(scores, dim=-1, descending=True)
    idx = (order[:, :num] if num <= c else
           order[:, torch.arange(num, device=active.device) % c])
    z = _uniform(gen, (e, num), z_lo, z_hi, dtype, active.device)
    return torch.cat([centers[idx].to(dtype), z[..., None]], -1)


def free_cell_attempts(gen, active: torch.Tensor, centers: torch.Tensor,
                       attempts: int, z_lo: float, z_hi: float,
                       dtype=torch.float32):
    """`attempts` independent one-cell draws of `sample_free_cells` per
    env, (E, attempts, 3): each a uniform free cell with a uniform z."""
    e, c = active.shape
    scores = torch.rand((e, attempts, c), generator=gen, device=active.device)
    scores = torch.where(active[:, None, :],
                         torch.full_like(scores, -float("inf")), scores)
    idx = torch.argmax(scores, -1)
    z = _uniform(gen, (e, attempts), z_lo, z_hi, dtype, active.device)
    return torch.cat([centers[idx].to(dtype), z[..., None]], -1)


def max_free_square_center(gen, obst_map2d: torch.Tensor,
                           centers: torch.Tensor, dtype=torch.float32):
    """The centre cell of every env's largest all-free square, (E, 3) with a
    uniform z in [1.5, 3).  obst_map2d (E, n, m) bool, True where occupied.

    The reference's dynamic programme, with its quirks kept: the first row
    and column of the table are seeded from the obstacle map itself, the
    first square found in row-major order wins, and the centre (cx, cy) is
    read from the cell-centre list at cx + m * cy (clamped to the list, as
    a JAX gather clamps).  The table is filled cell by cell over the env
    axis, with no host sync."""
    e, n, m = obst_map2d.shape
    dev = obst_map2d.device
    occ = obst_map2d.to(torch.int32)
    free = (~obst_map2d).to(torch.int32)
    cx = cy = torch.zeros((e,), dtype=torch.int64, device=dev)
    if n > 1 and m > 1:
        dp = [[occ[:, i, j] if i == 0 or j == 0 else None for j in range(m)]
              for i in range(n)]
        vals = []
        for i in range(1, n):
            for j in range(1, m):
                v = torch.minimum(torch.minimum(dp[i - 1][j], dp[i][j - 1]),
                                  dp[i - 1][j - 1])
                dp[i][j] = (v + 1) * free[:, i, j]
                vals.append(dp[i][j])
        vals = torch.stack(vals, -1)                   # row-major i, j >= 1
        k = torch.argmax(vals, -1)                     # the first best
        best = torch.gather(vals, -1, k[:, None])[:, 0].to(torch.int64)
        half = torch.div(best - 1, 2, rounding_mode="floor")
        found = best > 0
        cx = torch.where(found, torch.div(k, m - 1, rounding_mode="floor")
                         + 1 - half, cx)
        cy = torch.where(found, k % (m - 1) + 1 - half, cy)
    index = torch.clamp(cx + m * cy, max=centers.shape[0] - 1)
    z = _uniform(gen, (e,), 1.5, 3.0, dtype, dev)
    return torch.cat([centers[index].to(dtype), z[:, None]], -1)


# --------------------------------------------------------------------------
# Reset
# --------------------------------------------------------------------------

def scenario_reset(cfg: ScenarioConfig, gen: torch.Generator, mode,
                   dtype=torch.float32, allowed_modes=None,
                   num_slots: int | None = None, obst_active=None,
                   obst_centers=None) -> ScenarioState:
    """A fresh episode's scenario for each env's mode (E,) int tensor,
    including its presampled event table.  The obstacle modes place the
    drones on the free cells of `obst_active` (E, C) bool, whose cell
    centres are `obst_centers` (C, 2); without them the grid is empty."""
    present = set(int(m) for m in (torch.unique(mode).tolist()
                                   if allowed_modes is None
                                   else allowed_modes))
    check_modes(present)
    n = cfg.num_agents
    dev = mode.device
    e = mode.shape[0]
    mode = mode.to(torch.int32)
    box = cfg.box
    fid, npl, lo, hi, size, layer_dist = _sample_formation_params(
        gen, cfg, mode, dtype)
    default_center = torch.tensor([0.0, 0.0, 2.0], dtype=dtype,
                                  device=dev).expand(e, 3)
    base_goals = _permute(gen, generate_goals_affine(
        n, fid, default_center, size, layer_dist))
    g_at_0 = generate_goals_affine(n, fid, default_center, 0.0, layer_dist)
    g_at_1 = generate_goals_affine(n, fid, default_center, 1.0, layer_dist)
    u = lambda: _uniform(gen, (e,), 0.0, 1.0, dtype, dev)
    interval = ((u() * 2.0 + 4.0) * cfg.control_freq).to(torch.int32)
    st = ScenarioState(
        mode=mode, formation=fid, formation_size=size, lowest_size=lo,
        highest_size=hi, layer_dist=layer_dist, num_agents_per_layer=npl,
        formation_center=default_center.clone(), goals=base_goals,
        spawn_points=base_goals, interval=interval,
        increase_formation=u() < 0.5, control_speed=u() * 2.0 + 1.0,
        bezier_nodes=torch.zeros((e, 3, 3), dtype=dtype, device=dev),
        goal_center_1=default_center.clone(),
        goal_center_2=default_center.clone(),
        end_point=default_center.clone(),
        approach_goal_metric=torch.as_tensor(
            MODE_APPROACH_METRIC, dtype=dtype, device=dev)[mode.long()],
        goals_base=g_at_0, goals_slope=g_at_1 - g_at_0,
        scen_seed=torch.randint(0, 1 << 31, (e,), generator=gen, device=dev),
        event_count=torch.zeros((e,), dtype=torch.int32, device=dev),
        events=torch.zeros(
            (e, (num_slots or num_event_slots(cfg, allowed_modes))
             * event_table_width(n)), dtype=torch.float32, device=dev))

    # ep_lissajous3D: formation around [-2, 0, 2], no shuffle.
    is_liss = mode == MODE_IDS["ep_lissajous3D"]
    liss_center = torch.tensor([-2.0, 0.0, 2.0], dtype=dtype,
                               device=dev).expand(e, 3)
    liss_goals = generate_goals_affine(n, fid, liss_center, size, 0.0)

    # swarm_vs_swarm: two formation centers at least lowest_size apart along
    # the formation's separating axis.
    is_svs = mode == MODE_IDS["swarm_vs_swarm"]
    xy = torch.stack([u(), u()], -1) * (2 * box) - box
    z = get_z_value(u(), fid, n, npl, box, size)
    c1 = torch.cat([xy, z[:, None]], -1)
    gc_dist = u() * (box - box / 4) + box / 4
    phi = u() * (2 * math.pi) - math.pi
    theta = u() * math.pi - 0.5 * math.pi
    c2 = c1 + gc_dist[:, None] * torch.stack(
        [torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
         torch.cos(theta)], -1)
    axis = torch.where(fid == 0, 2, torch.where((fid == 1) | (fid == 5), 1, 0))
    planar = is_circle(fid) | is_grid(fid)
    d_ax = torch.gather(c2 - c1, 1, axis[:, None].to(torch.int64))[:, 0]
    c1_ax = torch.gather(c1, 1, axis[:, None].to(torch.int64))[:, 0]
    adjust = planar & (d_ax.abs() < lo)
    c2_adj = c2.clone()
    c2_adj.scatter_(1, axis[:, None].to(torch.int64),
                    (torch.sign(d_ax) * lo + c1_ax)[:, None])
    c2 = _sel(adjust, c2_adj, c2)
    svs_goals = torch.cat([
        generate_goals_affine(n // 2, fid, c1, size, layer_dist),
        generate_goals_affine(n - n // 2, fid, c2, size, layer_dist)], 1)

    goals = _sel(is_liss, liss_goals, _sel(is_svs, svs_goals, st.goals))
    st = st.replace(
        goals=goals, spawn_points=goals,
        formation_center=_sel(is_liss, liss_center,
                              _sel(is_svs, (c1 + c2) / 2,
                                   st.formation_center)),
        goal_center_1=_sel(is_svs, c1, st.goal_center_1),
        goal_center_2=_sel(is_svs, c2, st.goal_center_2))

    # The obstacle modes but o_test: spawn on free cells at z 1-3, goals
    # by sub-mode around the centre of the freest square.
    obst_modes = present & _OBSTACLE_RESET_MODES
    a0, a1 = cfg.obst_area
    active = (torch.zeros((e, a0 * a1), dtype=torch.bool, device=dev)
              if obst_active is None else obst_active)
    centers = (torch.zeros((a0 * a1, 2), dtype=dtype, device=dev)
               if obst_centers is None else obst_centers)
    if obst_modes:
        st = _reset_obstacle_modes(cfg, gen, st, obst_modes, active, centers,
                                   fid, size, layer_dist)

    # o_test: a formation from O_TEST_START moves to O_TEST_END after a
    # U(2, 4) s interval.
    if MODE_IDS["o_test"] in present:
        is_test = mode == MODE_IDS["o_test"]
        start = torch.tensor(O_TEST_START, dtype=dtype, device=dev).expand(e, 3)
        goals = _permute(gen, generate_goals_affine(n, fid, start, size,
                                                    layer_dist))
        dur = ((u() * 2.0 + 2.0) * cfg.control_freq).to(torch.int32)
        st = st.replace(
            goals=_sel(is_test, goals, st.goals),
            spawn_points=_sel(is_test, goals, st.spawn_points),
            end_point=_sel(is_test, torch.tensor(
                O_TEST_END, dtype=dtype, device=dev).expand(e, 3),
                st.end_point),
            formation_center=_sel(is_test, start, st.formation_center),
            interval=torch.where(is_test, dur, st.interval))

    # run_away: an event every second.
    st = st.replace(interval=torch.where(
        mode == MODE_IDS["run_away"],
        torch.full_like(st.interval, int(cfg.control_freq)), st.interval))

    # Bezier modes: an initial curve at reset (the tick-1 event resamples).
    for mid, (_, cap, z_range) in BEZIER_MODES.items():
        if mid in present:
            nodes = _sample_bezier_nodes(gen, st.goals[:, 0], cfg.room_dims,
                                         st.formation_size, cap, z_range)
            st = st.replace(bezier_nodes=_sel(mode == mid, nodes,
                                              st.bezier_nodes))
    return st.replace(events=presample_events(cfg, st, gen, present, active,
                                              centers))


def _reset_obstacle_modes(cfg: ScenarioConfig, gen, st: ScenarioState,
                          modes: set, active, centers, fid, size,
                          layer_dist) -> ScenarioState:
    """Spawn points, goals, end point and formation centre of the envs in
    the obstacle modes `modes` (all but o_test):
      o_random: goals on other free cells;
      o_swap_goals: a shuffled formation around the freest square's centre
        (drawn again, with its own z);
      o_static_diff_goal, o_dynamic_diff_goal: a shuffled formation around
        the freest square's centre;
      o_ep_rand_bezier: one goal on a free cell at z 0.75-3;
      o_uniform_same_goal_spawn: each drone on a uniform free cell, drawn
        with replacement;
      o_diagonal: the swarm on the free cells nearest a random corner at
        z 2, its shared goal on the free cell nearest the opposite corner;
      the rest: one goal at the freest square's centre."""
    n = cfg.num_agents
    mode = st.mode
    e, c = active.shape
    dev, dtype = active.device, st.goals.dtype
    a0, a1 = cfg.obst_area
    is_ = lambda name: mode == MODE_IDS[name]
    has = lambda name: MODE_IDS[name] in modes
    default_center = torch.tensor([0.0, 0.0, 2.0], dtype=dtype,
                                  device=dev).expand(e, 3)

    spawn = sample_free_cells(gen, active, centers, n, 1.0, 3.0, dtype)
    square = max_free_square_center(gen, active.reshape(e, a0, a1), centers,
                                    dtype)
    end = square
    goals = square[:, None, :].expand(e, n, 3)
    center = default_center
    if has("o_random"):
        per_agent = sample_free_cells(gen, active, centers, n, 1.0, 3.0,
                                      dtype)
        goals = _sel(is_("o_random"), per_agent, goals)
    if has("o_swap_goals"):
        swap_center = max_free_square_center(
            gen, active.reshape(e, a0, a1), centers, dtype)
        swap_goals = _permute(gen, generate_goals_affine(
            n, fid, swap_center, size, layer_dist))
        goals = _sel(is_("o_swap_goals"), swap_goals, goals)
        center = _sel(is_("o_swap_goals"), swap_center, center)
    if has("o_static_diff_goal") or has("o_dynamic_diff_goal"):
        is_diff = is_("o_static_diff_goal") | is_("o_dynamic_diff_goal")
        diff_goals = _permute(gen, generate_goals_affine(
            n, fid, square, size, layer_dist))
        goals = _sel(is_diff, diff_goals, goals)
        center = _sel(is_diff, square, center)
    if has("o_ep_rand_bezier"):
        bezier_end = sample_free_cells(gen, active, centers, 1, 0.75, 3.0,
                                       dtype)[:, 0]
        is_bez = is_("o_ep_rand_bezier")
        end = _sel(is_bez, bezier_end, end)
        goals = _sel(is_bez, bezier_end[:, None, :].expand(e, n, 3), goals)
    if has("o_uniform_same_goal_spawn"):
        scores = torch.rand((e, n, c), generator=gen, device=dev)
        scores = torch.where(active[:, None, :],
                             torch.full_like(scores, -1.0), scores)
        z = _uniform(gen, (e, n), 1.0, 3.0, dtype, dev)
        uniform = torch.cat([centers[torch.argmax(scores, -1)].to(dtype),
                             z[..., None]], -1)
        spawn = _sel(is_("o_uniform_same_goal_spawn"), uniform, spawn)
    if has("o_diagonal"):
        sign = torch.where(torch.rand((e, 2), generator=gen, device=dev)
                           < 0.5, 1.0, -1.0).to(dtype)
        score = centers.to(dtype) @ sign.T                     # (C, E)
        score = score.T
        noise = 1e-3 * torch.rand((e, c), generator=gen, dtype=dtype,
                                  device=dev)
        inf = torch.full_like(score, float("inf"))
        near = torch.where(active, -inf, score + noise)
        order = torch.argsort(near, dim=-1, descending=True)
        idx = order[:, torch.arange(n, device=dev) % c]
        two = lambda *s: torch.full(s + (1,), 2.0, dtype=dtype, device=dev)
        diag_spawn = torch.cat([centers[idx].to(dtype), two(e, n)], -1)
        far = torch.where(active, inf, score - noise)
        diag_goal = torch.cat([centers[torch.argmin(far, -1)].to(dtype),
                               two(e)], -1)
        is_diag = is_("o_diagonal")
        spawn = _sel(is_diag, diag_spawn, spawn)
        end = _sel(is_diag, diag_goal, end)
        goals = _sel(is_diag, diag_goal[:, None, :].expand(e, n, 3), goals)

    is_obst = torch.zeros_like(mode, dtype=torch.bool)
    for m in modes:
        is_obst |= mode == m
    return st.replace(goals=_sel(is_obst, goals, st.goals),
                      spawn_points=_sel(is_obst, spawn, st.spawn_points),
                      end_point=_sel(is_obst, end, st.end_point),
                      formation_center=_sel(is_obst, center,
                                            st.formation_center))


# --------------------------------------------------------------------------
# Events
# --------------------------------------------------------------------------

def _event_outcomes(cfg: ScenarioConfig, st: ScenarioState,
                    gen: torch.Generator, present: set, active: torch.Tensor,
                    centers: torch.Tensor) -> ScenarioState:
    """Every env's next event applied (the JAX package's slow phase at an
    event tick), drawn from `gen`; envs whose mode has no events pass
    through.  Only the branches of the modes in `present` are computed.
    `active` (E, C) and `centers` (C, 2) are the obstacle grid."""
    n = cfg.num_agents
    e, dev, dtype = st.mode.shape[0], st.mode.device, st.goals.dtype
    box = cfg.box
    mode = st.mode
    u = lambda: _uniform(gen, (e,), 0.0, 1.0, dtype, dev)
    is_ = lambda name: mode == MODE_IDS[name]
    has = lambda *names: any(MODE_IDS[m] in present for m in names)
    out = {}                  # leaf -> (mask, new value), applied in order

    def put(mask, **leaves):
        for name, value in leaves.items():
            out.setdefault(name, []).append((mask, value))

    if has("dynamic_same_goal"):
        # teleport the shared goal
        xy = torch.stack([u(), u()], -1) * (2 * box) - box
        z = torch.clamp(u() * box - 0.5 * box + 2.0, min=0.25)
        center = torch.cat([xy, z[:, None]], -1)
        put(is_("dynamic_same_goal"), formation_center=center,
            goals=generate_goals_affine(n, st.formation, center,
                                        st.formation_size, 0.0))
    if has("dynamic_diff_goal", "swarm_vs_swarm", "o_dynamic_diff_goal"):
        # a new formation, from each env's mode's table
        fid, npl, lo, hi, size, ld = _sample_formation_params(gen, cfg, mode,
                                                              dtype)
        form = dict(formation=fid, num_agents_per_layer=npl, lowest_size=lo,
                    highest_size=hi, formation_size=size, layer_dist=ld)
    if has("dynamic_diff_goal"):
        # new formation, teleport (z bound from the old formation, as the
        # reference), shuffle
        xy = torch.stack([u(), u()], -1) * (2 * box) - box
        z = get_z_value(u(), st.formation, n, st.num_agents_per_layer, box,
                        st.formation_size)
        center = torch.cat([xy, z[:, None]], -1)
        put(is_("dynamic_diff_goal"), formation_center=center,
            goals=_permute(gen, generate_goals_affine(n, fid, center, size,
                                                      ld)), **form)
    if has("swap_goals", "o_swap_goals"):
        put(is_("swap_goals") | is_("o_swap_goals"),
            goals=_permute(gen, st.goals))
    if has("swarm_vs_swarm"):
        # swap the two centers, new formation, regenerate and shuffle each
        # half
        c1, c2 = st.goal_center_2, st.goal_center_1
        put(is_("swarm_vs_swarm"), goal_center_1=c1, goal_center_2=c2,
            goals=torch.cat([
                _permute(gen, generate_goals_affine(n // 2, fid, c1, size,
                                                    ld)),
                _permute(gen, generate_goals_affine(n - n // 2, fid, c2, size,
                                                    ld))], 1), **form)
    for mid, (_, cap, z_range) in BEZIER_MODES.items():
        if mid in present:
            # resample the curve from the current goal
            put(mode == mid, bezier_nodes=_sample_bezier_nodes(
                gen, st.goals[:, 0], cfg.room_dims, st.formation_size, cap,
                z_range))
    if has("run_away") and n > 1:
        # drones 0 and 1 take the goals of two random others
        pick = torch.randint(1, n, (e, 2), generator=gen, device=dev)
        taken = torch.gather(st.goals, 1, pick[..., None].expand(e, 2, 3))
        put(is_("run_away"), goals=torch.cat([taken, st.goals[:, 2:]], 1))
    if has("o_dynamic_same_goal"):
        # a goal on a free cell within 4 of the last one, the first of
        # BEZIER_ATTEMPTS draws that is (else the first draw)
        pts = free_cell_attempts(gen, active, centers, BEZIER_ATTEMPTS, 0.75,
                                 3.0, dtype)
        ok = torch.linalg.vector_norm(st.end_point[:, None] - pts,
                                      dim=-1) <= 4.0
        first = torch.argmax(ok.to(torch.uint8), -1)
        goal = pts[torch.arange(e, device=dev), first]
        put(is_("o_dynamic_same_goal"), end_point=goal,
            goals=goal[:, None, :].expand(e, n, 3))
    if has("o_dynamic_diff_goal"):
        # the formation teleports to the freest square's centre (with a
        # new z), new formation, shuffled
        a0, a1 = cfg.obst_area
        center = max_free_square_center(gen, active.reshape(e, a0, a1),
                                        centers, dtype)
        put(is_("o_dynamic_diff_goal"), formation_center=center,
            end_point=center, goals=_permute(gen, generate_goals_affine(
                n, fid, center, size, ld)), **form)
    if has("o_test"):
        # the formation moves to the end point, once
        put(is_("o_test"), goals=generate_goals_affine(
            n, st.formation, st.end_point, st.formation_size, 0.0),
            interval=st.interval + int((cfg.ep_time + 1) * cfg.control_freq))

    changes = {}
    for name, updates in out.items():
        value = getattr(st, name)
        for mask, new in updates:
            value = _sel(mask, new, value)
        changes[name] = value
    return st.replace(**changes)


def _pack_row(st: ScenarioState) -> torch.Tensor:
    e = st.mode.shape[0]
    return torch.cat([getattr(st, name).reshape(e, -1).to(torch.float32)
                      for name in EVENT_WRITABLE], -1)


def _unpack_row(row: torch.Tensor, n: int, dtype) -> dict:
    out, off = {}, 0
    for name, spec, kind in _EVENT_SPEC:
        shape = _leaf_shape(spec, n)
        size = int(np.prod(shape, dtype=np.int64))
        val = row[:, off:off + size].reshape((row.shape[0],) + shape)
        out[name] = val.to(torch.int32 if kind == "i" else dtype)
        off += size
    return out


def presample_events(cfg: ScenarioConfig, st: ScenarioState,
                     gen: torch.Generator, present: set,
                     active: torch.Tensor, centers: torch.Tensor
                     ) -> torch.Tensor:
    """The episode's packed event table: slot k holds the outcome of the
    (k + 1)-th event, each event applied to the previous one's outcome.
    A Bezier event sees the goals at the previous curve's end point, so
    the chain moves them there after each Bezier slot.  Rows past an env's
    last event are never played back."""
    n = cfg.num_agents
    num_slots = st.events.shape[-1] // event_table_width(n)
    is_bez = torch.zeros_like(st.mode, dtype=torch.bool)
    for mid in BEZIER_MODES:
        is_bez |= st.mode == mid
    rows = []
    for _ in range(num_slots):
        new = _event_outcomes(cfg, st, gen, present, active, centers)
        rows.append(_pack_row(new))
        end_goals = new.bezier_nodes[:, :, 2][:, None, :].expand_as(new.goals)
        st = new.replace(goals=_sel(is_bez, end_goals, new.goals))
    return torch.cat(rows, -1)


def scenario_event(cfg: ScenarioConfig, st: ScenarioState,
                   tick: torch.Tensor) -> torch.Tensor:
    """(E,) bool: an event fires for this env at this tick."""
    mode = st.mode
    at_interval = (tick % torch.clamp(st.interval, min=1) == 0) & (tick > 0)
    interval_mode = torch.zeros_like(at_interval)
    for m in _INTERVAL_MODES:
        interval_mode |= mode == m
    event = interval_mode & at_interval
    # o_dynamic_same_goal also draws its first goal at tick 1
    event |= (mode == MODE_IDS["o_dynamic_same_goal"]) & (tick == 1)
    for mid, (secs, _, _) in BEZIER_MODES.items():
        cs = int(secs * cfg.control_freq)
        event |= (mode == mid) & ((tick % cs == 0) | (tick == 1))
    # o_test: once, on the first tick past its interval (the event pushes
    # the interval past the episode)
    event |= (mode == MODE_IDS["o_test"]) & (tick > st.interval)
    return event


# --------------------------------------------------------------------------
# Step
# --------------------------------------------------------------------------

def batched_scenario_step(cfg: ScenarioConfig, sts: ScenarioState,
                          ticks: torch.Tensor) -> ScenarioState:
    """Advance every env's scenario by one tick: the continuous goal motion
    of dynamic_formations, ep_lissajous3D and the two Bezier modes, then
    the playback of this tick's presampled events."""
    n = cfg.num_agents
    dtype = sts.goals.dtype
    mode = sts.mode
    goals = sts.goals

    # dynamic_formations: grow or shrink the formation every tick; flip the
    # direction and resample the speed at the bounds.
    is_df = mode == MODE_IDS["dynamic_formations"]
    at_low = sts.formation_size <= -sts.highest_size
    at_high = sts.formation_size >= sts.highest_size
    inc = torch.where(at_low, True, torch.where(at_high, False,
                                                sts.increase_formation))
    u = counter_uniform(sts.scen_seed, ticks, dtype)
    speed = torch.where(at_low | at_high, u * 2.0 + 1.0, sts.control_speed)
    sign = torch.where(inc, 1.0, -1.0).to(dtype)
    size = sts.formation_size + sign * 0.001 * speed
    df_goals = sts.goals_base + size[:, None, None] * sts.goals_slope
    goals = _sel(is_df, df_goals, goals)

    # ep_lissajous3D: the curve offset accumulates onto the previous goal.
    is_liss = mode == MODE_IDS["ep_lissajous3D"]
    t = ticks.to(dtype) / cfg.control_freq
    off = torch.stack([0.03 * torch.sin(t), 0.01 * torch.sin(2 * t + 90.0),
                       0.01 * torch.cos(2 * t + 90.0)], -1)
    goal0 = sts.goals[:, 0] + off
    goals = _sel(is_liss, goal0[:, None, :].expand(goals.shape), goals)

    # Bezier modes: move along the curve between resamples.
    for mid, (secs, _, _) in BEZIER_MODES.items():
        steps = int(secs * cfg.control_freq)
        t_idx = ticks % steps
        goal0 = _bezier_eval(sts.bezier_nodes, t_idx.to(dtype) / (steps - 1))
        move = (mode == mid) & (t_idx != 0) & (ticks > 1)
        goals = _sel(move, goal0[:, None, :].expand(goals.shape), goals)

    fast = sts.replace(
        goals=goals, formation_size=torch.where(is_df, size,
                                                sts.formation_size),
        increase_formation=torch.where(is_df, inc, sts.increase_formation),
        control_speed=torch.where(is_df, speed, sts.control_speed))

    # Event playback: row `event_count` of the packed table.
    event = scenario_event(cfg, sts, ticks)
    d = event_table_width(n)
    k_slots = sts.events.shape[-1] // d
    row = torch.clamp(sts.event_count, max=k_slots - 1).to(torch.int64)
    table = sts.events.reshape(-1, k_slots, d)
    sel = table[torch.arange(table.shape[0], device=row.device), row]
    leaves = _unpack_row(sel, n, dtype)
    merged = fast.replace(**{name: _sel(event, leaves[name],
                                        getattr(fast, name))
                             for name in EVENT_WRITABLE})
    return merged.replace(event_count=sts.event_count + event.to(torch.int32))
