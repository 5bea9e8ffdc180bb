"""Goal scenarios, batched over envs.

Port of quadswarm_tpu/env/scenarios.py for the nine free-space modes of the
multi-drone mix curriculum (MIX_MODES_MULTI).  Every function works on a
batch of E envs at once (the JAX package writes one env and vmaps); the
per-env mode is data, and each mode's branch is a masked `torch.where`.
Asking for any other mode raises NotImplementedError.

Where the randomness comes from.  The JAX package derives every scenario
draw from `fold_in(scen_key, tick)`, so that reset can presample the
episode's events.  The port draws at reset from the caller's generator:
`scenario_reset` samples the episode and `presample_events` fills the
packed (E, K * D) event table that `batched_scenario_step` plays back, in
the same layout.  The one per-tick draw, the dynamic_formations speed
resample, comes from a counter-based hash of the env's `scen_seed` and the
tick (`counter_uniform`), so it needs no generator on the hot path.  Such
draws match the JAX package in distribution, not bit for bit.
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
SUPPORTED_MODES = frozenset(MIX_MODES_MULTI)

_ARM = 0.05
# (formation choices, dist_low, dist_high) of the supported modes.
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
}
_ROWS = [MODE_TABLE.get(m, (1, 0.0, 0.0)) for m in MODES]
MODE_NUM_CHOICES = np.array([r[0] for r in _ROWS], np.int64)
MODE_DIST_LOW = np.array([r[1] for r in _ROWS], np.float64)
MODE_DIST_HIGH = np.array([r[2] for r in _ROWS], np.float64)
APPROACH_GOAL_METRIC = 0.5          # every free-space mode

BEZIER_ATTEMPTS = 20
CONTINUOUS_MODES = frozenset((MODE_IDS["dynamic_formations"],
                              MODE_IDS["ep_lissajous3D"],
                              MODE_IDS["ep_rand_bezier"]))
_INTERVAL_MODES = frozenset((2, 3, 4, 8))
BEZIER_SECS = 5


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
        raise NotImplementedError(
            f"scenario modes {[MODES[m] for m in bad]} are not ported yet; "
            "the port supports the nine free-space modes of the mix")


def num_event_slots(cfg: ScenarioConfig, allowed_modes=None) -> int:
    """Upper bound (plus one spare) on scenario events in one episode."""
    ep_len = int(cfg.ep_time * cfg.control_freq)
    allowed = (set(range(len(MODES))) if allowed_modes is None
               else set(int(m) for m in allowed_modes))
    f = cfg.control_freq
    k = 1
    if MODE_IDS["run_away"] in allowed:
        k = max(k, ep_len // max(int(1 * f), 1))
    if allowed & (_INTERVAL_MODES | {9, 12, 13, 18}):
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
                         max_dist_cap: float):
    """Degree-2 Bezier control points (E, 3 dims, 3 points) with the bounds
    check, by BEZIER_ATTEMPTS masked retries per env."""
    e, dev, dtype = goal0.shape[0], goal0.device, goal0.dtype
    room = torch.tensor(room_dims, dtype=dtype, device=dev) \
        - formation_size[:, None]
    zero = torch.zeros_like(room[:, 0])
    low = torch.stack([-room[:, 0] / 2, -room[:, 1] / 2, zero], -1)
    high = torch.stack([room[:, 0] / 2, room[:, 1] / 2, room[:, 2]], -1)
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
# Reset
# --------------------------------------------------------------------------

def scenario_reset(cfg: ScenarioConfig, gen: torch.Generator, mode,
                   dtype=torch.float32, allowed_modes=None,
                   num_slots: int | None = None) -> ScenarioState:
    """A fresh episode's scenario for each env's mode (E,) int tensor,
    including its presampled event table."""
    check_modes(torch.unique(mode).tolist() if allowed_modes is None
                else allowed_modes)
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
        approach_goal_metric=torch.full((e,), APPROACH_GOAL_METRIC,
                                        dtype=dtype, device=dev),
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

    # ep_rand_bezier: an initial curve at reset (the tick-1 event resamples).
    is_bez = mode == MODE_IDS["ep_rand_bezier"]
    nodes = _sample_bezier_nodes(gen, st.goals[:, 0], cfg.room_dims,
                                 st.formation_size, 30.0)
    st = st.replace(bezier_nodes=_sel(is_bez, nodes, st.bezier_nodes))
    return st.replace(events=presample_events(cfg, st, gen))


# --------------------------------------------------------------------------
# Events
# --------------------------------------------------------------------------

def _event_outcomes(cfg: ScenarioConfig, st: ScenarioState,
                    gen: torch.Generator) -> ScenarioState:
    """Every env's next event applied (the JAX package's slow phase at an
    event tick), drawn from `gen`; envs whose mode has no events pass
    through."""
    n = cfg.num_agents
    e, dev, dtype = st.mode.shape[0], st.mode.device, st.goals.dtype
    box = cfg.box
    mode = st.mode
    u = lambda: _uniform(gen, (e,), 0.0, 1.0, dtype, dev)

    # dynamic_same_goal: teleport the shared goal.
    xy = torch.stack([u(), u()], -1) * (2 * box) - box
    z = torch.clamp(u() * box - 0.5 * box + 2.0, min=0.25)
    dsg_center = torch.cat([xy, z[:, None]], -1)
    dsg_goals = generate_goals_affine(n, st.formation, dsg_center,
                                      st.formation_size, 0.0)

    # dynamic_diff_goal: new formation, teleport (z bound from the old
    # formation, as the reference), shuffle.
    fid, npl, lo, hi, size, ld = _sample_formation_params(gen, cfg, mode,
                                                          dtype)
    xy = torch.stack([u(), u()], -1) * (2 * box) - box
    z = get_z_value(u(), st.formation, n, st.num_agents_per_layer, box,
                    st.formation_size)
    ddg_center = torch.cat([xy, z[:, None]], -1)
    ddg_goals = _permute(gen, generate_goals_affine(n, fid, ddg_center, size,
                                                    ld))

    # swap_goals: shuffle.
    swap_goals = _permute(gen, st.goals)

    # swarm_vs_swarm: swap the two centers, new formation, regenerate and
    # shuffle each half.
    c1, c2 = st.goal_center_2, st.goal_center_1
    svs_goals = torch.cat([
        _permute(gen, generate_goals_affine(n // 2, fid, c1, size, ld)),
        _permute(gen, generate_goals_affine(n - n // 2, fid, c2, size, ld))],
        1)

    # ep_rand_bezier: resample the curve from the current goal.
    nodes = _sample_bezier_nodes(gen, st.goals[:, 0], cfg.room_dims,
                                 st.formation_size, 30.0)

    is_dsg = mode == MODE_IDS["dynamic_same_goal"]
    is_ddg = mode == MODE_IDS["dynamic_diff_goal"]
    is_swap = mode == MODE_IDS["swap_goals"]
    is_svs = mode == MODE_IDS["swarm_vs_swarm"]
    is_bez = mode == MODE_IDS["ep_rand_bezier"]
    new_form = is_ddg | is_svs
    goals = _sel(is_dsg, dsg_goals, _sel(is_ddg, ddg_goals, _sel(
        is_swap, swap_goals, _sel(is_svs, svs_goals, st.goals))))
    return st.replace(
        goals=goals,
        formation=_sel(new_form, fid, st.formation),
        num_agents_per_layer=_sel(new_form, npl, st.num_agents_per_layer),
        lowest_size=_sel(new_form, lo, st.lowest_size),
        highest_size=_sel(new_form, hi, st.highest_size),
        formation_size=_sel(new_form, size, st.formation_size),
        layer_dist=_sel(new_form, ld, st.layer_dist),
        formation_center=_sel(is_dsg, dsg_center, _sel(
            is_ddg, ddg_center, st.formation_center)),
        goal_center_1=_sel(is_svs, c1, st.goal_center_1),
        goal_center_2=_sel(is_svs, c2, st.goal_center_2),
        bezier_nodes=_sel(is_bez, nodes, st.bezier_nodes))


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
                     gen: torch.Generator) -> torch.Tensor:
    """The episode's packed event table: slot k holds the outcome of the
    (k + 1)-th event, each event applied to the previous one's outcome.
    A Bezier event sees the goals at the previous curve's end point, so
    the chain moves them there after each Bezier slot.  Rows past an env's
    last event are never played back."""
    n = cfg.num_agents
    num_slots = st.events.shape[-1] // event_table_width(n)
    is_bez = st.mode == MODE_IDS["ep_rand_bezier"]
    rows = []
    for _ in range(num_slots):
        new = _event_outcomes(cfg, st, gen)
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
    cs = int(BEZIER_SECS * cfg.control_freq)
    bez = (mode == MODE_IDS["ep_rand_bezier"]) & ((tick % cs == 0)
                                                  | (tick == 1))
    return (interval_mode & at_interval) | bez


# --------------------------------------------------------------------------
# Step
# --------------------------------------------------------------------------

def batched_scenario_step(cfg: ScenarioConfig, sts: ScenarioState,
                          ticks: torch.Tensor) -> ScenarioState:
    """Advance every env's scenario by one tick: the continuous goal motion
    of dynamic_formations, ep_lissajous3D and ep_rand_bezier, then the
    playback of this tick's presampled events."""
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
    size = sts.formation_size + torch.where(inc, 1.0, -1.0) * 0.001 * speed
    df_goals = sts.goals_base + size[:, None, None] * sts.goals_slope
    goals = _sel(is_df, df_goals, goals)

    # ep_lissajous3D: the curve offset accumulates onto the previous goal.
    is_liss = mode == MODE_IDS["ep_lissajous3D"]
    t = ticks.to(dtype) / cfg.control_freq
    off = torch.stack([0.03 * torch.sin(t), 0.01 * torch.sin(2 * t + 90.0),
                       0.01 * torch.cos(2 * t + 90.0)], -1)
    goal0 = sts.goals[:, 0] + off
    goals = _sel(is_liss, goal0[:, None, :].expand(goals.shape), goals)

    # ep_rand_bezier: move along the curve between resamples.
    is_bez = mode == MODE_IDS["ep_rand_bezier"]
    steps = int(BEZIER_SECS * cfg.control_freq)
    t_idx = ticks % steps
    goal0 = _bezier_eval(sts.bezier_nodes, t_idx.to(dtype) / (steps - 1))
    move = is_bez & (t_idx != 0) & (ticks > 1)
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
