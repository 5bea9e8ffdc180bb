"""Collision experience replay, batched over envs.

Port of quadswarm_tpu/env/replay.py.  Every 0.5 s of an episode the env's
state is checkpointed into a 6-slot ring (the last 3 s); on a new collision
the checkpoint from 1.5 s earlier goes into a 20-slot buffer; once the
drones "can fly" (fewer than 1 crash on average over the env's last 100
episodes, after at least 10), a finished episode restarts from a buffered
state with probability `sample_prob`, each entry at most 10 times.

The rings are `EnvState`s whose leaves carry (E, slots) in front, so under
`use_pallas_pairs` they hold the packed (E, slots, N, 128) int32 pair
histories.  A write touches one slot of each env (`ring[env, slot[env]]`),
never the whole ring, and the rings are written in place: the ReplayState
passed to `batched_replay_step` shares its rings with the one it returns.

Host syncs.  The tick decides on the device which envs save a checkpoint,
write the buffer, replay or reset, and reads the four "did any env" flags
to the host in one transfer: the one device-to-host sync of the tick, in
place of the JAX package's outer `lax.cond` and its two nested ones (and of
`batched_env_step`'s own `any(done)`).
"""
from __future__ import annotations

import dataclasses

import torch

from quadswarm_tpu_torch.env.multi import (
    EnvConfig, EnvState, _compute_obs, _select_done, _step,
    obstacles_of, reset_like,
)
from quadswarm_tpu_torch.utils.struct import Struct, leaves, map_fields

CP_STEP_SEC = 0.5            # checkpoint cadence
EP_CP_SLOTS = 6              # 3 s of checkpoints
BUFFER_SLOTS = 20
SAVE_BEFORE_COLLISION_SEC = 1.5
MAX_REPLAYS = 10
CRASH_WINDOW = 100
NO_TICK = -1_000_000_000     # last_tick_added of an episode with no write


@dataclasses.dataclass
class ReplayState(Struct):
    """Per-env replay machinery, leading axis E."""

    ep_checkpoints: EnvState          # ring, leaves (E, EP_CP_SLOTS, ...)
    ep_cp_count: torch.Tensor         # int32 checkpoints this episode
    buffer: EnvState                  # ring, leaves (E, BUFFER_SLOTS, ...)
    buffer_count: torch.Tensor        # int32 valid entries
    buffer_idx: torch.Tensor          # int32 next write slot
    num_replayed: torch.Tensor        # (E, BUFFER_SLOTS) int32
    last_tick_added: torch.Tensor     # int32
    saved_in_replay_buffer: torch.Tensor  # bool: replaying this episode
    activated: torch.Tensor           # bool: the drones can fly
    crash_history: torch.Tensor       # (E, CRASH_WINDOW) f32
    episode_count: torch.Tensor       # int32
    replayed_events: torch.Tensor     # int32


def init_replay_state(template: EnvState) -> ReplayState:
    """Empty replay state for the envs of `template` (leaves (E, ...)); the
    rings start as copies of the template, and no slot is read before it
    is written."""
    e = template.tick.shape[0]
    dev = template.tick.device
    ring = lambda k: map_fields(
        lambda x: x[:, None].expand((e, k) + x.shape[1:]).clone(), template)
    zi = lambda *s: torch.zeros((e,) + s, dtype=torch.int32, device=dev)
    flag = lambda: torch.zeros((e,), dtype=torch.bool, device=dev)
    return ReplayState(
        ep_checkpoints=ring(EP_CP_SLOTS), ep_cp_count=zi(),
        buffer=ring(BUFFER_SLOTS), buffer_count=zi(), buffer_idx=zi(),
        num_replayed=zi(BUFFER_SLOTS), last_tick_added=zi() + NO_TICK,
        saved_in_replay_buffer=flag(), activated=flag(),
        crash_history=torch.zeros((e, CRASH_WINDOW), dtype=torch.float32,
                                  device=dev),
        episode_count=zi(), replayed_events=zi())


def read_slots(ring: EnvState, slot: torch.Tensor) -> EnvState:
    """Env e's entry at slot[e]: leaves (E, K, ...) -> (E, ...)."""
    rows = torch.arange(slot.shape[0], device=slot.device)
    slot = slot.long()
    return map_fields(lambda r: r[rows, slot], ring)


def write_slots(ring: EnvState, slot: torch.Tensor, item: EnvState,
                cond: torch.Tensor) -> None:
    """In place: ring[e, slot[e]] = item[e] for the envs where cond[e]; the
    other envs' slot keeps its contents."""
    rows = torch.arange(slot.shape[0], device=slot.device)
    slot = slot.long()
    for (_, r), (_, x) in zip(leaves(ring), leaves(item)):
        mask = cond.reshape((-1,) + (1,) * (x.dim() - 1))
        r[rows, slot] = torch.where(mask, x, r[rows, slot])


def _unit_draw(draws: dict, name: str, e: int, gen, device):
    if name in draws:
        return draws[name]
    return torch.rand((e,), generator=gen, device=device)


def batched_replay_step(cfg: EnvConfig, params, sample_prob: float,
                        states: EnvState, rstates: ReplayState,
                        actions: torch.Tensor, gen: torch.Generator | None,
                        draws: dict | None = None):
    """One tick of E envs with collision replay.  Returns (states',
    rstates', obs, rewards (E, N), dones (E, N), info).

    draws: those of `batched_env_step`, plus "replay_u" (E,), the unit
    uniform compared with `sample_prob`, "replay_choice" (E,), the unit
    uniform u that picks buffer slot floor(u * max(buffer_count, 1)), and
    "replay_sensor", the sensor draws of a replayed env's observation.
    Missing draws come from `gen`; a fresh reset always draws from `gen`.
    """
    cfg.check_supported()
    draws = draws or {}
    new_state, obs, rew, done, info = _step(cfg, params, states, actions,
                                            gen, draws)
    e, dev = done.shape[0], done.device
    r = rstates
    freq = cfg.control_freq
    steps_ago = int(SAVE_BEFORE_COLLISION_SEC / CP_STEP_SEC)
    zero = torch.zeros_like(r.ep_cp_count)

    # Mid-episode: checkpoint cadence and collision writes.
    tick = states.tick + 1
    live = ~done & r.activated & ~r.saved_in_replay_buffer
    save_cp = live & (tick % int(CP_STEP_SEC * freq) == 0)
    cp_slot = r.ep_cp_count % EP_CP_SLOTS
    ep_cp_count = r.ep_cp_count + save_cp.to(torch.int32)
    # a new drone pair or a new obstacle hit
    collided = torch.any(new_state.prev_coll_ids & ~states.prev_coll_ids, -1)
    if cfg.use_obstacles:
        collided = collided | torch.any(
            new_state.prev_obst_hits & ~states.prev_obst_hits, -1)
    can_write = (live & collided & (tick > int(1.5 * freq))
                 & (tick - r.last_tick_added > int(5 * freq))
                 & (ep_cp_count >= steps_ago))
    # The checkpoint from 1.5 s ago: (count_after - 3) % 6 is never this
    # tick's write slot count_before % 6.
    read_slot = (ep_cp_count - steps_ago) % EP_CP_SLOTS
    slots = torch.arange(BUFFER_SLOTS, device=dev)
    written = can_write[:, None] & (slots == r.buffer_idx[:, None])
    num_replayed = torch.where(written, torch.zeros_like(r.num_replayed),
                               r.num_replayed)
    buffer_idx = torch.where(can_write, (r.buffer_idx + 1) % BUFFER_SLOTS,
                             r.buffer_idx)
    buffer_count = torch.where(
        can_write, torch.clamp(r.buffer_count + 1, max=BUFFER_SLOTS),
        r.buffer_count)
    last_tick_added = torch.where(can_write, tick, r.last_tick_added)

    # Episode end: the can-fly gate, then replay or fresh reset.
    hist_slot = torch.arange(CRASH_WINDOW, device=dev) == (
        r.episode_count % CRASH_WINDOW)[:, None]
    hist = torch.where(done[:, None] & hist_slot,
                       states.crashes_last_episode[:, None].to(
                           r.crash_history.dtype), r.crash_history)
    episode_count = r.episode_count + done.to(torch.int32)
    window = torch.clamp(episode_count, max=CRASH_WINDOW).to(hist.dtype)
    mean_crashes = torch.abs(hist.sum(-1) / torch.clamp(window, min=1.0))
    activated = r.activated | (done & (episode_count >= 10)
                               & (mean_crashes < 1.0))

    u_choice = _unit_draw(draws, "replay_choice", e, gen, dev)
    u_sample = _unit_draw(draws, "replay_u", e, gen, dev)
    valid = torch.clamp(buffer_count, min=1)
    choice = torch.minimum((u_choice * valid).to(torch.int32), valid - 1)
    chosen = slots == choice[:, None]
    # The count before this tick's write: a slot rewritten on the tick its
    # episode ends keeps its old count's veto.
    replayable = torch.sum(torch.where(chosen, r.num_replayed, 0),
                           -1) < MAX_REPLAYS
    did_replay = (done & activated & (buffer_count > 0) & replayable
                  & (u_sample < sample_prob))
    num_replayed = num_replayed + (did_replay[:, None] & chosen).to(
        torch.int32)
    replayed_events = r.replayed_events + did_replay.to(torch.int32)
    needs_reset = done & ~did_replay

    # The tick's one device-to-host read.
    fire_cp, fire_write, fire_replay, fire_reset = torch.stack([
        save_cp.any(), can_write.any(), did_replay.any(),
        needs_reset.any()]).tolist()
    if fire_write:
        item = read_slots(r.ep_checkpoints, read_slot)   # before the cp write
        write_slots(r.buffer, r.buffer_idx, item, can_write)
    if fire_cp:
        write_slots(r.ep_checkpoints, cp_slot, new_state, save_cp)
    if fire_replay:
        replay_env = read_slots(r.buffer, choice)
        replay_env = replay_env.replace(
            collisions_per_episode=zero, collisions_after_settle=zero,
            obst_collisions_per_episode=zero,
            obst_collisions_after_settle=zero,
            rew_coeff=new_state.rew_coeff)
        replay_obs, _ = _compute_obs(
            cfg, replay_env.dyn, replay_env.scenario.goals,
            replay_env.gyro_bias, gen, draws.get("replay_sensor"),
            obstacles_of(replay_env))
        new_state = _select_done(did_replay, replay_env, new_state)
        obs = torch.where(did_replay[:, None, None], replay_obs, obs)
    if fire_reset:
        # a fresh episode keeps the env's obstacle density and size unless
        # they are domain-random
        reset_states, reset_obs = reset_like(cfg, params, gen, new_state)
        new_state = _select_done(needs_reset, reset_states, new_state)
        obs = torch.where(needs_reset[:, None, None], reset_obs, obs)

    new_rstates = r.replace(
        ep_cp_count=torch.where(done, zero, ep_cp_count),
        buffer_count=buffer_count, buffer_idx=buffer_idx,
        num_replayed=num_replayed,
        last_tick_added=torch.where(done, zero + NO_TICK, last_tick_added),
        saved_in_replay_buffer=torch.where(done, did_replay,
                                           r.saved_in_replay_buffer),
        activated=activated, crash_history=hist,
        episode_count=episode_count, replayed_events=replayed_events)
    info["replay/replay_rate"] = (replayed_events.to(torch.float32)
                                  / torch.clamp(episode_count, min=1))
    info["replay/replay_buffer_size"] = buffer_count
    info["replay/activated"] = activated
    return (new_state, new_rstates, obs, rew,
            done[:, None].expand(rew.shape), info)
