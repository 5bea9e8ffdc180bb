"""The program's spans (`quadswarm_tpu_torch/utils/tracing.py`) in a rollout
of the swarm at a small size (2 envs x 8 drones, 8 ticks, replay on): off
without a profiler, the same outputs bit for bit with them on, the tree of
a tick, one stretch at a time, the profiler's clock, and `debug.trace`'s
Chrome trace.  The test marked `cuda` holds the device side on the card:
device times, no event of the profiler's device timeline from a span, one
sync a tick, and K1, K2, K3 and the tick's read each launched inside its
stage's span on the profiler's host clock.
Imports no JAX; on the card:
`python -m pytest tests/test_torch_tracing.py --noconftest -q`."""
import bisect
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quadswarm_tpu_torch.env.multi import env_reset
from quadswarm_tpu_torch.env.params import make_dynamics_params
from quadswarm_tpu_torch.env.replay import init_replay_state
from quadswarm_tpu_torch.env.reward import RewardCoeffs
from quadswarm_tpu_torch.parallel.ppo import collect_rollout
from quadswarm_tpu_torch.training.config import (
    base_rew_coeff_from_args, env_config_from_args, model_from_args,
    parse_swarm_cfg, ppo_config_from_args,
)
from quadswarm_tpu_torch.utils import debug, tracing

SEED = 2 ** 31 + 12345
# train.sh's swarm at a small size: the attention policy over 6 visible
# neighbours, K2 and K3 on the pairs route, downwash, replay on
FLAGS = ["--num_envs=2", "--quads_num_agents=8", "--rollout=8",
         "--rnn_size=16", "--quads_neighbor_hidden_size=16",
         "--nonlinearity=tanh", "--replay_buffer_sample_prob=0.75",
         "--quads_mode=mix", "--quads_episode_duration=15.0",
         "--quads_neighbor_encoder_type=attention",
         "--quads_neighbor_visible_num=6",
         "--quads_neighbor_obs_type=pos_vel",
         "--quads_collision_hitbox_radius=2.0",
         "--quads_collision_falloff_radius=4.0",
         "--quads_use_downwash=True", "--quads_use_pallas_pairs=true"]
TICK_CHILDREN = ("rollout.policy", "rollout.sample", "rollout.env_step")
STAGES = ("env.scenario", "env.dynamics", "env.collisions", "env.reward",
          "env.interactions", "env.obs", "env.stats")


class Rollout:
    """The swarm's rollout at a small size, with its env and replay state;
    two built on one device give the same outputs."""

    def __init__(self, device):
        args = parse_swarm_cfg(FLAGS + [f"--device={device}"])
        self.env_cfg = env_config_from_args(args)
        self.dyn = make_dynamics_params(dt=self.env_cfg.dt)
        self.ppo = ppo_config_from_args(args)
        self.rew_coeff = RewardCoeffs(**base_rew_coeff_from_args(args))
        torch.manual_seed(SEED)
        self.model = model_from_args(args, self.env_cfg, device=device)
        self.gen = torch.Generator(device).manual_seed(SEED)
        self.states, self.obs = env_reset(self.env_cfg, self.dyn, self.gen,
                                          args.num_envs, device=device)
        self.replay = init_replay_state(self.states)
        self.ticks = self.ppo.rollout

    def __call__(self):
        (self.states, self.obs, self.replay, traj, last_value,
         info) = collect_rollout(self.env_cfg, self.dyn, self.model,
                                 self.ppo, self.states, self.obs, self.gen,
                                 self.rew_coeff, self.replay)
        return traj, last_value, info


def _outputs_equal(a, b):
    (ta, va, ia), (tb, vb, ib) = a, b
    return (all(torch.equal(x, y) for x, y in zip(ta, tb))
            and torch.equal(va, vb) and ia.keys() == ib.keys()
            and all(torch.equal(ia[k], ib[k]) for k in ia))


def _clear_store():
    tracing._STORE.new_stretch()
    tracing._STORE.on = False


@pytest.fixture(scope="module")
def profiled():
    """One rollout with spans off and the same rollout with spans on (under
    the CPU profiler); the spans, the profiler and both outputs."""
    _clear_store()
    off, on = Rollout("cpu"), Rollout("cpu")
    out_off = off()
    spans_after_off = tracing.spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out_on = on()
    return dict(off=out_off, on=out_on, spans_after_off=spans_after_off,
                spans=tracing.spans(), prof=prof, ticks=off.ticks,
                rollout=on)


def test_spans_off_record_nothing_and_on_change_no_output(profiled):
    assert profiled["spans_after_off"] == []
    assert profiled["spans"]
    assert _outputs_equal(profiled["off"], profiled["on"])


def test_the_spans_of_a_rollout(profiled):
    spans, ticks = profiled["spans"], profiled["ticks"]
    assert tracing.dropped() == 0
    assert all(s.host_end_ns is not None for s in spans)
    if not torch.cuda.is_initialized():
        # a process that has touched CUDA records events for CPU work too
        assert all(s.device_ms is None for s in spans)
    tick_ids = [i for i, s in enumerate(spans) if s.name == "rollout.tick"]
    assert [spans[i].tick for i in tick_ids] == list(range(ticks))
    assert all(spans[i].parent is None for i in tick_ids)
    children = {i: [] for i in range(len(spans))}
    for i, s in enumerate(spans):
        if s.parent is not None:
            children[s.parent].append(i)
            parent = spans[s.parent]
            assert parent.host_start_ns <= s.host_start_ns
            assert s.host_end_ns <= parent.host_end_ns
            assert s.tick == parent.tick
    names = lambda ids: [spans[j].name for j in ids]
    for i in tick_ids:
        assert names(children[i]) == list(TICK_CHILDREN)
        env_step = children[i][2]
        inner = names(children[env_step])
        # the replay's tick: its decisions, the read, the writes
        assert inner == ["env.step", "replay.ring", "env.sync", "replay.ring"]
        step = children[env_step][0]
        assert names(children[step]) == list(STAGES)
        for j in children[step]:
            assert spans[j].tick == spans[i].tick
    # after the loop: the last value's forward and the stacks
    rest = [s for s in spans if s.tick is None]
    assert [s.name for s in rest] == ["rollout.policy", "rollout.stack"]


def test_a_new_profiled_stretch_drops_the_old_one(profiled):
    assert profiled["spans"]
    with tracing.span("between"):      # the profiler is off
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("second"):
            with tracing.span("inner"):
                pass
    assert [(s.name, s.parent, s.tick) for s in tracing.spans()] == [
        ("second", None, None), ("inner", 0, None)]


def test_spans_share_the_profilers_clock(profiled):
    """Every operator the CPU profiler records that starts inside a span
    ends inside it, and every tick and env stage holds operators."""
    cpu = torch.autograd.DeviceType.CPU
    ops = sorted((e.start_ns(), e.end_ns())
                 for e in profiled["prof"].profiler.kineto_results.events()
                 if e.device_type() == cpu and e.name().startswith("aten::"))
    starts = [a for a, _ in ops]
    assert ops
    for s in profiled["spans"]:
        inside = ops[bisect.bisect_left(starts, s.host_start_ns):
                     bisect.bisect_right(starts, s.host_end_ns)]
        assert all(b <= s.host_end_ns for _, b in inside), s
        if s.name == "rollout.tick" or s.name in STAGES:
            assert inside, s


class _Event:
    """An event of `kineto_results.events()`, as `launch_times` reads it."""

    def __init__(self, name, device_type, start_ns, correlation_id):
        self._name, self._type = name, device_type
        self._start, self._id = start_ns, correlation_id

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def start_ns(self):
        return self._start

    def correlation_id(self):
        return self._id


def test_launch_times_take_the_cuda_api_call_of_each_id():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Event("cudaLaunchKernel", cpu, 100, 1),
              _Event("elementwise_kernel", cuda, 150, 1),
              _Event("Activity Buffer Request", cpu, 900, 1),
              _Event("cuLaunchKernel", cpu, 200, 2),
              _Event("Memcpy DtoH", cuda, 260, 3),
              _Event("cudaMemcpyAsync", cpu, 250, 3)]
    assert tracing.launch_times(events) == {1: 100, 2: 200, 3: 250}


def test_span_at_gives_the_innermost_open_span():
    Span = tracing.Span
    spans = [Span("tick", None, 0, 0, 100, None),
             Span("step", 0, 0, 10, 60, None),
             Span("sync", 1, 0, 20, 30, None),
             Span("ring", 1, 0, 30, 40, None),
             Span("open", None, None, 200, None, None)]
    at = tracing.span_at(spans[::-1])
    assert [getattr(at(t), "name", None)
            for t in (5, 10, 25, 30, 35, 50, 100, 150, 250)] == [
        "tick", "step", "sync", "ring", "ring", "step", "tick", None, None]


def test_debug_trace_shows_the_spans(profiled, tmp_path):
    run = profiled["rollout"]
    with debug.trace(str(tmp_path)):
        run()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for name in ("rollout.tick", "rollout.stack", "env.sync", "replay.ring")\
            + TICK_CHILDREN + STAGES:
        assert name in names, name


@pytest.mark.cuda
def test_spans_on_the_card():
    """Under a profile of the device alone, as the benchmark's `--trace 1`
    takes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import SyncCounter
    run = Rollout("cuda")
    run()                                     # builds the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with SyncCounter() as syncs:
            run()
            torch.cuda.synchronize()
    spans = tracing.spans()
    assert syncs.implicit == run.ticks
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in spans)
    assert all(s.device_ms > 0 for s in spans if s.name == "rollout.policy")

    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type() == cuda]
    assert device
    span_names = {s.name for s in spans}
    assert not span_names & {e.name() for e in device}
    # the profiler's host clock is the spans': each of these operations is
    # launched (its CUDA API call) inside the span of the stage that runs
    # it.  The profiler's device times are not compared with the host's:
    # on an H100 they sit micro- to milliseconds off it in about half the
    # profiles, spans on or off (`portbench/tools/launch_lag.py`)
    launch = tracing.launch_times(events)
    span_at = tracing.span_at(spans)

    def launched_in(corr):
        at = launch.get(corr)
        s = None if at is None else span_at(at)
        return None if s is None else s.name

    stages = {"dynamics_kernel": "env.dynamics",
              "pair_collision_kernel": "env.collisions",
              "neighbor_topk_kernel": "env.obs", "Memcpy DtoH": "env.sync"}
    found = {piece: [] for piece in stages}
    for e in device:
        for piece in stages:
            if piece in e.name():
                found[piece].append(launched_in(e.correlation_id()))
    for piece, stage in stages.items():
        assert found[piece] == [stage] * run.ticks, (piece, found[piece])
