"""The readers of the program's spans (`portbench/spans.py` and the
`program_span` metrics) on a synthetic store: the values they give, and
None with no store (a program without `utils/tracing.py`), with no
spans, and with no device times (off the card)."""
import os
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(BENCH))

from portbench.harness import load_json, load_module  # noqa: E402
from quadswarm_tpu_torch.utils import tracing  # noqa: E402
from quadswarm_tpu_torch.utils.tracing import Span  # noqa: E402

MS = 1_000_000   # ns


def _store(device=True):
    """Two ticks: each 10 ms on the host, 6 of them in `env.sync`; the
    policy 3 ms on the device a tick and 3 more after the loop, the env
    step 2 ms, the rings 0.25 ms twice a tick, one restore of 0.5 ms."""
    out = []

    def add(name, parent, tick, t0, t1, dev):
        out.append(Span(name, parent, tick, t0, t1, dev if device else None))
        return len(out) - 1

    for k in range(2):
        t = k * 20 * MS
        i = add("rollout.tick", None, k, t, t + 10 * MS, 9.0)
        add("rollout.policy", i, k, t, t + MS, 3.0)
        add("rollout.sample", i, k, t + MS, t + 2 * MS, 0.5)
        j = add("rollout.env_step", i, k, t + 2 * MS, t + 10 * MS, 5.0)
        add("env.step", j, k, t + 2 * MS, t + 3 * MS, 2.0)
        add("replay.ring", j, k, t + 3 * MS, t + 3 * MS + 100, 0.25)
        add("env.sync", j, k, t + 3 * MS + 100, t + 9 * MS + 100, 0.1)
        add("replay.ring", j, k, t + 9 * MS + 100, t + 9 * MS + 200, 0.25)
        if k == 0:
            add("replay.restore", j, k, t + 9 * MS + 200, t + 10 * MS, 0.5)
    add("rollout.policy", None, None, 40 * MS, 41 * MS, 3.0)
    add("rollout.stack", None, None, 41 * MS, 42 * MS, 1.0)
    return out


EXPECTED = {
    "sync_wait_ms_per_tick.rollout": 6.0,
    "host_issue_ms_per_tick.rollout": 4.0,
    "policy_device_ms_per_tick.rollout": 4.5,
    "env_device_ms_per_tick.rollout": 2.0,
    "replay_device_ms_per_tick.rollout": 0.75,
}
HOST = ("sync_wait_ms_per_tick.rollout", "host_issue_ms_per_tick.rollout")


def _reader(name):
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "portbench_metric_" + name)


def _rec(traced=True):
    return types.SimpleNamespace(trace={"ticks": 2} if traced else None)


def test_every_span_metric_has_a_reader_and_its_entry():
    bench = load_json(os.path.dirname(BENCH), "BENCHMARK.json")
    spans = {m["name"]: m for m in bench["per_layer"]
             if m["source"] == "program_span"}
    assert set(spans) == set(EXPECTED)
    for m in spans.values():
        assert m["workloads"] == ["rollout.swarm128"]
        assert m["moves"] == "rollout_agent_steps_per_s"


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_on_a_synthetic_store(name, monkeypatch):
    monkeypatch.setattr(tracing, "spans", _store)
    assert _reader(name).read(_rec()) == pytest.approx(EXPECTED[name])
    assert _reader(name).read(_rec(traced=False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_without_device_times(name, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: _store(device=False))
    value = _reader(name).read(_rec())
    if name in HOST:
        assert value == pytest.approx(EXPECTED[name])
    else:
        assert value is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_with_no_spans_or_no_store(name, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert _reader(name).read(_rec()) is None
    # a program without the module, as the commit before the spans
    monkeypatch.setitem(sys.modules, "quadswarm_tpu_torch.utils.tracing",
                        None)
    monkeypatch.delattr(sys.modules["quadswarm_tpu_torch.utils"], "tracing")
    assert _reader(name).read(_rec()) is None


def test_gaps_by_span_names_each_gap_by_the_innermost_open_span():
    """...open on the host where the operation that ends the gap was
    launched, whatever the profiler's device times say of the host."""
    tool = load_module(os.path.join(BENCH, "tools", "gaps_by_span.py"),
                       "portbench_gaps_by_span")
    spans = _store()
    # device operations (name, start, end, correlation), in ns: gaps from
    # 1.5 to 2.5 ms, 9.2 to 9.5, 15 to 16 and 17 to 18
    ops = [("a", 0, 3 * MS // 2, 1), ("b", 5 * MS // 2, 3 * MS, 2),
           ("c", 29 * MS // 10, 92 * MS // 10, 3),
           ("d", 95 * MS // 10, 15 * MS, 4), ("e", 16 * MS, 17 * MS, 5),
           ("f", 18 * MS, 19 * MS, 6)]
    # b launched in tick 0's action draw, d in its replay's restore, e in
    # tick 1's policy (the device's times 4.5 ms off the host's there);
    # f's launch is not in the profile
    launches = {1: MS // 10, 2: 12 * MS // 10, 3: 2 * MS,
                4: 94 * MS // 10, 5: 205 * MS // 10}
    out = tool.summarize(ops, launches, spans, ticks=2)
    assert out["gaps"] == {
        "rollout.sample": {"per_tick": 0.5, "ms_per_tick": pytest.approx(0.5)},
        "rollout.policy": {"per_tick": 0.5, "ms_per_tick": pytest.approx(0.5)},
        "unmatched": {"per_tick": 0.5, "ms_per_tick": pytest.approx(0.5)},
        "replay.restore": {"per_tick": 0.5,
                           "ms_per_tick": pytest.approx(0.15)},
    }
    assert out["spans"]["rollout.policy"]["device_ms"] == pytest.approx(4.5)
    assert out["spans"]["replay.ring"]["per_tick"] == 2


def test_gaps_by_span_attributes_each_operation_to_its_launch():
    tool = load_module(os.path.join(BENCH, "tools", "gaps_by_span.py"),
                       "portbench_gaps_by_span")
    spans = _store()
    # (name, start, end, correlation) on the device; launches on the host
    ops = [("sm90_xmma_gemm_f32", 0, 2 * MS, 1),
           ("CatArrayBatchedCopy", 2 * MS, 3 * MS, 2),
           ("dynamics_kernel", 3 * MS, 4 * MS, 3),
           ("Memcpy DtoH", 4 * MS, 5 * MS, 4),
           ("vectorized_elementwise_kernel", 5 * MS, 6 * MS, 5)]
    launches = {1: MS // 2, 2: MS // 2, 3: 2 * MS + 10, 4: 4 * MS,
                5: 15 * MS}
    out = tool.kernels_by_span(ops, launches, spans, ticks=2)
    assert out == {"rollout.policy": {"gemm": 1.0, "cat": 0.5},
                   "env.step": {"K1": 0.5},
                   "env.sync": {"copy": 0.5},
                   "outside": {"elementwise": 0.5}}


class _Event:
    def __init__(self, name, device, start, end, corr, stream=7):
        import torch
        kind = torch.autograd.DeviceType
        self._v = (name, kind.CUDA if device else kind.CPU, start, end,
                   corr, stream)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_index(self):
        return 0

    def device_resource_id(self):
        return self._v[5]


def test_launch_lag_finds_an_operation_that_starts_before_its_launch():
    tool = load_module(os.path.join(BENCH, "tools", "launch_lag.py"),
                       "portbench_launch_lag")
    spans = [Span("a", None, 0, 900, 3000, 1.0),
             Span("b", None, 1, 4900, 6000, 1.0)]
    # k2 starts 1 µs before its launch; k3 starts on an idle device
    events = [_Event("cudaLaunchKernel", False, 1000, 1010, 1),
              _Event("k1", True, 1020, 2000, 1),
              _Event("cudaLaunchKernel", False, 5000, 5010, 2),
              _Event("k2", True, 4000, 4500, 2),
              _Event("cudaLaunchKernel", False, 50000, 50010, 3),
              _Event("k3", True, 80000, 90000, 3)]
    out = tool.read_profile(events, spans)
    assert (out["ops"], out["matched"]) == (3, 3)
    assert out["min_lag_us"] == pytest.approx(-1.0)
    [early] = out["early"]
    assert (early["name"], early["span"], early["index"]) == ("k2", "b", 1)
    assert early["lead_over_span_us"] == pytest.approx(0.9)
    assert out["stream_order"] == {"overlaps": 0, "inversions": 0}
    assert early["min_lag_before_us"] == pytest.approx(0.02)
    assert early["min_lag_after_us"] == pytest.approx(30.0)
    assert out["idle_lag_us"] is None     # one operation on an idle device
    assert out["span_lead_us"] == pytest.approx(0.1)
