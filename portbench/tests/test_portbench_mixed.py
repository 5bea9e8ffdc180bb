"""The configuration `pbt8-obst-attn` against the run file it names,
BENCHMARK.json against the files the harness finds by name, and the cell
`rollout.pbt8` end to end on the CPU at a few envs: a sound run is
correct; the control and each fault of `faults_mixed.py` are not."""
import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from portbench.faults_mixed import FAULTS  # noqa: E402
from portbench.harness import run_cell  # noqa: E402

RUN_FILE = "quadswarm_tpu_torch/runs/pbt_quads_multi_obstacles.py"
SMALL = ["--num_envs=4", "--num_policies=3", "--rollout=4",
         "--batch_size=128"]
SEED = 2 ** 31 + 54321


def _config():
    with open(os.path.join(BENCH, "configs", "pbt8-obst-attn.json")) as f:
        return json.load(f)


def test_the_configuration_is_the_pbt_run_file_mixed_at_2048_envs():
    from quadswarm_tpu_torch.runs.pbt_quads_multi_obstacles import PBT_CLI
    c = _config()
    assert c["base_flags"] == re.findall(r"--[a-z_]+=[^ ]+", PBT_CLI)
    text = open(os.path.join(ROOT, RUN_FILE)).read()
    assert c["base_flags"] == re.findall(r'--[a-z_]+=[^ "\n]+', text)
    assert c["added_flags"] == ["--pbt_mix_policies_in_one_env=True",
                                "--num_envs=2048"]
    assert c["reduced"] == []


def test_the_flags_parse_to_the_published_sizes():
    from quadswarm_tpu_torch.training.config import parse_swarm_cfg
    c = _config()
    a = parse_swarm_cfg(c["base_flags"] + c["added_flags"])
    assert (a.num_envs, a.quads_num_agents, a.num_policies) == (2048, 8, 8)
    assert a.with_pbt and a.pbt_mix_policies_in_one_env
    assert (a.rnn_size, a.quads_neighbor_hidden_size,
            a.quads_obst_hidden_size, a.quads_neighbor_visible_num) == (
        256, 256, 256, 6)
    assert a.quads_use_obstacles and a.quads_obstacle_obs_type == "octomap"
    assert (a.rollout, a.replay_buffer_sample_prob) == (128, 0.75)
    assert a.model_dtype == "auto" and a.dtype == "float32"
    assert not a.normalize_input and not a.normalize_returns


def test_benchmark_json_names_only_files_that_exist():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"])), c["file"]
    for w in b["workloads"]:
        with open(os.path.join(BENCH, "traffic",
                               w["traffic"] + ".json")) as f:
            driver = json.load(f)["driver"]
        for path in (("drivers", driver + ".py"),
                     ("limits", w["name"] + ".json")):
            assert os.path.exists(os.path.join(BENCH, *path)), path
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py")), m["name"]


def test_a_sound_run_is_correct():
    out = run_cell("rollout.pbt8", SEED, 0.05, True, device="cpu",
                   overrides=SMALL)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert out["metrics"]["head_rows_per_agent.pbt8"]["value"] == 3


@pytest.mark.parametrize("kind", ["control"] + sorted(FAULTS))
def test_the_control_and_each_fault_are_not_correct(kind):
    if kind == "control":
        out = run_cell("rollout.pbt8", SEED, 0.05, False, device="cpu",
                       overrides=SMALL, control=True)
    else:
        with FAULTS[kind]():
            out = run_cell("rollout.pbt8", SEED, 0.05, False, device="cpu",
                           overrides=SMALL)
    over = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert over and not out["correct"], out["checks"]


# --- the five readers on a synthetic store ---------------------------------

MS = 1_000_000   # ns


def _spans(device=True):
    """Two ticks of 10 ms: the stacked heads 4 ms on the device a tick and
    4 more for the last value, the selection 0.25 ms each, the obstacle
    hits 0.1 and the SDF 0.2 ms a tick, a push 0.5 before the loop and
    after each tick, a redraw 0.05 a tick."""
    from quadswarm_tpu_torch.utils.tracing import Span
    out = []

    def add(name, parent, tick, t0, dev):
        out.append(Span(name, parent, tick, t0, t0 + MS,
                        dev if device else None))
        return len(out) - 1
    add("pbt.coeffs", None, None, 0, 0.5)
    for k in range(2):
        t = (k + 1) * 20 * MS
        i = add("rollout.tick", None, k, t, 9.0)
        j = add("rollout.policy", i, k, t, 4.25)
        add("pbt.heads", j, k, t, 4.0)
        add("pbt.select", j, k, t, 0.25)
        s = add("env.step", i, k, t, 2.0)
        add("env.obstacle_hits", s, k, t, 0.1)
        add("env.obstacle_sdf", s, k, t, 0.2)
        add("pbt.assign", i, k, t, 0.05)
        add("pbt.coeffs", i, k, t, 0.5)
    j = add("rollout.policy", None, None, 80 * MS, 4.25)
    add("pbt.heads", j, None, 80 * MS, 4.0)
    add("pbt.select", j, None, 80 * MS, 0.25)
    return out


COUNTS = {"pbt.head_rows": 8 * 3 * 16, "pbt.agent_rows": 3 * 16}
SPAN_READERS = {
    "stacked_forward_device_ms_per_tick.pbt8": 6.0,
    "obstacle_device_ms_per_tick.pbt8": 0.3,
    "pbt_device_ms_per_tick.pbt8": (0.5 * 3 + 0.25 * 3 + 0.05 * 2) / 2,
}


def _reader(name):
    from portbench.harness import load_module
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "portbench_metric_" + name)


def _rec(traced=True, card=True):
    import types
    return types.SimpleNamespace(
        trace={"ticks": 2} if traced else None,
        card={"peaks": {"fp32_flops_per_s": 67e12}} if card else None,
        window_s=2.0, calls=4,
        flags=dict(quads_obs_repr="xyz_vxyz_R_omega_wall",
                   quads_neighbor_obs_type="pos_vel",
                   quads_neighbor_visible_num=6, rnn_size=256,
                   quads_neighbor_hidden_size=256, quads_use_obstacles=True,
                   quads_obstacle_obs_type="octomap",
                   quads_obst_hidden_size=256, quads_encoder_type="corl",
                   quads_neighbor_encoder_type="attention",
                   quads_sim2real=False, num_policies=8))


def test_every_new_metric_has_its_reader_and_entry():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    new = {m["name"]: m for m in b["per_layer"]
           if m.get("workloads") == ["rollout.pbt8"]}
    assert set(new) == set(SPAN_READERS) | {"head_rows_per_agent.pbt8",
                                            "mfu_pct.pbt8"}
    for m in new.values():
        assert m["moves"] == "rollout_agent_steps_per_s"


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_on_a_synthetic_store(name, monkeypatch):
    from quadswarm_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "spans", _spans)
    assert _reader(name).read(_rec()) == pytest.approx(SPAN_READERS[name])
    assert _reader(name).read(_rec(traced=False)) is None
    monkeypatch.setattr(tracing, "spans", lambda: _spans(device=False))
    assert _reader(name).read(_rec()) is None
    # the parent's program: ticks, but none of the new spans
    monkeypatch.setattr(tracing, "spans", lambda: [
        s for s in _spans() if not s.name.startswith(("pbt.",
                                                      "env.obstacle"))])
    assert _reader(name).read(_rec()) is None


def test_the_counter_readers(monkeypatch):
    from portbench.arith_mixed import served_flops_per_row
    from quadswarm_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "counts", lambda: dict(COUNTS))
    rec = _rec()
    assert _reader("head_rows_per_agent.pbt8").read(rec) == 8.0
    flops = served_flops_per_row(rec.flags) * COUNTS["pbt.agent_rows"]
    assert _reader("mfu_pct.pbt8").read(rec) == pytest.approx(
        100.0 * flops * 4 / 2.0 / 67e12)
    assert _reader("mfu_pct.pbt8").read(_rec(card=False)) is None
    for name in ("head_rows_per_agent.pbt8", "mfu_pct.pbt8"):
        assert _reader(name).read(_rec(traced=False)) is None
        monkeypatch.setattr(tracing, "counts", dict)
        assert _reader(name).read(rec) is None
        # the parent's program: no counters at all
        monkeypatch.delattr(tracing, "counts")
        assert _reader(name).read(rec) is None
        monkeypatch.setattr(tracing, "counts", lambda: dict(COUNTS),
                            raising=False)
