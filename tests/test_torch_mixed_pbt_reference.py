"""The benchmark cell `rollout.pbt8` (the 8-policy PBT obstacle run, its
policies mixed per agent) at a small size on the CPU: 4 envs x 8 drones,
3 policies, 4 ticks, the widths as published.

- the port's `mixed_rollout`, built and called as
  `portbench/drivers/mixed_rollout.py` does, against the plain reference
  (`portbench/reference/mixed.py`: each row under its own unstacked
  policy, the frozen env with each agent's own coefficients, the
  assignment by its invariants), with the obstacles and per-agent
  coefficients on: within the cell's limits;
- every agent routed to the next policy's head fails `value_gap`;
- the assignment's invariants count what breaks them;
- the stacked heads compute P rows for each row they serve while one
  GEMM tile holds every row (`pbt.head_rows` / `pbt.agent_rows`); at 32
  envs and 8 policies each head runs on its own group of a tile, and the
  cell stays correct; the mixture's arithmetic
  (`portbench/arith_mixed.py`) equals a hooked count of the reference's
  cat-form actor-critic;
- the new spans and counters record under a profiler and not outside
  one, and the obstacle spans open only with obstacles.
Imports no JAX."""
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import arith_mixed, program  # noqa: E402
from portbench.harness import Cell, run_cell  # noqa: E402
from portbench.reference import config as rconf  # noqa: E402
from portbench.reference import mixed as rmixed  # noqa: E402
from portbench.reference.qs.models.encoders import Dense  # noqa: E402
from quadswarm_tpu_torch.env import multi  # noqa: E402
from quadswarm_tpu_torch.env.params import make_dynamics_params  # noqa: E402
from quadswarm_tpu_torch.parallel import pbt_mixed  # noqa: E402
from quadswarm_tpu_torch.parallel.pbt_mixed import (  # noqa: E402
    StackedPolicies, _coeff_table, mixed_rollout,
)
from quadswarm_tpu_torch.training.config import (  # noqa: E402
    env_config_from_args, model_from_args, parse_swarm_cfg,
    ppo_config_from_args,
)
from quadswarm_tpu_torch.utils import tracing  # noqa: E402

CELL = "rollout.pbt8"
P = 3
SMALL = ["--num_envs=4", f"--num_policies={P}", "--rollout=4",
         "--batch_size=128"]
SEED = 2 ** 31 + 12345
MIXED_SPANS = ("pbt.heads", "pbt.select", "pbt.coeffs", "pbt.assign")
OBSTACLE_SPANS = ("env.obstacle_hits", "env.obstacle_sdf")


def _clear_store():
    tracing._STORE.new_stretch()
    tracing._STORE.on = False


@pytest.fixture(scope="module")
def sound():
    """One run of the cell at the small size, its traced call under the
    CPU profiler."""
    _clear_store()
    return run_cell(CELL, SEED, 0.05, True, device="cpu", overrides=SMALL)


def test_the_mixed_rollout_matches_the_plain_reference(sound):
    limits = Cell(CELL).limits["numbers"]
    assert set(sound["checks"]) == set(limits)
    for name, c in sound["checks"].items():
        assert c["value"] is not None and c["value"] <= c["limit"], name
    assert sound["correct"] and sound["failed"] == 0
    # the obstacles, the per-agent coefficients and P policies are on
    flags = program.reference_flags(Cell(CELL), SMALL)
    assert flags["quads_use_obstacles"] and flags["num_policies"] == P
    coeffs = sound["details"]["coeffs"]
    assert len({c["quadcol_bin"] for c in coeffs}) == P
    assert sound["details"]["agent_steps_compared"] == 4 * 4 * 8


def test_the_stacked_heads_compute_p_rows_a_row_served(sound):
    assert sound["metrics"]["head_rows_per_agent.pbt8"]["value"] == P
    rows = tracing.counts()
    assert rows["pbt.head_rows"] == P * rows["pbt.agent_rows"]
    # every tick's forward and the last value's: (T + 1) E N rows served
    assert rows["pbt.agent_rows"] == 5 * 4 * 8


def test_routing_engages_in_the_cells_own_path():
    """256 rows in 8 groups near 32: each head computes one tile of 128
    rows, 8 x 128 / 256 = 4 a row served."""
    _clear_store()
    out = run_cell(CELL, SEED, 0.05, True, device="cpu", overrides=[
        "--num_envs=32", "--num_policies=8", "--rollout=4",
        "--batch_size=128"])
    assert out["correct"], out["checks"]
    assert out["metrics"]["head_rows_per_agent.pbt8"]["value"] == 4.0


def test_every_agent_under_the_next_head_fails_value_gap(monkeypatch):
    """Each row grouped under the next policy's head, so computed by it
    (the rollout selects from the groups, not with `select_policy`)."""
    group = pbt_mixed.group_rows
    monkeypatch.setattr(pbt_mixed, "group_rows",
                        lambda a, p: group((a + 1) % p, p))
    out = run_cell(CELL, SEED, 0.05, False, device="cpu", overrides=SMALL)
    gap = out["checks"]["value_gap"]
    assert gap["value"] > gap["limit"] and not out["correct"]


@pytest.mark.parametrize("case,expected", [
    ("sound", 0),            # a redraw after an episode end is allowed
    ("changed", 1),          # one agent's policy changed mid-episode
    ("out_of_range", 5),     # one agent holds P throughout
    ("final_changed", 1),    # the assignment after the call moved
])
def test_assignment_invariants_count_what_breaks_them(case, expected):
    t_dim, e, n = 3, 2, 2
    assign = torch.tensor([[[0, 1], [2, 2]]] * t_dim)
    done = torch.zeros((t_dim, e, n), dtype=torch.bool)
    done[1, 0] = True                       # env 0 ends on tick 1
    assign[2, 0] = torch.tensor([2, 0])     # and draws new policies
    start, final = assign[0].clone(), assign[-1].clone()
    if case == "changed":
        assign[2, 1, 0] = 1
        final[1, 0] = 1
    elif case == "out_of_range":
        assign[:, 1, 1] = P
        start[1, 1] = final[1, 1] = P
    elif case == "final_changed":
        final[1, 1] = 0
    assert rmixed.assignment_mismatches(assign, done, start, final,
                                        P) == expected


def test_the_mixtures_arithmetic_is_the_cat_form_count():
    cell = Cell(CELL)
    flags = program.reference_flags(cell, SMALL)
    built = program.Built(program.program_args(cell, SMALL, "cpu", False),
                          "cpu")
    model = rconf.model(flags, rconf.env_config(flags), built.weights(SEED),
                        "cpu")
    total = [0]

    def hook(mod, inp, out):
        rows = inp[0].numel() // inp[0].shape[-1]
        total[0] += 2 * rows * mod.in_features * mod.out_features
    for m in model.modules():
        if isinstance(m, Dense):
            m.register_forward_hook(hook)
    rows = 5
    with torch.no_grad():
        model(torch.randn(rows, built.env_cfg.obs_dim))
    assert total[0] % rows == 0
    assert arith_mixed.served_flops_per_row(flags) == total[0] // rows


def _small_mixed(use_obstacles=True):
    """The cell's flags at 2 envs x 4 drones, 2 policies 16 wide, 2 ticks."""
    cell = Cell(CELL)
    args = parse_swarm_cfg(cell.flags() + [
        "--num_envs=2", "--quads_num_agents=4", "--num_policies=2",
        "--rollout=2", "--rnn_size=16", "--quads_neighbor_hidden_size=16",
        "--quads_obst_hidden_size=16", "--quads_neighbor_visible_num=2",
        "--replay_buffer_sample_prob=0", "--device=cpu"]
        + ([] if use_obstacles else ["--quads_use_obstacles=False",
                                     "--quads_obstacle_obs_type=none"]))
    env_cfg = env_config_from_args(args)
    dyn = make_dynamics_params(dt=env_cfg.dt)
    torch.manual_seed(SEED)
    heads = StackedPolicies([model_from_args(args, env_cfg, device="cpu")
                             for _ in range(2)])
    gen = torch.Generator("cpu").manual_seed(SEED)
    states, obs = multi.env_reset(env_cfg, dyn, gen, 2, device="cpu")
    assignment = torch.randint(0, 2, (2, 4), generator=gen)
    table = _coeff_table({}, 2, env_cfg.dtype, "cpu")

    def call():
        return mixed_rollout(env_cfg, dyn, heads, ppo_config_from_args(args),
                             states, obs, assignment, table, gen)
    return call


def test_spans_and_counters_record_only_under_a_profiler():
    call = _small_mixed()
    _clear_store()
    call()
    assert tracing.spans() == [] and tracing.counts() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    names = {s.name for s in tracing.spans()}
    assert set(MIXED_SPANS + OBSTACLE_SPANS) <= names
    # 3 forwards (2 ticks and the last value) of 2 envs x 4 agents
    assert tracing.counts() == {"pbt.head_rows": 2 * 3 * 8,
                                "pbt.agent_rows": 3 * 8}
    _clear_store()
    tracing.count("pbt.agent_rows", 8)
    assert tracing.counts() == {}


@pytest.mark.parametrize("use_obstacles", [True, False])
def test_obstacle_spans_open_only_with_obstacles(use_obstacles,
                                                 monkeypatch):
    entered = []
    real = multi.span

    def watched(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(multi, "span", watched)
    _small_mixed(use_obstacles)()
    found = set(entered) & set(OBSTACLE_SPANS)
    assert found == (set(OBSTACLE_SPANS) if use_obstacles else set())
