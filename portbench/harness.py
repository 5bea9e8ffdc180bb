"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line.

Everything that belongs to one cell is found by name: the workload's entry
in BENCHMARK.json names a configuration (`configs/<name>.json`) and a
traffic mix (`traffic/<name>.json`); the traffic names its driver
(`drivers/<driver>.py`); the limits of the numbers compared are in
`limits/<workload>.json`; each per-layer metric is read by
`metrics/<metric>.py`.  The program is `quadswarm_tpu_torch`, built through
its CLI's own functions from the configuration's flags.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "quadswarm_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, limits
    and metric entries."""

    def __init__(self, workload: str, bench: dict | None = None):
        bench = bench or load_json(ROOT, "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.entry = entries[workload]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(ROOT, conf["file"])
        self.traffic = load_json(HERE, "traffic",
                                 self.entry["traffic"] + ".json")
        self.limits = load_json(HERE, "limits", workload + ".json")

        def applies(m):
            return workload in m.get("workloads", [workload])
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    def flags(self) -> list:
        return list(self.config["base_flags"]) + list(
            self.config["added_flags"])


def sub_seeds(seed: int, count: int) -> list:
    """`count` independent 63-bit seeds drawn from the run's seed."""
    state = np.random.SeedSequence(int(seed)).generate_state(count, np.uint64)
    return [int(s) >> 1 for s in state]


def make_weights(shapes: dict, initial_stddev: float, seed: int,
                 device) -> dict:
    """Actor-critic weights from one draw on the device: a matrix uniform in
    +-sqrt(6 / (fan_in + fan_out)) (xavier), biases and LayerNorm shifts 0,
    LayerNorm scales 1, the log std log(initial_stddev)."""
    gen = torch.Generator(device).manual_seed(seed)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    total = sum(int(np.prod(s)) for s in mats.values())
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    w, at = {}, 0
    for k, s in shapes.items():
        if k in mats:
            n = int(np.prod(s))
            bound = float(np.sqrt(6.0 / (s[0] + s[1])))
            w[k] = (flat[at:at + n] * bound).reshape(s)
            at += n
        elif k.endswith("log_std"):
            w[k] = torch.full(s, float(np.log(initial_stddev)), device=device)
        elif k.endswith("layer_norm.weight"):
            w[k] = torch.ones(s, device=device)
        else:
            w[k] = torch.zeros(s, device=device)
    return w


class Record:
    """What a run observed: the traced call's device summary and the
    window's totals.  Per-layer metric readers read it."""

    def __init__(self, cell: Cell, flags: dict, card: dict | None):
        self.cell = cell
        self.flags = flags
        self.card = card
        self.trace = None
        self.window_s = 0.0
        self.calls = 0
        self.agent_steps = 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_info(device) -> dict | None:
    if torch.device(device).type != "cuda":
        return None
    from portbench.arith import peaks
    kind = torch.cuda.get_device_name()
    return {"kind": kind, "peaks": peaks(kind)}


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             overrides: list | None = None, control: bool = False,
             bench: dict | None = None) -> dict:
    """Runs the cell once and returns the result line as a dict.

    overrides: flags appended after the configuration's (the CPU tests'
    small sizes; both sides read them).  control: the program in the
    precision below the configuration's (TF32 products, a bfloat16 env),
    for setting the limits; never in a benchmark run."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(workload, bench)
    from portbench.program import reference_flags
    card = card_info(device)
    rec = Record(cell, reference_flags(cell, overrides), card)
    driver = load_module(os.path.join(
        HERE, "drivers", cell.traffic["driver"] + ".py"),
        "portbench_driver_" + cell.traffic["driver"])
    seeds = sub_seeds(seed, 4)
    run = driver.Run(cell, seeds, device, rec, control=control,
                     overrides=overrides)
    run.setup()
    _sync(device)
    if torch.device(device).type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # The window: whole calls, until `seconds` have passed and the call the
    # check samples has run.  The memory peak is read before that call, whose
    # record for the check stays on the device.
    on_card = torch.device(device).type == "cuda"
    window_peak = 0
    t0 = time.perf_counter()
    while True:
        if on_card and rec.calls == run.record_from:
            window_peak = torch.cuda.max_memory_allocated()
        run.call(rec.calls)
        _sync(device)
        rec.calls += 1
        if (time.perf_counter() - t0 >= seconds
                and rec.calls > run.min_calls):
            break
    rec.window_s = time.perf_counter() - t0

    if trace:
        from portbench.trace import traced
        rec.trace = traced(run.traced_call, device)
        _sync(device)

    memory_peak = max(window_peak, setup_peak) if card else 0
    run.release()
    t_check = time.perf_counter()
    checks = run.check()
    check_s = time.perf_counter() - t_check
    # every number the cell's limits name is compared; one the check did
    # not produce fails
    correct = run.failed == 0
    compared = {}
    for name, entry in cell.limits["numbers"].items():
        value = checks.get(name)
        correct = correct and value is not None and value <= entry["limit"]
        compared[name] = {"value": value, "limit": entry["limit"]}

    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(os.path.join(HERE, "metrics",
                                              m["name"] + ".py"),
                                 "portbench_metric_" + m["name"])
            value = reader.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "setup_s": setup_s,
            "peak_alloc_mib": window_peak / 2 ** 20,
            run.rate_metric: rec.agent_steps / rec.window_s,
        }
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    out = {
        "correct": bool(correct),
        "attempted": rec.calls,
        "failed": run.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if card else torch.device(device).type,
            "kind": card["kind"] if card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace:
        out["device"]["busy_s"] = rec.trace["busy_s"]
        out["device"]["window_s"] = rec.trace["window_s"]
        out["breakdown"] = rec.trace["breakdown"]
    out["details"] = dict(run.details, numbers=checks, check_s=check_s,
                          window_s=rec.window_s)
    out["checks"] = compared
    return out
