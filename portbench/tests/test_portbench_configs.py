"""Each configuration file against the flags of the run it names, and
BENCHMARK.json against the files the harness finds by name."""
import json
import os
import re

import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, HERE)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _run_flags(path):
    text = open(os.path.join(ROOT, path)).read()
    return re.findall(r'--[a-z_]+=[^ "\n]+', text)


def test_swarm128_is_train_sh_at_128_drones():
    c = _config("swarm128-attn")
    assert c["base_flags"] == _run_flags("train.sh")
    assert c["added_flags"] == ["--quads_num_agents=128",
                                "--quads_use_pallas_pairs=true"]
    assert c["reduced"] == []


def test_flags_parse_with_the_cli():
    from quadswarm_tpu_torch.training.config import parse_swarm_cfg
    c = _config("swarm128-attn")
    args = parse_swarm_cfg(c["base_flags"] + c["added_flags"])
    assert args.model_dtype == "auto" and args.dtype == "float32"
    assert (args.num_envs, args.quads_num_agents) == (1024, 128)
    assert args.quads_use_pallas_pairs


def test_every_name_finds_its_files():
    b = _bench()
    assert b["paths"] == ["portbench"]
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert _config(c["name"])["name"] == c["name"]
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        traffic = json.load(open(os.path.join(
            BENCH, "traffic", w["traffic"] + ".json")))
        assert os.path.exists(os.path.join(
            BENCH, "drivers", traffic["driver"] + ".py"))
        limits = json.load(open(os.path.join(
            BENCH, "limits", w["name"] + ".json")))
        assert limits["numbers"]
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
