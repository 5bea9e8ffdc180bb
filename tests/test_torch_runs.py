"""The port's run files and launcher (quadswarm_tpu_torch/runs) against the
JAX package's.

- Every port run file expands to the JAX file's commands with the
  training module swapped, and nothing else changed.
- Every command parses with the port's parser and builds its env config
  and its model on the CPU at the file's own widths, except
  `quad_multi_mix_baseline_attn_8`, whose model build raises the documented
  refusal (the 'attention' encoder type without an obstacle observation).
- The launcher's `dry` backend prints the commands.
"""
from __future__ import annotations

import importlib
import shlex

import pytest
import torch

from quadswarm_tpu_torch.training import config as t_config

RUN_MODULES = [
    "quad_multi_mix_baseline", "quad_multi_mix_baseline_attn_8",
    "single_quad_baseline", "single_quad", "pbt_quads_multi_obstacles",
    "obstacles.quads_multi_obstacles", "obstacles.obst_density_random",
    "obstacles.obst_size_random", "obstacles.obst_domain_random",
    "obstacles.quads_multi_obstacles_nei_encoder_search",
]
REFUSED = {"quad_multi_mix_baseline_attn_8"}
JAX_MODULE = "quadswarm_tpu.training.train"
PORT_MODULE = "quadswarm_tpu_torch.training.train"


def _commands(package: str, name: str) -> list:
    mod = importlib.import_module(f"{package}.runs.{name}")
    return list(mod.RUN_DESCRIPTION.commands("td"))


@pytest.mark.parametrize("name", RUN_MODULES)
def test_run_file_commands_equal_the_jax_files(name):
    jax_cmds = _commands("quadswarm_tpu", name)
    port_cmds = _commands("quadswarm_tpu_torch", name)
    assert jax_cmds and len(port_cmds) == len(jax_cmds)
    for (jn, jc), (pn, pc) in zip(jax_cmds, port_cmds):
        assert pn == jn
        assert JAX_MODULE in jc and PORT_MODULE not in jc
        assert pc == jc.replace(JAX_MODULE, PORT_MODULE)


@pytest.mark.parametrize("name", RUN_MODULES)
def test_run_file_commands_build_on_the_cpu(name):
    """Each distinct model of the file is built once (the commands differ
    by seed and experiment name, and the search grid by its axes)."""
    built = set()
    for _, cmd in _commands("quadswarm_tpu_torch", name):
        words = shlex.split(cmd)
        assert words[:3] == ["python", "-m", PORT_MODULE]
        args = t_config.parse_swarm_cfg(words[3:] + ["--device=cpu"])
        env_cfg = t_config.env_config_from_args(args)
        kwargs = t_config.model_kwargs_from_args(args, env_cfg)
        key = (env_cfg.obs_dim, tuple(sorted(kwargs.items())))
        if key in built:
            continue
        built.add(key)
        if name in REFUSED:
            with pytest.raises(ValueError, match="ZeroDivisionError"):
                t_config.model_from_args(args, env_cfg, device="cpu")
            continue
        model = t_config.model_from_args(args, env_cfg, device="cpu")
        with torch.no_grad():
            mean, _, value = model(torch.zeros(3, env_cfg.obs_dim))
        assert mean.shape == (3, 4) and value.shape == (3,)
        assert t_config.ppo_config_from_args(args).num_envs == args.num_envs
    assert built


def test_launcher_dry_backend_prints_every_command(capsys):
    from quadswarm_tpu_torch.runs.launcher import main
    rc = main(["--run=quadswarm_tpu_torch.runs.obstacles."
               "quads_multi_obstacles_nei_encoder_search", "--backend=dry",
               "--train_dir=td"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "12 experiments" in out
    assert out.count(PORT_MODULE) == 12 and JAX_MODULE not in out
