"""What a benchmark run loads: neither JAX nor the JAX package, compared by
whole top-level module names; the reference loads nothing of the program;
without a card the command prints no result."""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def _python(code: str, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, **env})


def test_the_reference_imports_nothing_of_the_program():
    for dirpath, _, files in os.walk(os.path.join(BENCH, "reference")):
        for name in files:
            if name.endswith(".py"):
                text = open(os.path.join(dirpath, name)).read()
                assert "import quadswarm_tpu" not in text
                assert "from quadswarm_tpu" not in text
                assert "import jax" not in text
    out = _python(
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.reference.rollout\n"
        "import portbench.reference.config, portbench.reference.convert\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr
    tops = eval(out.stdout.strip().splitlines()[-1])
    assert not {"quadswarm_tpu_torch", "quadswarm_tpu", "jax",
                "flax"} & set(tops)


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path.insert(0, '.'); sys.path.insert(0, %r)\n"
        "from small import SMALL, SEED\n"
        "from portbench.harness import run_cell, forbidden_modules\n"
        "out = run_cell('rollout.swarm128', SEED, 0.1, False, device='cpu',"
        " overrides=SMALL['rollout.swarm128'])\n"
        "print(out['correct'], forbidden_modules())" % HERE)
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_the_forbidden_names_are_whole_top_level_names():
    from portbench.harness import forbidden_modules
    sys.modules.setdefault("quadswarm_tpu_torch_like", sys)
    try:
        assert "quadswarm_tpu" not in forbidden_modules()
    finally:
        del sys.modules["quadswarm_tpu_torch_like"]


def test_without_a_card_it_exits_without_a_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "rollout.swarm128",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
