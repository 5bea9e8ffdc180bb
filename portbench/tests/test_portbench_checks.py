"""The comparison that decides `correct`, driven through a whole run of each
cell at a small size on the CPU (the harness's look for a card skipped):
a sound run is correct; the control, the program in the precision below
the configuration's, is not; nor is a run whose timed path is broken
underneath by each fault the cell can have.  On the CPU the program takes
its kernels' plain versions, so a sound run reads 0 or rounding on every
number.  The control at the cells' own sizes on the card is
`calibrate.py`'s; `test_control_on_the_card` repeats it at a small size."""
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

from small import SEED, SMALL  # noqa: E402

from portbench.faults import FAULTS  # noqa: E402
from portbench.harness import run_cell  # noqa: E402

CELLS = sorted(SMALL)


def _run(workload, device="cpu", **kw):
    return run_cell(workload, SEED, 0.05, False, device=device,
                    overrides=SMALL[workload], **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    out = _run(workload, control=True)
    assert not out["correct"]
    over = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert over


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_rollout_is_not_correct(workload, fault):
    with FAULTS[fault]():
        out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
def test_control_on_the_card():
    """The control fails on the card too (TF32 products and a bfloat16
    env at a small size; the cells' own sizes are calibrate.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload in CELLS:
        assert _run(workload, device="cuda")["correct"]
        assert not _run(workload, device="cuda", control=True)["correct"]
