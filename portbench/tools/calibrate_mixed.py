"""`calibrate.py` with the mixed-policy rollout's faults (`faults_mixed.py`)
beside `faults.py`'s: the readings that `rollout.pbt8`'s limits are set
from, in one process on the card.

    python3 portbench/tools/calibrate_mixed.py --workload rollout.pbt8 \
        --seeds 3 --control 2 --faults next_head,policy0_coeffs,stale_sdf \
        --fault_seeds 2

Takes `calibrate.py`'s arguments and prints what it prints.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    sys.path.insert(0, ROOT)
    from portbench import calibrate, faults, faults_mixed
    faults.FAULTS.update(faults_mixed.FAULTS)
    return calibrate.main()


if __name__ == "__main__":
    sys.exit(main())
