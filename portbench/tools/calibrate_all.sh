#!/bin/bash
# The readings behind a cell's limits (calibrate.py, in one process on this
# machine's card): the program's sound runs on <sound> seeds from
# <first_seed> on, the control on 3 and each planted fault of faults.py on
# <faulted> seeds (3 if not given), at the cell's own size.
#   bash portbench/tools/calibrate_all.sh <workload> <first_seed> <sound> [<faulted>]
# Output goes under $PORTBENCH_OUT (portbench_out/ if unset).
set -u
w=$1; first=$2; sound=$3; faulted=${4:-3}
out=${PORTBENCH_OUT:-portbench_out}/cal
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$SECONDS
python3 portbench/calibrate.py --workload "$w" --seeds "$sound" --control 3 \
  --faults env_altered,env_unchanged,policy_value,actions_shifted \
  --fault_seeds "$faulted" --seconds 0 --first_seed "$first" \
  > "$out/$w.jsonl" 2> "$out/$w.err"
echo "calibrate $w rc=$? wall $((SECONDS - t0)) s"
tail -n 1 "$out/$w.jsonl"; tail -n 5 "$out/$w.err"
