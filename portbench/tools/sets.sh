#!/bin/bash
# Two sets of runs of one cell on this machine's card, the same seeds in
# both, after one run that builds the kernels; then each metric's median
# and spread per set (tools/spread.py).
#   bash portbench/tools/sets.sh <workload> <seconds> <seed> [<seed> ...]
# Output goes under $PORTBENCH_OUT (portbench_out/ if unset).
set -u
w=$1; secs=$2; shift 2
out=${PORTBENCH_OUT:-portbench_out}/sets/$w
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 portbench/run.py --workload "$w" --seed 1 --seconds 1 --trace 0 > "$out/build.out" 2> "$out/build.err"
echo "build run rc=$?"
for set in a b; do
  for s in "$@"; do
    t0=$SECONDS
    python3 portbench/run.py --workload "$w" --seed "$s" --seconds "$secs" --trace 0 > "$out/$set.$s.out" 2> "$out/$set.$s.err"
    echo "set $set seed $s rc=$? wall $((SECONDS - t0)) s"
  done
done
python3 portbench/tools/spread.py "$out"
