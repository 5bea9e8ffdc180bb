#!/bin/bash
# How long one run of rollout.swarm128 takes, from process start, at each
# given --num_envs, with the kernels built by a first run at the cell's own
# size; traced when the size is given as <envs>t.
#   bash portbench/tools/probe_envs.sh <seconds> <envs>[t] [<envs>[t] ...]
# Output goes under $PORTBENCH_OUT (portbench_out/ if unset).
set -u
secs=$1; shift
out=${PORTBENCH_OUT:-portbench_out}/probe_envs
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$SECONDS
python3 portbench/run.py --workload rollout.swarm128 --seed 3900000001 \
  --seconds 1 --trace 0 > "$out/build.out" 2> "$out/build.err"
echo "build run rc=$? wall $((SECONDS - t0)) s"
tail -n 8 "$out/build.err"; tail -c 1500 "$out/build.out"; echo
for arg in "$@"; do
  e=${arg%t}; trace=0; [ "$arg" != "$e" ] && trace=1
  t0=$SECONDS
  python3 portbench/calibrate.py --workload rollout.swarm128 --seeds 1 \
    --control 0 --seconds "$secs" --trace "$trace" \
    --first_seed $((3900000000 + e)) --overrides="--num_envs=$e" \
    > "$out/$arg.jsonl" 2> "$out/$arg.err"
  echo "envs $e trace $trace rc=$? wall $((SECONDS - t0)) s"
  head -c 2500 "$out/$arg.jsonl"; tail -n 5 "$out/$arg.err"
done
