#!/bin/bash
# Traced runs (--trace 1) of one cell on this machine's card, one a seed.
#   bash portbench/tools/traced.sh <workload> <seconds> <seed> [<seed> ...]
# Output goes under $PORTBENCH_OUT (portbench_out/ if unset).
set -u
w=$1; secs=$2; shift 2
out=${PORTBENCH_OUT:-portbench_out}/traced/$w
mkdir -p "$out"
for s in "$@"; do
  t0=$SECONDS
  python3 portbench/run.py --workload "$w" --seed "$s" --seconds "$secs" \
    --trace 1 > "$out/$s.out" 2> "$out/$s.err"
  echo "traced $w $s rc=$? wall $((SECONDS - t0)) s"
  tail -n 1 "$out/$s.out" | head -c 1500; echo
done
