#!/bin/bash
# Two trees of the repo on this machine's card, one cell, in turns: a run
# each that builds the kernels, then a pair of --trace 0 runs a seed, the
# parent first in even pairs and the change first in odd ones; then each
# side's medians and spreads (tools/spread.py: set a is the parent, b the
# change) and each pair's change over parent in the cell's throughput.
#   bash portbench/tools/in_turns.sh <parent tree> <change tree> <workload> <seconds> <seed> [<seed> ...]
# A tree is the root of a checkout, e.g. a `git archive` of a commit
# unpacked into an ignored directory.  Output goes under $PORTBENCH_OUT
# (portbench_out/ if unset).
set -u
parent=$(cd "$1" && pwd); change=$(cd "$2" && pwd); w=$3; secs=$4; shift 4
out=$PWD/${PORTBENCH_OUT:-portbench_out}/turns/$w
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # <a|b> <seed> <seconds>
  local dir=$change; [ "$1" = a ] && dir=$parent
  local t0=$SECONDS
  (cd "$dir" && python3 portbench/run.py --workload "$w" --seed "$2" \
    --seconds "$3" --trace 0 > "$out/$1.$2.out" 2> "$out/$1.$2.err")
  echo "$1 seed $2 rc=$? wall $((SECONDS - t0)) s"
}
for side in a b; do run $side 1 1; mv "$out/$side.1.out" "$out/build.$side.out"; done
i=0
for s in "$@"; do
  if [ $((i % 2)) -eq 0 ]; then run a "$s" "$secs"; run b "$s" "$secs"
  else run b "$s" "$secs"; run a "$s" "$secs"; fi
  i=$((i + 1))
done
python3 portbench/tools/spread.py "$out"
python3 - "$out" "$@" <<'PY'
import json, sys
out, seeds = sys.argv[1], sys.argv[2:]
for s in seeds:
    v = {}
    for side in "ab":
        lines = open(f"{out}/{side}.{s}.out").read().strip().splitlines()
        m = json.loads(lines[-1])["metrics"] if lines else {}
        v[side] = {k: x["value"] for k, x in m.items() if k != "setup_s"}
    both = sorted(set(v["a"]) & set(v["b"]))
    print("pair", s, {k: v["b"][k] / v["a"][k] for k in both if v["a"][k]})
PY
