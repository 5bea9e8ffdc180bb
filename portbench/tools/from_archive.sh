#!/bin/bash
# Runs from a copy of the committed files (`git archive` of the tree,
# unpacked into <tree>) on this machine's card: the first run builds the
# kernels in the copy's own cache, the second finds them built, the third
# is traced; then, in <bare>, which holds only BENCHMARK.json and the
# benchmark's folder, a run has to fail with no result.
#   bash portbench/tools/from_archive.sh <tree> <bare> <workload> <seed> <seed> <seed>
# Output goes under $PORTBENCH_OUT (portbench_out/ if unset).
set -u
tree=$1; bare=$2; w=$3; shift 3
out=$PWD/${PORTBENCH_OUT:-portbench_out}/archive
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
cd "$tree"
i=0
for s in "$@"; do
  i=$((i + 1)); trace=0; [ $i -eq 3 ] && trace=1
  t0=$SECONDS
  python3 portbench/run.py --workload "$w" --seed "$s" --seconds 30 \
    --trace $trace > "$out/$w.$s.out" 2> "$out/$w.$s.err"
  echo "archive $w seed $s trace $trace rc=$? wall $((SECONDS - t0)) s"
  tail -n 7 "$out/$w.$s.err"; tail -n 1 "$out/$w.$s.out" | head -c 1200; echo
done
cd - > /dev/null && cd "$bare"
python3 portbench/run.py --workload "$w" --seed 5 --seconds 5 --trace 0 \
  > "$out/bare.out" 2> "$out/bare.err"
echo "bare rc=$? stdout bytes $(wc -c < "$out/bare.out")"
tail -n 2 "$out/bare.err"
