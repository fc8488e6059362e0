#!/usr/bin/env bash
# Time two trees of this repository against each other on one GPU, in turns
# (A, B, B, A), so that drift of the card or the host falls on both alike.
#
#   mkdir -p build/ab/parent build/ab/change
#   git archive <parent-commit> | tar -x -C build/ab/parent
#   git add -A && git archive "$(git write-tree)" | tar -x -C build/ab/change
#   bash scripts/chip_ab.sh build/ab/parent build/ab/change --shift 4
#
# Each run is `python3 chip_smoke.py <args>` from the root of its tree, which
# builds that tree's kernels into its own build/ directory.  The output of
# run i goes to $AB_LOG_DIR/ab_<i>_<name>.log (default build/ab/logs); the
# build, kernel and cell (main, ooc, quant, quant_ooc, fp16) lines are echoed.
set -euo pipefail
a=$1 b=$2
shift 2
out="$(pwd)/${AB_LOG_DIR:-build/ab/logs}"
mkdir -p "$out"
i=0
for tree in "$a" "$b" "$b" "$a"; do
  i=$((i + 1))
  log="$out/ab_${i}_$(basename "$tree").log"
  (cd "$tree" && python3 chip_smoke.py "$@") > "$log" 2>&1
  echo "== run $i: $tree"
  grep -E "^\[(build)\] seconds|case=main_shape|^\[(main|ooc|quant|quant_ooc|fp16)\] (engine|rows_)|power.limit|W$" "$log" || true
done
