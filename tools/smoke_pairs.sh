#!/bin/bash
# The whole chip_smoke.py of two checkouts in one call, in the order A,
# B, B, A, each from a cold kernel build. Prints each run's exit code, its
# seconds on the host clock and its last two lines; keeps each run's
# output in OUT_DIR/cmp{i}_{name}.log and .err, where name is the
# checkout directory's base name.
#
#   tools/smoke_pairs.sh A_DIR B_DIR OUT_DIR
#
# A_DIR and B_DIR each hold a checkout (for instance `git archive` of two
# trees unpacked under build/). Needs one CUDA card. Exits non-zero when a
# run of B fails.
set -u
a=$(realpath "$1"); b=$(realpath "$2"); out=$(realpath "$3")
mkdir -p "$out"
bad=0
i=0
for dir in "$a" "$b" "$b" "$a"; do
  i=$((i + 1))
  name=$(basename "$dir")
  rm -rf "$dir/build"
  t0=$(date +%s)
  (cd "$dir" && python3 chip_smoke.py > "$out/cmp${i}_$name.log" \
    2> "$out/cmp${i}_$name.err")
  rc=$?
  t1=$(date +%s)
  echo "run $i $name rc=$rc seconds=$((t1 - t0))"
  tail -n 2 "$out/cmp${i}_$name.log" | cut -c1-400
  if [ "$dir" = "$b" ] && [ $rc -ne 0 ]; then bad=1; fi
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $bad
