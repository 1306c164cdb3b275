#!/usr/bin/env bash
# Compares two checkouts of the repo on one card in one run: chip_smoke.py
# from the parent, the change, the change again and the parent again (so a
# drift of the card's clock over the run shows as parent1 != parent4), then
# `chip_smoke.py --profile` on the change, then the change's chip_smoke.py
# alone in a directory, where it must fail.
#
#   bash rapidraw_tpu_torch/tools/compare_trees.sh PARENT_DIR CHANGE_DIR OUT_DIR
#
# Each run's output goes to OUT_DIR/<tag>.log and its nvcc/ptxas logs (and
# the profile's chrome traces) to OUT_DIR/<tag>/. The summary printed at the
# end holds each run's exit code, the card's name, power limit and SM clock
# before and after, and the lines to compare: the grade builds' registers and
# spills, the B = 2 config-3 and config-5 grade times, the NR and flare
# builds and phase 13's flare and per-pixel NR lines, probe P2's build and
# its phase-9 lines (`[P2]`: each band's time, the plain version, the conv2d
# yardstick and the bit-for-bit checks), the config-4 and
# config-2 (RAW: phase 11's DNG and RAF, phase 12's vendor files) lines and
# the kernels JSON of the change's first run; a parent older than a phase
# prints none of its lines. Exits non-zero
# if a run that must pass failed, or if the lone script did not fail.
set -u
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
mkdir -p "$3"
out=$(cd "$3" && pwd)
card() { nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader; }

status=0
run() {  # tag, tree, chip_smoke.py arguments
    local tag=$1 tree=$2
    shift 2
    (cd "$tree" && python3 chip_smoke.py --out "$out/$tag" "$@") >"$out/$tag.log" 2>&1
    local rc=$?
    echo "[$tag] rc=$rc"
    [ "$rc" -eq 0 ] || status=1
}

echo "[card] before: $(card)"
run parent1 "$parent"
run change2 "$change"
run change3 "$change"
run parent4 "$parent"
run profile "$change" --profile
mkdir -p "$out/alone"
cp "$change/chip_smoke.py" "$out/alone/"
(cd "$out/alone" && python3 chip_smoke.py) >"$out/alone.txt" 2>&1
rc=$?
echo "[alone] rc=$rc (must be non-zero)"
[ "$rc" -ne 0 ] || status=1
echo "[card] after: $(card)"

for tag in parent1 change2 change3 parent4; do
    grep -E "^\[build\] grade|^\[grade\] B=2 (config3|config5_linear) dither=off" \
        "$out/$tag.log" | sed "s/^/$tag /"
done
for tag in parent1 change2 change3 parent4; do
    grep -E "^\[build\] (nr|flare) |^\[flare\]|^\[nr-dyn\]" "$out/$tag.log" | sed "s/^/$tag /"
done
for tag in parent1 change2 change3 parent4; do
    grep -E "^\[build\] nr_slices|^\[P2\]" "$out/$tag.log" | sed "s/^/$tag /"
done
for tag in parent1 change2 change3 parent4 profile; do
    grep -E "^\[(masks|grade-masks|blur-bands|e2e4|raw|e2e2|vendor)\]|^\[profile\] config[42]|^\[time\] config [42]" \
        "$out/$tag.log" | grep -v "dither=on" | sed "s/^/$tag /"
done
grep -E '^\{"kernels"' "$out/change2.log" >"$out/kernels.json"
tail -n 2 "$out/change2.log"
exit $status
