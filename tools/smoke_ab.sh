#!/bin/sh
# chip_smoke.py in two checkouts on one card, in the order A, B, B, A, so
# that a drift of the host or the card falls on both sides alike.
#
#     sh tools/smoke_ab.sh DIR_A DIR_B [OUT]
#
# DIR_A and DIR_B each hold a whole checkout (e.g. two commits' `git
# archive`s unpacked under build/).  Run n of a side writes its output to
# OUT/<a|b><n>.log and its chiprun_out/chip_smoke.json to OUT/<a|b><n>.json
# (OUT defaults to chiprun_out/smoke_ab).  Every run is made; the exit code
# is nonzero when one of them failed.
set -u
a=$(cd "$1" && pwd) b=$(cd "$2" && pwd)
out=${3:-chiprun_out/smoke_ab}
mkdir -p "$out"
out=$(cd "$out" && pwd)
rc=0
n=0
for side in a b b a; do
    n=$((n + 1))
    if [ "$side" = a ]; then dir=$a; else dir=$b; fi
    rm -f "$dir/chiprun_out/chip_smoke.json"
    start=$(date +%s)
    (cd "$dir" && python3 chip_smoke.py) > "$out/$side$n.log" 2>&1
    code=$?
    echo "$side$n: $dir exit $code in $(( $(date +%s) - start )) s"
    [ "$code" -eq 0 ] || rc=1
    [ -f "$dir/chiprun_out/chip_smoke.json" ] && \
        cp "$dir/chiprun_out/chip_smoke.json" "$out/$side$n.json"
done
exit $rc
