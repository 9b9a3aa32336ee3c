#!/usr/bin/env bash
# Compare the port's kernels in two checkouts on one card, in one call.
#
#   bash chip_compare.sh DIR_A DIR_B [LOG_DIR]
#
# Runs this checkout's `chip_smoke.py --only_kernels` against the package
# of DIR_A, DIR_B, DIR_B, DIR_A in turn (the script is copied into a
# directory that is not this checkout, so both sides are measured by the
# same code, and a drift of the card over the call falls on both alike).
# Each run's log goes to LOG_DIR/run<i>.log (default: build/compare/
# beside this script); the card's name and power limit and each run's
# device ms per kernel (per predict batch for K1, per train step for
# K2/K3, from the kernels' JSON line) go to standard output.  Exits
# non-zero if any run fails.
#
# DIR_A is typically the parent commit, unpacked into an ignored
# directory before the call:
#   mkdir -p build/archive/parent
#   git archive HEAD~1 | tar -x -C build/archive/parent
#   bash chip_compare.sh build/archive/parent .
set -euo pipefail
[ $# -eq 2 ] || [ $# -eq 3 ] \
  || { echo "usage: bash chip_compare.sh DIR_A DIR_B [LOG_DIR]" >&2; exit 64; }
here="$(cd "$(dirname "$0")" && pwd)"
out="${3:-$here/build/compare}"
mkdir -p "$out"
out="$(cd "$out" && pwd)"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for dir in "$1" "$2" "$2" "$1"; do
  i=$((i + 1))
  dir="$(cd "$dir" && pwd)"
  [ "$dir" = "$here" ] || cp "$here/chip_smoke.py" "$dir/chip_smoke.py"
  log="$out/run$i.log"
  (cd "$dir" && python3 chip_smoke.py --only_kernels) > "$log" 2>&1 \
    || { echo "run $i in $dir failed; see $log" >&2; tail -n 20 "$log" >&2; exit 1; }
  python3 - "$i" "$dir" "$log" <<'EOF'
import json
import sys

run, where, log = sys.argv[1:]
line = next(l for l in reversed(open(log).read().splitlines())
            if l.startswith('{"kernels"'))
# each kernel's second batch size: (record key, time key, label)
other = {"code_conv1d": ("at_b256", "ms", "B=256"),
         "code_conv_pool_fwd": ("at_b2048", "k2_ms", "B=2048"),
         "code_conv_pool_bwd": ("at_b2048", "k3_ms", "B=2048")}
for k in json.loads(line)["kernels"]:
    rec, key, label = other.get(k["name"], ("", "", "-"))
    print(f"run {run} {where}: {k['name']} ms {k['ms']!r}, at {label} "
          f"{k.get(rec, {}).get(key)!r}; bound {k['bound_ms']!r}; "
          f"max_abs_err {k['max_abs_err']!r}")
EOF
done
