#!/bin/bash
# Runs of this study on one card, from the root of a checkout:
#
#     [CHANGE=<checkout>] studies/epoch_rows/check.sh <out dir> <plan> \
#         [tests] [smoke]
#
# the card and the software; with "tests" the card-only tests of the
# epoch's index rows; the plan's runs (studies/tracing/runs.sh: the
# change in $CHANGE, by default this checkout, the parent in $PARENT, by
# default build/parent); with "smoke" then the whole of chip_smoke.py.
# Each checkout is made with git archive.
OUT=$1
PLAN=$2
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
CHANGE=${CHANGE:-.}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' | tee -a "$OUT/card.txt"
if [[ " $* " == *" tests "* ]]; then
  t0=$(date +%s)
  (cd "$CHANGE" && python3 -m pytest --noconftest -m cuda tests/test_torch_epoch_rows.py -q -p no:cacheprovider) > "$OUT/card_tests.txt" 2>&1
  echo "card tests rc=$? $(( $(date +%s) - t0 ))s"
  tail -n 3 "$OUT/card_tests.txt"
fi
CHANGE=$CHANGE studies/tracing/runs.sh "$OUT" "$PLAN"
if [[ " $* " == *" smoke "* ]]; then
  t0=$(date +%s)
  (cd "$CHANGE" && timeout 1500 python3 chip_smoke.py) > "$OUT/chip_smoke.log" 2>&1
  echo "chip_smoke rc=$? $(( $(date +%s) - t0 ))s"
  tail -n 5 "$OUT/chip_smoke.log"
fi
