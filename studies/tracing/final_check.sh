#!/bin/bash
# The final tree's check on one card, from checkouts made with git archive
# ($PARENT: the parent commit, $CHANGE: the final tree):
#
#     PARENT=build/parent CHANGE=build/final \
#         studies/tracing/final_check.sh <out dir>
#
# the card and the software; traced pairs of one seed, parent against
# change (plans/traced_pairs.plan), and one run with the tracer on; the
# seconds a fresh process takes to import torch and the tracer (what
# run_on.py's setup_s leaves out); profile_step's spans under a profiler
# of the device alone; then the whole of chip_smoke.py.
OUT=$1
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
CHANGE=${CHANGE:-.}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' | tee -a "$OUT/card.txt"
studies/tracing/runs.sh "$OUT" studies/tracing/plans/traced_pairs.plan
for i in 1 2; do
  (cd "$CHANGE" && python3 -c 'import time; t = time.perf_counter(); import torch; from gltvae_torch import trace; print(f"import torch and the tracer: {time.perf_counter() - t:.3f} s")')
done | tee "$OUT/import_s.txt"
t0=$(date +%s)
(cd "$CHANGE" && python3 -m gltvae_torch.profile_step --steps 4 --out "$OUT/profile") > "$OUT/profile_step.txt" 2>&1
echo "profile_step rc=$? $(( $(date +%s) - t0 ))s"
grep -a ' span ' "$OUT/profile_step.txt"
rm -f "$OUT"/profile/*_trace.json
t0=$(date +%s)
(cd "$CHANGE" && timeout 1500 python3 chip_smoke.py) > "$OUT/chip_smoke.log" 2>&1
echo "chip_smoke rc=$? $(( $(date +%s) - t0 ))s"
tail -n 5 "$OUT/chip_smoke.log"
