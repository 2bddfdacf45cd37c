#!/bin/bash
# Runs of perfbench cells, one process each, in the order of a plan:
#
#     studies/tracing/runs.sh <out dir> <plan>
#
# from the root of a checkout. Each line of the plan is
#
#     <tag> <side> <cell> <seed> <seconds> <trace> [on]
#
# (blank lines and lines that start with '#' are skipped). <side> is
# "parent" (the checkout in $PARENT, by default build/parent, made with
# `git archive <parent commit>`) or "change" (the one in $CHANGE, by
# default this one). A run is <side>'s perfbench/run.py, or with "on"
# this checkout's studies/tracing/run_on.py over <side> (the program's
# tracer on for the whole run). Its standard output and errors are kept
# as <out dir>/<tag>.out and .err; a line gives the tag, the exit code
# and the seconds taken.
OUT=$1
PLAN=$2
HERE=$(pwd)
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
grep -v '^\s*\(#\|$\)' "$PLAN" | while read -r tag side cell seed seconds tr on; do
  case $side in
    parent) dir=${PARENT:-build/parent} ;;
    change) dir=${CHANGE:-.} ;;
    *) echo "$tag: unknown side $side"; continue ;;
  esac
  args=(--workload "$cell" --seed "$seed" --seconds "$seconds" --trace "$tr")
  t0=$(date +%s)
  if [ "$on" = on ]; then
    python3 "$HERE/studies/tracing/run_on.py" "$dir" "${args[@]}" \
      > "$OUT/$tag.out" 2> "$OUT/$tag.err" < /dev/null
  else
    (cd "$dir" && python3 perfbench/run.py "${args[@]}") \
      > "$OUT/$tag.out" 2> "$OUT/$tag.err" < /dev/null
  fi
  echo "$tag rc=$? $(( $(date +%s) - t0 ))s"
done
