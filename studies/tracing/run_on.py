"""perfbench/run.py with the program's tracer on (no profiler) for the
whole run:

    python studies/tracing/run_on.py <checkout> <run.py arguments>

At exit it prints on standard error the spans' ms a dispatch (train) or a
pass (test) over the dispatches after the first epoch, or the passes after
the first. Its ``setup_s`` is not run.py's: this wrapper imports torch and
the tracer before run.py starts its clock, so the import is left out of
it. The timed window, and so the rate and ``step_ms_p95``, are run.py's.
"""
import atexit
import os
import runpy
import sys

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
from gltvae_torch import trace  # noqa: E402

trace.set_mode('on')


def table():
    sp = trace.records()
    print(f'tracer on: {len(sp)} spans, {trace.dropped()} dropped',
          file=sys.stderr)
    epochs = [i for i, s in enumerate(sp) if s['name'] == 'train.epoch']
    tops = [i for i, s in enumerate(sp) if s['name'] == 'train.dispatch'
            and s['parent'] != (epochs[0] if epochs else None)]
    kind = 'dispatch'
    if not tops:
        tops = [i for i, s in enumerate(sp) if s['name'] == 'eval.pass'][1:]
        kind = 'pass'
    top = set(tops)
    sums = {}
    for i, s in enumerate(sp):
        if i in top or s['parent'] in top or (
                s['parent'] >= 0 and sp[s['parent']]['parent'] in top):
            key = 'TOP ' + s['name'] if i in top else s['name']
            sums[key] = sums.get(key, 0) + s['end_ns'] - s['start_ns']
    for k, v in sorted(sums.items(), key=lambda kv: -kv[1]):
        print(f'span ms a {kind} ({len(tops)}): {v / 1e6 / len(tops):.4f} {k}',
              file=sys.stderr)


atexit.register(table)
os.chdir(root)
sys.argv = [os.path.join(root, 'perfbench', 'run.py')] + sys.argv[2:]
runpy.run_path(sys.argv[0], run_name='__main__')
