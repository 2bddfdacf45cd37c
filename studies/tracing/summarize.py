"""The result lines of a directory of runs (``<tag>.out``, ``<tag>.err``
as ``runs.sh`` keeps them): each run's metrics, a traced run's idle gaps
and device figures, and per cell and side (tag ``<cell>_<P|C|ON>_<x>``)
the end-to-end metrics and their median:

    python studies/tracing/summarize.py <out dir>
"""
import glob
import json
import os
import statistics
import sys

d = sys.argv[1]
rows = {}
for f in sorted(glob.glob(os.path.join(d, '*.out'))):
    tag = os.path.basename(f)[:-4]
    lines = [l for l in open(f).read().splitlines() if l.startswith('{')]
    if not lines:
        print(tag, 'NO RESULT'); continue
    r = json.loads(lines[-1])
    rows[tag] = r
    m = {k: v['value'] for k, v in r['metrics'].items()}
    print(tag, 'correct', r['correct'], json.dumps(m))
    if 'breakdown' in r:
        print('   idle', r['breakdown']['idle_gaps'])
        print('   busy', r['device'].get('busy_s'), 'window', r['device'].get('window_s'), 'peak', r['device']['memory_peak_bytes'])
    err = open(f[:-4] + '.err').read().splitlines()
    for l in err:
        if 'tracer on' in l or 'nothing to read' in l:
            print('   ', l)
for cell in ('c64.train', 'c64.test'):
    for side in ('P', 'C', 'ON', 'TP', 'TC'):
        runs = [rows[t] for t in rows if t.startswith(f'{cell}_{side}_')]
        for key in sorted({k for r in runs for k in r['metrics']}):
            v = [r['metrics'][key]['value'] for r in runs
                 if key in r['metrics']]
            print(cell, key, side, [round(x, 4) for x in v],
                  'median', round(statistics.median(v), 4))
