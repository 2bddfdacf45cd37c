"""Parent against change over a directory of runs (``<tag>.out`` as
``studies/tracing/runs.sh`` keeps them, tags ``<cell>_<P|C>_<k>`` for the
two sides of pair k):

    python studies/epoch_rows/pairs.py <out dir>

For each cell and end-to-end metric: each pair's values and the change's
ratio to the parent, the pairs the change wins (by the metric's
direction), each side's median, and each side's spread (the distance
between the first and third quartiles of ``statistics.quantiles(n=4)``
over the median).
"""
import glob
import json
import os
import statistics
import sys

HIGHER = {'train_img_per_s', 'eval_img_per_s'}


def higher(m):
    return m in HIGHER or 'mfu' in m or 'roofline' in m


def result(path):
    lines = [l for l in open(path).read().splitlines() if l.startswith('{')]
    return json.loads(lines[-1]) if lines else None


def spread(v):
    if len(v) < 2 or not statistics.median(v):
        return float('nan')
    q1, _, q3 = statistics.quantiles(v, n=4)
    return (q3 - q1) / statistics.median(v)


runs = {}
for f in sorted(glob.glob(os.path.join(sys.argv[1], '*.out'))):
    tag = os.path.basename(f)[:-4]
    cell, side, k = tag.rsplit('_', 2)
    if side not in ('P', 'C'):
        continue
    r = result(f)
    if r is None:
        print(tag, 'NO RESULT')
        continue
    if not r['correct']:
        print(tag, 'NOT CORRECT')
    runs.setdefault(cell, {}).setdefault(k, {})[side] = r
for cell, pairs in runs.items():
    keys = sorted({m for p in pairs.values() for r in p.values()
                   for m in r['metrics']})
    for m in keys:
        p_v, c_v, n = [], [], 0
        for k in sorted(pairs, key=int):
            p, c = pairs[k].get('P'), pairs[k].get('C')
            if not p or not c or m not in p['metrics'] or m not in c['metrics']:
                continue
            a, b = p['metrics'][m]['value'], c['metrics'][m]['value']
            p_v.append(a)
            c_v.append(b)
            n += 1
            better = b > a if higher(m) else b < a
            print(f'{cell} {m} pair {k}: parent {a} change {b} '
                  f'ratio {b / a:.5f} {"win" if better else "loss"}')
        if not n:
            continue
        better = [(b > a) if higher(m) else (b < a)
                  for a, b in zip(p_v, c_v)]
        print(f'{cell} {m}: change better in {sum(better)} of {n}; median '
              f'parent {statistics.median(p_v)} change '
              f'{statistics.median(c_v)} ratio '
              f'{statistics.median(c_v) / statistics.median(p_v):.5f}; '
              f'spread parent {spread(p_v):.5f} change {spread(c_v):.5f}')
