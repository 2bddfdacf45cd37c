"""The parked cell c64bf16.dp4 run as perfbench's mesh driver runs it
(--trace 1), each rank with the program's tracer on for the whole run,
its spans written per rank and reduced: which span of which rank runs
late.

    python studies/tracing/dp4_spans.py <out dir> <seed> [<seed> ...]

from the root of a checkout on a host with four CUDA devices (``--cpu``
among the seeds: gloo ranks on the CPU at small sizes, a rehearsal).
"""
import gzip
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.getcwd()
sys.path[:0] = [os.path.join(ROOT, 'perfbench'), ROOT]
CELL, WORLD, SECONDS = 'c64bf16.dp4', 4, 20
#: a CPU rehearsal (--cpu): gloo ranks at small sizes
CPU = []
HOST = ('train.batch', 'train.h2d', 'host.draw', 'host.fill',
        'graph.replay', 'graph.outputs', 'train.log', 'wait.nan_check',
        'wait.flush', 'wait.barrier')


def rank(argv):
    from gltvae_torch import trace
    import harness as H
    import run
    from drivers.mesh_train_epochs import rank_main
    args = run.parse(argv[:-1])
    trace.set_mode('on')
    sizes = json.loads(args.sizes) if args.sizes else None
    rank_main(args, H.load_cell(args.workload, sizes))
    trace.set_mode('auto')
    with open(argv[-1], 'w') as f:
        json.dump({'rank': args.rank, 'spans': trace.records(),
                   'dropped': trace.dropped()}, f)


def one(out, seed, keep):
    from drivers.mesh_train_epochs import free_port
    port = free_port()
    env = dict(os.environ)
    env.setdefault('OMP_NUM_THREADS', '1')
    procs, files = [], []
    t0 = time.time()
    for r in range(WORLD):
        rec = os.path.join(out, f's{seed}_rank{r}.rec.json')
        spans = os.path.join(out, f's{seed}_rank{r}.spans.json')
        log = open(os.path.join(out, f's{seed}_rank{r}.log'), 'w')
        argv = [sys.executable, __file__, '--rank-entry', '--workload', CELL,
                '--seed', str(seed % 2**32), '--seconds', str(SECONDS),
                '--trace',
                '1', '--rank', str(r), '--world', str(WORLD), '--port',
                str(port), '--t0', repr(t0), '--rank-out', rec] + CPU + [spans]
        procs.append(subprocess.Popen(argv, stdout=log,
                                      stderr=subprocess.STDOUT, env=env))
        files.append((rec, spans, log))
    for p in procs:
        p.wait(timeout=600)
    for _, _, log in files:
        log.close()
    if any(p.returncode for p in procs):
        print(f'seed {seed}: ranks exited {[p.returncode for p in procs]}')
        return None
    recs = [json.load(open(f[0])) for f in files]
    ranks = [json.load(open(f[1])) for f in files]
    summary = reduce(ranks)
    summary['seed'] = seed
    summary['e2e'] = recs[0]['e2e']
    summary['device'] = [{k: r['trace'][k] for k in ('busy_ns', 'window_ns',
                                                     'nccl_ns', 'h2d_ns',
                                                     'steps')}
                         for r in recs]
    summary['idle_gaps'] = [r['trace']['idle_gaps'] for r in recs]
    if keep:
        for (_, spans, _), r in zip(files, ranks):
            with gzip.open(spans + '.gz', 'wt') as f:
                json.dump(r, f)
    for _, spans, _ in files:
        os.remove(spans)
    return summary


def reduce(ranks):
    """Per rank, each host span's ms a step over the steady dispatches
    (the first epoch and the traced last one left out); per step, the rank
    whose graph launch starts last, by how much, and the span of that
    rank that ran longest over the others' median at that step."""
    per_rank, starts, parts = [], [], []
    for rk in ranks:
        sp = rk['spans']
        disp = {s['request']: i for i, s in enumerate(sp)
                if s['name'] == 'train.dispatch'}
        epochs = [i for i, s in enumerate(sp) if s['name'] == 'train.epoch']
        keep = {k for k, i in disp.items()
                if sp[i]['parent'] not in (epochs[0], epochs[-1])}
        kids = {}
        for s in sp:
            if s['parent'] >= 0 and sp[s['parent']]['name'] == \
                    'train.dispatch' and s['request'] in keep:
                kids.setdefault(s['request'], {}).setdefault(s['name'], [0, 0])
                d = kids[s['request']][s['name']]
                d[0] += s['end_ns'] - s['start_ns']
                d[1] = d[1] or s['start_ns']
        part = {k: {n: v[0] for n, v in kids.get(k, {}).items()} for k in keep}
        for k in keep:
            s = sp[disp[k]]
            part[k]['train.dispatch'] = s['end_ns'] - s['start_ns']
        start = {k: kids.get(k, {}).get('graph.replay', [0, 0])[1]
                 for k in keep}
        parts.append(part)
        starts.append(start)
        names = ('train.dispatch',) + HOST
        per_rank.append({n: statistics.fmean(part[k].get(n, 0) for k in keep)
                         / 1e6 for n in names})
        per_rank[-1]['steps'] = len(keep)
        per_rank[-1]['dropped'] = rk['dropped']
    common = sorted(set.intersection(*(set(s) for s in starts)))
    late = {}
    for k in common:
        t = [s[k] for s in starts]
        r = max(range(len(t)), key=t.__getitem__)
        lag = t[r] - sorted(t)[-2]
        excess = {n: parts[r][k].get(n, 0) - statistics.median(
            p[k].get(n, 0) for i, p in enumerate(parts) if i != r)
            for n in HOST if n != 'graph.replay'}
        n = max(excess, key=excess.get)
        e = late.setdefault(f'rank {r} {n}', [0, 0.0, 0.0])
        e[0] += 1
        e[1] += lag / 1e6
        e[2] += excess[n] / 1e6
    return {'per_rank_ms_a_step': per_rank, 'steps_compared': len(common),
            'late': {k: {'steps': v[0], 'lag_ms_mean': v[1] / v[0],
                         'excess_ms_mean': v[2] / v[0]}
                     for k, v in sorted(late.items(),
                                        key=lambda kv: -kv[1][0])}}


if __name__ == '__main__':
    if sys.argv[1] == '--rank-entry':
        rank(sys.argv[2:])
        sys.exit(0)
    out = sys.argv[1]
    os.makedirs(out, exist_ok=True)
    seeds = sys.argv[2:]
    if '--cpu' in seeds:
        seeds.remove('--cpu')
        SECONDS = 2
        CPU[:] = ['--device', 'cpu', '--sizes', json.dumps(
            {'n_train': 320, 'n_valid': 64, 'n_test': 24, 'batch_size': 32,
             'compute_dtype': 'float32', 'trace': {'skip': 0, 'count': None}})]
    for i, seed in enumerate(int(s) for s in seeds):
        res = one(out, seed, keep=i == 0)
        print(json.dumps(res, indent=1), flush=True)
        if res:
            with open(os.path.join(out, f's{seed}.summary.json'), 'w') as f:
                json.dump(res, f, indent=1)
