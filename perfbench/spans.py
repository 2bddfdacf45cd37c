"""The program's spans and counters over a run's traced segment, reduced
for the per-layer readers (``metrics/*_per_step.train.py``,
``*_per_pass.eval.py``, ``capture_s.py``).

The segment runs under the profiler, which lengthens the host's time: a
graph launch takes tens of times longer there than unprofiled, so no
reader reads a launch, nor a dispatch's host time, from it. The draws
(a few ops each) and the waits are read; the waits include the resident
index rows' blocking copy (``wait.h2d``).

The program's tracer (``gltvae_torch.trace``) records its spans while a
torch profiler runs, which is its default mode, and keeps the counters at
the ends of each such recording interval. So the traced segment of a
``--trace 1`` run, which ``harness.profiler`` profiles, carries the
program's spans, and the timed window, which runs unprofiled, records
none. The segment is the tracer's last interval: it starts at the first
span after the profiler started and lasts the trace's ``window_ns``, so a
span still open when the profiler stopped counts up to the segment's end.
The graph captures recorded before it, and after the interval before it,
are the run's set-up and warm-up (``capture_s``).

``program(rec)`` is None where the program has no tracer or recorded no
interval, and each reader then returns None.
"""

from __future__ import annotations

from typing import Optional

#: the spans a draw is put down to
DISPATCH, PASS = 'train.dispatch', 'eval.pass'


def program(rec: dict) -> Optional[dict]:
    """The segment's reduction, made once a record: ``steps`` (train) or
    ``passes`` (eval), ``noise_bytes`` drawn in it, ``capture_s`` before
    it, and ``ranks``: for each rank the nanoseconds of its waits and of
    the draws inside train dispatches and inside eval passes."""
    if 'program' not in rec:
        rec['program'] = _reduce(rec)
    return rec['program']


def _reduce(rec: dict) -> Optional[dict]:
    try:
        from gltvae_torch import trace
    except ImportError:         # a program without the tracer
        return None
    traces = rec.get('traces') or []
    ivs = trace.intervals()
    if not traces or not ivs:
        return None
    iv = ivs[-1]
    t0 = iv['start_ns']
    t1 = t0 + traces[-1]['window_ns']
    after = (ivs[-2]['stop_ns'] or 0) if len(ivs) > 1 else 0
    spans = trace.records()
    stop = iv['stop'] or trace.snapshot()
    out = {'steps': traces[-1].get('steps'),
           'passes': traces[-1].get('passes'),
           'noise_bytes': stop['noise_bytes'] - iv['start']['noise_bytes'],
           'capture_s': sum(s['end_ns'] - s['start_ns'] for s in spans
                            if s['name'] == 'graph.capture' and s['end_ns']
                            and after <= s['start_ns']
                            and s['end_ns'] <= t0) / 1e9,
           'ranks': {}}
    for i, s in enumerate(spans):
        ns = min(s['end_ns'] or t1, t1) - max(s['start_ns'], t0)
        if ns <= 0:
            continue
        r = out['ranks'].setdefault(s['rank'], dict.fromkeys(
            ('wait', 'train_draw', 'eval_draw'), 0))
        name = s['name']
        ctx, in_wait = _context(spans, i)
        if name.startswith('wait.') and not in_wait:
            r['wait'] += ns
        elif name == 'host.draw':
            where = {DISPATCH: 'train', PASS: 'eval'}.get(ctx)
            if where:
                r[f'{where}_draw'] += ns
    return out


def _context(spans: list, i: int):
    """(the name of span i's nearest dispatch or pass, whether a wait
    encloses it)."""
    ctx, in_wait, j = None, False, spans[i]['parent']
    while j >= 0:
        name = spans[j]['name']
        in_wait = in_wait or name.startswith('wait.')
        if ctx is None and name in (DISPATCH, PASS):
            ctx = name
        j = spans[j]['parent']
    return ctx, in_wait


def per(rec: dict, kind: str, key: str) -> Optional[float]:
    """In a record of `kind` ('train' or 'eval'), the largest over the
    ranks of their `key` milliseconds over the segment's train steps or
    test passes."""
    p = program(rec) if rec['kind'] == kind else None
    over = p and p['steps' if kind == 'train' else 'passes']
    if not over or not p['ranks']:
        return None
    return max(r[key] for r in p['ranks'].values()) / 1e6 / over
