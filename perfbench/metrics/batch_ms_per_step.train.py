"""The host loader's gathers in the traced train segment: the
``train.batch`` spans inside train dispatches (a streamed dispatch's
rows taken from the host splits), clipped to the segment as
``spans.program`` clips, over its train steps; the largest over the
ranks. Nothing where the program has no tracer, the run traced no
segment, or no dispatch took its batch from the host (a resident epoch
draws its rows once, before its dispatches)."""

import spans


def read(rec):
    if rec['kind'] != 'train' or not rec['traces']:
        return None
    try:
        from gltvae_torch import trace
    except ImportError:         # a program without the tracer
        return None
    ivs, steps = trace.intervals(), rec['traces'][-1].get('steps')
    if not ivs or not steps:
        return None
    t0 = ivs[-1]['start_ns']
    t1 = t0 + rec['traces'][-1]['window_ns']
    recs, ranks = trace.records(), {}
    for i, s in enumerate(recs):
        if s['name'] != 'train.batch':
            continue
        ns = min(s['end_ns'] or t1, t1) - max(s['start_ns'], t0)
        if ns > 0 and spans._context(recs, i)[0] == spans.DISPATCH:
            ranks[s['rank']] = ranks.get(s['rank'], 0) + ns
    return max(ranks.values()) / 1e6 / steps if ranks else None
