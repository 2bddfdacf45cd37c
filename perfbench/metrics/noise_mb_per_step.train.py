"""Megabytes (10**6 B) of variates the host parts drew in the traced
train segment (the program's ``noise_bytes`` counter at the segment's
ends) over its train steps. Nothing where the program has no tracer
(``spans.program``)."""

import spans


def read(rec):
    p = spans.program(rec) if rec['kind'] == 'train' else None
    if not p or not p['steps']:
        return None
    return p['noise_bytes'] / 1e6 / p['steps']
