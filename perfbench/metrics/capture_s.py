"""Seconds the program spent capturing its graphs in the run's set-up
and warm-up (its ``graph.capture`` spans before the traced segment,
warm-up runs included). Nothing where the program has no tracer
(``spans.program``)."""

import spans


def read(rec):
    p = spans.program(rec)
    return None if p is None else p['capture_s']
