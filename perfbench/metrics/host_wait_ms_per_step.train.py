"""The host's time blocked on the device or on other ranks in the traced
train segment (its ``wait.*`` spans: the resident index rows' blocking
copy, NaN checks, log flushes, barriers) over its train steps; the
largest over the ranks. Nothing where the program has no tracer
(``spans.program``)."""

import spans


def read(rec):
    return spans.per(rec, 'train', 'wait')
