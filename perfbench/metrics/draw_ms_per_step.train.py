"""The host parts' draws of variates inside the traced train segment's
dispatches (``host.draw`` spans) over its train steps; the largest over
the ranks. Nothing where the
program has no tracer (``spans.program``)."""

import spans


def read(rec):
    return spans.per(rec, 'train', 'train_draw')
