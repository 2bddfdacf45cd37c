"""The host parts' draws of variates inside the traced test passes
(``host.draw`` spans inside ``eval.pass``) over the passes. Nothing where the
program has no tracer (``spans.program``)."""

import spans


def read(rec):
    return spans.per(rec, 'eval', 'eval_draw')
