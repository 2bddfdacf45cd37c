"""The test pass after training (``cli.py --do-test``): repeated
``Trainer.test`` passes over the test split, each one accuracy.

Traffic keys: the split sizes and ``train`` as ``train_epochs``;
``trace.count`` passes traced after the window; ``check_passes`` passes
drawn from the seed (with the first and the last) that the reference
recomputes; ``limits``.
"""

from __future__ import annotations

import time

import harness as H
import checks as C
from flops import eval_image


def run(ctx) -> dict:
    cell = ctx.cell
    splits = H.make_splits(cell, ctx.seed, ctx.device)
    H.reset_peak(ctx.device)
    trainer, loaders = H.build_program(cell, splits, ctx.seed, ctx.device,
                                       ctx.tmp)
    test = loaders['test']
    answers = [trainer.test(test)]          # warm-up: captures the pass
    setup_s = ctx.clock() - ctx.t0
    rows = test.epoch_batches * test.bs
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        answers.append(trainer.test(test))
    window_s = time.perf_counter() - t0
    passes = len(answers) - 1
    H.log(f'window: {passes} test passes of {rows} rows in '
          f'{window_s:.3f} s')
    out = {'e2e': {'setup_s': setup_s,
                   'eval_img_per_s': passes * rows / window_s},
           'attempted': len(answers), 'failed': 0}
    traces = []
    if ctx.trace:
        n = cell.traffic['trace']['count']

        def more():
            for _ in range(n):
                answers.append(trainer.test(test))
        prof, a, b = H.traced(ctx.cuda, more)
        rec = H.reduce_trace(prof, a, b)
        rec['passes'], rec['batches'] = n, n * test.epoch_batches
        traces.append(rec)
    out['memory_peak_bytes'] = ctx.memory_peak()
    m = cell.model
    out['record'] = {
        'kind': 'eval', 'model': m, 'train': cell.train, 'chips': 1,
        'window_s': window_s, 'eval_images': passes * rows,
        'eval_flops': passes * rows * eval_image(m), 'traces': traces}
    del trainer, loaders, test
    H.free_program()
    picks = C.sample_passes(len(answers), ctx.seed,
                            cell.traffic['check_passes'])
    ref = C.test_reference(cell, ctx.seed, splits, ctx.device, picks)
    out['checks'] = C.test_checks({j: answers[j] for j in picks}, ref)
    return out
