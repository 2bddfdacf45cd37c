"""Training on one device: whole ``Trainer.train`` epochs, as the
command line runs them (``cli.py --do-train``).

Traffic keys: ``n_train``, ``n_valid``, ``n_test`` (the synthetic
splits), ``train`` (settings over the configuration's: batch,
supervision, steps a dispatch), ``trace`` (``skip`` dispatches into an
epoch, then ``count`` traced, or the rest of the epoch with its
validation when ``count`` is null) and ``limits`` (the comparison's).
"""

from __future__ import annotations

import harness as H
import checks as C
from session import TrainSession


def train_record(cell, win: dict, traces: list, eval_batches: int) -> dict:
    """What the per-layer readers read of a train cell's run."""
    return {'kind': 'train', 'model': cell.model, 'train': cell.train,
            'chips': cell.chips, 'window_s': win['window_s'],
            'images': win['images'], 'steps': win['steps'],
            'traces': traces, 'eval_batches': eval_batches}


def run(ctx) -> dict:
    cell = ctx.cell
    s = TrainSession(cell, ctx.seed, ctx.device, ctx.tmp)
    s.warm_up()
    setup_s = ctx.clock() - ctx.t0
    win = s.window(ctx.seconds)
    iv = win['intervals_ms']
    H.log(f'window: {win["epochs"]} epochs, {win["dispatches"]} dispatches, '
          f'{win["images"]} images in {win["window_s"]:.3f} s; step_ms_p95 '
          f'over {len(iv)} intervals')
    out = {'e2e': {'setup_s': setup_s,
                   'train_img_per_s': win['images'] / win['window_s'],
                   'step_ms_p95': H.p95(iv)},
           'attempted': win['dispatches'], 'failed': 0}
    traces = []
    if ctx.trace:
        tr = cell.traffic['trace']
        traces.append(s.trace(tr['skip'], tr.get('count')))
    out['memory_peak_bytes'] = ctx.memory_peak()
    out['record'] = train_record(cell, win, traces, s.eval_batches())
    prog = s.program_readout()
    splits = s.splits
    s.close()
    ref = C.train_reference(cell, ctx.seed, splits, ctx.device,
                            prog['first'], prog['steps'])
    out['checks'] = C.train_checks(prog, ref)
    return out
