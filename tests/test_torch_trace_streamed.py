"""``gltvae_torch.trace`` on the Trainer's streamed path: a tiny CPU
Trainer whose splits are shipped from the host (``resident_train`` and
``resident_eval`` 'off'), with the tracer on.

- Each streamed dispatch and each streamed eval chunk holds one
  ``train.h2d`` with one ``wait.h2d`` inside it: the copies block.
- ``h2d_bytes`` rises by exactly the images' and labels' bytes that each
  ``_place`` ships, and the recording interval keeps it at both ends.
- A resident run ships its splits once, at set-up, and its dispatches add
  no ``h2d_bytes``.
- Parameters and metrics.csv are bit-equal to a run with the tracer off.
"""

import csv

import pytest
import torch

from gltvae_torch import trace
from gltvae_torch.data.pipeline import BatchLoader
from gltvae_torch.data.synthetic import synthetic_splits
from gltvae_torch.ops.gating import cooccurrence_gating_matrix
from gltvae_torch.train.loop import Trainer
from tests import torch_dp_workers as W

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    trace.set_mode('auto')
    yield
    trace.set_mode('auto')
    trace.reset()


def _trainer(tmp_path, name, resident):
    model_cfg, train_cfg = W.configs(perc_supervision=0.5)
    splits = synthetic_splits(n_train=64, n_valid=32, n_test=16,
                              sup_frac=0.5, image_size=16, y_dim=4, seed=0)
    loaders = {k: BatchLoader(v, W.B, seed=0) for k, v in splits.items()}
    mode = 'auto' if resident else 'off'
    t = Trainer(model_cfg, train_cfg,
                mu_init=cooccurrence_gating_matrix(splits['sup'].labels),
                metrics_path=str(tmp_path / name / 'metrics.csv'),
                device='cpu', resident_train=mode, resident_eval=mode)
    return t, loaders


def _spy(t, monkeypatch):
    """Each ``_place`` call's (h2d_bytes it added, bytes it returned)."""
    calls, place = [], t._place

    def spy(batch, stacked=False):
        n0 = trace.h2d_bytes
        x, y = place(batch, stacked)
        calls.append((trace.h2d_bytes - n0, x.nbytes + y.nbytes))
        return x, y
    monkeypatch.setattr(t, '_place', spy)
    return calls


def _run(tmp_path, name, mode, monkeypatch, resident=False):
    t, loaders = _trainer(tmp_path, name, resident)
    calls = _spy(t, monkeypatch)
    trace.set_mode(mode)
    t.train(loaders, epochs=2, log_every=1)
    trace.set_mode('auto')
    return t, loaders, calls, trace.records(), trace.intervals()


@pytest.fixture(scope='module')
def streamed(tmp_path_factory):
    """Two streamed epochs with the tracer on and with it off."""
    tmp = tmp_path_factory.mktemp('trace_streamed')
    with pytest.MonkeyPatch.context() as mp:
        trace.reset()
        on = _run(tmp, 'on', 'on', mp)
        trace.reset()
        off = _run(tmp, 'off', 'auto', mp)
        trace.reset()
    return on, off


def _inside(rec, i, name):
    return [j for j, r in enumerate(rec) if r['parent'] == i
            and r['name'] == name]


def test_each_streamed_copy_is_one_wait_inside_its_h2d(streamed):
    (t, loaders, _, rec, _), _ = streamed
    total, _, _ = t.epoch_schedule(loaders)
    dispatches = [i for i, r in enumerate(rec)
                  if r['name'] == 'train.dispatch']
    passes = [i for i, r in enumerate(rec) if r['name'] == 'eval.pass']
    assert len(dispatches) == 2 * total and len(passes) == 2
    for i in dispatches:
        (h2d,) = _inside(rec, i, 'train.h2d')
        assert len(_inside(rec, h2d, 'wait.h2d')) == 1
        assert rec[i]['request'] == rec[h2d]['request']
    chunks = loaders['valid'].epoch_batches       # steps_per_dispatch 1
    for i in passes:
        assert rec[i]['attrs']['resident'] is False
        h2ds = _inside(rec, i, 'train.h2d')
        assert len(h2ds) == chunks
        for h in h2ds:
            assert len(_inside(rec, h, 'wait.h2d')) == 1
    waits = [r for r in rec if r['name'] == 'wait.h2d']
    assert len(waits) == 2 * (total + chunks)
    assert all(rec[r['parent']]['name'] == 'train.h2d' for r in waits)


def test_h2d_bytes_count_what_each_place_ships(streamed):
    (t, loaders, calls, _, ivs), (_, _, calls_off, _, _) = streamed
    total, _, _ = t.epoch_schedule(loaders)
    m = t.model.cfg
    b = W.B
    one = b * m.image_size ** 2 * m.channels + b * m.y_dim * 4
    assert calls == [(one, one)] * (2 * (total
                                         + loaders['valid'].epoch_batches))
    assert calls_off == calls               # counted with the tracer off
    (iv,) = ivs
    assert iv['stop']['h2d_bytes'] - iv['start']['h2d_bytes'] == \
        one * len(calls)


def test_a_resident_runs_dispatches_ship_nothing(tmp_path, monkeypatch):
    """The splits are copied once each (sup and unsup at the first
    epoch, valid at the first pass); the second epoch ships nothing."""
    t, loaders = _trainer(tmp_path, 'resident', resident=True)
    calls = _spy(t, monkeypatch)
    trace.set_mode('on')
    t.train(loaders, epochs=1)
    after_first = trace.h2d_bytes
    t.train(loaders, epochs=1)
    trace.set_mode('auto')
    split = {k: loaders[k].dataset for k in ('sup', 'unsup', 'valid')}
    want = [v.images.nbytes + len(v) * v.labels.shape[1] * 4
            for v in split.values()]
    assert sorted(a for a, _ in calls) == sorted(want)
    assert trace.h2d_bytes == after_first
    (iv,) = trace.intervals()
    assert iv['stop']['h2d_bytes'] - iv['start']['h2d_bytes'] == sum(want)
    copies = [r for r in trace.records() if r['name'] == 'resident.copy']
    assert len(copies) == 3


def _csv_without_time(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        del r['time']
    return rows


def test_tracing_the_streamed_path_changes_no_number(streamed):
    (on, _, _, _, _), (off, _, _, _, _) = streamed
    for part in ('model', 'adam_m', 'adam_v'):
        a, b = (getattr(t.state, part) for t in (on, off))
        a, b = ((x.state_dict() if part == 'model' else x) for x in (a, b))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)
    assert on.state.step == off.state.step > 0
    assert _csv_without_time(on.metrics.path) == \
        _csv_without_time(off.metrics.path)
    assert len(_csv_without_time(on.metrics.path)) > 0
