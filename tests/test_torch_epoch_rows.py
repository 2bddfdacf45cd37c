"""A resident train epoch's index rows go to the device in one copy.

The Trainer draws a resident epoch's rows at its start, from the loaders'
``_next_batch_idxs`` in the order of the epoch's steps, copies them in one
upload, and gives each dispatch its slice on the device. On the CPU
(tiny model, 16 px), for 1 and 4 steps a dispatch and for mixed (sup 0.5)
and uniform (sup 1.0, sup 0.0) schedules:

- the uploaded rows are the loaders' rows in flag order, and each
  resident pass uploads its loader's ``epoch_indices()``;
- the cursors, metrics and parameters equal, bit for bit, those of a run
  in which every dispatch draws and copies its own rows;
- ``trace.index_uploads`` counts one a train epoch and one a resident pass.

On the card: 20 resident dispatches queue with no wait, so the stream is
still busy after them, and the run equals one synchronized after every
dispatch. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from gltvae_torch import trace
from gltvae_torch.config import ModelConfig, TrainConfig
from gltvae_torch.data.pipeline import BatchLoader
from gltvae_torch.data.synthetic import synthetic_splits
from gltvae_torch.ops.gating import cooccurrence_gating_matrix
from gltvae_torch.train.loop import Trainer
from gltvae_torch.train.metrics import Throughput

torch.set_num_threads(1)

#: the tiny model of the data-parallel tests, and its batch
SMALL = dict(image_size=16, z_dim=8, y_dim=4, enc_features=(8, 8),
             enc_hidden=16, dec_features=(16, 8))
B = 16
EPOCHS = 2
CASES = [(spd, sup) for spd in (1, 4) for sup in (0.5, 1.0, 0.0)]


class Recording(Trainer):
    """The Trainer, keeping a copy of every index upload."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.uploads = []

    def _upload_rows(self, idx):
        self.uploads.append(np.array(idx))
        return super()._upload_rows(idx)


class _PerDispatchRows:
    """An epoch's rows as each dispatch took them before the epoch's one
    upload: a slice draws its own rows from the loaders and copies them."""

    def __init__(self, trainer, loaders, flags):
        self.trainer, self.loaders, self.flags = trainer, loaders, flags

    def __getitem__(self, s: slice):
        idx = np.stack([(self.loaders['sup'] if f else self.loaders['unsup'])
                        ._next_batch_idxs() for f in self.flags[s]])
        self.trainer.dispatch_rows.append(idx)
        return self.trainer._upload_rows(idx)


class PerDispatch(Recording):
    """The Trainer with each resident dispatch drawing and copying its own
    rows; ``dispatch_rows`` keeps them."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.dispatch_rows = []

    def _epoch_rows(self, loaders, flags):
        return _PerDispatchRows(self, loaders, flags)


def _loaders(sup, seed=0):
    splits = synthetic_splits(n_train=80, n_valid=24, n_test=16,
                              sup_frac=sup, image_size=16, y_dim=4,
                              learnable_signal=True)
    return ({k: BatchLoader(v, B, seed=seed) for k, v in splits.items()},
            cooccurrence_gating_matrix(
                splits['unsup' if sup == 0.0 else 'sup'].labels))


def _train(cls, tmp_path, spd, sup):
    loaders, mu = _loaders(sup)
    t = cls(ModelConfig(**SMALL),
            TrainConfig(batch_size=B, lr=1e-3, classifier_mc_samples=4,
                        perc_supervision=sup),
            mu_init=mu, steps_per_dispatch=spd,
            device='cpu', metrics_path=str(tmp_path / cls.__name__ /
                                           'metrics.csv'))
    n0 = trace.index_uploads
    t.train(loaders, epochs=EPOCHS, log_every=1)
    return t, loaders, trace.index_uploads - n0


@pytest.fixture(scope='module', params=CASES,
                ids=[f'spd{spd}-sup{sup}' for spd, sup in CASES])
def runs(request, tmp_path_factory):
    """(spd, sup, the epoch's one upload, per-dispatch copies): each a
    (trainer, loaders, index uploads counted) of two epochs."""
    spd, sup = request.param
    tmp = tmp_path_factory.mktemp(f'rows_spd{spd}_sup{sup}')
    return (spd, sup, _train(Recording, tmp, spd, sup),
            _train(PerDispatch, tmp, spd, sup))


def test_uploaded_rows_are_the_loaders_rows_in_flag_order(runs):
    _, sup, (t, loaders, _), _ = runs
    ref, _ = _loaders(sup)
    flags = t._schedule_flags(*t.epoch_schedule(loaders))
    assert len(t.uploads) == 2 * EPOCHS     # an epoch's, its validation's
    for e in range(EPOCHS):
        want = np.stack([(ref['sup'] if f else ref['unsup'])
                         ._next_batch_idxs() for f in flags])
        assert t.uploads[2 * e].shape == (len(flags), B)
        np.testing.assert_array_equal(t.uploads[2 * e], want)
        np.testing.assert_array_equal(t.uploads[2 * e + 1],
                                      ref['valid'].epoch_indices())


def test_cursors_metrics_and_params_equal_per_dispatch_copies(runs):
    _, _, (t, loaders, _), (p, per_loaders, _) = runs
    for k in loaders:
        a, b = loaders[k], per_loaders[k]
        assert a._start == b._start, k
        np.testing.assert_array_equal(a._idxs, b._idxs)
        for x, y in zip(a._rng.get_state(), b._rng.get_state()):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.concatenate(p.dispatch_rows),
                                  np.concatenate(t.uploads[::2]))
    assert t.state.step == p.state.step
    for part in ('adam_m', 'adam_v'):
        for k, v in getattr(t.state, part).items():
            assert torch.equal(v, getattr(p.state, part)[k]), (part, k)
    a, b = t.model.state_dict(), p.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    rows = [{k: v for k, v in r.items() if k != 'time'}
            for r in t.metrics.rows]
    assert rows == [{k: v for k, v in r.items() if k != 'time'}
                    for r in p.metrics.rows]
    assert len(rows) == t.state.step


def test_index_uploads_count_an_epoch_and_a_pass(runs):
    spd, _, (t, loaders, got), (_, _, per) = runs
    assert got == 2 * EPOCHS
    dispatches = len(t._chunk_sizes(
        t._schedule_flags(*t.epoch_schedule(loaders)), spd, True))
    assert per == EPOCHS * (dispatches + 1)   # one copy a dispatch, before
    assert trace.snapshot()['index_uploads'] == trace.index_uploads


# ------------------------------- on the card -------------------------------
class _Meter(Throughput):
    """The Trainer's meter with a callback after each dispatch."""

    def __init__(self, after):
        super().__init__()
        self.after, self.dispatches = after, 0

    def step(self, batch_images: int):
        super().step(batch_images)
        self.dispatches += 1
        self.after(self.dispatches)


def _card_run(after_dispatch):
    """The CelebA-64 model at bs 256, sup 0.2, resident, captured, on
    cuDNN's deterministic algorithms: one epoch that captures every graph,
    then one with `after_dispatch(k)` called after its k-th dispatch."""
    splits = synthetic_splits(n_train=256 * 40, n_valid=256, n_test=256,
                              sup_frac=0.2, seed=3, learnable_signal=True)
    loaders = {k: BatchLoader(v, 256, seed=3) for k, v in splits.items()}
    t = Trainer(ModelConfig(), TrainConfig(perc_supervision=0.2),
                mu_init=cooccurrence_gating_matrix(splits['sup'].labels),
                device='cuda')
    t.train(loaders, epochs=1)
    t.throughput = _Meter(after_dispatch)
    t.train(loaders, epochs=1)
    torch.cuda.synchronize()
    return t


@pytest.mark.cuda
def test_resident_dispatches_run_ahead_of_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the host runs ahead of a card')
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        busy = {}

        def look(k):
            if k == 20:     # no NaN check nor log flush before it
                busy['after 20'] = not torch.cuda.current_stream().query()
        ahead = _card_run(look)
        synced = _card_run(lambda k: torch.cuda.synchronize())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert busy == {'after 20': True}
    assert ahead.state.step == synced.state.step == 2 * 40
    a, b = ahead.model.state_dict(), synced.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for part in ('adam_m', 'adam_v'):
        for k, v in getattr(ahead.state, part).items():
            assert torch.equal(v, getattr(synced.state, part)[k]), (part, k)
    rows = [{k: v for k, v in r.items() if k != 'time'}
            for r in ahead.metrics.rows]
    assert rows == [{k: v for k, v in r.items() if k != 'time'}
                    for r in synced.metrics.rows]
    assert rows
