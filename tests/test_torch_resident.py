"""Device-resident training and eval in the gltvae_torch Trainer (small
model, 16 px, bs 8, on the CPU), against the port's host-shipped path.

The resident path gathers each batch from the split on the device by the
loaders' own index stream, so everything must be bit-identical to shipping
the batches: the u8 batches each step sees, params, Adam moments,
metrics.csv, validation accuracy and ELBO. No tolerance is used."""

import csv

import numpy as np
import pytest
import torch

from tests.test_torch_config_bridge import small_configs

import gltvae_torch.config as tcfg
import gltvae_torch.train.steps as tsteps
from gltvae_torch.data.pipeline import ArrayDataset, BatchLoader
from gltvae_torch.data.synthetic import synthetic_splits
from gltvae_torch.ops.gating import cooccurrence_gating_matrix
from gltvae_torch.train.loop import Trainer
from gltvae_torch.train.state import init_model, step_seed

torch.set_num_threads(2)

BS = 8


def _loaders(sup, train_pad=0):
    splits = synthetic_splits(n_train=64, n_valid=20, n_test=16,
                              sup_frac=sup, image_size=16, y_dim=4,
                              learnable_signal=True, train_pad=train_pad)
    loaders = {k: BatchLoader(v, BS, seed=0) for k, v in splits.items()}
    mu = cooccurrence_gating_matrix(
        splits['sup' if 'sup' in splits else 'unsup'].labels)
    return loaders, mu


def _trainer(tmp_path, name, sup, spd, resident, augment_pad=0, **kw):
    _, tm = small_configs()
    loaders, mu = _loaders(sup, train_pad=augment_pad)
    t = Trainer(tm, tcfg.TrainConfig(batch_size=BS, perc_supervision=sup,
                                     classifier_mc_samples=4,
                                     augment_pad=augment_pad),
                mu_init=mu, steps_per_dispatch=spd, device='cpu',
                metrics_path=str(tmp_path / name / 'metrics.csv'),
                resident_train=resident, resident_eval=resident, **kw)
    return t, loaders


def _run(tmp_path, sup, spd, resident, monkeypatch, epochs=1):
    """Train `epochs`, recording the uint8 batch of every step and eval
    batch (the input of the steps' _prep_image)."""
    name = f'sup{sup}_spd{spd}_{resident}'
    t, loaders = _trainer(tmp_path, name, sup, spd, resident)
    seen, real = [], tsteps._prep_image
    monkeypatch.setattr(tsteps, '_prep_image',
                        lambda x, s: seen.append(x.clone()) or real(x, s))
    result = t.train(loaders, log_every=1, epochs=epochs)
    elbo = t.test_elbo(loaders['test'])
    monkeypatch.setattr(tsteps, '_prep_image', real)
    with open(tmp_path / name / 'metrics.csv') as f:
        rows = [{k: v for k, v in r.items() if k != 'time'}
                for r in csv.DictReader(f)]
    return t, rows, seen, result, elbo


def _assert_runs_equal(a, b):
    (ta, rows_a, seen_a, res_a, elbo_a), (tb, rows_b, seen_b, res_b,
                                          elbo_b) = a, b
    assert ta.state.step == tb.state.step
    assert len(seen_a) == len(seen_b)
    for xa, xb in zip(seen_a, seen_b):
        assert xa.dtype == xb.dtype == torch.uint8 and torch.equal(xa, xb)
    for (n, p), q in zip(ta.model.state_dict().items(),
                         tb.model.state_dict().values()):
        assert torch.equal(p, q), n
    for n in ta.state.adam_m:
        assert torch.equal(ta.state.adam_m[n], tb.state.adam_m[n]), n
        assert torch.equal(ta.state.adam_v[n], tb.state.adam_v[n]), n
    assert rows_a == rows_b
    assert res_a['best_val_accuracy'] == res_b['best_val_accuracy']
    assert elbo_a == elbo_b


@pytest.mark.parametrize('spd', [1, 4])
@pytest.mark.parametrize('sup', [1.0, 0.5])
def test_resident_epoch_bit_identical_to_shipped(tmp_path, monkeypatch, sup,
                                                 spd):
    res = _run(tmp_path, sup, spd, 'auto', monkeypatch)
    shipped = _run(tmp_path, sup, spd, 'off', monkeypatch)
    assert set(res[0]._resident_data) and not shipped[0]._resident_data
    assert res[0].state.step == 8
    # 8 train steps, 3 valid batches, 2 test batches
    assert len(res[2]) == 8 + 3 + 2
    _assert_runs_equal(res, shipped)


@pytest.mark.slow
def test_resident_two_epochs_bit_identical_to_shipped(tmp_path,
                                                      monkeypatch):
    _assert_runs_equal(
        _run(tmp_path, 0.5, 4, 'auto', monkeypatch, epochs=2),
        _run(tmp_path, 0.5, 4, 'off', monkeypatch, epochs=2))


@pytest.mark.parametrize('spd', [1, 4])
def test_resident_eval_and_elbo_equal_per_batch(tmp_path, spd):
    """evaluate/test_elbo: resident, shipped in chunks of spd, and the
    per-batch eval step with a fresh generator of the same seed."""
    res, loaders = _trainer(tmp_path, 'res', 0.5, spd, 'auto')
    shipped, _ = _trainer(tmp_path, 'shipped', 0.5, spd, 'off')
    valid = loaders['valid']
    accs = []
    for t in (res, shipped):
        valid.reset()
        accs.append((t.evaluate(valid), t.test_elbo(valid)))
    assert id(valid) in res._resident_data
    assert accs[0] == accs[1]
    gen = torch.Generator().manual_seed(step_seed(0 + 1, 0))
    ev = tsteps.make_eval_step(res.model, res.cfg)
    el = tsteps.make_elbo_eval_step(res.model, res.cfg)
    valid.reset()
    it = iter(valid)
    epoch = lambda: [next(it) for _ in range(valid.epoch_batches)]
    acc = torch.stack([ev(res.model, torch.from_numpy(x), torch.from_numpy(y),
                          gen, res.gating_temp) for x, y in epoch()])
    # test_elbo took the loader's next epoch
    elbo = torch.stack([el(res.model, torch.from_numpy(x), gen,
                           res.gating_temp) for x, _ in epoch()])
    assert accs[0] == (float(acc.mean()), float(elbo.mean()))


def test_scan_eval_and_elbo_chunks_equal_per_batch_calls():
    _, tm = small_configs()
    cfg = tcfg.TrainConfig(batch_size=BS)
    model = init_model(tm, cfg, np.eye(4, dtype=np.float32))
    rng = np.random.RandomState(5)
    xs = torch.from_numpy(rng.randint(0, 256, (3, BS, 16, 16, 3),
                                      dtype=np.uint8))
    ys = torch.from_numpy((rng.rand(3, BS, 4) > 0.5).astype(np.float32))
    ev, el = (tsteps.make_eval_step(model, cfg),
              tsteps.make_elbo_eval_step(model, cfg))
    gen = lambda: torch.Generator().manual_seed(9)
    # per-batch calls, all accuracies then all ELBOs on one generator
    g = gen()
    acc = torch.stack([ev(model, x, y, g, 0.5) for x, y in zip(xs, ys)])
    elbo = torch.stack([el(model, x, g, 0.5) for x in xs])
    g = gen()
    assert torch.equal(
        tsteps.make_scan_eval_step(model, cfg)(model, xs, ys, g, 0.5), acc)
    assert torch.equal(
        tsteps.make_scan_elbo_step(model, cfg)(model, xs, g, 0.5), elbo)
    # the resident forms gather the same rows from the split
    images, labels = xs.reshape(3 * BS, 16, 16, 3), ys.reshape(3 * BS, 4)
    idxs = torch.arange(3 * BS).reshape(3, BS)
    g = gen()
    assert torch.equal(tsteps.make_resident_eval_step(model, cfg)(
        model, images, labels, idxs, g, 0.5), acc)
    assert torch.equal(tsteps.make_resident_elbo_step(model, cfg)(
        model, images, idxs, g, 0.5), elbo)


def _sharded(loader):
    loader.shard = (0, 2)
    return loader


@pytest.mark.parametrize('case', ['off', 'augment', 'over_budget',
                                  'shape_mismatch', 'host_sharded'])
def test_resident_train_gating(tmp_path, case):
    """Resident training is off when asked, for augmented runs, over the
    budget, when sup and unsup images differ in shape, and for host-sharded
    loaders; the run then streams from the host."""
    kw = {}
    if case == 'over_budget':
        kw = dict(resident_train_max_bytes=1000)
    t, loaders = _trainer(tmp_path, case, 0.5, 1,
                          'off' if case == 'off' else 'auto',
                          augment_pad=2 if case == 'augment' else 0, **kw)
    if case == 'shape_mismatch':
        u = loaders['unsup'].dataset
        loaders['unsup'] = BatchLoader(ArrayDataset(
            u.images[:, :8, :8], u.labels), BS, seed=0)
    if case == 'host_sharded':
        _sharded(loaders['sup'])
    assert t._resident_train_splits(loaders) is None
    if case == 'host_sharded':
        assert t._resident_split(loaders['sup'], 2**30) is None
    if case in ('off', 'augment', 'over_budget'):
        t.train(loaders, epochs=1)
        assert t.state.step == 8
        assert set(t._resident_data) <= {id(loaders['valid'])}
    fits, _ = _trainer(tmp_path, case + '_fits', 0.5, 1, 'auto')
    assert fits._resident_train_splits(_loaders(0.5)[0]) is not None


def test_resident_eval_over_budget_streams(tmp_path):
    res, loaders = _trainer(tmp_path, 'small', 0.5, 1, 'auto',
                            resident_eval_max_bytes=1000)
    full, _ = _trainer(tmp_path, 'full', 0.5, 1, 'auto')
    assert res._resident_eval_split(loaders['valid']) is None
    loaders['valid'].reset()
    a = res.evaluate(loaders['valid'])
    loaders['valid'].reset()
    assert full.evaluate(loaders['valid']) == a
    assert id(loaders['valid']) in full._resident_data


def test_bad_resident_mode_raises():
    _, tm = small_configs()
    for kw in (dict(resident_train='on'), dict(resident_eval='yes')):
        with pytest.raises(ValueError, match='auto'):
            Trainer(tm, tcfg.TrainConfig(batch_size=BS),
                    mu_init=np.eye(4, dtype=np.float32), device='cpu', **kw)
