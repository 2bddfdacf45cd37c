"""The gltvae_torch Trainer and data layer on synthetic data at sup 0.5
(n_train 64, bs 16, small model, on the CPU): schedule, data streams,
artifacts, resume and temperature decay."""

import csv
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.data.pipeline import BatchLoader as JBatchLoader
from gltvae.data.synthetic import synthetic_splits as j_splits
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.train.loop import Trainer as JTrainer
from gltvae.train.state import create_train_state
from gltvae.train.steps import make_train_steps as j_make_train_steps
from tests.test_torch_config_bridge import jax_params, scheme_mu, small_configs

import gltvae_torch.config as tcfg
from gltvae_torch.config import CELEBA_LABELS
from gltvae_torch.data.pipeline import BatchLoader
from gltvae_torch.data.synthetic import synthetic_celeba, synthetic_splits
from gltvae_torch.ops.gating import cooccurrence_gating_matrix
from gltvae_torch.train.loop import Trainer

torch.set_num_threads(2)

BS = 16


def _loaders(seed=0):
    splits = synthetic_splits(n_train=64, n_valid=16, n_test=16,
                              sup_frac=0.5, image_size=16, y_dim=4,
                              seed=seed, learnable_signal=True)
    return ({k: BatchLoader(v, BS, seed=seed) for k, v in splits.items()},
            cooccurrence_gating_matrix(splits['sup'].labels))


def _trainer(tmp_path, name='run'):
    _, tm = small_configs()
    loaders, mu = _loaders()
    cfg = tcfg.TrainConfig(batch_size=BS, perc_supervision=0.5, n_epochs=2)
    t = Trainer(tm, cfg, mu_init=mu,
                checkpoint_dir=str(tmp_path / name / 'ckpt'),
                metrics_path=str(tmp_path / name / 'metrics.csv'),
                device='cpu')
    return t, loaders


@pytest.mark.parametrize('total,period,sup_b', [
    (8, 2, 4), (10, 5, 2), (7, 1, 7), (9, 1, 5), (5, 0, 0), (13, 3, 4)])
def test_schedule_flags_equal(total, period, sup_b):
    assert Trainer._schedule_flags(total, period, sup_b) == \
        JTrainer._schedule_flags(total, period, sup_b)


@pytest.mark.parametrize('kw', [
    dict(), dict(learnable_signal=True, sup_frac=0.3, seed=4),
    dict(sup_frac=1.0, image_size=16, y_dim=4),
    dict(sup_frac=0.0, train_pad=2, image_size=16)])
def test_synthetic_splits_byte_identical(kw):
    a, b = synthetic_splits(**kw), j_splits(**kw)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k].images, b[k].images)
        assert a[k].images.dtype == b[k].images.dtype == np.uint8
        assert np.array_equal(a[k].labels, b[k].labels)
    s = synthetic_celeba(n=8, image_size=16)
    assert s.images.shape == (8, 16, 16, 3)


@pytest.mark.parametrize('reshuffle', [True, False])
def test_batch_loader_stream_identical(reshuffle):
    data = synthetic_splits(n_train=37, n_valid=8, n_test=8, image_size=8,
                            sup_frac=1.0)['sup']
    ours = BatchLoader(data, 10, seed=3, reshuffle_each_epoch=reshuffle)
    ref = JBatchLoader(data, 10, seed=3, reshuffle_each_epoch=reshuffle)
    assert ours.epoch_batches == ref.epoch_batches == 4
    for _ in range(9):       # wraps around and reshuffles twice
        assert np.array_equal(ours._next_batch_idxs(),
                              ref._next_batch_idxs())
    assert np.array_equal(ours.epoch_indices(), ref.epoch_indices())
    for (x1, y1), (x2, y2), _ in zip(ours, ref, range(5)):
        assert np.array_equal(x1, x2) and np.array_equal(y1, y2)
    ours.reset()
    ref.reset()
    assert np.array_equal(ours.epoch_indices(), ref.epoch_indices())


def _gltvae_metric_columns():
    """The metrics.csv columns gltvae's Trainer writes (traced, not run)."""
    jm, _ = small_configs()
    cfg = jcfg.TrainConfig(batch_size=BS)
    model = JCCVAE(jm)
    params = jax.tree.map(jnp.asarray, jax_params(jm, scheme_mu(jm)))
    state = create_train_state(model, cfg, jax.random.key(0), params=params)
    sup, _ = j_make_train_steps(model, cfg, jit=False)
    x = jnp.zeros((BS, 16, 16, 3), jnp.uint8)
    _, metrics = jax.eval_shape(sup, state, x, jnp.zeros((BS, 4)), 1.0)
    return sorted((set(metrics) - {'c_nan'})
                  | {'step', 'time', 'epoch', 'supervised'})


def test_trainer_artifacts(tmp_path):
    t, loaders = _trainer(tmp_path)
    param_dir = tmp_path / 'run'
    result = t.train(loaders, param_dir=str(param_dir), log_every=1)
    assert t.state.step == 2 * 4            # 2 epochs of (2 sup + 2 unsup)
    with open(param_dir / 'metrics.csv') as f:
        rows = list(csv.DictReader(f))
    assert sorted(rows[0]) == _gltvae_metric_columns()
    assert len(rows) == 8
    assert [int(r['supervised']) for r in rows[:4]] == [1, 0, 1, 0]
    assert all(math.isfinite(float(r['loss'])) for r in rows)
    assert t.ckpt.all_steps() == [4, 8]
    mu = np.load(param_dir / 'learned_gating_matrix_last.npy')
    assert np.array_equal(mu, t.model.mu.detach().numpy())
    with open(param_dir / 'learned_gating_matrix_last.csv') as f:
        table = list(csv.reader(f))
    assert table[0] == [''] + list(CELEBA_LABELS[:4])   # y_dim 4 != 18
    assert [r[0] for r in table[1:]] == ['z1', 'z2', 'z3', 'z4']
    np.testing.assert_array_equal(
        np.asarray([r[1:] for r in table[1:]], np.float32), mu)
    assert (param_dir / 'gating_history.npz').exists()
    assert 0.0 <= result['best_val_accuracy'] <= 1.0
    assert 0.0 <= t.test(loaders['test']) <= 1.0
    assert math.isfinite(t.test_elbo(loaders['test']))
    assert t.gating_temp == pytest.approx(0.99 ** 2, rel=1e-12)


def test_resume_is_bit_exact(tmp_path):
    full, loaders = _trainer(tmp_path, 'full')
    full.train(loaders)

    half, loaders = _trainer(tmp_path, 'half')
    half.train(loaders, epochs=1)
    assert half.gating_temp == pytest.approx(0.99, rel=1e-12)
    resumed, loaders = _trainer(tmp_path, 'half')
    # the loaders restart at their seed; fast-forward them one epoch
    for k in ('sup', 'unsup'):
        loaders[k].epoch_indices()
    resumed.train(loaders, resume=True)
    assert resumed.state.step == full.state.step == 8
    assert resumed.gating_temp == pytest.approx(full.gating_temp, rel=1e-12)
    for (n, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    for n in full.state.adam_m:
        assert torch.equal(full.state.adam_m[n], resumed.state.adam_m[n])
        assert torch.equal(full.state.adam_v[n], resumed.state.adam_v[n])


def test_nan_gates_raise(tmp_path):
    from gltvae_torch.train.loop import NanGateError
    _, tm = small_configs()
    loaders, mu = _loaders()
    mu[0, 1] = np.nan                      # a NaN mean gives NaN gates
    t = Trainer(tm, tcfg.TrainConfig(batch_size=BS, perc_supervision=0.5),
                mu_init=mu, device='cpu')
    with pytest.raises(NanGateError, match='epoch 0 step 4'):
        t.train(loaders, epochs=1)


def test_cli_trains_and_tests_on_cpu(tmp_path):
    import json
    from gltvae_torch import cli
    out = cli.main(['--synthetic', '--do-train', '--epochs', '1', '--sup',
                    '0.5', '-bs', '16', '--synthetic-n', '32', '--device',
                    'cpu', '--output-dir', str(tmp_path)])
    run = tmp_path / 'params_0.5_learnable'
    result = json.loads((run / 'result.json').read_text())
    assert result['test_accuracy'] == pytest.approx(out[0.5])
    assert result['device'] == 'cpu' and len(result['history']) == 1
    assert tcfg.load_model_config(str(run)) == tcfg.ModelConfig()
    for name in ('metrics.csv', 'learned_gating_matrix_best.npy',
                 'gating_history.npz'):
        assert (run / name).exists()
