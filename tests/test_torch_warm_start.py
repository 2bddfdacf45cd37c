"""Warm start from a reference-format .h5 folder: ``Trainer.load_params``,
the CLI's ``--init-from-h5`` (training and test-only) and ``python -m
gltvae_torch.infer --checkpoint <.h5 folder> [--mu]``, against gltvae's
Trainer.load_params, train.py and tools/infer.py on the same folder.

Every .h5 folder is written by gltvae's exporter from seeded params."""

import logging
import os

import jax
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
import train as jtrain
from gltvae.utils.h5_export import export_reference_checkpoint
from tests.test_torch_config_bridge import (SCHEMES, jax_params, scheme_mu,
                                            small_configs)
from tools import infer as jinfer

import gltvae_torch.config as tcfg
from gltvae_torch import cli
from gltvae_torch import infer as tinfer
from gltvae_torch.bridge import params_to_state_dict
from gltvae_torch.train.loop import Trainer
from gltvae_torch.utils.h5_import import load_reference_checkpoint

torch.set_num_threads(2)


def _h5_folder(path, jm, seed, keep_mu=True):
    params = jax_params(jm, scheme_mu(jm, seed=seed), seed=seed)
    export_reference_checkpoint(params, str(path), 'best')
    if not keep_mu:
        os.remove(path / 'learned_gating_matrix_best.npy')
    return params


@pytest.mark.parametrize('scheme', SCHEMES, ids=lambda s: '/'.join(s))
def test_load_params_keeps_step_and_adam_state(tmp_path, scheme):
    jm, tm = small_configs(*scheme)
    params = _h5_folder(tmp_path, jm, seed=11)
    trainer = Trainer(tm, tcfg.TrainConfig(batch_size=4,
                                           classifier_mc_samples=2),
                      mu_init=scheme_mu(jm), device='cpu')
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 256, (4, 16, 16, 3), dtype=np.uint8))
    y = torch.from_numpy((rng.rand(4, 4) > 0.5).astype(np.float32))
    trainer.state, _ = trainer._sup_step(trainer.state, x, y, 1.0)
    before = trainer.state.state_dict()
    trainer.load_params(load_reference_checkpoint(str(tmp_path)))
    after = trainer.state.state_dict()
    assert (after['step'], after['adam_count']) == (1, 1)
    for key in ('adam_m', 'adam_v'):
        assert after[key].keys() == before[key].keys()
        for k, v in before[key].items():
            assert torch.equal(after[key][k], v), (key, k)
    want = params_to_state_dict(params)
    for k, v in after['params'].items():
        assert torch.equal(v, want[k]), k
    assert ('mu' in after['adam_m']) == tm.mu_trainable
    mu0 = trainer.model.mu.detach().clone()
    trainer.state, m = trainer._sup_step(trainer.state, x, y, 1.0)
    assert np.isfinite(float(m['loss'])) and trainer.state.step == 2
    assert torch.equal(trainer.model.mu, mu0) != tm.mu_trainable


def _cli_flags(h5, out, *extra):
    return ['--synthetic', '--synthetic-n', '32', '-bs', '16', '--sup',
            '0.5', '--init-from-h5', str(h5), '--deterministic-eval',
            '--output-dir', str(out), *extra]


def test_init_from_h5_test_only_equals_train_py(tmp_path, monkeypatch):
    """Test-only: the port tests exactly the .h5 weights (a stale
    checkpoint in the run folder is ignored) and scores what train.py
    scores on the same folder and split (deterministic eval)."""
    jm, _ = jcfg.default_celeba64()
    params = _h5_folder(tmp_path / 'h5', jm, seed=12)
    seen = []
    real_test = Trainer.test
    monkeypatch.setattr(Trainer, 'test', lambda self, loader: (
        seen.append(self.model.state_dict()), real_test(self, loader))[1])
    monkeypatch.setattr(Trainer, 'restore', lambda self, step=None: (
        _ for _ in ()).throw(AssertionError('restored a checkpoint')))
    got = cli.main(_cli_flags(tmp_path / 'h5', tmp_path / 'port',
                              '--device', 'cpu'))[0.5]
    want = params_to_state_dict(params)
    assert len(seen) == 1 and all(torch.equal(v, want[k])
                                  for k, v in seen[0].items())
    ref = jtrain.main(_cli_flags(tmp_path / 'h5', tmp_path / 'gltvae',
                                 '--platform', 'cpu', '--compilation-cache',
                                 'off'))[0.5]
    assert abs(got - ref) <= 1e-6, (got, ref)


@pytest.mark.parametrize('scheme', [('learnable', 'inferred'),
                                    ('fixed', 'one-one')],
                         ids=lambda s: '/'.join(s))
def test_init_from_h5_then_train(tmp_path, monkeypatch, caplog, scheme):
    """Training starts from the .h5 weights; a fixed one-one folder without
    the μ .npy falls back to the identity (not the co-occurrence init)."""
    jm, _ = jcfg.default_celeba64()
    jm = jm.__class__(**{**jm.__dict__, 'gate_type': scheme[0],
                         'gate_subtype': scheme[1]})
    params = _h5_folder(tmp_path / 'h5', jm, seed=13,
                        keep_mu=scheme[0] == 'learnable')
    starts = []
    real_train = Trainer.train
    monkeypatch.setattr(Trainer, 'train', lambda self, *a, **k: (
        starts.append({n: v.clone() for n, v in
                       self.model.state_dict().items()}),
        real_train(self, *a, **k))[1])
    flags = ['--gate-type', scheme[0], '--gate-subtype', scheme[1],
             '--do-train', '--epochs', '1', '--device', 'cpu']
    with caplog.at_level(logging.INFO, logger='gltvae_torch.cli'):
        acc = cli.main(_cli_flags(tmp_path / 'h5', tmp_path / 'run',
                                  *flags))[0.5]
    assert 0.0 <= acc <= 1.0
    assert 'warm-started from' in caplog.text
    want = params_to_state_dict(params)
    if scheme[0] == 'fixed':
        want['mu'] = torch.eye(jm.z_classify, jm.y_dim)
    assert len(starts) == 1
    for k, v in starts[0].items():
        assert torch.equal(v, want[k]), k
    run = tmp_path / 'run' / ('params_0.5_learnable' if scheme[0] ==
                              'learnable' else 'params_0.5_fixed_one-one')
    assert os.path.isdir(run / 'checkpoints')


@pytest.fixture(scope='module')
def photos(tmp_path_factory):
    import PIL.Image
    d = tmp_path_factory.mktemp('photos')
    r = np.random.RandomState(0)
    for i in range(5):
        PIL.Image.fromarray(r.randint(0, 256, (218, 178, 3), dtype=np.uint8)
                            ).save(d / f'im{i}.jpg', quality=95)
    return d


@pytest.mark.parametrize('with_mu', [False, True])
def test_infer_h5_folder_matches_tools_infer(tmp_path, photos, monkeypatch,
                                             with_mu):
    """The same .h5 folder through both CLIs: probabilities within 1e-5;
    with --mu, a fixed/inferred folder that stores no μ .npy."""
    import gltvae.utils.compile_cache as cc
    monkeypatch.setattr(cc, 'enable_persistent_compilation_cache',
                        lambda *a, **k: None)
    jm, _ = jcfg.default_celeba64()
    extra = []
    if with_mu:
        jm = jm.__class__(**{**jm.__dict__, 'gate_type': 'fixed'})
        params = _h5_folder(tmp_path / 'h5', jm, seed=14, keep_mu=False)
        np.save(tmp_path / 'mu.npy', params['mu'])
        extra = ['--mu', str(tmp_path / 'mu.npy'), '--gate-type', 'fixed']
    else:
        _h5_folder(tmp_path / 'h5', jm, seed=14)
    probs = {'port': [], 'gltvae': []}
    real_write = tinfer.write_rows
    monkeypatch.setattr(tinfer, 'write_rows', lambda w, n, p: (
        probs['port'].append(p), real_write(w, n, p))[1])
    real_make = jinfer.make_predict

    def make_predict(*a, **k):
        fn = real_make(*a, **k)
        return lambda *b: (lambda out: (probs['gltvae'].append(
            np.asarray(out)), out)[1])(fn(*b))
    monkeypatch.setattr(jinfer, 'make_predict', make_predict)
    common = ['--checkpoint', str(tmp_path / 'h5'), '--images', str(photos),
              '--batch-size', '4', *extra]
    jinfer.main(common + ['--output', str(tmp_path / 'j.csv'),
                          '--platform', 'cpu'])
    tinfer.main(common + ['--output', str(tmp_path / 't.csv'),
                          '--device', 'cpu'])
    got = np.concatenate(probs['port'])
    want = np.concatenate(probs['gltvae'])[:len(got)]
    assert got.shape == (5, 18)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    head = [(tmp_path / f).read_text().splitlines()[0]
            for f in ('j.csv', 't.csv')]
    assert head[0] == head[1]
    if with_mu:
        os.remove(tmp_path / 'mu.npy')
        with pytest.raises(FileNotFoundError, match='pass mu='):
            tinfer.main(common[:6] + ['--output', str(tmp_path / 'x.csv'),
                                      '--device', 'cpu'])
