"""``gltvae_torch.eval_reference_checkpoints`` against
tools/eval_reference_checkpoints.py: run-folder names, the μ fallback, and
a seeded set of .h5 checkpoint folders (written by gltvae's own
``export_reference_checkpoint``) scored by both tools on one JPEG corpus.

Both tools' ``Trainer.test`` is stochastic by default, with draws that
torch cannot replay (threefry), so the scoring test forces deterministic
eval on both sides (``TrainConfig(deterministic_eval=True)`` through each
package's ``TrainConfig``): mean z and expected gates, the same function
of the same weights. A learnable folder without its μ .npy gives the
same error record on both sides."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import gltvae.config as jcfg
import gltvae_torch.config as tcfg
from gltvae_torch import eval_reference_checkpoints as T
from tests.test_torch_config_bridge import jax_params
from tools import eval_reference_checkpoints as J

torch.set_num_threads(2)

NAMES = ['params_1.0_learnable', 'params_0.5_learnable',
         'params_0.2_learnable', 'params_1.0_fixed_one-one',
         'params_0.5_fixed_one-one', 'params_0.2_fixed_one-one',
         'params_1.0_fixed_inferred', 'params_0.5_fixed_inferred',
         'params_0.2_fixed_inferred', 'params_0.2_0.5_learnable',
         'params_0.2_0.5_fixed_inferred', 'params_0.2_0.5_fixed_one-one',
         'notes.txt', 'params_1.0_learnable.log', 'params__learnable',
         'params_1.0_fixed']


@pytest.mark.parametrize('name', NAMES)
def test_parse_run_dir_equals_the_jax_tool(name):
    assert T.parse_run_dir(name) == J.parse_run_dir(name)


def test_parse_run_dir_shipped_names():
    """The JAX tool's own expectations (tests/test_eval_reference_ckpts.py)
    hold for the port."""
    assert T.parse_run_dir('params_1.0_learnable') == \
        ('1.0', 'learnable', 'inferred')
    assert T.parse_run_dir('params_0.2_fixed_one-one') == \
        ('0.2', 'fixed', 'one-one')
    assert T.parse_run_dir('params_0.2_0.5_learnable') == \
        ('0.5', 'learnable', 'inferred')
    assert T.parse_run_dir('notes.txt') is None


@pytest.mark.parametrize('gate', [('learnable', 'inferred'),
                                  ('fixed', 'one-one'),
                                  ('fixed', 'inferred')])
@pytest.mark.parametrize('sup', ['1.0', '0.5'])
def test_mu_for_equals_the_jax_tool(tmp_path, gate, sup):
    """μ of each mode: None, the identity, the data folder's cache (present
    for sup 0.5 only; both raise the same error without it)."""
    models = tmp_path / 'models'
    models.mkdir()
    (tmp_path / 'data').mkdir()
    np.save(tmp_path / 'data' / 'gating_matrix_0.5.npy',
            np.random.RandomState(0).rand(18, 18))
    try:
        want = J.mu_for(str(models), sup, *gate)
    except FileNotFoundError as e:
        with pytest.raises(FileNotFoundError, match=str(e)):
            T.mu_for(str(models), sup, *gate)
        return
    got = T.mu_for(str(models) + '/', sup, *gate)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """models/ with four .h5 checkpoint folders and a log file, data/ with
    the fixed-inferred μ cache, and a 16-image corpus (the parity corpus,
    8/4/4)."""
    from gltvae.utils.h5_export import export_reference_checkpoint
    from tools.parity_corpus import generate_corpus
    root = tmp_path_factory.mktemp('ref_ckpts')
    corpus = root / 'corpus'
    generate_corpus(str(corpus), n=16, seed=3)
    rng = np.random.RandomState(7)
    cache = rng.rand(18, 18).astype(np.float32)
    np.fill_diagonal(cache, 1.0)
    (root / 'data').mkdir()
    np.save(root / 'data' / 'gating_matrix_0.5.npy', cache)
    learned = rng.rand(18, 18).astype(np.float32)
    folders = {'params_1.0_learnable': (learned, True, 1),
               'params_0.5_fixed_inferred': (cache, False, 2),
               'params_0.2_fixed_one-one': (np.eye(18, dtype=np.float32),
                                            False, 3),
               'params_0.5_learnable': (learned, False, 4)}   # broken
    for name, (mu, keep_mu, seed) in folders.items():
        d = root / 'models' / name
        export_reference_checkpoint(jax_params(jcfg.ModelConfig(), mu,
                                               seed=seed), str(d))
        if not keep_mu:
            os.remove(d / 'learned_gating_matrix_best.npy')
    (root / 'models' / 'params_0.2_0.5_fixed_inferred').write_text('log\n')
    return root, corpus


def test_reference_checkpoints_score_as_in_the_jax_tool(monkeypatch,
                                                        checkpoints,
                                                        capsys):
    root, corpus = checkpoints
    for mod in (jcfg, tcfg):
        monkeypatch.setattr(mod, 'TrainConfig', functools.partial(
            mod.TrainConfig, deterministic_eval=True))
    common = ['--models-dir', str(root / 'models'), '--data-dir',
              str(corpus), '--n-train', '8', '--n-valid', '4', '--n-test',
              '4', '--batch-size', '4']
    out = {}
    for side in ('jax', 'port'):
        js = root / f'{side}.json'
        if side == 'jax':
            J.main(common + ['--out-json', str(js), '--platform', 'cpu'])
        else:
            T.main(common + ['--out-json', str(js), '--device', 'cpu'])
        out[side] = (json.loads(js.read_text()), capsys.readouterr().out)
    (want, want_text), (got, got_text) = out['jax'], out['port']
    assert sorted(got) == sorted(want) == [
        'params_0.2_fixed_one-one', 'params_0.5_fixed_inferred',
        'params_0.5_learnable', 'params_1.0_learnable']
    assert got['params_0.5_learnable'] == want['params_0.5_learnable']
    assert 'no learned gating matrix' in got['params_0.5_learnable']['error']
    for name, rec in want.items():
        if 'error' in rec:
            continue
        assert {k: v for k, v in got[name].items() if k != 'test_accuracy'} \
            == {k: v for k, v in rec.items() if k != 'test_accuracy'}
        assert abs(got[name]['test_accuracy'] - rec['test_accuracy']) \
            <= 1e-6, name
    assert got_text == want_text


def test_one_set_of_loaders_serves_every_folder(checkpoints):
    """One set of loaders serves every folder (the tool's sweep); the
    default device is cuda."""
    root, corpus = checkpoints
    cfg = dataclasses.replace(tcfg.DataConfig(), data_dir=str(corpus),
                              n_train=8, n_valid=4, n_test=4, num_workers=0)
    loaders = T.make_loaders(cfg, 4)
    accs = [T.evaluate_checkpoint(str(root / 'models' / name), mu, cfg, 4,
                                  loaders=loaders, device='cpu')
            for name, mu in (('params_1.0_learnable', None),
                             ('params_0.2_fixed_one-one',
                              np.eye(18, dtype=np.float32)))]
    assert all(0.0 <= a <= 1.0 for a in accs)
    if not torch.cuda.is_available():      # the default device is cuda
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.evaluate_checkpoint(
                str(root / 'models' / 'params_1.0_learnable'), None, cfg, 4,
                loaders=loaders)
