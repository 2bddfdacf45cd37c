"""The port's gating and metrics tools against the JAX package's tools on
the same files: ``gen_gating_matrix`` (the .npy and .csv byte for byte, at
18 and 40 labels), ``analyze_gating`` and ``metrics_summary`` (stdout
character for character; metrics.csv and gating_history.npz written by
the port's Trainer, and a seeded 15-epoch pair that takes the shortened
table)."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

import gltvae_torch.config as tcfg
from gltvae_torch import analyze_gating as t_analyze
from gltvae_torch import gen_gating_matrix as t_gen
from gltvae_torch import metrics_summary as t_metrics
from tools import analyze_gating as j_analyze
from tools import gen_gating_matrix as j_gen
from tools import metrics_summary as j_metrics

torch.set_num_threads(2)


def _stdout(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a, **k)
    return buf.getvalue()


def _jax_main(monkeypatch, module, argv):
    """A JAX tool's main, which reads sys.argv, on `argv`; its stdout."""
    monkeypatch.setattr(sys, 'argv', [module.__file__] + argv)
    return _stdout(module.main)


def _attr_csv(path, n=300, seed=0):
    """A Kaggle-layout attribute CSV of `n` rows of seeded ±1 labels, some
    rows all -1 (the co-occurrence's N⁺ excludes them)."""
    rng = np.random.RandomState(seed)
    vals = np.where(rng.rand(n, 40) < 0.3, 1, -1)
    vals[::17] = -1
    lines = ['image_id,' + ','.join(tcfg.CELEBA_LABELS)]
    lines += [f'{i + 1:06d}.jpg,' + ','.join(map(str, r))
              for i, r in enumerate(vals)]
    path.write_text('\n'.join(lines) + '\n')
    return str(path)


@pytest.mark.parametrize('all_labels', [False, True],
                         ids=['18_labels', '40_labels'])
def test_gen_gating_matrix_files_and_text_equal_the_jax_tool(
        monkeypatch, tmp_path, all_labels):
    csv_path = _attr_csv(tmp_path / 'list_attr_celeba.csv')
    flag = ['--all-labels'] if all_labels else []
    out = {}
    for side in ('jax', 'port'):
        d = tmp_path / side
        argv = ['--attr-csv', csv_path, '--out-dir', str(d)] + flag
        text = (_jax_main(monkeypatch, j_gen, argv) if side == 'jax'
                else _stdout(t_gen.main, argv))
        out[side] = (text.replace(str(d), 'OUT'),
                     (d / 'gating_matrix.npy').read_bytes(),
                     (d / 'gating_matrix.csv').read_bytes())
    assert out['port'] == out['jax']
    mu = np.load(tmp_path / 'port' / 'gating_matrix.npy')
    assert mu.shape == ((40, 40) if all_labels else (18, 18))


def _mu_files(root, sups, seed=0):
    """gating_matrix_<sup>.npy under root/data and the learned μ under
    root/models/params_<sup>_learnable, seeded, with gates on both sides
    of each threshold and one exactly at 0.6 (not above it)."""
    rng = np.random.RandomState(seed)
    for sup in sups:
        for path in (root / 'data' / f'gating_matrix_{sup}.npy',
                     root / 'models' / f'params_{sup}_learnable'
                     / 'learned_gating_matrix_best.npy'):
            mu = rng.rand(18, 18).astype(np.float32) ** 2
            np.fill_diagonal(mu, 1.0)
            mu[3, 5] = 0.6
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, mu)


@pytest.mark.parametrize('argv', [[], ['--sup', '0.5', '--threshold', '0.3'],
                                  ['--sup', '1.0', '0.2', '--threshold',
                                   '0.6']], ids=['defaults', 'sup0.5_t0.3',
                                                 'two_sups'])
def test_analyze_gating_prints_the_jax_tools_text(monkeypatch, tmp_path,
                                                  argv):
    _mu_files(tmp_path, (1.0, 0.5, 0.2))
    argv = ['--data-dir', str(tmp_path / 'data'), '--models-dir',
            str(tmp_path / 'models')] + argv
    want = _jax_main(monkeypatch, j_analyze, argv)
    got = _stdout(t_analyze.main, argv)
    assert got == want
    assert 'Learned Gating Matrix' in got and 'z_' in got


@pytest.fixture(scope='module')
def port_run(tmp_path_factory):
    """metrics.csv and gating_history.npz written by the port's Trainer: a
    tiny learnable model, 3 epochs at sup 0.5, a row every step."""
    from gltvae_torch.data.pipeline import BatchLoader
    from gltvae_torch.data.synthetic import synthetic_splits
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.train.loop import Trainer
    run_dir = tmp_path_factory.mktemp('metrics_run')
    model_cfg = tcfg.ModelConfig(image_size=16, z_dim=8, y_dim=4,
                                 enc_features=(8, 8), enc_hidden=16,
                                 dec_features=(16, 8))
    train_cfg = tcfg.TrainConfig(batch_size=8, perc_supervision=0.5,
                                 n_epochs=3, classifier_mc_samples=4,
                                 lr=1e-2)
    splits = synthetic_splits(n_train=32, n_valid=8, n_test=8,
                              sup_frac=0.5, image_size=16, y_dim=4)
    loaders = {k: BatchLoader(v, 8, seed=0) for k, v in splits.items()}
    tr = Trainer(model_cfg, train_cfg,
                 mu_init=cooccurrence_gating_matrix(splits['sup'].labels),
                 metrics_path=str(run_dir / 'metrics.csv'), device='cpu')
    tr.train(loaders, param_dir=str(run_dir), log_every=1)
    return run_dir / 'metrics.csv', run_dir / 'gating_history.npz'


def _long_run(tmp_path):
    """A 15-epoch metrics.csv (a repeated header row left by a resume) and
    a 15-epoch gating history: both tables take the '...' form."""
    rng = np.random.RandomState(1)
    cols = ['step', 'epoch', 'supervised'] + list(t_metrics.COLS) + ['time']
    lines = [','.join(cols)]
    for ep in range(15):
        for s in range(3):
            if ep == 7 and s == 0:
                lines.append(','.join(cols))
            lines.append(','.join([str(ep * 3 + s), str(ep), str(s % 2)]
                                  + [repr(float(v)) for v in
                                     rng.randn(len(t_metrics.COLS)) * 50]
                                  + ['0.0']))
    csv_path = tmp_path / 'metrics.csv'
    csv_path.write_text('\n'.join(lines) + '\n')
    npz = tmp_path / 'gating_history.npz'
    np.savez(npz, epochs=np.arange(15, dtype=np.int32),
             mu=rng.rand(15, 18, 18).astype(np.float32))
    return csv_path, npz


@pytest.mark.parametrize('source', ['port_trainer', 'seeded_15_epochs'])
@pytest.mark.parametrize('history', [False, True],
                         ids=['csv', 'csv_and_gating_history'])
def test_metrics_summary_prints_the_jax_tools_text(monkeypatch, tmp_path,
                                                   port_run, source,
                                                   history):
    csv_path, npz = (port_run if source == 'port_trainer'
                     else _long_run(tmp_path))
    argv = [str(csv_path)] + (['--gating-history', str(npz)] if history
                              else [])
    want = _jax_main(monkeypatch, j_metrics, argv)
    got = _stdout(t_metrics.main, argv)
    assert got == want
    assert ('gating history:' in got) == history


def test_metrics_summary_plot_writes_both_pngs(tmp_path, port_run):
    pytest.importorskip('matplotlib')
    csv_path, npz = port_run
    png = tmp_path / 'curves.png'
    out = _stdout(t_metrics.main, [str(csv_path), '--plot', str(png),
                                   '--gating-history', str(npz)])
    gating = tmp_path / 'curves_gating.png'
    assert f'wrote {png}' in out and f'wrote {gating}' in out
    for p in (png, gating):
        assert p.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'


def test_metrics_summary_plot_without_matplotlib_raises(monkeypatch,
                                                        port_run):
    """--plot without matplotlib fails loudly before printing anything."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(ImportError, match='--plot needs matplotlib'):
        t_metrics.main([str(port_run[0]), '--plot', os.devnull])
    assert buf.getvalue() == ''
