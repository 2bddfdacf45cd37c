"""The port's CLI on CelebA files: train.py's data path. On the same flags
its loaders give the batches train.py's ``make_loaders`` gives, and the
same μ init (tolerance 0); a training run writes the run folder; a
test-only rerun takes its data geometry from the recorded config."""

import json
import shutil

import numpy as np
import pytest
import torch

import train as jtrain

import gltvae_torch.config as tcfg
from gltvae_torch import cli
from gltvae_torch.data.synthetic import write_celeba_corpus

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('celeba')
    write_celeba_corpus(str(root), 32, 16, 16, seed=5)
    return root


def _flags(root, *extra):
    return ['--data-dir', str(root), '--split-file',
            'list_eval_partition.csv', '-bs', '16', '--num-workers', '2',
            *extra]


@pytest.mark.parametrize('extra', [
    ('--sup', '0.5'),
    ('--sup', '1.0', '--augment-pad', '2', '--decode-backend', 'pil'),
    ('--sup', '0.0', '--image-size', '128', '--cache-decoded'),
    ('--sup', '0.5', '--n-train', '24', '--n-valid', '16', '--n-test', '8',
     '--parity'),
], ids=['64px', 'augment_pil', '128px_cached', 'prefix_parity'])
def test_loaders_and_mu_equal_train_py(corpus, tmp_path, extra):
    """Each package reads its own copy of the corpus (the gating cache is
    written beside it)."""
    argv = _flags(corpus, *extra)
    if '--n-train' in extra:
        argv.remove('--split-file')
        argv.remove('list_eval_partition.csv')
    sup = float(extra[1])
    roots = {}
    for who in ('port', 'gltvae'):
        roots[who] = tmp_path / who
        shutil.copytree(corpus, roots[who])
    targs = cli.parse_args([a if a != str(corpus) else str(roots['port'])
                            for a in argv])
    jargs = jtrain.parse_args([a if a != str(corpus)
                               else str(roots['gltvae']) for a in argv])
    model_cfg, train_cfg = cli.build_configs(targs, sup)
    loaders, mu = cli.make_loaders(targs, model_cfg, train_cfg)
    jm, jt, jd = jtrain.build_configs(jargs, sup)
    jloaders, jmu, sharded = jtrain.make_loaders(jargs, jd, jt, jm.y_dim)
    td = cli.build_data_config(targs, model_cfg)
    assert {k: v for k, v in td.__dict__.items() if k != 'data_dir'} == \
        {k: v for k, v in jd.__dict__.items() if k != 'data_dir'}
    assert not sharded and mu.dtype == jmu.dtype and np.array_equal(mu, jmu)
    assert list(loaders) == list(jloaders)
    for m in jloaders:
        assert loaders[m].n_s == jloaders[m].n_s
        it, ij = iter(loaders[m]), iter(jloaders[m])
        for _ in range(jloaders[m].epoch_batches + 1):
            (x, y), (jx, jy) = next(it), next(ij)
            assert np.array_equal(x, jx) and np.array_equal(y, jy), m
        it.close()
    names = sorted(p.name for p in roots['port'].iterdir())
    assert names == sorted(p.name for p in roots['gltvae'].iterdir())
    assert any(n.startswith('gating_matrix_') for n in names)


def test_cli_trains_from_files_then_reruns_test_only(corpus, tmp_path):
    out = tmp_path / 'runs'
    data = tmp_path / 'data'
    shutil.copytree(corpus, data)
    res = cli.main(_flags(data, '--do-train', '--epochs', '1', '--sup',
                          '0.5', '--device', 'cpu', '--deterministic-eval',
                          '--output-dir', str(out)))
    run = out / 'params_0.5_learnable'
    result = json.loads((run / 'result.json').read_text())
    assert result['test_accuracy'] == pytest.approx(res[0.5])
    assert np.isfinite(result['test_accuracy'])
    assert result['device'] == 'cpu' and len(result['history']) == 1
    assert tcfg.load_model_config(str(run)) == tcfg.ModelConfig()
    for name in ('metrics.csv', 'learned_gating_matrix_best.npy',
                 'learned_gating_matrix_best.csv', 'gating_history.npz',
                 'model_config.json'):
        assert (run / name).exists(), name
    assert (data / 'gating_matrix_0.5.npy.sha256').exists()
    # a test-only rerun with a conflicting --image-size adopts the recorded
    # 64 px model and its data geometry, and keeps the training record; the
    # deterministic eval scores the restored best checkpoint as before
    res2 = cli.main(_flags(data, '--sup', '0.5', '--image-size', '128',
                           '--device', 'cpu', '--deterministic-eval',
                           '--output-dir', str(out)))
    assert res2[0.5] == pytest.approx(res[0.5])
    again = json.loads((run / 'result.json').read_text())
    assert again['history'] == result['history']
    assert tcfg.load_model_config(str(run)) == tcfg.ModelConfig()


def test_grain_backend_raises_naming_its_roadmap_item(corpus, tmp_path):
    data = tmp_path / 'data'
    shutil.copytree(corpus, data)
    with pytest.raises(NotImplementedError, match='ROADMAP Queue 1 item 8'):
        cli.main(_flags(data, '--do-train', '--epochs', '1', '--sup', '1.0',
                        '--decode-backend', 'grain', '--device', 'cpu',
                        '--output-dir', str(tmp_path / 'runs')))
