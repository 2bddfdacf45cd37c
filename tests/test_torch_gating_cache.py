"""The gating-matrix npy cache of gltvae_torch.ops.gating against
gltvae.ops.gating: the same files, byte for byte (tolerance 0), and the
same decisions on unmarked, mismatched and stale caches."""

import numpy as np
import pytest

from gltvae.ops import gating as jg

from gltvae_torch.config import CELEBA_EASY_LABELS, CELEBA_LABELS
from gltvae_torch.ops import gating as tg


def _labels(y, n=50, seed=0):
    r = np.random.RandomState(seed)
    return ((r.rand(n, y) > 0.6).astype(np.int64),
            (r.rand(n // 2, y) > 0.6).astype(np.int64))


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize('y,names,sup', [(18, CELEBA_EASY_LABELS, 0.5),
                                         (40, CELEBA_LABELS, 0.5),
                                         (18, CELEBA_EASY_LABELS, 0.0),
                                         (40, CELEBA_LABELS, 1.0)])
def test_cache_files_byte_equal(tmp_path, y, names, sup):
    """A fresh computation writes {stem}.npy, .npy.sha256 and .csv; the
    stem carries the width except at 18 labels; both packages' files are
    equal byte for byte, and each package reads the other's back."""
    sup_l, val_l = _labels(y)
    (tmp_path / 'j').mkdir()
    (tmp_path / 't').mkdir()
    mj = jg.gating_matrix_from_labels(sup_l, val_l, y, sup,
                                      cache_dir=str(tmp_path / 'j'),
                                      label_names=names)
    mt = tg.gating_matrix_from_labels(sup_l, val_l, y, sup,
                                      cache_dir=str(tmp_path / 't'),
                                      label_names=names)
    assert mt.dtype == mj.dtype and np.array_equal(mt, mj)
    stem = f'gating_matrix_{sup}' + ('' if y == 18 else f'_{y}')
    fj, ft = _files(tmp_path / 'j'), _files(tmp_path / 't')
    assert sorted(ft) == [f'{stem}.csv', f'{stem}.npy', f'{stem}.npy.sha256']
    assert ft == fj
    # each reads the other's marked cache back without recomputing
    for mod, d in ((tg, 'j'), (jg, 't')):
        got = mod.gating_matrix_from_labels(None, None, y, sup,
                                            cache_dir=str(tmp_path / d))
        assert np.array_equal(got, mj)


def test_csv_equals_pandas_on_awkward_values(tmp_path):
    """The CSV writer against pandas.to_csv on values whose text form is
    not plain: tiny, huge, negative, integral, float32."""
    import pandas as pd
    mu = np.array([[1e-20, 0.1, 1.0 / 3], [2.5e17, -0.0, 7.0],
                   [np.nextafter(0.5, 1), 123456.789, 5e-324]])
    names = ['a', 'b,c', 'd']
    for arr in (mu, mu.astype(np.float32)):
        index = [f'z{i + 1}' for i in range(3)]
        pd.DataFrame(arr, index=index, columns=names).to_csv(
            tmp_path / 'pd.csv')
        tg.save_labeled_csv(arr, names, str(tmp_path / 'port.csv'))
        assert (tmp_path / 'port.csv').read_bytes() == \
            (tmp_path / 'pd.csv').read_bytes()


def _place_unmarked(d, mu, y=18, sup=0.5):
    stem = f'gating_matrix_{sup}' + ('' if y == 18 else f'_{y}')
    np.save(d / f'{stem}.npy', mu)
    return d / f'{stem}.npy'


@pytest.mark.parametrize('pkg', ['port', 'gltvae'])
def test_unmarked_cache_that_agrees_is_adopted_and_marked(tmp_path, pkg):
    mod = tg if pkg == 'port' else jg
    sup_l, val_l = _labels(18)
    mu = jg.cooccurrence_gating_matrix(np.concatenate([sup_l, val_l]))
    npy = _place_unmarked(tmp_path, mu)
    got = mod.gating_matrix_from_labels(sup_l, val_l, 18, 0.5,
                                        cache_dir=str(tmp_path))
    assert np.array_equal(got, mu)
    assert (tmp_path / 'gating_matrix_0.5.npy.sha256').exists()
    assert not (tmp_path / 'gating_matrix_0.5.csv').exists()
    assert np.array_equal(np.load(npy), mu)


def test_unmarked_paths_equal_gltvae(tmp_path, caplog):
    """Agreeing, mismatched and stale-shaped unmarked caches: the port
    returns what gltvae returns and leaves the same files."""
    sup_l, val_l = _labels(18)
    fresh = jg.cooccurrence_gating_matrix(np.concatenate([sup_l, val_l]))
    cases = {'agrees': fresh, 'mismatch': np.full((18, 18), 0.25),
             'stale_shape': np.full((40, 40), 0.25)}
    for name, cached in cases.items():
        out = {}
        for pkg, mod in (('t', tg), ('j', jg)):
            d = tmp_path / name / pkg
            d.mkdir(parents=True)
            _place_unmarked(d, cached)
            caplog.clear()
            out[pkg] = (mod.gating_matrix_from_labels(
                sup_l, val_l, 18, 0.5, cache_dir=str(d),
                label_names=CELEBA_EASY_LABELS), _files(d),
                [r.levelname for r in caplog.records])
        assert np.array_equal(out['t'][0], out['j'][0]), name
        assert out['t'][1] == out['j'][1], name
        assert out['t'][2] == out['j'][2], name
        want = {'agrees': fresh, 'mismatch': cached,
                'stale_shape': fresh}[name]
        assert np.array_equal(out['t'][0], want), name
        assert ('WARNING' in out['t'][2]) == (name != 'agrees'), name


def test_a_tampered_marked_cache_is_verified_again(tmp_path):
    """A sidecar that no longer matches the npy makes the cache unmarked:
    it is checked against a fresh computation, in both packages."""
    sup_l, val_l = _labels(18)
    for mod, d in ((tg, tmp_path / 't'), (jg, tmp_path / 'j')):
        d.mkdir()
        mod.gating_matrix_from_labels(sup_l, val_l, 18, 0.5,
                                      cache_dir=str(d))
        np.save(d / 'gating_matrix_0.5.npy', np.full((18, 18), 0.25))
        got = mod.gating_matrix_from_labels(sup_l, val_l, 18, 0.5,
                                            cache_dir=str(d))
        assert np.array_equal(got, np.full((18, 18), 0.25))
    assert _files(tmp_path / 't') == _files(tmp_path / 'j')


def test_no_cache_dir_equals_gltvae():
    sup_l, val_l = _labels(7)
    for sup in (0.0, 0.5, 1.0):
        s = None if sup == 0.0 else sup_l
        assert np.array_equal(
            tg.gating_matrix_from_labels(s, val_l, 7, sup),
            jg.gating_matrix_from_labels(s, val_l, 7, sup))
