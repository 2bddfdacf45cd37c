"""The port's Keras .h5 interchange (utils/h5_import, utils/h5_export) and
μ export against gltvae's, in both directions, bit for bit.

Every .h5 file is written here from seeded params: by the port's exporter
(read back by gltvae's importer) or by gltvae's (read by the port's). The
files' attributes are held equal, and the μ CSV byte-equal to gltvae's
``export_gating_matrix`` (it once differed in float format and line
ends)."""

import builtins
import os

import h5py
import jax
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.train.checkpoint import export_gating_matrix as j_export_mu
from gltvae.utils import h5_export as jexp
from gltvae.utils import h5_import as jimp
from tests.test_torch_config_bridge import (SCHEMES, jax_params, scheme_mu,
                                            small_configs, torch_model)

import gltvae_torch.config as tcfg
from gltvae_torch.bridge import params_to_state_dict, state_dict_to_params
from gltvae_torch.train.checkpoint import export_gating_matrix as t_export_mu
from gltvae_torch.utils import h5_export as texp
from gltvae_torch.utils import h5_import as timp

torch.set_num_threads(2)

FILES = ('encoder_model', 'decoder_model', 'classifier', 'cond_prior')


def _configs(name):
    if name == 'small':
        return small_configs()
    jm, _ = getattr(jcfg, name)()
    tm, _ = getattr(tcfg, name)()
    return jm, tm


def _assert_tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        assert np.array_equal(x, y)


def _attrs(path):
    """Every attribute of an .h5 file, by group, and its dataset paths."""
    out, datasets = {}, {}
    with h5py.File(path, 'r') as f:
        def visit(name, obj):
            if hasattr(obj, 'shape'):
                datasets[name] = (obj.shape, obj.dtype.str)
            else:
                out[name] = {k: np.asarray(v).tolist()
                             for k, v in obj.attrs.items()}
        out['/'] = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}
        f.visititems(visit)
    return out, datasets


@pytest.mark.parametrize('name', ['small', 'default_celeba64', 'celeba128'])
def test_port_export_reads_back_in_gltvae(tmp_path, name):
    jm, tm = _configs(name)
    params = jax_params(jm, scheme_mu(jm), seed=7)
    model = torch_model(tm, params)
    texp.export_reference_checkpoint(model, str(tmp_path / 'port'), 'best')
    back = jimp.load_reference_checkpoint(str(tmp_path / 'port'), 'best')
    _assert_tree_equal(jax.device_get(back),
                       state_dict_to_params(model.state_dict()))
    # and the port reads its own files back to the same state_dict
    sd = timp.load_reference_checkpoint(str(tmp_path / 'port'))
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize('name', ['small', 'default_celeba64', 'celeba128'])
def test_gltvae_export_imports_to_the_same_state_dict(tmp_path, name):
    jm, tm = _configs(name)
    params = jax_params(jm, scheme_mu(jm), seed=8)
    jexp.export_reference_checkpoint(params, str(tmp_path), 'last')
    sd = timp.load_reference_checkpoint(str(tmp_path), 'last')
    want = params_to_state_dict(params)
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], v), k
    torch_model(tm, params).load_state_dict(sd, strict=True)


@pytest.mark.parametrize('label_names', [None, 'names'])
def test_files_and_attributes_equal_gltvae(tmp_path, label_names):
    """Same files, attributes (layer_names, weight_names, keras_version,
    backend), dataset paths, shapes and bytes of data; μ .npy (and .csv
    with label names) byte-equal."""
    jm, tm = small_configs()
    params = jax_params(jm, scheme_mu(jm), seed=9)
    names = list(jcfg.CELEBA_LABELS)[:jm.y_dim] if label_names else None
    jexp.export_reference_checkpoint(params, str(tmp_path / 'j'), 'best',
                                     label_names=names)
    texp.export_reference_checkpoint(torch_model(tm, params).state_dict(),
                                     str(tmp_path / 't'), 'best',
                                     label_names=names)
    assert sorted(os.listdir(tmp_path / 'j')) == \
        sorted(os.listdir(tmp_path / 't'))
    for stem in FILES:
        j, t = (tmp_path / d / f'{stem}_best.h5' for d in ('j', 't'))
        assert _attrs(j) == _attrs(t), stem
        root = _attrs(t)[0]['/']
        assert root['keras_version'] == '2.8.0'
        assert root['backend'] == 'tensorflow'
        with h5py.File(j, 'r') as fj, h5py.File(t, 'r') as ft:
            assert fj.attrs['layer_names'].dtype == \
                ft.attrs['layer_names'].dtype
            for k in _attrs(j)[1]:
                assert np.asarray(fj[k]).tobytes() == \
                    np.asarray(ft[k]).tobytes()
    for f in os.listdir(tmp_path / 'j'):
        if not f.endswith('.h5'):
            assert (tmp_path / 'j' / f).read_bytes() == \
                (tmp_path / 't' / f).read_bytes(), f


@pytest.mark.parametrize('shape', [(18, 18), (40, 40), (45, 18)])
def test_mu_csv_byte_equal_to_gltvae(tmp_path, shape):
    """F1: the μ CSV the Trainer and the exporter write, byte-equal to
    gltvae's pandas.to_csv, for 18- and 40-column μ (awkward values: tiny,
    negative, exactly 1, f32 values with long reprs)."""
    rng = np.random.RandomState(shape[1])
    mu = rng.rand(*shape).astype(np.float32)
    mu[0, :3] = [1.0, 1e-6, -0.5]
    mu[1, 0] = np.float32(0.1)
    names = (list(jcfg.CELEBA_EASY_LABELS) if shape[1] == 18
             else list(jcfg.CELEBA_LABELS))
    j_export_mu(mu, str(tmp_path / 'j'), 'best', names)
    t_export_mu(torch.from_numpy(mu), str(tmp_path / 't'), 'best', names)
    for ext in ('csv', 'npy'):
        f = f'learned_gating_matrix_best.{ext}'
        assert (tmp_path / 'j' / f).read_bytes() == \
            (tmp_path / 't' / f).read_bytes(), ext
    assert b'\r\n' not in (tmp_path / 't' /
                           'learned_gating_matrix_best.csv').read_bytes()


@pytest.mark.parametrize('scheme', SCHEMES, ids=lambda s: '/'.join(s))
def test_mu_from_npy_or_argument_or_error(tmp_path, scheme):
    """A folder without the μ .npy (as fixed gate schemes write it) takes
    mu=, and raises FileNotFoundError without it, as gltvae's importer."""
    jm, tm = small_configs(*scheme)
    params = jax_params(jm, scheme_mu(jm), seed=10)
    texp.export_reference_checkpoint(torch_model(tm, params), str(tmp_path))
    sd = timp.load_reference_checkpoint(str(tmp_path))
    assert torch.equal(sd['mu'], torch.from_numpy(params['mu']))
    os.remove(tmp_path / 'learned_gating_matrix_best.npy')
    for mod in (timp, jimp):
        with pytest.raises(FileNotFoundError, match='pass mu='):
            mod.load_reference_checkpoint(str(tmp_path))
    mu = np.eye(jm.z_classify, jm.y_dim, dtype=np.float64) * 0.5
    sd = timp.load_reference_checkpoint(str(tmp_path), mu=mu)
    assert sd['mu'].dtype == torch.float32
    np.testing.assert_array_equal(
        sd['mu'].numpy(), np.asarray(jimp.load_reference_checkpoint(
            str(tmp_path), mu=mu)['mu']))


def test_ordered_layers_sorts_numerically():
    w = {f'{n}/kernel': None for n in
         ('dense_10', 'dense', 'dense_2', 'dense_1', 'conv2d_transpose',
          'conv2d_3', 'conv2d', 'dense_x')}
    for prefix in ('dense', 'conv2d', 'conv2d_transpose'):
        assert timp._ordered_layers(w, prefix) == \
            jimp._ordered_layers(w, prefix)
    assert timp._ordered_layers(w, 'dense') == ['dense', 'dense_1',
                                                'dense_2', 'dense_10']
    assert timp._ordered_layers(w, 'conv2d') == ['conv2d', 'conv2d_3']


def test_missing_h5py_names_it(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == 'h5py':
            raise ImportError('No module named h5py')
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, '__import__', no_h5py)
    with pytest.raises(ImportError, match='h5py'):
        timp.load_reference_checkpoint(str(tmp_path))
    jm, tm = small_configs()
    with pytest.raises(ImportError, match='h5py'):
        texp.export_reference_checkpoint(
            torch_model(tm, jax_params(jm, scheme_mu(jm))), str(tmp_path))
