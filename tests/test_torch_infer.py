"""gltvae_torch.infer against tools/infer.py on the same params (the
bridge): probabilities to 1e-5 (f32 summation order; both sides run the
same encoder and classifier), stochastic with gltvae's draws injected, the
same CSV layout, and a round trip through the port's checkpoint folder."""

import csv
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.ops.sampling import sample_gumbel
from tests.test_torch_config_bridge import (jax_params, scheme_mu,
                                            small_configs, torch_model)
from tools import infer as jinfer

import gltvae_torch.config as tcfg
from gltvae_torch import infer as tinfer
from gltvae_torch.train.checkpoint import CheckpointManager
from gltvae_torch.train.state import create_train_state

torch.set_num_threads(2)

TOL = 1e-5


def _models(name):
    if name == 'small':
        jm, tm = small_configs()
    else:
        jm, _ = jcfg.default_celeba64()
        tm, _ = tcfg.default_celeba64()
    params = jax_params(jm, scheme_mu(jm), seed=3)
    return jm, JCCVAE(jm), torch_model(tm, params).eval(), params


def _batch(size, n=6, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               dtype=np.uint8)


def _gltvae_noise(key, B, z_dim, mu_shape):
    """The draws tools/infer.py's make_predict takes from `key`."""
    key_z, key_gate = jax.random.split(key)
    k1, k2 = jax.random.split(key_gate)
    f = lambda a: torch.from_numpy(np.array(a, np.float32))
    return {'eps_z': f(jax.random.normal(key_z, (B, z_dim))),
            'g1': f(sample_gumbel(k1, mu_shape)),
            'g2': f(sample_gumbel(k2, mu_shape))}


@pytest.mark.parametrize('name', ['small', 'celeba64'])
@pytest.mark.parametrize('stochastic', [False, True])
def test_predict_equals_make_predict(name, stochastic):
    jm, jmodel, port, params = _models(name)
    x = _batch(jm.image_size)
    key = jax.random.fold_in(jax.random.key(0), 1)
    want = np.asarray(jinfer.make_predict(jmodel, stochastic, 0.3)(
        params, x, key))
    noise = (_gltvae_noise(key, len(x), jm.z_dim, params['mu'].shape)
             if stochastic else None)
    got = tinfer.make_predict(port, stochastic, 0.3)(torch.from_numpy(x),
                                                     noise=noise)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    if stochastic:          # the draws matter: deterministic differs
        det = tinfer.make_predict(port, False, 0.3)(torch.from_numpy(x))
        assert not torch.allclose(det, got, atol=1e-3)


@pytest.fixture(scope='module')
def photos(tmp_path_factory):
    import PIL.Image
    d = tmp_path_factory.mktemp('photos')
    r = np.random.RandomState(0)
    for i in range(5):
        PIL.Image.fromarray(r.randint(0, 256, (218, 178, 3), dtype=np.uint8)
                            ).save(d / f'im{i}.jpg', quality=95)
    PIL.Image.fromarray(r.randint(0, 256, (218, 178), dtype=np.uint8),
                        mode='L').save(d / 'gray.png')
    PIL.Image.fromarray(r.randint(0, 256, (218, 178, 4), dtype=np.uint8),
                        mode='RGBA').save(d / 'rgba.PNG')
    (d / 'notes.txt').write_text('not an image')
    return d


def _port_run(tmp_path, tm, params, steps=(3, 7), metrics=(0.9, 0.1)):
    """A port run folder: model_config.json and checkpoints at `steps`, the
    first with the best metric; the last checkpoint's params are the given
    ones plus 1."""
    run = tmp_path / 'run'
    run.mkdir()
    tcfg.save_model_config(tm, str(run))
    model = torch_model(tm, params)
    state = create_train_state(model, tcfg.TrainConfig())
    mgr = CheckpointManager(str(run / 'checkpoints'))
    for i, (step, m) in enumerate(zip(steps, metrics)):
        if i:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        state.step = step
        mgr.save(state, metrics={'val_accuracy': m})
    return run


def _read(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


@pytest.mark.parametrize('stochastic', [False, True])
def test_csv_follows_tools_infer(tmp_path, photos, monkeypatch, stochastic):
    """The port's CLI on a port run folder and tools/infer.py's on the same
    params (its checkpoint loader replaced by the bridge's pytree): the
    same header, ids and cell formats. Deterministic: probabilities within
    1e-4 after the 4-decimal rounding, the same hard labels wherever
    |p - 0.5| > 1e-4, and a rerun byte-identical. Stochastic: the two draw
    from different generators (the values are held with gltvae's draws
    injected in test_predict_equals_make_predict)."""
    jm, tm = small_configs()
    params = jax_params(jm, scheme_mu(jm), seed=3)
    run = _port_run(tmp_path, tm, params)
    monkeypatch.setattr(jinfer, 'load_params', lambda args, model: params)
    import gltvae.utils.compile_cache as cc
    monkeypatch.setattr(cc, 'enable_persistent_compilation_cache',
                        lambda *a, **k: None)
    extra = ['--stochastic'] if stochastic else []
    common = ['--checkpoint', str(run), '--images', str(photos),
              '--batch-size', '3', *extra]
    jinfer.main(common + ['--output', str(tmp_path / 'j.csv'),
                          '--platform', 'cpu'])
    out = tinfer.main(common + ['--output', str(tmp_path / 't.csv'),
                                '--device', 'cpu'])
    assert out == str(tmp_path / 't.csv')
    t, j = _read(tmp_path / 't.csv'), _read(tmp_path / 'j.csv')
    names = list(tcfg.CELEBA_LABELS)[:tm.y_dim]
    assert t[0] == j[0] == (['image_id'] + names
                            + [f'p_{n}' for n in names])
    assert len(t) == len(j) == 8
    assert [r[0] for r in t[1:]] == sorted(
        ['gray.png', 'rgba.PNG'] + [f'im{i}.jpg' for i in range(5)])
    y = tm.y_dim
    for rt, rj in zip(t[1:], j[1:]):
        assert rt[0] == rj[0]
        pt = np.array([float(v) for v in rt[1 + y:]])
        pj = np.array([float(v) for v in rj[1 + y:]])
        assert all(len(v.split('.')[1]) == 4 for v in rt[1 + y:])
        assert ((0 <= pt) & (pt <= 1)).all()
        ht, hj = np.array(rt[1:1 + y], int), np.array(rj[1:1 + y], int)
        # p > 0.5 before the rounding to 4 decimals
        assert np.array_equal(ht, (pt > 0.5) | ((pt == 0.5) & (ht == 1)))
        if stochastic:
            continue
        assert np.abs(pt - pj).max() <= 1e-4 + 1e-9
        sure = np.abs(pj - 0.5) > 1e-4
        assert np.array_equal(ht[sure], hj[sure])
    if not stochastic:
        tinfer.main(common + ['--output', str(tmp_path / 't2.csv'),
                              '--device', 'cpu'])
        assert (tmp_path / 't2.csv').read_bytes() == \
            (tmp_path / 't.csv').read_bytes()


def test_checkpoint_round_trip_best_and_last(tmp_path):
    jm, tm = small_configs()
    params = jax_params(jm, scheme_mu(jm), seed=3)
    run = _port_run(tmp_path, tm, params)
    args = tinfer.parse_args(['--checkpoint', str(run), '--images', '.'])
    cfg = tinfer.resolve_model_config(args)
    assert cfg == tm
    best = tinfer.load_model(args, cfg, torch.device('cpu'))
    want = torch_model(tm, params).state_dict()
    for k, v in best.state_dict().items():
        assert torch.equal(v, want[k]), k
    args.model_id = 'last'
    last = tinfer.load_model(args, cfg, torch.device('cpu'))
    for k, v in last.state_dict().items():
        assert torch.equal(v, want[k] + 1.0), k


def test_model_config_from_flags_and_recorded_notes(tmp_path, capsys):
    args = tinfer.parse_args(['--checkpoint', str(tmp_path), '--images', '.',
                              '--image-size', '128', '--gate-type', 'fixed',
                              '--z-dim', '120'])
    cfg = tinfer.resolve_model_config(args)
    want = dataclasses.replace(tcfg.celeba128()[0], gate_type='fixed',
                               z_dim=120)
    assert cfg == want
    assert jinfer.resolve_model_config(args).__dict__ == want.__dict__
    tcfg.save_model_config(tcfg.ModelConfig(), str(tmp_path))
    assert tinfer.resolve_model_config(args) == tcfg.ModelConfig()
    assert 'ignoring the conflicting CLI value 128' in capsys.readouterr().out


def test_unported_options_raise(tmp_path, photos):
    """--mesh, once unported, now runs (a mesh of one here; two ranks in
    tests/test_torch_dp_infer.py) up to the missing checkpoint; a folder of
    *_best.h5 files is read as a reference checkpoint
    (tests/test_torch_warm_start.py), here an empty file that h5py
    refuses; a folder with neither exits with a message."""
    base = ['--images', str(photos), '--device', 'cpu']
    with pytest.raises(SystemExit, match='no checkpoints/'):
        tinfer.main(['--checkpoint', str(tmp_path), '--mesh'] + base)
    (tmp_path / 'encoder_model_best.h5').write_bytes(b'')
    with pytest.raises(OSError):
        tinfer.main(['--checkpoint', str(tmp_path)] + base)
    os.remove(tmp_path / 'encoder_model_best.h5')
    with pytest.raises(SystemExit, match='no checkpoints/'):
        tinfer.main(['--checkpoint', str(tmp_path)] + base)
