"""The port's serving artifacts (utils/serving.py, ``python -m
gltvae_torch.export_serving``) against the live model and gltvae's
``jax.export`` artifact on the same params.

An artifact saved to a file and loaded back must equal the live model's
``predict_probs(x / 255, deterministic=True)`` within 1e-5 at two batch
sizes (one program serves every b), and gltvae's serving program within
1e-5; the reconstruct artifact likewise. The CPU exports on the CPU: a
torch artifact keeps its weights on the device it was exported from."""

import io

import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.utils import serving as jserving
from tests.test_torch_config_bridge import jax_params, scheme_mu, torch_model

import gltvae_torch.config as tcfg
from gltvae_torch import export_serving
from gltvae_torch.models.ccvae import Temps
from gltvae_torch.ops.preprocess import dequant
from gltvae_torch.train.checkpoint import CheckpointManager
from gltvae_torch.train.state import create_train_state
from gltvae_torch.utils import serving

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(scope='module')
def models():
    jm, _ = jcfg.default_celeba64()
    tm, _ = tcfg.default_celeba64()
    params = jax_params(jm, scheme_mu(jm), seed=21)
    return JCCVAE(jm), params, torch_model(tm, params).eval()


def _u8(b, seed=0, size=64):
    return np.random.RandomState(seed).randint(0, 256, (b, size, size, 3),
                                               dtype=np.uint8)


@torch.no_grad()
def _live(model, u8):
    return model.predict_probs(dequant(torch.from_numpy(u8), 'div'),
                               Temps(gating=1.0), deterministic=True)


def test_predict_artifact_round_trip(models, tmp_path):
    jmodel, params, port = models
    path = tmp_path / 'model.pt2'
    path.write_bytes(serving.export_predict(port))
    fn = serving.load_serving(str(path))
    jfn = jserving.load_serving(jserving.export_predict(
        jmodel, params, platforms=('cpu',)))
    for b in (1, 7):
        u8 = _u8(b, seed=b)
        got = fn(torch.from_numpy(u8))
        assert got.shape == (b, 18) and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), _live(port, u8).numpy(),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn.call(u8)),
                                   rtol=0, atol=TOL)


def test_reconstruct_artifact(models):
    jmodel, params, port = models
    fn = serving.load_serving(serving.export_reconstruct(port))
    jfn = jserving.load_serving(jserving.export_reconstruct(
        jmodel, params, platforms=('cpu',)))
    for b in (2, 5):
        u8 = _u8(b, seed=10 + b)
        got = fn(torch.from_numpy(u8))
        assert got.shape == u8.shape
        with torch.no_grad():
            live = port.reconstruct(dequant(torch.from_numpy(u8), 'div'))
        np.testing.assert_allclose(got.numpy(), live.numpy(), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn.call(u8)),
                                   rtol=0, atol=TOL)


def test_artifact_divides_by_a_tensor(models):
    """The program's dequant is the divide form, by a 0-d tensor buffer
    (not a Python scalar, which CUDA turns into a multiply)."""
    prog = torch.export.load(io.BytesIO(serving.export_predict(models[2])))
    divs = [n for n in prog.graph.nodes if n.op == 'call_function'
            and 'div' in str(n.target)]
    assert divs, 'no division in the program'
    assert isinstance(divs[0].args[1], torch.fx.Node), divs[0].args


def _run_folder(tmp_path, tm, model):
    run = tmp_path / 'run'
    run.mkdir()
    tcfg.save_model_config(tm, str(run))
    state = create_train_state(model, tcfg.TrainConfig())
    CheckpointManager(str(run / 'checkpoints')).save(
        state, metrics={'val_accuracy': 0.5})
    return run


def test_export_serving_cli(models, tmp_path, capsys):
    _, _, port = models
    run = _run_folder(tmp_path, port.cfg, port)
    out = tmp_path / 'm.pt2'
    assert export_serving.main(['--checkpoint', str(run), '--output',
                                str(out), '--with-reconstruct',
                                '--device', 'cpu']) == str(out)
    printed = capsys.readouterr().out
    assert 'verified max diff' in printed and 'reconstruct artifact' in printed
    u8 = _u8(3, seed=5)
    np.testing.assert_allclose(
        serving.load_serving(out.read_bytes())(torch.from_numpy(u8)).numpy(),
        _live(port, u8).numpy(), rtol=0, atol=TOL)
    rec = serving.load_serving(str(out) + '.recon')(torch.from_numpy(u8))
    assert rec.shape == u8.shape


def test_export_serving_cli_refuses_a_bad_round_trip(models, tmp_path,
                                                     monkeypatch):
    _, _, port = models
    run = _run_folder(tmp_path, port.cfg, port)
    real = serving.load_serving
    monkeypatch.setattr(serving, 'load_serving',
                        lambda b: (lambda f: lambda u8: f(u8) + 1e-3)(
                            real(b)))
    out = tmp_path / 'm.pt2'
    with pytest.raises(SystemExit, match='verification FAILED'):
        export_serving.main(['--checkpoint', str(run), '--output', str(out),
                             '--device', 'cpu'])
    assert not out.exists()
