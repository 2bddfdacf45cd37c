"""``python -m gltvae_torch.render`` against tools/render.py's functions on
the same params (the bridge) and gltvae's draws injected: each mode's grid
within 1e-5, and the PNG decodes with PIL to the tiled shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gltvae.config as jcfg
from gltvae.data.synthetic import synthetic_celeba
from gltvae.eval.traversal import latent_traversal
from gltvae.models.ccvae import CCVAE as JCCVAE, Temps as JTemps
from gltvae.ops.sampling import sample_gating_deterministic, sample_gumbel
from gltvae.utils.h5_export import export_reference_checkpoint
from tests.test_torch_config_bridge import jax_params, scheme_mu, torch_model

import gltvae_torch.config as tcfg
from gltvae_torch import render

torch.set_num_threads(2)

TOL = 1e-5
LABELS = ['Male', 'Smiling']


@pytest.fixture(scope='module')
def models():
    jm, _ = jcfg.default_celeba64()
    tm, _ = tcfg.default_celeba64()
    params = jax_params(jm, scheme_mu(jm), seed=31)
    return JCCVAE(jm), params, torch_model(tm, params).eval()


def _gltvae_prior_anchor(jmodel, params, labels, seed):
    """tools/render.py's 'prior' anchor (render.py:94-106)."""
    cfg = jmodel.cfg
    y = np.zeros((1, cfg.y_dim), np.float32)
    for name in labels:
        y[:, jcfg.CELEBA_EASY_LABELS.index(name)] = 1.0
    locs, _ = jmodel.prior_zc(params, jnp.asarray(y),
                              sample_gating_deterministic(params['mu']))
    zs = (jnp.zeros((cfg.z_style,), jnp.float32) if seed == 0 else
          jax.random.normal(jax.random.key(seed), (cfg.z_style,),
                            jnp.float32))
    return jnp.concatenate([zs, locs[0]]), np.array(zs)


@pytest.mark.parametrize('anchor,seed', [('zeros', 0), ('prior', 0),
                                         ('prior', 7)])
def test_traversal_grid(models, anchor, seed):
    jmodel, params, port = models
    cfg = port.cfg
    dims = list(range(cfg.z_style, cfg.z_dim))
    z_base, zs = (None, None)
    if anchor == 'prior':
        z_base, zs = _gltvae_prior_anchor(jmodel, params, LABELS, seed)
    want = np.asarray(latent_traversal(jmodel, params, z_base=z_base,
                                       n_steps=4, dims=dims))
    if seed == 0:
        got = render.traversal(port, None, anchor, LABELS, seed, n_steps=4)
    else:       # torch cannot replay threefry: inject gltvae's z_style
        from gltvae_torch.eval.traversal import latent_traversal as tlt
        got = tlt(port, z_base=render.prior_anchor(
            port, LABELS, seed, eps_zs=torch.from_numpy(zs)),
            n_steps=4, dims=dims)
    assert got.shape == want.shape == (cfg.z_classify, 4, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_reconstruct_grid(models):
    jmodel, params, port = models
    ds = synthetic_celeba(5, seed=3)
    x = jnp.asarray(ds.images, jnp.float32) / 255.0
    want = np.stack([np.asarray(x),
                     np.asarray(jmodel.reconstruct(params, x))])
    got = render.reconstruct(port, 5, seed=3)
    assert got.shape == want.shape == (2, 5, 64, 64, 3)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_conditional_grid(models):
    """sample_conditional at T=0.3 with gltvae's draws for key(seed)."""
    jmodel, params, port = models
    cfg, n, seed = port.cfg, 6, 4
    key = jax.random.key(seed)
    y = np.zeros((n, 18), np.float32)
    for name in LABELS:
        y[:, jcfg.CELEBA_EASY_LABELS.index(name)] = 1.0
    want = np.asarray(jmodel.sample_conditional(
        params, jnp.asarray(y), key, JTemps(gating=jnp.float32(0.3))))[None]
    key_gate, key_zc, key_zs = jax.random.split(key, 3)
    k1, k2 = jax.random.split(key_gate)
    f = lambda a: torch.from_numpy(np.array(a, np.float32))
    noise = {'g1': f(sample_gumbel(k1, params['mu'].shape)),
             'g2': f(sample_gumbel(k2, params['mu'].shape)),
             'eps_zc': f(jax.random.normal(key_zc, (n, cfg.z_classify))),
             'eps_zs': f(jax.random.normal(key_zs, (n, cfg.z_style)))}
    got = render.conditional(port, LABELS, n, seed, noise=noise)
    assert got.shape == want.shape == (1, n, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    drawn = render.conditional(port, LABELS, n, seed)   # torch's draws
    assert drawn.shape == got.shape and torch.isfinite(drawn).all()


@pytest.mark.parametrize('mode,shape', [
    ('traversal', (18 * 64, 8 * 64, 3)), ('reconstruct', (2 * 64, 8 * 64, 3)),
    ('conditional', (64, 8 * 64, 3))])
def test_cli_writes_the_tiled_png(models, tmp_path, mode, shape):
    """From a reference-format .h5 folder (written by gltvae's exporter):
    the PNG is the grid tiled as tools/render.py tiles it, one pixel per
    image pixel."""
    jmodel, params, port = models
    export_reference_checkpoint(params, str(tmp_path / 'h5'))
    out = tmp_path / f'{mode}.png'
    assert render.main(['--mode', mode, '--ref-checkpoint',
                        str(tmp_path / 'h5'), '--anchor', 'prior',
                        '--labels', ','.join(LABELS), '--out', str(out),
                        '--device', 'cpu']) == str(out)
    png = np.asarray(Image.open(out))
    assert png.shape == shape and png.dtype == np.uint8
    if mode == 'traversal':
        z_base, _ = _gltvae_prior_anchor(jmodel, params, LABELS, 0)
        grid = np.asarray(latent_traversal(
            jmodel, params, z_base=z_base,
            dims=list(range(port.cfg.z_style, port.cfg.z_dim))))
        tile = grid.transpose(0, 2, 1, 3, 4).reshape(shape)
        want = np.round(np.clip(tile, 0, 1) * 255)
        assert np.abs(png.astype(np.float64) - want).max() <= 1


def test_fresh_init_and_run_folder(tmp_path):
    """No checkpoint: a fresh CelebA-64 init; a port run folder: its
    recorded model and best checkpoint."""
    from gltvae_torch.train.checkpoint import CheckpointManager
    from gltvae_torch.train.state import create_train_state
    from tests.test_torch_config_bridge import small_configs
    out = tmp_path / 'fresh.png'
    render.main(['--mode', 'traversal', '--dims', '0', '1', '--n-steps', '3',
                 '--out', str(out), '--device', 'cpu'])
    assert np.asarray(Image.open(out)).shape == (2 * 64, 3 * 64, 3)
    args = render.parse_args(['--out', 'x.png', '--device', 'cpu'])
    assert render.load(args, torch.device('cpu')).cfg == tcfg.ModelConfig()
    jm, tm = small_configs()
    model = torch_model(tm, jax_params(jm, scheme_mu(jm), seed=32))
    tcfg.save_model_config(tm, str(tmp_path))
    CheckpointManager(str(tmp_path / 'checkpoints')).save(
        create_train_state(model, tcfg.TrainConfig()))
    args.checkpoint = str(tmp_path)
    loaded = render.load(args, torch.device('cpu'))
    assert loaded.cfg == tm
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
