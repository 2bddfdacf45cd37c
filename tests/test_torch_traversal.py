"""gltvae_torch.eval.traversal and ops.preprocess.preprocess_batch against
gltvae's (the port's counterpart of tests/test_traversal_preprocess.py).

The traversal grid is exact; the images from every anchor and a dims
subset are within 1e-5 of gltvae's on the same params (the bridge), as the
decoder tests hold. preprocess_batch equals gltvae's bit for bit under an
injected flip mask (gltvae's own bernoulli draw): the Pallas dequant runs
in interpret mode on the CPU, as gltvae's tests run it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.eval import traversal as jtrav
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.ops.pallas.preprocess import preprocess_batch as j_preprocess
from tests.test_torch_config_bridge import (jax_params, scheme_mu,
                                            small_configs, torch_model)

import gltvae_torch.config as tcfg
from gltvae_torch.eval import traversal as ttrav
from gltvae_torch.ops import preprocess

torch.set_num_threads(2)

TOL = 1e-5


def _models(name):
    if name == 'small':
        jm, tm = small_configs()
    else:
        jm, _ = jcfg.default_celeba64()
        tm, _ = tcfg.default_celeba64()
    params = jax_params(jm, scheme_mu(jm), seed=4)
    return JCCVAE(jm), params, torch_model(tm, params).eval()


def test_build_grid_is_exact():
    rng = np.random.RandomState(0)
    z = rng.randn(8).astype(np.float32)
    dims = np.array([1, 5, 7, 1], np.int32)
    vals = rng.randn(5).astype(np.float32)
    want = np.asarray(jtrav._build_grid(jnp.asarray(z), jnp.asarray(dims),
                                        jnp.asarray(vals)))
    got = ttrav._build_grid(torch.from_numpy(z), torch.from_numpy(dims),
                            torch.from_numpy(vals))
    assert got.shape == (20, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    g = got.numpy().reshape(4, 5, 8)
    np.testing.assert_array_equal(g[1, :, 5], vals)
    row = g[1, 2].copy()
    row[5] = z[5]
    np.testing.assert_array_equal(row, z)


@pytest.mark.parametrize('name', ['small', 'celeba64'])
@pytest.mark.parametrize('anchor', ['zeros', 'image', 'z_base', 'dims'])
def test_images_match_gltvae(name, anchor):
    """Each anchor: z = 0, an image's posterior mean, an explicit z_base;
    and a dims subset with lo/hi/n_steps of its own."""
    jmodel, params, port = _models(name)
    cfg = port.cfg
    rng = np.random.RandomState(1)
    kw = dict(n_steps=4)
    jkw, tkw = {}, {}
    if anchor == 'image':
        x = rng.rand(2, cfg.image_size, cfg.image_size, 3).astype(np.float32)
        jkw['x'], tkw['x'] = jnp.asarray(x), torch.from_numpy(x)
    elif anchor == 'z_base':
        z = rng.randn(cfg.z_dim).astype(np.float32)
        jkw['z_base'], tkw['z_base'] = jnp.asarray(z), torch.from_numpy(z)
    elif anchor == 'dims':
        kw = dict(n_steps=5, lo=-2.0, hi=1.5, dims=[0, cfg.z_dim - 1, 2])
    want = np.asarray(jtrav.latent_traversal(jmodel, params, **jkw, **kw))
    got = ttrav.latent_traversal(port, **tkw, **kw)
    assert got.shape == want.shape
    assert want.shape[:2] == (len(kw.get('dims', range(cfg.z_dim))),
                              kw['n_steps'])
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_traversal_fn_reused_across_anchors():
    jmodel, params, port = _models('small')
    fn = ttrav.make_traversal_fn(port, n_steps=3, dims=[2, 3])
    jfn = jtrav.make_traversal_fn(jmodel, n_steps=3, dims=[2, 3])
    for seed in (0, 1):
        z = np.random.RandomState(seed).randn(8).astype(np.float32)
        np.testing.assert_allclose(fn(torch.from_numpy(z)).numpy(),
                                   np.asarray(jfn(params, jnp.asarray(z))),
                                   rtol=0, atol=TOL)


# ---------------------------- preprocess_batch ----------------------------

IMAGENET = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))


@pytest.mark.parametrize('size', [64, 128])
@pytest.mark.parametrize('norm', ['none', 'mean_std', 'mean_only'])
def test_preprocess_batch_equals_gltvae(size, norm):
    u8 = np.random.RandomState(size).randint(0, 256, (6, size, size, 3),
                                             dtype=np.uint8)
    key = jax.random.key(size + 1)
    mask = np.array(jax.random.bernoulli(key, 0.5, (6,)))
    assert 0 < mask.sum() < 6            # both kinds of image
    kw = {'none': {}, 'mean_std': IMAGENET,
          'mean_only': dict(mean=IMAGENET['mean'])}[norm]
    want = np.asarray(j_preprocess(jnp.asarray(u8), key=key, flip=True,
                                   **kw))
    got = preprocess.preprocess_batch(torch.from_numpy(u8), flip=True,
                                      flip_mask=torch.from_numpy(mask), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    no_flip = preprocess.preprocess_batch(torch.from_numpy(u8), **kw)
    np.testing.assert_array_equal(
        no_flip.numpy(), np.asarray(j_preprocess(jnp.asarray(u8), **kw)))


def test_preprocess_batch_flip_draws_and_refusal():
    u8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (16, 8, 8, 3), dtype=np.uint8))
    with pytest.raises(ValueError, match='flip_mask or a generator'):
        preprocess.preprocess_batch(u8, flip=True)
    got = preprocess.preprocess_batch(
        u8, flip=True, generator=torch.Generator().manual_seed(0))
    base = preprocess.dequant_reference(u8, 'mul')
    flipped = [bool(torch.equal(g, b.flip(1))) for g, b in zip(got, base)]
    same = [bool(torch.equal(g, b)) for g, b in zip(got, base)]
    assert all(f or s for f, s in zip(flipped, same))
    assert any(flipped) and any(same)
