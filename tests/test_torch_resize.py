"""The port's device resize (gltvae_torch/ops/resize.py and the resize
branch of train/steps.py::_prep_image) against gltvae's.

``_linear_weights`` is a copy of gltvae's numpy function: bit-equal.
``resize_bilinear`` computes the same two contractions in another order of
summation: rtol 1e-5 / atol 1e-6 (f32 rounding of sums over <= 4 taps of a
[0, 1] image, ~1e-7). A sup step on a full-resolution (B, 218, 178, 3)
uint8 batch matches gltvae's step on it as tests/test_torch_steps.py's
steps do (metrics rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.ops.resize import _linear_weights as j_weights
from gltvae.ops.resize import resize_bilinear as j_resize
from gltvae.train.state import create_train_state
from gltvae.train.steps import _prep_image as j_prep
from gltvae.train.steps import make_train_steps as j_make_train_steps
from tests.test_torch_config_bridge import (jax_params, scheme_mu,
                                            small_configs, torch_model)
from tests.tf_twin import reconstruct_noise

import gltvae_torch.config as tcfg
from gltvae_torch.ops.resize import _linear_weights, resize_bilinear
from gltvae_torch.train.state import create_train_state as t_create
from gltvae_torch.train.steps import _prep_image, make_train_steps

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('src,dst', [(218, 64), (178, 64), (218, 128),
                                     (178, 128), (64, 64), (32, 64)])
def test_linear_weights_bit_equal(src, dst):
    got = _linear_weights(src, dst)
    assert got.dtype == np.float32 and got.shape == (dst, src)
    assert np.array_equal(got, j_weights(src, dst))


@pytest.mark.parametrize('out', [(64, 64), (128, 128), (96, 80)])
def test_resize_bilinear_matches_gltvae(out):
    x = np.random.RandomState(1).rand(2, 218, 178, 3).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), *out)
    want = np.asarray(j_resize(jnp.asarray(x), *out))
    assert got.shape == want.shape == (2, *out, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    same = torch.from_numpy(x[:, :64, :64])
    assert resize_bilinear(same, 64, 64) is same


@pytest.mark.parametrize('size', [64, 128])
def test_prep_image_full_res_matches_gltvae(size):
    u8 = np.random.RandomState(2).randint(0, 256, (3, 218, 178, 3),
                                          dtype=np.uint8)
    got = _prep_image(torch.from_numpy(u8), size)
    want = np.asarray(j_prep(jnp.asarray(u8), size))
    assert got.dtype == torch.float32 and got.shape == (3, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize('shape,match', [
    ((2, 72, 72, 3), 'augment_pad'),          # padded-loader lookalike
    ((2, 32, 32, 3), 'resolution'),
    ((2, 64, 32, 3), 'resolution')])
def test_prep_image_guards_as_gltvae(shape, match):
    u8 = np.zeros(shape, np.uint8)
    for prep, arr in ((_prep_image, torch.from_numpy(u8)),
                      (j_prep, jnp.asarray(u8))):
        with pytest.raises(ValueError, match=match):
            prep(arr, 64)
    # a square ship at >= 2x is a real full-res resize in both packages
    assert tuple(_prep_image(torch.zeros((2, 128, 128, 3), dtype=torch.uint8),
                             64).shape) == (2, 64, 64, 3)


def test_device_resize_is_supported():
    tcfg.check_supported(tcfg.ModelConfig(), tcfg.TrainConfig(),
                         tcfg.DataConfig(device_resize=True))


def test_sup_step_on_full_res_batch_matches_gltvae():
    B, K = 4, 8
    jm, tm = small_configs()
    params = jax_params(jm, scheme_mu(jm), seed=3)
    r = np.random.RandomState(4)
    x = r.randint(0, 256, (B, 218, 178, 3), dtype=np.uint8)
    y = (r.rand(B, 4) > 0.5).astype(np.float32)
    jcfg_ = jcfg.TrainConfig(batch_size=B, classifier_mc_samples=K)
    jmodel = JCCVAE(jm)
    jstate = create_train_state(jmodel, jcfg_, jax.random.key(0),
                                params=jax.tree.map(jnp.asarray, params))
    noise = reconstruct_noise(jstate.next_rng(), True, B, K, z_dim=8, y_dim=4)
    sup, _ = j_make_train_steps(jmodel, jcfg_, jit=False)
    _, jmet = jax.jit(sup)(jstate, jnp.asarray(x), jnp.asarray(y), 1.0)

    tcfg_ = tcfg.TrainConfig(batch_size=B, classifier_mc_samples=K)
    model = torch_model(tm, params)
    t_sup, _ = make_train_steps(model, tcfg_)
    _, tmet = t_sup(t_create(model, tcfg_), torch.from_numpy(x),
                    torch.from_numpy(y), 1.0,
                    noise={k: torch.tensor(v) for k, v in noise.items()})
    for k in jmet:
        np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jmet[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
