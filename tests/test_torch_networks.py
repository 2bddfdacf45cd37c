"""Each gltvae_torch network against its Flax module on shared params, at
float32 and the default 64 px widths.

Tolerance: atol 1e-5 / rtol 1e-5. XLA's and torch's CPU convolutions sum
in different orders; through five conv layers that leaves ~1e-6
differences on O(1) activations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gltvae.models.ccvae import CCVAE as JCCVAE

from tests.test_torch_config_bridge import jax_params, scheme_mu, torch_model
import gltvae.config as jcfg
import gltvae_torch.config as tcfg

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B = 4


def _models(locs):
    jm = jcfg.ModelConfig(posterior_locs=locs)
    tm = tcfg.ModelConfig(posterior_locs=locs)
    params = jax_params(jm, scheme_mu(jm), seed=1)
    return JCCVAE(jm), torch_model(tm, params), params


@pytest.mark.parametrize('locs', ['relu', 'linear'])
def test_encoder_matches_flax(locs):
    jmodel, tmodel, params = _models(locs)
    x = np.random.RandomState(0).rand(B, 64, 64, 3).astype(np.float32)
    jl, js_ = jax.jit(jmodel.encode)(params, jnp.asarray(x))
    with torch.no_grad():
        tl, ts_ = tmodel.encode(torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), **TOL)
    if locs == 'linear':
        assert (tl < 0).any()      # the linear head is not clipped at 0
    else:
        assert (tl >= 0).all()


def test_decoder_matches_flax():
    jmodel, tmodel, params = _models('relu')
    z = np.random.RandomState(1).randn(B, 45).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.decode)(params, jnp.asarray(z)))
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (B, 64, 64, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_classifier_and_cond_prior_match_flax():
    jmodel, tmodel, params = _models('relu')
    r = np.random.RandomState(2)
    zc = r.randn(B, 18).astype(np.float32)
    gates = r.rand(18, 18).astype(np.float32)
    y = (r.rand(B, 18) > 0.5).astype(np.float32)
    want = np.asarray(jmodel.classify(params, jnp.asarray(zc),
                                      jnp.asarray(gates)))
    jloc, jsc = jmodel.prior_zc(params, jnp.asarray(y), jnp.asarray(gates))
    with torch.no_grad():
        got = tmodel.classify(torch.from_numpy(zc), torch.from_numpy(gates))
        tloc, tsc = tmodel.prior_zc(torch.from_numpy(y),
                                    torch.from_numpy(gates))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tloc.numpy(), np.asarray(jloc), **TOL)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), **TOL)
