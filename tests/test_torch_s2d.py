"""The port's space-to-depth regroupings (input_s2d, output_s2d) against
gltvae's S2DConv / S2DTransposeLast and against the port's own direct
convs, at float32, 64 and 128 px.

Tolerances are tests/test_s2d.py's for the same comparisons: 1e-6
(rtol and atol) at 64 px, rtol 1e-5 with atol 1e-5 (encoder) or 1e-6
(decoder) at 128 px, where the deeper stack sums more products. The
bridge round trip with s2d on is exact: the parameters keep their
canonical layout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE, Temps as JTemps
from gltvae.models import networks as jnet
from tests.test_torch_config_bridge import (_tree_equal, jax_params,
                                            scheme_mu, torch_model)
from tests.tf_twin import reconstruct_noise

import gltvae_torch.config as tcfg
from gltvae_torch.bridge import state_dict_to_params
from gltvae_torch.models import networks as tnet
from gltvae_torch.models.ccvae import Temps

torch.set_num_threads(2)

B = 2
S2D = dict(input_s2d=True, output_s2d=True)
# (config builder, encoder tolerance, decoder tolerance)
SIZES = {64: ('default_celeba64', dict(rtol=1e-6, atol=1e-6),
              dict(rtol=1e-6, atol=1e-6)),
         128: ('celeba128', dict(rtol=1e-5, atol=1e-5),
               dict(rtol=1e-5, atol=1e-6))}


def _configs(size, **kw):
    name = SIZES[size][0]
    jm, _ = getattr(jcfg, name)()
    tm, _ = getattr(tcfg, name)()
    return dataclasses.replace(jm, **kw), dataclasses.replace(tm, **kw)


@pytest.fixture(scope='module', params=[64, 128])
def size_params(request):
    size = request.param
    jm, _ = _configs(size)
    return size, jax_params(jm, scheme_mu(jm), seed=1)


def test_space_to_depth_equals_gltvae_and_round_trips():
    x = np.random.RandomState(3).rand(2, 8, 6, 3).astype(np.float32)
    got = tnet.space_to_depth(torch.from_numpy(x))
    assert np.array_equal(got.numpy(),
                          np.asarray(jnet.space_to_depth(jnp.asarray(x))))
    assert torch.equal(tnet.depth_to_space(got), torch.from_numpy(x))
    y = np.random.RandomState(4).rand(2, 3, 4, 12).astype(np.float32)
    assert np.array_equal(tnet.depth_to_space(torch.from_numpy(y)).numpy(),
                          np.asarray(jnet.depth_to_space(jnp.asarray(y))))


def test_s2d_layers_match_flax(size_params):
    """S2DConv and S2DTransposeLast alone, on the canonical kernels."""
    size, params = size_params
    _, enc_tol, dec_tol = SIZES[size]
    r = np.random.RandomState(0)
    x = r.rand(B, size, size, 3).astype(np.float32)
    p1 = params['encoder']['conv1']
    want = jnet.S2DConv(p1['kernel'].shape[-1]).apply({'params': p1},
                                                      jnp.asarray(x))
    with torch.no_grad():
        got = tnet.s2d_conv1(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(p1['kernel'].transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(p1['bias']), torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **enc_tol)

    jm, _ = _configs(size)
    last = params['decoder'][f'conv{len(jm.dec_features) + 1}t']
    cin = last['kernel'].shape[-1]
    h = r.rand(B, size // 2, size // 2, cin).astype(np.float32) - 0.5
    want = jnet.S2DTransposeLast(3).apply({'params': last}, jnp.asarray(h))
    with torch.no_grad():
        got = tnet.s2d_conv_transpose_last(
            torch.from_numpy(h).permute(0, 3, 1, 2),
            torch.from_numpy(last['kernel'].transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(last['bias']), torch.float32)
    assert got.shape == (B, 12, size // 2, size // 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **dec_tol)


def test_encoder_decoder_with_s2d_match_flax_and_port_direct(size_params):
    """Both flags on: encode and decode against gltvae with both flags, and
    against the port with both off."""
    size, params = size_params
    _, enc_tol, dec_tol = SIZES[size]
    jm, tm = _configs(size, **S2D)
    jmodel = JCCVAE(jm)
    t_s2d = torch_model(tm, params)
    t_direct = torch_model(_configs(size)[1], params)
    r = np.random.RandomState(1)
    x = r.rand(B, size, size, 3).astype(np.float32)
    z = r.randn(B, jm.z_dim).astype(np.float32)
    jl, js_ = jmodel.encode(params, jnp.asarray(x))
    jd = jmodel.decode(params, jnp.asarray(z))
    with torch.no_grad():
        tl, ts_ = t_s2d.encode(torch.from_numpy(x))
        td = t_s2d.decode(torch.from_numpy(z))
        dl, ds_ = t_direct.encode(torch.from_numpy(x))
        dd = t_direct.decode(torch.from_numpy(z))
    assert td.shape == (B, size, size, 3)
    for got, want, tol in ((tl, jl, enc_tol), (ts_, js_, enc_tol),
                           (td, jd, dec_tol), (tl, dl, enc_tol),
                           (ts_, ds_, enc_tol), (td, dd, dec_tol)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize('name', ['default_celeba64', 'celeba128'])
def test_bridge_round_trip_bit_identical_with_s2d(name):
    jm, _ = getattr(jcfg, name)()
    tm, _ = getattr(tcfg, name)()
    params = jax_params(jm, scheme_mu(jm))
    model = torch_model(dataclasses.replace(tm, **S2D), params)
    _tree_equal(params, state_dict_to_params(model.state_dict()))
    assert set(model.state_dict()) == set(
        torch_model(tm, params).state_dict())


def test_s2d_sup_loss_and_grads_match_gltvae():
    """The supervised loss with both flags: the recon term compares the s2d
    decoder output with space_to_depth(x). Loss rtol 1e-6 as
    tests/test_s2d.py; gradients rtol 2e-3 as its output-s2d test, with atol
    2e-4 of each leaf's largest value: the Laplace term's gradient is
    sign(x - recon), and where recon ~= x a summation-order difference
    flips it (one element of a 16,384-element leaf moved by 5.4e-4)."""
    jm, tm = _configs(64, **S2D)
    params = jax_params(jm, scheme_mu(jm), seed=2)
    jmodel = JCCVAE(jm)
    r = np.random.RandomState(2)
    x = r.rand(4, 64, 64, 3).astype(np.float32)
    y = (r.rand(4, jm.y_dim) > 0.5).astype(np.float32)
    key = jax.random.key(7)

    def j_loss(p):
        return jmodel.sup_loss(p, jnp.asarray(x), jnp.asarray(y), key,
                               JTemps(gating=jnp.float32(1.0)),
                               gating_reg=0.2, k=8)[0]
    jl, jg = jax.value_and_grad(j_loss)(params)
    noise = reconstruct_noise(key, True, 4, 8, z_dim=jm.z_dim,
                              y_dim=jm.y_dim)
    model = torch_model(tm, params)
    loss, _ = model.sup_loss(torch.from_numpy(x), torch.from_numpy(y),
                             Temps(gating=1.0), gating_reg=0.2, k=8,
                             noise={k: torch.tensor(v)
                                    for k, v in noise.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    grads = state_dict_to_params({n: p.grad for n, p in
                                  model.named_parameters()})
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=2e-3, atol=2e-4 * np.abs(b).max()), grads, jg)
