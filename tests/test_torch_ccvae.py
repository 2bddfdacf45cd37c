"""The CCVAE losses of gltvae_torch against gltvae under the same params
and the same noise: the loss, every LossAux field and the full gradient
tree (μ included), for all three gate schemes at k=100, and predict_probs.

The noise is drawn on the JAX side from the loss key and injected
(tests/tf_twin.py::reconstruct_noise rebuilds exactly those draws).

Tolerance: values rtol 1e-5 / atol 1e-5; gradients rtol 1e-4 with atol
1e-5 of the largest gradient of each leaf. The two libraries' CPU
convolutions and matmuls sum in different orders, and the supervised loss
multiplies by w = exp(log q(y|ẑ,c) − log q(y|x)), which carries those
float32 differences into every gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE, Temps as JTemps
from gltvae.ops.sampling import sample_gumbel
from tests.test_torch_config_bridge import (SCHEMES, jax_params, scheme_mu,
                                            small_configs, torch_model)
from tests.tf_twin import reconstruct_noise

from gltvae_torch.bridge import state_dict_to_params
from gltvae_torch.models.ccvae import Temps

torch.set_num_threads(2)

B, K = 8, 100
VAL = dict(rtol=1e-5, atol=1e-5)


def _setup(scheme):
    jm, tm = small_configs(*scheme)
    params = jax_params(jm, scheme_mu(jm), seed=3)
    r = np.random.RandomState(4)
    x = r.rand(B, 16, 16, 3).astype(np.float32)
    y = (r.rand(B, 4) > 0.5).astype(np.float32)
    temp = jcfg.TrainConfig().gating_temp_for(jm)
    reg = 0.2 if jm.mu_trainable else 0.0
    # gltvae's losses do not read the gate scheme (μ's values and the L1
    # weight carry it), so one JAX model serves all three: fewer compiles
    return (JCCVAE(small_configs()[0]), torch_model(tm, params),
            jax.tree.map(jnp.asarray, params), x, y, temp, reg)


_JIT = {}


def _jax_loss_and_grad(model, kind, reg):
    """jit(value_and_grad(loss)) per (model, kind, gating_reg)."""
    key = (model, kind, reg)
    if key not in _JIT:
        if kind == 'sup':
            fn = lambda p, x, y, k, t: model.sup_loss(p, x, y, k, t,
                                                      gating_reg=reg, k=K)
        else:
            fn = lambda p, x, y, k, t: model.unsup_loss(p, x, k, t,
                                                        gating_reg=reg)
        _JIT[key] = jax.jit(jax.value_and_grad(fn, has_aux=True))
    return _JIT[key]


def _check_grads(tmodel, loss, jgrads):
    names = [n for n, _ in tmodel.named_parameters()]
    grads = torch.autograd.grad(loss, list(tmodel.parameters()))
    got = state_dict_to_params(dict(zip(names, grads)))
    want = jax.tree.map(np.asarray, jgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))
    return got


@pytest.mark.parametrize('kind', ['sup', 'unsup'])
@pytest.mark.parametrize('scheme', SCHEMES, ids='/'.join)
def test_loss_aux_and_gradients_match(scheme, kind):
    jmodel, tmodel, params, x, y, temp, reg = _setup(scheme)
    key = jax.random.key(11)
    noise = reconstruct_noise(key, kind == 'sup', B, K, z_dim=8, y_dim=4)
    (jl, jaux), jgrads = _jax_loss_and_grad(jmodel, kind, reg)(
        params, jnp.asarray(x), jnp.asarray(y), key,
        JTemps(gating=jnp.float32(temp)))
    tnoise = {k: torch.tensor(v) for k, v in noise.items()}
    tx = torch.from_numpy(x)
    if kind == 'sup':
        tl, taux = tmodel.sup_loss(tx, torch.from_numpy(y), Temps(temp),
                                   gating_reg=reg, k=K, noise=tnoise)
    else:
        tl, taux = tmodel.unsup_loss(tx, Temps(temp), gating_reg=reg,
                                     noise=tnoise)
    np.testing.assert_allclose(tl.item(), float(jl), **VAL)
    for field in jaux._fields:
        np.testing.assert_allclose(getattr(taux, field).detach().numpy(),
                                   np.asarray(getattr(jaux, field)),
                                   err_msg=field, **VAL)
    grads = _check_grads(tmodel, tl, jgrads)
    # μ = I (one-one) sits where every gate's μ-gradient vanishes
    assert (np.abs(grads['mu']).max() > 0) == (scheme[1] == 'inferred')


@pytest.mark.parametrize('deterministic', [False, True])
def test_predict_probs_matches(deterministic):
    jmodel, tmodel, params, x, _, _, _ = _setup(SCHEMES[0])
    key = jax.random.key(12)
    temp = 0.3
    want = np.asarray(jmodel.predict_probs(
        params, jnp.asarray(x), key, JTemps(gating=jnp.float32(temp)),
        deterministic=deterministic))
    # predict_probs splits its key two ways: (z, gates)
    k_z, k_gate = jax.random.split(key)
    k1, k2 = jax.random.split(k_gate)
    noise = {'eps_z': np.asarray(jax.random.normal(k_z, (B, 8))),
             'g1': np.asarray(sample_gumbel(k1, (4, 4))),
             'g2': np.asarray(sample_gumbel(k2, (4, 4)))}
    with torch.no_grad():
        got = tmodel.predict_probs(
            torch.from_numpy(x), Temps(temp), deterministic=deterministic,
            noise={k: torch.tensor(v) for k, v in noise.items()})
    np.testing.assert_allclose(got.numpy(), want, **VAL)
