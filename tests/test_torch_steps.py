"""Keras Adam and the train steps of gltvae_torch against gltvae.

The slice as a whole: three consecutive steps (sup, unsup, sup) from one
state give the same params, Adam moments and metrics as gltvae's
make_train_steps(jit=False) (each wrapped in jax.jit here, to compile
once), with each step's noise rebuilt from that step's state.next_rng().

Tolerances: Adam alone, params rtol 1e-6 and moments rtol 1e-5 with atol
1e-6 of each leaf's largest value: the same f32 formulas, but under jit XLA
contracts b1·m + (1-b1)·g into one FMA where torch rounds twice, and 50
steps accumulate that near zero. Steps: metrics rtol 1e-5; Adam moments
rtol 1e-4 with atol 1e-5 of each leaf's largest value (they are the
gradients, see test_torch_ccvae.py); params atol 1e-7, since an
Adam step moves a parameter by at most ~lr = 1e-4 and a 1e-4 relative
gradient difference moves that by ~1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.train.state import create_train_state, keras_adam
from gltvae.train.steps import make_train_steps as j_make_train_steps
from tests.test_torch_config_bridge import (jax_params, scheme_mu,
                                            small_configs, torch_model)
from tests.tf_twin import reconstruct_noise

import gltvae_torch.config as tcfg
from gltvae_torch.bridge import params_to_state_dict, state_dict_to_params
from gltvae_torch.ops import preprocess
from gltvae_torch.train.state import (create_train_state as t_create,
                                      keras_adam_update)
from gltvae_torch.train.steps import make_train_steps

torch.set_num_threads(2)

B, K = 8, 100


def _leaves_close(got, want, rtol, atol_frac=0.0, atol=0.0):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=max(atol, atol_frac * np.abs(w).max()))


def test_keras_adam_50_updates_match():
    jm, tm = small_configs()
    params = jax_params(jm, scheme_mu(jm))
    tx = keras_adam(1e-3)
    j_params = jax.tree.map(jnp.asarray, params)
    opt = tx.init(j_params)
    update = jax.jit(tx.update)
    state = t_create(torch_model(tm, params), tcfg.TrainConfig())
    names = [n for n, _ in state.model.named_parameters()]
    r = np.random.RandomState(0)
    for _ in range(50):
        g = jax.tree.map(lambda p: r.standard_normal(p.shape)
                         .astype(np.float32) * 0.01, params)
        upd, opt = update(jax.tree.map(jnp.asarray, g), opt)
        j_params = jax.tree.map(lambda p, u: p + u, j_params, upd)
        keras_adam_update(state, params_to_state_dict(g), 1e-3)
    assert state.adam_count == int(opt.count) == 50
    _leaves_close(state_dict_to_params(state.model.state_dict()),
                  j_params, rtol=1e-6, atol=1e-7)
    m = params_to_state_dict(jax.tree.map(np.asarray, opt.mu))
    v = params_to_state_dict(jax.tree.map(np.asarray, opt.nu))
    for n in names:
        for got, want in ((state.adam_m[n], m[n]), (state.adam_v[n], v[n])):
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=1e-5,
                atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize('subtype', ['one-one', 'inferred'])
def test_frozen_mu_stays_bit_fixed(subtype):
    jm, tm = small_configs('fixed', subtype)
    params = jax_params(jm, scheme_mu(jm))
    state = t_create(torch_model(tm, params), tcfg.TrainConfig())
    assert 'mu' not in state.adam_m and 'mu' not in state.trainable()
    mu0 = state.model.mu.detach().clone()
    grads = {n: torch.ones_like(p) for n, p in state.model.named_parameters()}
    for _ in range(3):
        keras_adam_update(state, grads, 1e-3)
    assert torch.equal(state.model.mu, mu0)
    assert not torch.equal(state.model.classifier.kernel,
                           torch.from_numpy(params['classifier']['kernel']))


def three_steps():
    """sup, unsup, sup from one state through both packages, each step's
    noise drawn by gltvae and injected into the port; yields (port metrics,
    gltvae metrics, port state, gltvae state) after each step."""
    jm, tm = small_configs()
    train_cfg = jcfg.TrainConfig(batch_size=B, perc_supervision=0.5)
    params = jax_params(jm, scheme_mu(jm), seed=5)
    jmodel = JCCVAE(jm)
    jstate = create_train_state(jmodel, train_cfg, jax.random.key(0),
                                params=jax.tree.map(jnp.asarray, params))
    j_sup, j_unsup = (jax.jit(f) for f in
                      j_make_train_steps(jmodel, train_cfg, jit=False))

    model = torch_model(tm, params)
    state = t_create(model, tcfg.TrainConfig(batch_size=B,
                                             perc_supervision=0.5))
    t_sup, t_unsup = make_train_steps(model, tcfg.TrainConfig(
        batch_size=B, perc_supervision=0.5))

    r = np.random.RandomState(6)
    temp = 1.0
    for sup in (True, False, True):
        x = r.randint(0, 256, (B, 16, 16, 3), dtype=np.uint8)
        y = (r.rand(B, 4) > 0.5).astype(np.float32)
        noise = reconstruct_noise(jstate.next_rng(), sup, B, K, z_dim=8,
                                  y_dim=4)
        jstate, jmet = (j_sup if sup else j_unsup)(
            jstate, jnp.asarray(x), jnp.asarray(y), temp)
        state, tmet = (t_sup if sup else t_unsup)(
            state, torch.from_numpy(x), torch.from_numpy(y), temp,
            noise={k: torch.tensor(v) for k, v in noise.items()})
        yield tmet, jmet, state, jstate


def test_three_steps_match_gltvae():
    """sup, unsup, sup from one state: params, Adam moments, metrics."""
    launches = preprocess.launches
    for tmet, jmet, state, jstate in three_steps():
        assert state.step == int(jstate.step)
        assert set(tmet) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jmet[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        _leaves_close(state_dict_to_params(state.model.state_dict()),
                      jstate.params, rtol=0, atol=1e-7)
        jmu, jnu = jstate.opt_state.mu, jstate.opt_state.nu
        assert state.adam_count == int(jstate.opt_state.count)
        _leaves_close(state_dict_to_params(state.adam_m), jmu, rtol=1e-4,
                      atol_frac=1e-5)
        _leaves_close(state_dict_to_params(state.adam_v), jnu, rtol=1e-4,
                      atol_frac=1e-5)
    assert preprocess.launches == launches     # CPU batches: no kernel
