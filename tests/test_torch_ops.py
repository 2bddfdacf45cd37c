"""Distributions, samplers and gating matrices of gltvae_torch against the
JAX package, under the same injected noise.

Tolerance: rtol 1e-6 / atol 1e-6 (float32 elementwise math; the two
libraries' exp/log/pow/softplus differ by a few ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.ops.distributions as jd
import gltvae.ops.gating as jg
import gltvae.ops.sampling as js

import gltvae_torch.ops.distributions as td
import gltvae_torch.ops.gating as tg
import gltvae_torch.ops.sampling as ts

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)
R = np.random.RandomState(0)
A = R.randn(6, 5).astype(np.float32)
B = R.randn(6, 5).astype(np.float32)
S = (np.abs(R.randn(6, 5)) + 0.1).astype(np.float32)
Y = (R.rand(6, 5) > 0.5).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _value_and_grads(jfn, tfn, args):
    """Value and the gradient of sum(f) w.r.t. every argument, both sides."""
    jv, jgs = jax.value_and_grad(lambda *a: jnp.sum(jfn(*a)),
                                 argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    ts_ = [_t(a, True) for a in args]
    tv = tfn(*ts_).sum()
    tgs = torch.autograd.grad(tv, ts_)
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    for g1, g2 in zip(tgs, jgs):
        np.testing.assert_allclose(g1.numpy(), np.asarray(g2), **TOL)


@pytest.mark.parametrize('name,args', [
    ('gaussian_kl', (A, S, B, S[::-1].copy())),
    ('laplace_log_prob', (A, B)),
    ('img_log_likelihood', (np.abs(A[None, None]) % 1, np.abs(B[None, None]) % 1)),
    ('bernoulli_log_prob', (A * 30, Y)),
    ('bernoulli_log_prob_probs', (np.full((5,), 0.3, np.float32), Y)),
])
def test_distributions_value_and_grad(name, args):
    _value_and_grads(getattr(jd, name), getattr(td, name), args)


def test_bernoulli_sample_with_injected_uniforms():
    key = jax.random.key(5)
    logits = A * 3
    u = np.asarray(jax.random.uniform(key, logits.shape, jnp.float32))
    want = np.asarray(jd.bernoulli_sample(key, jnp.asarray(logits)))
    got = td.bernoulli_sample(_t(logits), u=_t(u)).numpy()
    assert np.array_equal(got, want)


def test_clip_passthrough_gradient_is_one_at_ties():
    x = _t(np.array([-1.0, 0.0, 0.5, 1.0, 2.0], np.float32), True)
    (g,) = torch.autograd.grad(ts.clip_passthrough(x, 0.0, 1.0).sum(), x)
    assert g.tolist() == [0.0, 1.0, 1.0, 1.0, 0.0]
    _value_and_grads(lambda v: js.clip_passthrough(v, 0.0, 1.0),
                     lambda v: ts.clip_passthrough(v, 0.0, 1.0),
                     (np.array([-1.0, 0.0, 0.5, 1.0, 2.0], np.float32),))


def _gumbels(key, shape):
    k1, k2 = jax.random.split(key)
    return (np.asarray(js.sample_gumbel(k1, shape)),
            np.asarray(js.sample_gumbel(k2, shape)))


@pytest.mark.parametrize('temp', [1.0, 0.3, 0.05])
def test_sample_gating_value_and_grad(temp):
    mu = jg.cooccurrence_gating_matrix(R.rand(40, 5) > 0.5).astype(np.float32)
    mu[0, 1], mu[1, 0] = 1.2, -0.1           # clipped from both sides
    key = jax.random.key(7)
    g1, g2 = _gumbels(key, mu.shape)
    _value_and_grads(
        lambda m: js.sample_gating(key, m, jnp.float32(temp)),
        lambda m: ts.sample_gating(m, temp, g1=_t(g1), g2=_t(g2)), (mu,))


@pytest.mark.parametrize('temp', [0.01, 0.3])
def test_sample_gating_hardening_gives_no_nan_where_jax_gives_none(temp):
    """μ=1: (1-μ)^{1/T}=0 against a Gumbel ratio that overflows at T=0.01.
    The gate is exactly 1 on both sides. The hardening fixes the value,
    not the gradient: the discarded branch's 0·inf reaches d/dμ in JAX as
    in torch, so the NaN pattern of the gradient must be the same."""
    mu = np.ones((6, 6), np.float32)
    key = jax.random.key(0)
    g1, g2 = _gumbels(key, mu.shape)
    jc, jgrad = jax.value_and_grad(
        lambda m: js.sample_gating(key, m, jnp.float32(temp)).sum())(
            jnp.asarray(mu))
    m = _t(mu, True)
    c = ts.sample_gating(m, temp, g1=_t(g1), g2=_t(g2))
    (g,) = torch.autograd.grad(c.sum(), m)
    assert torch.all(c == 1.0) and float(jc) == mu.size
    assert np.array_equal(torch.isnan(g).numpy(), np.isnan(np.asarray(jgrad)))
    if temp == 0.3:
        assert torch.isfinite(g).all()


def test_sample_normal_and_gumbel_injected_and_drawn():
    key = jax.random.key(3)
    eps = np.asarray(jax.random.normal(key, A.shape, jnp.float32))
    want = np.asarray(js.sample_normal(key, jnp.asarray(A), jnp.asarray(S)))
    got = ts.sample_normal(_t(A), _t(S), eps=_t(eps)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    gen = torch.Generator().manual_seed(0)
    g = ts.sample_gumbel((4000,), gen)
    assert abs(float(g.mean()) - 0.5772) < 0.05   # Euler–Mascheroni
    z = ts.sample_normal(torch.zeros(4000), torch.ones(4000), gen)
    assert abs(float(z.std()) - 1.0) < 0.05


def test_sample_gating_deterministic():
    mu = np.array([[-0.5, 0.3], [1.0, 1.7]], np.float32)
    assert np.array_equal(ts.sample_gating_deterministic(_t(mu)).numpy(),
                          np.asarray(js.sample_gating_deterministic(
                              jnp.asarray(mu))))


def test_gating_matrices_equal():
    labels = (R.rand(50, 18) > 0.6).astype(np.float32)
    labels[3] = 0.0                                   # an all-zero row
    assert np.array_equal(tg.cooccurrence_gating_matrix(labels),
                          jg.cooccurrence_gating_matrix(labels))
    assert np.array_equal(tg.identity_gating_matrix(18, 18),
                          jg.identity_gating_matrix(18, 18))
    assert np.array_equal(tg.uniform_gating_matrix(18),
                          jg.uniform_gating_matrix(18))
    for sup in (0.0, 0.5):
        assert np.array_equal(
            tg.gating_matrix_from_labels(labels[:30], labels[30:], 18, sup),
            jg.gating_matrix_from_labels(labels[:30], labels[30:], 18, sup))
