"""compute_dtype='bfloat16': the port against gltvae at bf16, on shared
params (the bridge) and injected noise.

The rule, for each quantity: the port's relative L2 distance from gltvae's
bf16 value is at most half of gltvae's own bf16-vs-f32 distance on the same
inputs. A port that computed in f32 by mistake would sit about that full
distance away and fail; ``test_an_f32_port_fails_the_rule`` shows it does.

Held quantities: each submodule's forward at 64 and 128 px (B=8), with
and without both s2d flags; one sup and one unsup step at the CelebA-64
widths (B=8, k=100): the loss and the gradient (Adam's first moment after
the step, all leaves as one vector). The loss, a scalar that bf16 may move
by only a few f32 ulps, is held within max(half the gap, 16 ulps)
(``assert_loss_close``). The steps use the 64 px widths
because at the 16 px test widths a few bf16 rounding flips in the encoder
swing the sup loss's importance weight further than bf16 moves it from
f32. The conditional prior is f32 in every mode, so its bf16 and f32
outputs must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.train.state import create_train_state
from gltvae.train.steps import make_train_steps as j_make_train_steps
from tests.test_torch_config_bridge import jax_params, scheme_mu, torch_model
from tests.tf_twin import reconstruct_noise

import gltvae_torch.config as tcfg
from gltvae_torch.bridge import state_dict_to_params
from gltvae_torch.train.state import create_train_state as t_create
from gltvae_torch.train.steps import make_train_steps

torch.set_num_threads(2)

BF16 = dict(compute_dtype='bfloat16')


def rel_l2(got, want):
    got, want = (np.ravel(np.asarray(a, np.float64)) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_closer_than_half(port, j_bf16, j_f32, what):
    gap = rel_l2(j_bf16, j_f32)
    assert gap > 0, f'{what}: gltvae bf16 equals f32'
    assert rel_l2(port, j_bf16) <= 0.5 * gap, (
        f'{what}: port vs gltvae bf16 {rel_l2(port, j_bf16):.3e} > half of '
        f'gltvae bf16 vs f32 {gap:.3e}')


def _configs(name, **kw):
    jm, _ = getattr(jcfg, name)()
    tm, _ = getattr(tcfg, name)()
    return dataclasses.replace(jm, **kw), dataclasses.replace(tm, **kw)


@pytest.fixture(scope='module', params=[
    ('default_celeba64', {}), ('celeba128', {}),
    ('default_celeba64', dict(input_s2d=True, output_s2d=True))],
    ids=['64px', '128px', '64px_s2d'])
def setup(request):
    name, s2d = request.param
    jm, tm = _configs(name, **s2d)
    params = jax_params(jm, scheme_mu(jm), seed=1)
    j_f32 = JCCVAE(jm)
    j_bf16 = JCCVAE(dataclasses.replace(jm, **BF16))
    port = torch_model(dataclasses.replace(tm, **BF16), params)
    return jm, params, j_f32, j_bf16, port


def test_encoder_and_decoder(setup):
    jm, params, j_f32, j_bf16, port = setup
    r = np.random.RandomState(0)
    size = jm.image_size
    x = r.rand(8, size, size, 3).astype(np.float32)
    z = r.randn(4, jm.z_dim).astype(np.float32)
    with torch.no_grad():
        tl, ts_ = port.encode(torch.from_numpy(x))
        td = port.decode(torch.from_numpy(z))
    assert tl.dtype == ts_.dtype == td.dtype == torch.float32
    jb = j_bf16.encode(params, jnp.asarray(x))
    jf = j_f32.encode(params, jnp.asarray(x))
    assert_closer_than_half(tl, jb[0], jf[0], 'encoder locs')
    assert_closer_than_half(ts_, jb[1], jf[1], 'encoder scale')
    assert_closer_than_half(td, j_bf16.decode(params, jnp.asarray(z)),
                            j_f32.decode(params, jnp.asarray(z)), 'decoder')


def test_classifier_and_cond_prior(setup):
    jm, params, j_f32, j_bf16, port = setup
    r = np.random.RandomState(2)
    zc = r.randn(8, jm.z_classify).astype(np.float32)
    gates = r.rand(jm.z_classify, jm.y_dim).astype(np.float32)
    y = (r.rand(8, jm.y_dim) > 0.5).astype(np.float32)
    args = (jnp.asarray(zc), jnp.asarray(gates))
    with torch.no_grad():
        logits = port.classify(torch.from_numpy(zc), torch.from_numpy(gates))
        loc, sc = port.prior_zc(torch.from_numpy(y), torch.from_numpy(gates))
    assert logits.dtype == torch.float32
    assert_closer_than_half(logits, j_bf16.classify(params, *args),
                            j_f32.classify(params, *args), 'classifier')
    # both take the product of the same bf16-rounded operands in f32: a
    # product rounded to bf16 (a bf16 torch.matmul) would be ~2e-3 off
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(j_bf16.classify(params, *args)),
                               rtol=1e-5, atol=1e-6)
    jloc, jsc = j_bf16.prior_zc(params, jnp.asarray(y), jnp.asarray(gates))
    floc, fsc = j_f32.prior_zc(params, jnp.asarray(y), jnp.asarray(gates))
    assert np.array_equal(jloc, floc) and np.array_equal(jsc, fsc)
    f32_port = torch_model(tcfg.ModelConfig(
        **{k: v for k, v in dataclasses.asdict(jm).items()}), params)
    with torch.no_grad():
        loc32, sc32 = f32_port.prior_zc(torch.from_numpy(y),
                                        torch.from_numpy(gates))
    assert torch.equal(loc, loc32) and torch.equal(sc, sc32)
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=1e-5,
                               atol=1e-5)


B, K = 8, 100


@pytest.fixture(scope='module')
def steps():
    """One sup then one unsup step from one state: gltvae at bf16 and at
    f32, the port at bf16 and at f32, each port step with the noise gltvae
    drew. Returns {run: [(loss, Adam m tree), ...]}."""
    jm, tm = _configs('default_celeba64')
    params = jax_params(jm, scheme_mu(jm), seed=5)
    r = np.random.RandomState(6)
    x = r.randint(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    y = (r.rand(B, jm.y_dim) > 0.5).astype(np.float32)
    cfg = jcfg.TrainConfig(batch_size=B)
    out, noises = {}, []
    for dt in ('bfloat16', 'float32'):
        model = JCCVAE(dataclasses.replace(jm, compute_dtype=dt))
        state = create_train_state(model, cfg, jax.random.key(0),
                                   params=jax.tree.map(jnp.asarray, params))
        fns = [jax.jit(f) for f in j_make_train_steps(model, cfg, jit=False)]
        out[f'gltvae_{dt}'] = []
        for sup, fn in zip((True, False), fns):
            if dt == 'bfloat16':
                noises.append(reconstruct_noise(state.next_rng(), sup, B, K,
                                                z_dim=jm.z_dim,
                                                y_dim=jm.y_dim))
            state, m = fn(state, jnp.asarray(x), jnp.asarray(y), 1.0)
            out[f'gltvae_{dt}'].append(
                (float(m['loss']), jax.device_get(state.opt_state.mu)))
    for dt in ('bfloat16', 'float32'):
        model = torch_model(dataclasses.replace(tm, compute_dtype=dt),
                            params)
        tcfg_ = tcfg.TrainConfig(batch_size=B)
        state = t_create(model, tcfg_)
        out[f'port_{dt}'] = []
        for fn, noise in zip(make_train_steps(model, tcfg_), noises):
            state, m = fn(state, torch.from_numpy(x), torch.from_numpy(y),
                          1.0, noise={k: torch.tensor(v)
                                      for k, v in noise.items()})
            # copies: the next step updates the moments in place
            out[f'port_{dt}'].append((float(m['loss']), jax.tree.map(
                np.copy, state_dict_to_params(state.adam_m))))
    return out


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(a))
                           for a in jax.tree.leaves(tree)])


def assert_loss_close(port, j_bf16, j_f32, what):
    """The scalar loss: the port within max(half of gltvae's bf16-vs-f32
    gap, 16 f32 ulps of the loss) of gltvae's bf16 loss. Where bf16 moves
    the loss by only a few ulps (the unsup loss, ~7 ulps at ~1.2e4), half
    the gap is f32 summation noise, which XLA's threaded CPU reductions
    change from run to run; the ulp floor keeps the check off that noise.
    The gradient check below is what tells bf16 from f32."""
    gap = abs(j_bf16 - j_f32)
    assert gap > 0, f'{what}: gltvae bf16 equals f32'
    ulps = 16 * float(np.spacing(np.float32(abs(j_bf16))))
    err = abs(port - j_bf16)
    assert err <= max(0.5 * gap, ulps), (
        f'{what}: port vs gltvae bf16 {err:.3e} > max(half of gltvae bf16 '
        f'vs f32 {gap:.3e}, 16 ulps {ulps:.3e}); port = {port!r}, '
        f'j_bf16 = {j_bf16!r}, j_f32 = {j_f32!r}')
    return err / gap


@pytest.mark.parametrize('i,kind', [(0, 'sup'), (1, 'unsup')])
def test_steps(steps, i, kind, record_property):
    (pl, pm), (bl, bm), (fl, fm) = (steps[k][i] for k in (
        'port_bfloat16', 'gltvae_bfloat16', 'gltvae_float32'))
    assert jax.tree.structure(pm) == jax.tree.structure(bm)
    # port-vs-bf16 over bf16-vs-f32, kept in the junit XML
    record_property('loss_ratio', assert_loss_close(pl, bl, fl,
                                                    f'{kind} loss'))
    assert_closer_than_half(_flat(pm), _flat(bm), _flat(fm),
                            f'{kind} gradient (Adam m)')


@pytest.mark.parametrize('i', [0, 1])
def test_an_f32_port_fails_the_rule(steps, i):
    """The port at f32 is as far from gltvae's bf16 step as gltvae's f32
    step is: the rule above tells the two apart."""
    (pl, pm), (bl, bm), (fl, fm) = (steps[k][i] for k in (
        'port_float32', 'gltvae_bfloat16', 'gltvae_float32'))
    with pytest.raises(AssertionError, match='half of'):
        assert_closer_than_half(_flat(pm), _flat(bm), _flat(fm), 'f32')
