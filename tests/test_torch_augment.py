"""The augment kernel's wrapper, plain version and draw, and augmented train
steps, against the JAX package.

Plain augment vs gltvae's Pallas kernel (interpret mode): tolerance 0, as
u32 views. Both are a crop (exact), a mirror (exact) and one f32 multiply
by f32(1/255). Augmented steps: the tolerances of test_torch_steps.py.

JAX is imported inside the tests that compare with it, so that the card
test runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_augment.py
"""

import numpy as np
import pytest
import torch

from gltvae_torch.ops import preprocess
from gltvae_torch.ops.preprocess import (augment_reference, draw_crop_flip,
                                         fused_augment,
                                         fused_augment_given,
                                         fused_augment_stacked,
                                         fused_augment_stacked_given)
from gltvae_torch.train.state import step_seed

torch.set_num_threads(2)

# label: (u8 shape, crop, how the offsets and flips are set)
CASES = {
    'drawn_64': ((8, 72, 72, 3), 64, 'drawn'),
    'drawn_128': ((2, 136, 136, 3), 128, 'drawn'),
    'one_channel': ((4, 20, 20, 1), 16, 'drawn'),
    'odd_b_nonsquare': ((5, 21, 19, 3), 16, 'drawn'),
    'origin': ((4, 20, 20, 3), 16, 'origin'),
    'far_corner': ((4, 21, 19, 3), 16, 'far'),
    'all_flip': ((4, 20, 20, 3), 16, 'flip'),
    'no_flip': ((4, 20, 20, 3), 16, 'no_flip'),
}


def _draws(rng, lead, H, W, S, how='drawn'):
    """int32 (dy, dx, fl) of shape `lead`, in range, made with numpy."""
    dy = rng.randint(0, H - S + 1, lead)
    dx = rng.randint(0, W - S + 1, lead)
    fl = rng.randint(0, 2, lead)
    if how == 'origin':
        dy, dx = 0 * dy, 0 * dx
    elif how == 'far':
        dy, dx = 0 * dy + H - S, 0 * dx + W - S
    elif how in ('flip', 'no_flip'):
        fl = 0 * fl + (how == 'flip')
    return tuple(np.asarray(v, np.int32) for v in (dy, dx, fl))


def _case(label, seed=0):
    shape, S, how = CASES[label]
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, shape, dtype=np.uint8)
    return u8, _draws(rng, shape[:-3], shape[-3], shape[-2], S, how), S


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _u32_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize('label', list(CASES))
def test_plain_augment_bit_equal_to_gltvae(label):
    import jax.numpy as jnp
    from gltvae.ops.pallas.preprocess import fused_augment_given as j_aug
    u8, (dy, dx, fl), S = _case(label)
    want = j_aug(*(jnp.asarray(a) for a in (u8, dy, dx, fl)), S,
                 interpret=True)
    got = fused_augment_given(*_torch(u8, dy, dx, fl), S)
    _u32_equal(got.numpy(), want)
    assert got.shape == (u8.shape[0], S, S, u8.shape[-1])


def test_plain_stacked_bit_equal_to_gltvae():
    import jax.numpy as jnp
    from gltvae.ops.pallas.preprocess import \
        fused_augment_stacked_given as j_aug
    rng = np.random.RandomState(1)
    u8 = rng.randint(0, 256, (3, 4, 20, 20, 3), dtype=np.uint8)
    draws = _draws(rng, (3, 4), 20, 20, 16)
    want = j_aug(*(jnp.asarray(a) for a in (u8, *draws)), 16,
                 interpret=True)
    got = fused_augment_stacked_given(*_torch(u8, *draws), 16)
    _u32_equal(got.numpy(), want)


def test_plain_version_is_crop_mirror_multiply():
    """Independent of gltvae: the crop of a known image, by numpy."""
    u8, (dy, dx, fl), S = _case('odd_b_nonsquare', seed=3)
    got = augment_reference(*_torch(u8, dy, dx, fl), S).numpy()
    for b in range(len(u8)):
        crop = u8[b, dy[b]:dy[b] + S, dx[b]:dx[b] + S]
        crop = crop[:, ::-1] if fl[b] else crop
        _u32_equal(got[b], crop.astype(np.float32) * np.float32(1 / 255))


def test_cpu_wrapper_takes_the_plain_version_without_launching():
    before = preprocess.augment_launches
    u8, draws, S = _case('drawn_64')
    args = _torch(u8, *draws)
    assert torch.equal(fused_augment_given(*args, S),
                       augment_reference(*args, S))
    assert preprocess.augment_launches == before


def test_wrapper_rejects_bad_input():
    u8, (dy, dx, fl), S = _case('all_flip')
    tu8, tdy, tdx, tfl = _torch(u8, dy, dx, fl)
    with pytest.raises(TypeError, match='uint8'):
        fused_augment_given(tu8.float(), tdy, tdx, tfl, S)
    with pytest.raises(TypeError, match='int32'):
        fused_augment_given(tu8, tdy.long(), tdx, tfl, S)
    with pytest.raises(ValueError, match='shape'):
        fused_augment_given(tu8, tdy[:2], tdx, tfl, S)
    with pytest.raises(ValueError, match='smaller than crop 24'):
        fused_augment_given(tu8, tdy, tdx, tfl, 24)
    with pytest.raises(ValueError, match='contiguous'):
        fused_augment_given(tu8.transpose(1, 2), tdy, tdx, tfl, S)
    with pytest.raises(ValueError, match='5-d'):
        fused_augment_stacked_given(tu8, tdy, tdx, tfl, S)


def _gen(seed, step):
    return torch.Generator().manual_seed(step_seed(seed + 2, step))


def test_draw_is_reproducible_from_seed_and_step():
    a = draw_crop_flip(_gen(0, 5), 64, 72, 72, 64)
    b = draw_crop_flip(_gen(0, 5), 64, 72, 72, 64)
    c = draw_crop_flip(_gen(0, 6), 64, 72, 72, 64)
    for u, v in zip(a, b):
        assert u.dtype == torch.int32 and u.shape == (64,)
        assert torch.equal(u, v)
    assert not all(torch.equal(u, w) for u, w in zip(a, c))
    assert not draw_crop_flip(_gen(0, 5), 64, 72, 72, 64, flip=False)[2].any()


def test_stacked_draw_equals_per_step_draws():
    u8 = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (3, 4, 20, 20, 3), dtype=np.uint8))
    stacked = fused_augment_stacked(u8, [_gen(0, 7 + i) for i in range(3)],
                                    16)
    for i in range(3):
        assert torch.equal(stacked[i], fused_augment(u8[i], _gen(0, 7 + i),
                                                     16))
    with pytest.raises(ValueError, match='2 generators for 3'):
        fused_augment_stacked(u8, [_gen(0, 0)] * 2, 16)


def test_draw_covers_the_pad_range_and_flips_half():
    P, S = 4, 64
    dys, dxs, fls = zip(*(draw_crop_flip(_gen(0, s), 256, S + 2 * P,
                                         S + 2 * P, S) for s in range(16)))
    for v in (dys, dxs):
        assert sorted(set(torch.cat(v).tolist())) == list(range(2 * P + 1))
    rate = torch.cat(fls).double().mean().item()
    assert sorted(set(torch.cat(fls).tolist())) == [0, 1]
    assert abs(rate - 0.5) <= 0.03


# --------------------- augmented steps against gltvae ---------------------

B, K, PAD = 8, 100, 2


def augmented_steps():
    """An augmented sup step, then an augmented unsup step, from one state
    through both packages: the same padded batch and (dy, dx, fl) go
    through gltvae's Pallas kernel (interpret) and the port's augment,
    and gltvae's step noise is injected into the port. Yields (port
    metrics, gltvae metrics, port state, gltvae state, port batch)."""
    import jax
    import jax.numpy as jnp
    import gltvae.config as jcfg
    from gltvae.models.ccvae import CCVAE as JCCVAE
    from gltvae.ops.pallas.preprocess import fused_augment_given as j_aug
    from gltvae.train.state import create_train_state
    from gltvae.train.steps import make_train_steps as j_make_train_steps
    from tests.test_torch_config_bridge import (jax_params, scheme_mu,
                                                small_configs, torch_model)
    from tests.tf_twin import reconstruct_noise

    import gltvae_torch.config as tcfg
    from gltvae_torch.train.state import create_train_state as t_create
    from gltvae_torch.train.steps import make_train_steps

    jm, tm = small_configs()
    kw = dict(batch_size=B, perc_supervision=0.5, augment_pad=PAD)
    params = jax_params(jm, scheme_mu(jm), seed=5)
    jmodel = JCCVAE(jm)
    jstate = create_train_state(jmodel, jcfg.TrainConfig(**kw),
                                jax.random.key(0),
                                params=jax.tree.map(jnp.asarray, params))
    j_sup, j_unsup = (jax.jit(f) for f in j_make_train_steps(
        jmodel, jcfg.TrainConfig(**kw), jit=False))
    model = torch_model(tm, params)
    state = t_create(model, tcfg.TrainConfig(**kw))
    t_sup, t_unsup = make_train_steps(model, tcfg.TrainConfig(**kw))

    rng = np.random.RandomState(8)
    size = tm.image_size + 2 * PAD
    for sup in (True, False):
        u8 = rng.randint(0, 256, (B, size, size, 3), dtype=np.uint8)
        draws = _draws(rng, (B,), size, size, tm.image_size)
        y = (rng.rand(B, 4) > 0.5).astype(np.float32)
        jx = j_aug(*(jnp.asarray(a) for a in (u8, *draws)), tm.image_size,
                   interpret=True)
        tx = fused_augment_given(*_torch(u8, *draws), tm.image_size)
        noise = reconstruct_noise(jstate.next_rng(), sup, B, K, z_dim=8,
                                  y_dim=4)
        jstate, jmet = (j_sup if sup else j_unsup)(jstate, jx,
                                                   jnp.asarray(y), 1.0)
        state, tmet = (t_sup if sup else t_unsup)(
            state, tx, torch.from_numpy(y), 1.0,
            noise={k: torch.tensor(v) for k, v in noise.items()})
        yield tmet, jmet, state, jstate, tx


def test_augmented_steps_match_gltvae(monkeypatch):
    from gltvae_torch.bridge import state_dict_to_params
    from gltvae_torch.train import steps
    from tests.test_torch_steps import _leaves_close
    dequants = []
    real = steps.dequant
    monkeypatch.setattr(steps, 'dequant',
                        lambda *a, **k: dequants.append(1) or real(*a, **k))
    for tmet, jmet, state, jstate, tx in augmented_steps():
        assert tx.dtype == torch.float32
        assert state.step == int(jstate.step)
        assert set(tmet) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jmet[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        _leaves_close(state_dict_to_params(state.model.state_dict()),
                      jstate.params, rtol=0, atol=1e-7)
        _leaves_close(state_dict_to_params(state.adam_m),
                      jstate.opt_state.mu, rtol=1e-4, atol_frac=1e-5)
        _leaves_close(state_dict_to_params(state.adam_v),
                      jstate.opt_state.nu, rtol=1e-4, atol_frac=1e-5)
    assert state.step == 2
    assert dequants == []       # the augmented batch is not dequantized again


# ------------------------------- on the card -------------------------------

@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    before = preprocess.augment_launches
    calls = 0
    for label in CASES:
        u8, draws, S = _case(label, seed=4)
        args = [t.cuda() for t in _torch(u8, *draws)]
        got = fused_augment_given(*args, S)
        calls += 1
        assert torch.equal(got, augment_reference(*args, S)), label
        assert torch.equal(got.cpu(), augment_reference(
            *_torch(u8, *draws), S)), label
    # an unaligned source base pointer, odd B, odd S*C (scalar stores)
    buf = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, 5 * 21 * 19 * 3 + 1, dtype=np.uint8)).cuda()
    u8 = buf[1:].view(5, 21, 19, 3)
    assert u8.data_ptr() % 16 != 0
    draws = [t.cuda() for t in _torch(*_draws(np.random.RandomState(6),
                                              (5,), 21, 19, 15))]
    assert torch.equal(fused_augment_given(u8, *draws, 15),
                       augment_reference(u8, *draws, 15))
    calls += 1
    # stacked: one launch, equal to per-step launches
    rng = np.random.RandomState(7)
    u8 = torch.from_numpy(rng.randint(0, 256, (4, 8, 72, 72, 3),
                                      dtype=np.uint8)).cuda()
    draws = [t.cuda() for t in _torch(*_draws(rng, (4, 8), 72, 72, 64))]
    stacked = fused_augment_stacked_given(u8, *draws, 64)
    calls += 1
    assert torch.equal(stacked, augment_reference(u8, *draws, 64))
    for i in range(4):
        assert torch.equal(stacked[i], fused_augment_given(
            u8[i], *(d[i] for d in draws), 64))
        calls += 1
    torch.cuda.synchronize()
    assert preprocess.augment_launches == before + calls
