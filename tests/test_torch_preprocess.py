"""The dequant kernel's wrapper and plain version against the JAX package.

Tolerance 0 throughout: both forms are exactly rounded f32 operations.

JAX is imported inside the tests that compare with it, so that the card
test runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_preprocess.py
"""

import numpy as np
import pytest
import torch

from gltvae_torch.ops import preprocess
from gltvae_torch.ops.preprocess import dequant, dequant_reference

torch.set_num_threads(2)

ALL_BYTES = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)


def _u8(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize('shape', [(8, 64, 64, 3), (3, 5, 7, 3),
                                   (1, 16, 16, 1)])
def test_div_form_bit_equal_to_jax_step(shape):
    import jax.numpy as jnp
    from gltvae.train.steps import _as_f32_image
    u8 = ALL_BYTES if shape == (1, 16, 16, 1) else _u8(shape)
    want = np.asarray(_as_f32_image(jnp.asarray(u8)))
    got = dequant(torch.from_numpy(u8), 'div').numpy()
    assert got.dtype == np.float32 and got.shape == u8.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize('shape', [(8, 64, 64, 3),    # tile-aligned: Pallas
                                   (3, 5, 7, 3)])     # ragged: XLA fallback
def test_mul_form_bit_equal_to_normalize_images(shape):
    import jax.numpy as jnp
    from gltvae.ops.pallas.preprocess import normalize_images
    u8 = _u8(shape, seed=1)
    want = np.asarray(normalize_images(jnp.asarray(u8), interpret=True))
    got = dequant(torch.from_numpy(u8), 'mul').numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_div_and_mul_forms_differ_on_126_byte_values():
    """x / 255 and x * (1/255) are different roundings; the main path must
    keep the divide (it is what the JAX step computes)."""
    u8 = torch.from_numpy(ALL_BYTES)
    div, mul = dequant(u8, 'div'), dequant(u8, 'mul')
    assert int((div != mul).sum()) == 126
    assert float((div - mul).abs().max()) <= float(np.spacing(np.float32(1)))


def test_cpu_wrapper_takes_the_plain_version_without_launching():
    before = preprocess.launches
    u8 = torch.from_numpy(_u8((2, 8, 8, 3)))
    assert torch.equal(dequant(u8), dequant_reference(u8))
    assert torch.equal(dequant(u8, 'mul', 0.5), u8.float() * 0.5)
    assert preprocess.launches == before


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        dequant(torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError):
        dequant(torch.zeros(4, dtype=torch.uint8), mode='sub')


@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    before = preprocess.launches
    buf = torch.from_numpy(_u8((256 * 64 * 64 * 3 + 1,), seed=2)).cuda()
    cases = [buf[:-1].view(256, 64, 64, 3),           # the bs-256 batch
             buf[:3 * 5 * 7 * 3].view(3, 5, 7, 3),    # numel % 16 != 0
             buf[1:12289].view(4, 32, 32, 3)]         # unaligned base
    for u8 in cases:
        for mode in ('div', 'mul'):
            assert torch.equal(dequant(u8, mode), dequant_reference(u8, mode))
    torch.cuda.synchronize()
    assert preprocess.launches == before + 6
