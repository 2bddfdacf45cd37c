"""TrainConfig.remat in the port: 'full' and 'dots' recompute the loss's
forward in the backward pass and must train as 'none' does.

Tolerances are tests/test_trainer_scan.py's remat test's (loss rtol 1e-5;
params rtol 1e-4, atol 1e-6). On the CPU the port does better: recomputed
ops repeat the same arithmetic, so params, Adam moments and metrics come
out bit-equal, which the test also asserts.

What 'dots' keeps: the outputs of aten.mm and aten.addmm (2-d products, no
batch dims), the port's reading of the JAX package's
dots_with_no_batch_dims_saveable, under which a convolution is not a
dot_general and is recomputed. Shown two ways: the loss's saved tensors
do not reach an outer saved_tensors_hooks (checkpoint holds them), and
the backward pass re-runs every forward convolution and no addmm."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_config_bridge import small_configs

import gltvae_torch.config as tcfg
from gltvae_torch.models.ccvae import Temps
from gltvae_torch.train.state import create_train_state, init_model
from gltvae_torch.train.steps import (DOTS_SAVED, draw_noise,
                                      make_train_steps, remat)

torch.set_num_threads(2)

BS = 8


def _two_steps(mode, **model_kw):
    _, tm = small_configs(**model_kw)
    cfg = tcfg.TrainConfig(batch_size=BS, classifier_mc_samples=4,
                           remat=mode)
    model = init_model(tm, cfg, np.eye(4, dtype=np.float32))
    state = create_train_state(model, cfg)
    sup, unsup = make_train_steps(model, cfg)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 256, (BS, 16, 16, 3), dtype=np.uint8))
    y = torch.from_numpy((rng.rand(BS, 4) > 0.5).astype(np.float32))
    state, m1 = sup(state, x, y, 1.0)
    state, m2 = unsup(state, x, y, 1.0)
    return state, (m1, m2)


@pytest.mark.parametrize('model_kw', [
    {}, dict(compute_dtype='bfloat16', input_s2d=True, output_s2d=True)],
    ids=['f32', 'bf16_s2d'])
@pytest.mark.parametrize('mode', ['full', 'dots'])
def test_remat_trains_as_none(mode, model_kw):
    ref, ref_m = _two_steps('none', **model_kw)
    got, got_m = _two_steps(mode, **model_kw)
    for a, b in zip(got_m, ref_m):
        np.testing.assert_allclose(float(a['loss']), float(b['loss']),
                                   rtol=1e-5)
    for (n, p), q in zip(got.model.state_dict().items(),
                         ref.model.state_dict().values()):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)
    # bit-equal on the CPU, moments and metrics too
    for (n, p), q in zip(got.model.state_dict().items(),
                         ref.model.state_dict().values()):
        assert torch.equal(p, q), n
    for n in ref.adam_m:
        assert torch.equal(got.adam_m[n], ref.adam_m[n]), n
        assert torch.equal(got.adam_v[n], ref.adam_v[n]), n
    for a, b in zip(got_m, ref_m):
        assert all(torch.equal(a[k], b[k]) for k in b)


class _OpLog(TorchDispatchMode):
    """Logs the aten ops that run under it, and the output shapes of its
    convolutions."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.conv_shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        out = func(*args, **(kwargs or {}))
        if func == torch.ops.aten.convolution.default:
            self.conv_shapes.add(tuple(out.shape))
        return out


def _loss_and_backward(mode):
    """The sup loss of a small model under remat `mode`, with an outer
    saved_tensors_hooks around its forward and an op log around its
    backward. Returns (shapes the outer hook saw, forward log, backward
    log)."""
    _, tm = small_configs()
    cfg = tcfg.TrainConfig(batch_size=BS, classifier_mc_samples=4)
    model = init_model(tm, cfg, np.eye(4, dtype=np.float32))
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.rand(BS, 16, 16, 3).astype(np.float32))
    y = torch.from_numpy((rng.rand(BS, 4) > 0.5).astype(np.float32))
    noise = draw_noise(model, BS, True, 4, torch.Generator().manual_seed(0))

    def loss_fn(model, x, y, noise):
        return model.sup_loss(x, y, Temps(gating=1.0), gating_reg=0.2, k=4,
                              noise=noise)[0]
    seen = []
    fwd, bwd = _OpLog(), _OpLog()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: seen.append(tuple(t.shape)) or t, lambda t: t):
        with fwd:
            loss = remat(loss_fn, mode)(model, x, y, noise)
    with bwd:
        loss.backward()
    return seen, fwd, bwd


def test_dots_keeps_no_convolution_output():
    conv = torch.ops.aten.convolution.default
    seen_none, fwd_none, bwd_none = _loss_and_backward('none')
    seen_dots, fwd_dots, bwd_dots = _loss_and_backward('dots')
    conv_shapes = fwd_none.conv_shapes
    # without remat autograd saves conv outputs (ReLU keeps its result);
    # under 'dots' the outer hook sees only the checkpoint's inputs (the
    # NHWC images and the labels) and no convolution output
    assert conv_shapes & set(seen_none)
    assert sorted(seen_dots) == [(BS, 4), (BS, 16, 16, 3)]
    assert not conv_shapes & set(seen_dots)
    fwd_none, bwd_none = fwd_none.ops, bwd_none.ops
    fwd_dots, bwd_dots = fwd_dots.ops, bwd_dots.ops
    n_conv = fwd_none.count(conv)
    assert n_conv == fwd_dots.count(conv) == 3 + 3     # encoder + decoder
    assert bwd_none.count(conv) == 0
    # every convolution is run again in the backward pass: none was kept
    assert bwd_dots.count(conv) == n_conv
    # the 2-d products were kept: none re-runs (the backward's own
    # products are aten.mm, never addmm)
    saved = [op for op in fwd_dots if op in DOTS_SAVED]
    assert torch.ops.aten.mm.default in saved
    assert torch.ops.aten.addmm.default not in bwd_dots
    assert (bwd_dots.count(torch.ops.aten.mm.default)
            == bwd_none.count(torch.ops.aten.mm.default))


def test_full_recomputes_the_products_too():
    _, fwd_none, bwd_none = _loss_and_backward('none')
    bwd_full = _loss_and_backward('full')[2]
    fwd_none, bwd_none, bwd_full = fwd_none.ops, bwd_none.ops, bwd_full.ops
    mm = torch.ops.aten.mm.default
    assert bwd_full.count(mm) == bwd_none.count(mm) + fwd_none.count(mm)


def test_bogus_remat_mode_raises():
    _, tm = small_configs()
    cfg = tcfg.TrainConfig(remat='bogus')
    with pytest.raises(ValueError, match='remat'):
        make_train_steps(init_model(tm, cfg, np.eye(4, dtype=np.float32)),
                         cfg)
