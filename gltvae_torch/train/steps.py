"""Train and eval steps (counterpart of gltvae/train/steps.py).

``make_train_steps`` returns (sup_step, unsup_step):
``(state, x, y, gating_temp, noise=None) -> (state, metrics)``. A step
dequantizes a uint8 batch on the device (the dequant kernel; an augmented
batch arrives as f32 already), draws its noise from the state's per-step
generator unless ``noise`` is given, takes the loss and its gradient, and
applies Keras Adam in place. ``metrics`` holds 0-d device tensors, so a
step never waits for the device.

``make_scan_train_steps`` and ``make_mixed_scan_train_step`` are the
multi-step chunks of ``steps_per_dispatch > 1``: a Python loop of the same
steps over a stacked [n, B, ...] batch already on the device, with metrics
stacked to [n]. They equal n per-step calls bit for bit. The resident
variants are not ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from gltvae_torch.config import TrainConfig, check_supported
from gltvae_torch.models.ccvae import CCVAE, Temps
from gltvae_torch.ops.preprocess import dequant
from gltvae_torch.ops.sampling import sample_gumbel
from gltvae_torch.train.state import TrainState, keras_adam_update


def draw_noise(model: CCVAE, batch: int, supervised: bool, k: int,
               generator: torch.Generator) -> dict:
    """Every draw of one train step, in the order the losses take them."""
    c = model.cfg
    dev = model.mu.device
    n = lambda shape: torch.randn(shape, generator=generator, device=dev)
    gumbel = lambda: sample_gumbel(model.mu.shape, generator, device=dev)
    noise = {'eps_z': n((batch, c.z_dim)), 'g1': gumbel(), 'g2': gumbel()}
    if supervised:
        noise['eps_k'] = n((k, batch, c.z_dim))
    else:
        noise['u_y'] = torch.rand((batch, c.y_dim), generator=generator,
                                  device=dev)
    return noise


def _metrics(loss, aux):
    return {
        'loss': loss.detach(), 'elbo': aux.elbo.detach(),
        'log_pxz': aux.log_pxz.detach(), 'kl': aux.kl.detach(),
        'log_qy_zc': aux.log_qy_zc.detach(),
        'log_qy_x': aux.log_qy_x.detach(),
        'c_sum': torch.sum(aux.gates.detach()),
        'c_nan': torch.any(torch.isnan(aux.gates.detach())),
    }


def make_train_steps(model: CCVAE, train_cfg: TrainConfig
                     ) -> Tuple[Callable, Callable]:
    """(sup_step, unsup_step) for `model`; each updates the state in place
    and returns it with the step's metrics."""
    check_supported(model.cfg, train_cfg)
    gating_reg = train_cfg.gating_reg if model.cfg.mu_trainable else 0.0
    k = train_cfg.classifier_mc_samples
    size = model.cfg.image_size

    def _apply(state: TrainState, loss, aux):
        params = state.trainable()
        grads = torch.autograd.grad(loss, list(params.values()))
        keras_adam_update(state, dict(zip(params, grads)), train_cfg.lr,
                          eps=train_cfg.adam_eps)
        state.step += 1
        return state, _metrics(loss, aux)

    def sup_step(state: TrainState, x, y, gating_temp,
                 noise: Optional[dict] = None):
        x = _prep_image(x, size)
        if noise is None:
            noise = draw_noise(state.model, x.shape[0], True, k,
                               state.next_generator())
        loss, aux = state.model.sup_loss(
            x, y.to(torch.float32), Temps(gating=gating_temp),
            gating_reg=gating_reg, k=k, noise=noise)
        return _apply(state, loss, aux)

    def unsup_step(state: TrainState, x, y, gating_temp,
                   noise: Optional[dict] = None):
        del y  # unsupervised: labels unused
        x = _prep_image(x, size)
        if noise is None:
            noise = draw_noise(state.model, x.shape[0], False, k,
                               state.next_generator())
        loss, aux = state.model.unsup_loss(
            x, Temps(gating=gating_temp), gating_reg=gating_reg, noise=noise)
        return _apply(state, loss, aux)

    return sup_step, unsup_step


def make_mixed_scan_train_step(model: CCVAE, train_cfg: TrainConfig
                               ) -> Callable:
    """(state, xs, ys, sup_mask, gating_temp) -> (state, metrics [n]):
    inner step j runs the sup step where sup_mask[j], else the unsup step,
    on xs[j], ys[j]."""
    sup, unsup = make_train_steps(model, train_cfg)

    def chunk(state: TrainState, xs, ys, sup_mask: Sequence[bool],
              gating_temp):
        if not len(xs) == len(ys) == len(sup_mask):
            raise ValueError(f'chunk of {len(xs)} batches, {len(ys)} label '
                             f'batches and {len(sup_mask)} flags')
        mets = []
        for x, y, m in zip(xs, ys, sup_mask):
            state, met = (sup if m else unsup)(state, x, y, gating_temp)
            mets.append(met)
        return state, {k: torch.stack([m[k] for m in mets]) for k in mets[0]}
    return chunk


def make_scan_train_steps(model: CCVAE, train_cfg: TrainConfig
                          ) -> Tuple[Callable, Callable]:
    """Uniform chunks (scan_sup, scan_unsup):
    (state, xs, ys, gating_temp) -> (state, metrics [n])."""
    chunk = make_mixed_scan_train_step(model, train_cfg)

    def make(sup: bool):
        def scan(state: TrainState, xs, ys, gating_temp):
            return chunk(state, xs, ys, [sup] * len(xs), gating_temp)
        return scan
    return make(True), make(False)


def make_eval_step(model: CCVAE, train_cfg: TrainConfig) -> Callable:
    """(model, x, y, generator, gating_temp) -> batch accuracy (0-d tensor).
    Stochastic unless train_cfg.deterministic_eval."""
    det = train_cfg.deterministic_eval
    size = model.cfg.image_size

    @torch.no_grad()
    def eval_step(model: CCVAE, x, y, generator, gating_temp):
        x = _prep_image(x, size)
        return model.classifier_accuracy(x, y.to(torch.float32),
                                         Temps(gating=gating_temp),
                                         deterministic=det,
                                         generator=generator)
    return eval_step


def make_elbo_eval_step(model: CCVAE, train_cfg: TrainConfig) -> Callable:
    """(model, x, generator, gating_temp) -> mean unsupervised ELBO."""
    size = model.cfg.image_size

    @torch.no_grad()
    def elbo_step(model: CCVAE, x, generator, gating_temp):
        x = _prep_image(x, size)
        _, aux = model.unsup_loss(x, Temps(gating=gating_temp),
                                  generator=generator)
        return aux.elbo
    return elbo_step


def _as_f32_image(x):
    """uint8 [0,255] -> f32 [0,1] through the dequant kernel (its divide
    form, which rounds as the JAX step's x / 255.0); f32 passes through."""
    if x.dtype == torch.uint8:
        return dequant(x, 'div')
    return x


def _prep_image(x, image_size: int):
    """Device-side input stage: dequant, and the JAX package's guards on
    the batch resolution. The full-res device resize is not ported yet."""
    x = _as_f32_image(x)
    h, w = x.shape[-3], x.shape[-2]
    if h == image_size and w == image_size:
        return x
    if h > image_size and w > image_size:
        if h == w and h < 2 * image_size:
            raise ValueError(
                f'square {h}x{h} train batch at under 2x the model '
                f'resolution {image_size}: this looks like a padded '
                f'augmentation loader (DataConfig.augment_pad='
                f'{(h - image_size) // 2}) feeding a step built with '
                f'TrainConfig.augment_pad=0 — set both pads to the same '
                f'value')
        raise NotImplementedError(
            'device resize of full-res batches: ROADMAP Queue 1 item 11 '
            '(ops/resize.py)')
    raise ValueError(
        f'batch resolution {h}x{w} is neither the model resolution '
        f'{image_size}x{image_size} nor a full-res ship to downscale')
