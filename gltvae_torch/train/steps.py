"""Train and eval steps (counterpart of gltvae/train/steps.py).

``make_train_steps`` returns (sup_step, unsup_step):
``(state, x, y, gating_temp, noise=None) -> (state, metrics)``. A step
dequantizes a uint8 batch on the device (the dequant kernel; an augmented
batch arrives as f32 already) and resizes a full-resolution one
(``_prep_image``), draws its noise from the state's per-step generator
unless ``noise`` is given, takes the loss and its gradient, and applies
Keras Adam in place. ``metrics`` holds 0-d device tensors, so a step never
waits for the device.

``TrainConfig.remat`` recomputes the loss's forward in the backward pass
(``torch.utils.checkpoint``): 'none', 'full' (keeps only the loss's
inputs) or 'dots' (keeps the outputs of ``aten.mm`` and ``aten.addmm``,
the 2-d products with no batch dimension, and recomputes everything else,
convolutions and ``bmm`` included: what the JAX package's
``dots_with_no_batch_dims_saveable`` policy keeps, since a convolution is
not a ``dot_general``). The noise is drawn before the loss, so nothing
inside a recomputed region draws.

The multi-batch forms are Python loops of these steps with the same draws,
so they equal the per-batch calls bit for bit:
- ``make_scan_train_steps`` / ``make_mixed_scan_train_step``: chunks of
  ``steps_per_dispatch > 1`` over a stacked [n, B, ...] batch;
- ``make_scan_eval_step`` / ``make_scan_elbo_step``: eval chunks, one
  generator advanced batch by batch;
- the resident builders (``make_resident_*``): the split lives on the
  device and each batch is gathered from it by an [n, B] index tensor
  (``index_select`` of uint8 rows, then the dequant kernel), so the
  gathered bytes equal what the host would have shipped.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from gltvae_torch.config import TrainConfig
from gltvae_torch.models.ccvae import CCVAE, Temps
from gltvae_torch.ops.preprocess import dequant
from gltvae_torch.ops.resize import resize_bilinear
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


#: The ops whose outputs remat='dots' keeps: 2-d products, no batch dims.
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, mode: str) -> Callable:
    """``fn`` with its forward recomputed in the backward pass by
    ``mode`` ('none', 'full', 'dots'; see the module docstring)."""
    if mode == 'none':
        return fn
    if mode == 'full':
        kw = {}
    elif mode == 'dots':
        kw = {'context_fn': functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)}
    else:
        raise ValueError(f'unknown remat mode {mode!r} '
                         "(choices: 'none', 'full', 'dots')")

    # nothing inside draws (the noise is an argument), so no RNG state is
    # stashed for the recomputation
    @functools.wraps(fn)
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return wrapped


def make_train_steps(model: CCVAE, train_cfg: TrainConfig
                     ) -> Tuple[Callable, Callable]:
    """(sup_step, unsup_step) for `model`; each updates the state in place
    and returns it with the step's metrics."""
    gating_reg = train_cfg.gating_reg if model.cfg.mu_trainable else 0.0
    k = train_cfg.classifier_mc_samples
    size = model.cfg.image_size

    def sup_loss(model, x, y, temps, noise):
        return model.sup_loss(x, y, temps, gating_reg=gating_reg, k=k,
                              noise=noise)

    def unsup_loss(model, x, temps, noise):
        return model.unsup_loss(x, temps, gating_reg=gating_reg, noise=noise)

    sup_loss = remat(sup_loss, train_cfg.remat)
    unsup_loss = remat(unsup_loss, train_cfg.remat)

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
        loss, aux = sup_loss(state.model, x, y.to(torch.float32),
                             Temps(gating=gating_temp), noise)
        return _apply(state, loss, aux)

    def unsup_step(state: TrainState, x, y, gating_temp,
                   noise: Optional[dict] = None):
        del y  # unsupervised: labels unused
        x = _prep_image(x, size)
        if noise is None:
            noise = draw_noise(state.model, x.shape[0], False, k,
                               state.next_generator())
        loss, aux = unsup_loss(state.model, x, Temps(gating=gating_temp),
                               noise)
        return _apply(state, loss, aux)

    return sup_step, unsup_step


def _run_chunk(sup, unsup, state: TrainState, batches: Iterable,
               sup_mask: Sequence[bool], gating_temp):
    """Inner step j runs `sup` where sup_mask[j], else `unsup`, on the j-th
    (x, y) of `batches`; metrics are stacked to [n]."""
    mets = []
    for (x, y), m in zip(batches, sup_mask):
        state, met = (sup if m else unsup)(state, x, y, gating_temp)
        mets.append(met)
    return state, {k: torch.stack([m[k] for m in mets]) for k in mets[0]}


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
        return _run_chunk(sup, unsup, state, zip(xs, ys), sup_mask,
                          gating_temp)
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


def make_resident_scan_train_steps(model: CCVAE, train_cfg: TrainConfig
                                   ) -> Tuple[Callable, Callable]:
    """Device-resident training chunks (scan_sup, scan_unsup):
    (state, images [N, H, W, C] u8, labels [N, y] f32, idxs [n, B] int,
    gating_temp) -> (state, metrics [n]). Inner step j trains on rows
    idxs[j], gathered on the device."""
    sup, unsup = make_train_steps(model, train_cfg)

    def make(kind: bool):
        def scan(state: TrainState, images, labels, idxs, gating_temp):
            batches = ((images.index_select(0, i), labels.index_select(0, i))
                       for i in idxs)
            return _run_chunk(sup, unsup, state, batches,
                              [kind] * len(idxs), gating_temp)
        return scan
    return make(True), make(False)


def make_resident_mixed_scan_train_step(model: CCVAE, train_cfg: TrainConfig
                                        ) -> Callable:
    """Semi-supervised resident chunks: (state, images_sup, labels_sup,
    images_unsup, labels_unsup, idxs [n, B], sup_mask [n], gating_temp) ->
    (state, metrics [n]). Row j of idxs indexes the sup split where
    sup_mask[j], else the unsup split: the row stream the host path's
    ``next(sup_iter if flag else unsup_iter)`` consumes."""
    sup, unsup = make_train_steps(model, train_cfg)

    def chunk(state: TrainState, images_sup, labels_sup, images_unsup,
              labels_unsup, idxs, sup_mask: Sequence[bool], gating_temp):
        if len(idxs) != len(sup_mask):
            raise ValueError(f'{len(idxs)} index rows and {len(sup_mask)} '
                             'flags')
        batches = (((images_sup if m else images_unsup).index_select(0, i),
                    (labels_sup if m else labels_unsup).index_select(0, i))
                   for i, m in zip(idxs, sup_mask))
        return _run_chunk(sup, unsup, state, batches, sup_mask, gating_temp)
    return chunk


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


def make_scan_eval_step(model: CCVAE, train_cfg: TrainConfig) -> Callable:
    """(model, xs, ys, generator, gating_temp) -> accs [n] over stacked
    [n, B, ...] batches: n make_eval_step calls with one generator."""
    ev = make_eval_step(model, train_cfg)

    def scan(model: CCVAE, xs, ys, generator, gating_temp):
        return torch.stack([ev(model, x, y, generator, gating_temp)
                            for x, y in zip(xs, ys)])
    return scan


def make_scan_elbo_step(model: CCVAE, train_cfg: TrainConfig) -> Callable:
    """(model, xs, generator, gating_temp) -> elbos [n] over stacked
    batches: n make_elbo_eval_step calls with one generator."""
    el = make_elbo_eval_step(model, train_cfg)

    def scan(model: CCVAE, xs, generator, gating_temp):
        return torch.stack([el(model, x, generator, gating_temp)
                            for x in xs])
    return scan


def make_resident_eval_step(model: CCVAE, train_cfg: TrainConfig
                            ) -> Callable:
    """Device-resident eval: (model, images, labels, idxs [n, B],
    generator, gating_temp) -> accs [n], batch j gathered from rows
    idxs[j]; the generator advances as in the per-batch path."""
    ev = make_eval_step(model, train_cfg)

    def resident(model: CCVAE, images, labels, idxs, generator,
                 gating_temp):
        return torch.stack([ev(model, images.index_select(0, i),
                               labels.index_select(0, i), generator,
                               gating_temp) for i in idxs])
    return resident


def make_resident_elbo_step(model: CCVAE, train_cfg: TrainConfig
                            ) -> Callable:
    """Device-resident ELBO: (model, images, idxs [n, B], generator,
    gating_temp) -> elbos [n]."""
    el = make_elbo_eval_step(model, train_cfg)

    def resident(model: CCVAE, images, idxs, generator, gating_temp):
        return torch.stack([el(model, images.index_select(0, i), generator,
                               gating_temp) for i in idxs])
    return resident


def _as_f32_image(x):
    """uint8 [0,255] -> f32 [0,1] through the dequant kernel (its divide
    form, which rounds as the JAX step's x / 255.0); f32 passes through."""
    if x.dtype == torch.uint8:
        return dequant(x, 'div')
    return x


def _prep_image(x, image_size: int):
    """Device-side input stage: dequant, then, for a full-resolution batch
    (DataConfig.device_resize, e.g. CelebA's 218x178), the bilinear resize
    to the model resolution. Any other resolution mismatch raises, and so
    does a square batch under 2x the model resolution: that is what a
    padded augmentation loader ships, and resizing it would train on
    blurred, shifted images."""
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
        return resize_bilinear(x, image_size, image_size)
    raise ValueError(
        f'batch resolution {h}x{w} is neither the model resolution '
        f'{image_size}x{image_size} nor a full-res ship to downscale')
