"""Train and eval steps (counterpart of gltvae/train/steps.py).

``make_train_steps`` returns (sup_step, unsup_step):
``(state, x, y, gating_temp, noise=None) -> (state, metrics)``. A step
draws its noise from the state's per-step generator unless ``noise`` is
given and advances the Adam count (its host part), then dequantizes a
uint8 batch on the device (the dequant kernel), crops a padded one
(``TrainConfig.augment_pad``: the augment kernel, its offsets drawn by
the host part) and resizes a full-resolution one (``_prep_image``), takes
the loss and its gradient, and applies Keras Adam in place (its device
part). ``metrics`` holds 0-d device tensors, so a step never waits for
the device.

By default every maker here is captured (``jit``, gltvae's ``jax.jit``):
the device part of each dispatch is a CUDA graph replayed on a CUDA
device (``train/graphs.py``), and on the CPU the same static-buffer path
runs eagerly; ``jit=False`` runs everything eagerly. The rule on a mesh
is ``resolve_jit``'s: captured over NCCL at every size, the static-buffer
path on the CPU, eager over gloo on CUDA tensors (where ``jit=True``
raises).
Captured, each dispatch is one replay:
- a train step (``make_train_steps``), one graph a step kind and input
  shape;
- a chunk of n steps (``make_scan_train_steps``,
  ``make_mixed_scan_train_step``, the resident chunk makers and
  ``mixed_chunk`` of two captured steps): one graph a sup/unsup mask
  pattern, whose host part draws the n steps' noise as n single steps
  would, so it equals them bit for bit;
- an eval or ELBO pass over n batches (``make_{scan_,resident_,}eval_
  step``, ``make_{scan_,resident_,}elbo_step``): its host part draws the
  n batches' noise from the one eval generator, batch by batch, as the
  eager pass does (``draw_eval_noise``, ``draw_noise``); a resident eval
  epoch is one replay.

A captured dispatch's host part draws only the raw variates, in the eager
order: z's normals, the two gate uniforms u1, u2, then eps_k or u_y
(``draw_noise(raw=True)``). Its device part turns the uniforms into the
gate Gumbels g1, g2 (``gate_gumbels``), as gltvae makes its noise inside
the jitted step: the ops of the eager draw's ``sample_gumbel`` on the same
values, so the same bits, with the six launches a gate inside the graph.
Noise given (``noise=``), or drawn by a function put in the place of
``draw_noise`` or ``draw_eval_noise`` that takes no ``raw`` (which is then
called without it), reaches the device part as it comes, Gumbels or
uniforms; each noise form (``noise_form``) has programs of its own.

``TrainConfig.remat`` recomputes the loss's forward in the backward pass
(``torch.utils.checkpoint``): 'none', 'full' (keeps only the loss's
inputs) or 'dots' (keeps the outputs of ``aten.mm`` and ``aten.addmm``,
the 2-d products with no batch dimension, and recomputes everything else,
convolutions and ``bmm`` included: what the JAX package's
``dots_with_no_batch_dims_saveable`` policy keeps, since a convolution is
not a ``dot_general``). The noise is drawn before the loss, so nothing
inside a recomputed region draws.

Eagerly, the multi-batch forms are Python loops of the per-batch steps
with the same draws, so they equal the per-batch calls bit for bit:
- ``make_scan_train_steps`` / ``make_mixed_scan_train_step``: chunks of
  ``steps_per_dispatch > 1`` over a stacked [n, B, ...] batch;
- ``make_scan_eval_step`` / ``make_scan_elbo_step``: eval chunks, one
  generator advanced batch by batch;
- the resident builders (``make_resident_*``): the split lives on the
  device and each batch is gathered from it by an [n, B] index tensor
  (``index_select`` of uint8 rows, then the dequant kernel), so the
  gathered bytes equal what the host would have shipped (a captured
  program gathers them inside its graph from a static index buffer).

Every maker takes ``dp``, a ``parallel.dp.DataParallel``, which makes its
steps the data-parallel ones of parallel/dp.py (gltvae's
``make_parallel_*``, jitted there as here); without it they run on one
device. With ``dp`` the host part draws the global batch's noise (into
global-size static buffers when captured) and the device part reads this
rank's rows of it as views, so the draws, and the generators after them,
are the eager data-parallel step's; a padded batch's crops are this
rank's rows of the global batch's; a resident program exchanges its rows
over the mesh (``parallel.dp.gather_rows``) inside its graph, and the
eval's all_gather and the gradient all-reduce run there too.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from gltvae_torch import trace
from gltvae_torch.config import TrainConfig
from gltvae_torch.models.ccvae import CCVAE, Temps
from gltvae_torch.ops import preprocess
from gltvae_torch.ops.preprocess import dequant
from gltvae_torch.ops.resize import resize_bilinear
from gltvae_torch.ops.sampling import gumbel_from_uniform, sample_gumbel
from gltvae_torch.train.graphs import (Crop, JitChunk, JitPass, JitStep,
                                       graph_pool, index_rows)
from gltvae_torch.train.state import (TrainState, keras_adam_update,
                                      next_alpha)


def _normal(shape, generator, device, out):
    if out is None:
        return torch.randn(shape, generator=generator, device=device)
    return torch.randn(shape, generator=generator, out=out)


def _uniform(shape, generator, device, out):
    if out is None:
        return torch.rand(shape, generator=generator, device=device)
    return torch.rand(shape, generator=generator, out=out)


def _gate_draws(model: CCVAE, generator: torch.Generator, out: dict,
                raw: bool) -> dict:
    """The two gate draws of μ's shape, in order: the Gumbels g1, g2, or
    with `raw` their uniforms u1, u2 (the same generator calls)."""
    mu = model.mu
    if raw:
        return {n: _uniform(mu.shape, generator, mu.device, out.get(n))
                for n in ('u1', 'u2')}
    return {n: sample_gumbel(mu.shape, generator, device=mu.device,
                             out=out.get(n))
            for n in ('g1', 'g2')}


def draw_noise(model: CCVAE, batch: int, supervised: bool, k: int,
               generator: torch.Generator, out: Optional[dict] = None,
               raw: bool = False) -> dict:
    """Every draw of one train step, in the order the losses take them
    (also an ELBO batch's: ``supervised`` False, k 0). With `out` (a dict
    of buffers of the draws' shapes) they are drawn into it. With `raw` the
    gates' draws are their uniforms u1, u2, which ``gate_gumbels`` turns
    into the Gumbels on the device; the generator ends where it would."""
    c = model.cfg
    dev = model.mu.device
    o = out or {}
    noise = {'eps_z': _normal((batch, c.z_dim), generator, dev,
                              o.get('eps_z'))}
    noise.update(_gate_draws(model, generator, o, raw))
    if supervised:
        noise['eps_k'] = _normal((k, batch, c.z_dim), generator, dev,
                                 o.get('eps_k'))
    else:
        noise['u_y'] = _uniform((batch, c.y_dim), generator, dev,
                                o.get('u_y'))
    trace.count_noise(noise)
    return noise


def draw_eval_noise(model: CCVAE, batch: int, generator: torch.Generator,
                    out: Optional[dict] = None, raw: bool = False) -> dict:
    """One stochastic eval batch's draws, in the order ``predict_probs``
    takes them from a generator: z's normals, then the two gate Gumbels
    (with `raw` their uniforms; on a mesh, the global batch's, of which
    each rank reads its rows). With `out` they are drawn into it."""
    o = out or {}
    noise = {'eps_z': _normal((batch, model.cfg.z_dim), generator,
                              model.mu.device, o.get('eps_z'))}
    noise.update(_gate_draws(model, generator, o, raw))
    trace.count_noise(noise)
    return noise


def draw_form(draw: Callable) -> str:
    """The form of what a host part draws through `draw`: 'uniform' where
    it takes ``raw`` (this module's draws, asked with ``raw=True``),
    'gumbel' where it does not (a draw put in their place, called without
    it)."""
    return ('uniform' if 'raw' in inspect.signature(draw).parameters
            else 'gumbel')


def gate_gumbels(noise: Optional[dict]) -> Optional[dict]:
    """`noise` with its gate uniforms u1, u2 turned into the Gumbels g1, g2
    (``gumbel_from_uniform``, out of place, so that a replay reads its
    static uniforms unchanged); noise of Gumbels, or None, as it is. The
    device parts run it first: the same ops on the same uniforms as
    ``sample_gumbel``, so the same bits as the eager draws."""
    if noise is None or 'u1' not in noise:
        return noise
    out = {k: v for k, v in noise.items() if k not in ('u1', 'u2')}
    out['g1'] = gumbel_from_uniform(noise['u1'])
    out['g2'] = gumbel_from_uniform(noise['u2'])
    return out


class StepDraws:
    """The host part's draws of one train step kind, ``(state, b, noise,
    out=None) -> noise``: `noise` when given, else drawn from the state's
    per-step generator through the module's ``draw_noise``, looked up at
    each call so that a draw put in its place is reached (into `out` when
    given; on a mesh the global batch's for b rows a rank,
    ``DataParallel.draws``). ``form``, fixed when it is made
    (``draw_form``), is what its draws are; ``kw`` asks for them."""

    def __init__(self, supervised: bool, k: int, dp=None):
        self.supervised, self.k, self.dp = supervised, k, dp
        self.form = draw_form(draw_noise)
        self.kw = {'raw': True} if self.form == 'uniform' else {}

    def __call__(self, state: TrainState, b: int, noise: Optional[dict],
                 out: Optional[dict] = None) -> dict:
        if self.dp is not None:
            return self.dp.draws(state, b, self.supervised, self.k, noise,
                                 out, **self.kw)
        if noise is None:
            noise = draw_noise(state.model, b, self.supervised, self.k,
                               state.next_generator(), out=out, **self.kw)
        return noise


class PassDraws:
    """The host part of one batch of a stochastic eval pass (``draw_eval_
    noise``) or, with `elbo`, of an ELBO pass (``draw_noise``,
    unsupervised, k 0): ``(model, b, generator, out=None) -> noise``
    through the module's function, looked up at each call; ``form`` and
    ``kw`` as ``StepDraws``'."""

    def __init__(self, elbo: bool = False):
        self.elbo = elbo
        self.form = draw_form(draw_noise if elbo else draw_eval_noise)
        self.kw = {'raw': True} if self.form == 'uniform' else {}

    def __call__(self, model: CCVAE, b: int, generator: torch.Generator,
                 out: Optional[dict] = None) -> dict:
        if self.elbo:
            return draw_noise(model, b, False, 0, generator, out=out,
                              **self.kw)
        return draw_eval_noise(model, b, generator, out=out, **self.kw)


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


def resolve_jit(jit: Optional[bool], dp) -> bool:
    """Whether a maker's dispatches are captured. `dp` is a
    ``DataParallel`` (or the Trainer's mesh), read through its mesh's
    record: on one device, on an NCCL mesh of any size (gltvae jits its
    mesh dispatches at every size) and on a CPU mesh, captured by default
    (on the CPU, the static-buffer path run eagerly); on a gloo mesh over
    CUDA tensors eager by default, and ``jit=True`` raises. A graph that
    holds NCCL's kernels keeps NCCL from destroying its communicator, so
    a process that left its group with a captured Trainer alive blocked
    there (fault F4); ``parallel.mesh.shutdown`` now releases every such
    graph before it leaves."""
    mesh = None if dp is None else getattr(dp, 'mesh', dp)
    if mesh is not None and mesh.device.type == 'cuda':
        if not mesh.capturable:
            if jit:
                raise ValueError(
                    f'jit=True on a {mesh.backend} mesh over {mesh.device}: '
                    f'gloo moves CUDA tensors through host memory, which a '
                    f'CUDA graph cannot hold; use NCCL (one rank a card) '
                    f'or pass jit=False')
            return False
    return True if jit is None else jit


def train_crop(model: CCVAE, train_cfg: TrainConfig,
               dp=None) -> Optional[Crop]:
    """The augment stage of `model`'s train steps (None without
    ``augment_pad``); with `dp`, its rank's rows of the global batch's
    draws."""
    if train_cfg.augment_pad <= 0:
        return None
    mesh = None if dp is None else dp.mesh
    return Crop(model.cfg.image_size, train_cfg.augment_pad, train_cfg.seed,
                *(() if mesh is None else (mesh.rank, mesh.world)))


def resident_gather(dp) -> Callable:
    """The row gather of `dp`'s resident programs, ``(sources, idxs) ->
    [(x, y)]``: ``graphs.index_rows`` on one device, the mesh's exchange
    (``DataParallel.step_batches``) on a mesh."""
    return index_rows if dp is None else dp.step_batches


def make_train_steps(model: CCVAE, train_cfg: TrainConfig, dp=None,
                     jit: Optional[bool] = None
                     ) -> Tuple[Callable, Callable]:
    """(sup_step, unsup_step) for `model`; each updates the state in place
    and returns it with the step's metrics. With `dp`
    (``parallel.dp.DataParallel``) they are the data-parallel steps: x, y
    are this rank's rows, `noise` is the global batch's draws, and the
    gradients and metrics are averaged over the ranks.

    A step is a host part (the noise, the augment offsets of a padded
    batch, the Adam count and alpha, the step counter) and a device part
    (input stage, loss, gradient, Keras Adam, metrics). With `jit` (the
    default on one device) the steps are ``graphs.JitStep``s: on a CUDA
    device the device part is a CUDA graph, captured once per input shape
    and dtype and replayed at each step (gltvae's ``jax.jit(step,
    donate_argnums=(0,))``); on the CPU the same static-buffer path runs
    eagerly. ``jit=False`` gives the plain eager steps. With `dp` the rule
    is ``resolve_jit``'s: the graph holds the gradient all-reduce.

    With ``train_cfg.augment_pad`` P > 0, a uint8 batch padded to S + 2P
    is cropped by the augment kernel inside the step (inside its graph
    when captured), with the offsets of global step ``state.step``
    (``graphs.Crop``; on a mesh this rank's rows of the global batch's);
    any other batch goes in as it is."""
    jit = resolve_jit(jit, dp)
    gating_reg = train_cfg.gating_reg if model.cfg.mu_trainable else 0.0
    k = train_cfg.classifier_mc_samples
    size = model.cfg.image_size
    crop = train_crop(model, train_cfg, dp)

    def sup_loss(model, x, y, temps, noise):
        return model.sup_loss(x, y, temps, gating_reg=gating_reg, k=k,
                              noise=noise)

    def unsup_loss(model, x, temps, noise):
        return model.unsup_loss(x, temps, gating_reg=gating_reg, noise=noise)

    sup_loss = remat(sup_loss, train_cfg.remat)
    unsup_loss = remat(unsup_loss, train_cfg.remat)

    def device_part(supervised: bool) -> Callable:
        """(state, x, y, gating_temp, alpha, noise) -> metrics: everything
        of a step that runs on the device, reading nothing back."""
        def part(state: TrainState, x, y, gating_temp, alpha, noise):
            noise = gate_gumbels(noise)
            if dp is not None:
                noise = dp.rows_of(noise)
            x = _prep_image(x, size)
            temps = Temps(gating=gating_temp)
            if supervised:
                loss, aux = sup_loss(state.model, x, y.to(torch.float32),
                                     temps, noise)
            else:               # unsupervised: labels unused
                loss, aux = unsup_loss(state.model, x, temps, noise)
            params = state.trainable()
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            metrics = _metrics(loss, aux)
            if dp is not None:
                grads, metrics = dp.average(grads, metrics)
            keras_adam_update(state, grads, train_cfg.lr,
                              eps=train_cfg.adam_eps, alpha=alpha)
            return metrics
        return part

    def eager(supervised: bool) -> Callable:
        part, draws = device_part(supervised), StepDraws(supervised, k, dp)

        def step(state: TrainState, x, y, gating_temp,
                 noise: Optional[dict] = None):
            noise = draws(state, x.shape[0], noise)
            if crop is not None and crop.takes(x.shape, x.dtype):
                x = preprocess.fused_augment_given(
                    x, *crop.draw(state.step, x.shape[0], x.device), size)
            alpha = next_alpha(state, train_cfg.lr)
            metrics = part(state, x, y, gating_temp, alpha, noise)
            state.step += 1
            return state, metrics
        step.__name__ = 'sup_step' if supervised else 'unsup_step'
        return step

    if not jit:
        return eager(True), eager(False)
    dev = model.mu.device
    pool = graph_pool(dev)
    return tuple(JitStep(device_part(s), StepDraws(s, k, dp), train_cfg.lr,
                         dev, pool, crop, dp)
                 for s in (True, False))


def _stack(mets):
    return {k: torch.stack([m[k] for m in mets]) for k in mets[0]}


def _run_chunk(sup, unsup, state: TrainState, batches: Iterable,
               sup_mask: Sequence[bool], gating_temp):
    """Inner step j runs `sup` where sup_mask[j], else `unsup`, on the j-th
    (x, y) of `batches`; metrics are stacked to [n]."""
    mets = []
    for (x, y), m in zip(batches, sup_mask):
        state, met = (sup if m else unsup)(state, x, y, gating_temp)
        mets.append(met)
    return state, _stack(mets)


def mixed_chunk(sup: Callable, unsup: Callable) -> Callable:
    """(state, xs, ys, sup_mask, gating_temp) -> (state, metrics [n]) of
    the steps `sup` and `unsup`: inner step j runs `sup` where
    sup_mask[j], else `unsup`, on xs[j], ys[j]. Two captured steps give a
    ``graphs.JitChunk`` (one replay a chunk), any others a loop."""
    if isinstance(sup, JitStep) and isinstance(unsup, JitStep):
        return JitChunk(sup, unsup)

    def chunk(state: TrainState, xs, ys, sup_mask: Sequence[bool],
              gating_temp):
        if not len(xs) == len(ys) == len(sup_mask):
            raise ValueError(f'chunk of {len(xs)} batches, {len(ys)} label '
                             f'batches and {len(sup_mask)} flags')
        return _run_chunk(sup, unsup, state, zip(xs, ys), sup_mask,
                          gating_temp)
    return chunk


def make_mixed_scan_train_step(model: CCVAE, train_cfg: TrainConfig,
                               dp=None, jit: Optional[bool] = None
                               ) -> Callable:
    """(state, xs, ys, sup_mask, gating_temp) -> (state, metrics [n]):
    inner step j runs the sup step where sup_mask[j], else the unsup step,
    on xs[j], ys[j]. `jit` as ``make_train_steps``: a chunk is one replay
    of the graph of its mask pattern."""
    return mixed_chunk(*make_train_steps(model, train_cfg, dp, jit))


def make_scan_train_steps(model: CCVAE, train_cfg: TrainConfig, dp=None,
                          jit: Optional[bool] = None
                          ) -> Tuple[Callable, Callable]:
    """Uniform chunks (scan_sup, scan_unsup):
    (state, xs, ys, gating_temp) -> (state, metrics [n])."""
    chunk = make_mixed_scan_train_step(model, train_cfg, dp, jit)

    def make(sup: bool):
        def scan(state: TrainState, xs, ys, gating_temp):
            return chunk(state, xs, ys, [sup] * len(xs), gating_temp)
        return scan
    return make(True), make(False)


def make_resident_scan_train_steps(model: CCVAE, train_cfg: TrainConfig,
                                   dp=None, jit: Optional[bool] = None
                                   ) -> Tuple[Callable, Callable]:
    """Device-resident training chunks (scan_sup, scan_unsup):
    (state, images [N, H, W, C] u8, labels [N, y] f32, idxs [n, B] int,
    gating_temp) -> (state, metrics [n]). Inner step j trains on rows
    idxs[j], gathered on the device (a captured chunk gathers them inside
    its graph). With `dp`, images are this rank's resident rows
    (``parallel.dp.place_resident_split``) and one exchange gathers the
    chunk's rows (inside the graph when captured)."""
    sup, unsup = make_train_steps(model, train_cfg, dp, jit)
    jchunk = JitChunk(sup, unsup) if isinstance(sup, JitStep) else None
    gather = resident_gather(dp)

    def make(kind: bool):
        def scan(state: TrainState, images, labels, idxs, gating_temp):
            sources = [(images, labels)] * len(idxs)
            mask = [kind] * len(idxs)
            if jchunk is not None:
                return jchunk.gathered(state, sources, idxs, mask,
                                       gating_temp)
            return _run_chunk(sup, unsup, state, gather(sources, idxs), mask,
                              gating_temp)
        return scan
    return make(True), make(False)


def make_resident_mixed_scan_train_step(model: CCVAE, train_cfg: TrainConfig,
                                        dp=None, jit: Optional[bool] = None
                                        ) -> Callable:
    """Semi-supervised resident chunks: (state, images_sup, labels_sup,
    images_unsup, labels_unsup, idxs [n, B], sup_mask [n], gating_temp) ->
    (state, metrics [n]). Row j of idxs indexes the sup split where
    sup_mask[j], else the unsup split: the row stream the host path's
    ``next(sup_iter if flag else unsup_iter)`` consumes. With `dp`, one
    exchange a split gathers the rows of its steps
    (``resident_gather``)."""
    sup, unsup = make_train_steps(model, train_cfg, dp, jit)
    jchunk = JitChunk(sup, unsup) if isinstance(sup, JitStep) else None
    gather = resident_gather(dp)

    def chunk(state: TrainState, images_sup, labels_sup, images_unsup,
              labels_unsup, idxs, sup_mask: Sequence[bool], gating_temp):
        if len(idxs) != len(sup_mask):
            raise ValueError(f'{len(idxs)} index rows and {len(sup_mask)} '
                             'flags')
        sources = [(images_sup, labels_sup) if m
                   else (images_unsup, labels_unsup) for m in sup_mask]
        if jchunk is not None:
            return jchunk.gathered(state, sources, idxs, sup_mask,
                                   gating_temp)
        return _run_chunk(sup, unsup, state, gather(sources, idxs), sup_mask,
                          gating_temp)
    return chunk


def _accuracy(model: CCVAE, x, y, temps: Temps, det: bool, noise, dp):
    """One eval batch's accuracy from its draws `noise` (None when
    deterministic; its gate uniforms become Gumbels here): with `dp`, x
    and y are this rank's rows, `noise` the global batch's draws, and the
    matches are gathered over the ranks."""
    noise = gate_gumbels(noise)
    if dp is None:
        return model.classifier_accuracy(x, y.to(torch.float32), temps,
                                         deterministic=det, noise=noise)
    y_hat = model.predict_labels(x, temps, det,
                                 None if det else dp.rows_of(noise))
    return dp.mean_rows((y_hat == y.to(y_hat.dtype)).to(torch.float32))


def _elbo(model: CCVAE, x, temps: Temps, noise, dp):
    """One ELBO batch's mean ELBO from its draws; with `dp`, this rank's
    rows of the global batch's, averaged over the ranks."""
    noise = gate_gumbels(noise)
    if dp is None:
        return model.unsup_loss(x, temps, noise=noise)[1].elbo
    return dp.mean(model.unsup_loss(x, temps,
                                    noise=dp.rows_of(noise))[1].elbo)


def _eval_pass(model: CCVAE, train_cfg: TrainConfig, dp=None) -> JitPass:
    """The captured eval pass of `model`: batch accuracies, stochastic
    unless train_cfg.deterministic_eval; with `dp`, the global batch's."""
    det = train_cfg.deterministic_eval
    size = model.cfg.image_size

    def fn(model: CCVAE, x, y, temp, noise):
        return _accuracy(model, _prep_image(x, size), y, Temps(gating=temp),
                         det, noise, dp)
    return JitPass(model, fn, None if det else PassDraws(), dp)


def _elbo_pass(model: CCVAE, dp=None) -> JitPass:
    """The captured ELBO pass of `model`: mean unsupervised ELBOs; with
    `dp`, the global batch's."""
    size = model.cfg.image_size

    def fn(model: CCVAE, x, y, temp, noise):
        return _elbo(model, _prep_image(x, size), Temps(gating=temp), noise,
                     dp)
    return JitPass(model, fn, PassDraws(elbo=True), dp)


def make_eval_step(model: CCVAE, train_cfg: TrainConfig, dp=None,
                   jit: Optional[bool] = None) -> Callable:
    """(model, x, y, generator, gating_temp) -> batch accuracy (0-d tensor).
    Stochastic unless train_cfg.deterministic_eval. With `dp`, x and y are
    this rank's rows, the draws are the global batch's, and the accuracy
    is the global batch's. `jit` as ``make_train_steps`` (the rule of
    ``resolve_jit``): a captured pass of one batch."""
    if resolve_jit(jit, dp):
        jp = _eval_pass(model, train_cfg, dp)
        return lambda model, x, y, generator, gating_temp: jp.stacked(
            model, x[None], y[None], generator, gating_temp, 'batch')[0]
    det = train_cfg.deterministic_eval
    size = model.cfg.image_size
    world = 1 if dp is None else dp.mesh.world

    @torch.no_grad()
    def eval_step(model: CCVAE, x, y, generator, gating_temp):
        x = _prep_image(x, size)
        temps = Temps(gating=gating_temp)
        if dp is None:
            return model.classifier_accuracy(x, y.to(torch.float32), temps,
                                             deterministic=det,
                                             generator=generator)
        noise = None if det else draw_eval_noise(model, len(x) * world,
                                                 generator)
        return _accuracy(model, x, y, temps, det, noise, dp)
    return eval_step


def make_elbo_eval_step(model: CCVAE, train_cfg: TrainConfig, dp=None,
                        jit: Optional[bool] = None) -> Callable:
    """(model, x, generator, gating_temp) -> mean unsupervised ELBO. With
    `dp`: this rank's rows, the global batch's draws, the mean over the
    ranks. `jit` as ``make_eval_step``."""
    if resolve_jit(jit, dp):
        jp = _elbo_pass(model, dp)
        return lambda model, x, generator, gating_temp: jp.stacked(
            model, x[None], None, generator, gating_temp, 'batch')[0]
    size = model.cfg.image_size
    world = 1 if dp is None else dp.mesh.world

    @torch.no_grad()
    def elbo_step(model: CCVAE, x, generator, gating_temp):
        x = _prep_image(x, size)
        temps = Temps(gating=gating_temp)
        if dp is None:
            return model.unsup_loss(x, temps, generator=generator)[1].elbo
        noise = draw_noise(model, len(x) * world, False, 0, generator)
        return _elbo(model, x, temps, noise, dp)
    return elbo_step


def make_scan_eval_step(model: CCVAE, train_cfg: TrainConfig, dp=None,
                        jit: Optional[bool] = None) -> Callable:
    """(model, xs, ys, generator, gating_temp) -> accs [n] over stacked
    [n, B, ...] batches: n make_eval_step calls with one generator
    (captured: one replay)."""
    if resolve_jit(jit, dp):
        return _eval_pass(model, train_cfg, dp).stacked
    ev = make_eval_step(model, train_cfg, dp, jit=False)

    def scan(model: CCVAE, xs, ys, generator, gating_temp):
        return torch.stack([ev(model, x, y, generator, gating_temp)
                            for x, y in zip(xs, ys)])
    return scan


def make_scan_elbo_step(model: CCVAE, train_cfg: TrainConfig, dp=None,
                        jit: Optional[bool] = None) -> Callable:
    """(model, xs, generator, gating_temp) -> elbos [n] over stacked
    batches: n make_elbo_eval_step calls with one generator (captured:
    one replay)."""
    if resolve_jit(jit, dp):
        jp = _elbo_pass(model, dp)
        return lambda model, xs, generator, gating_temp: jp.stacked(
            model, xs, None, generator, gating_temp)
    el = make_elbo_eval_step(model, train_cfg, dp, jit=False)

    def scan(model: CCVAE, xs, generator, gating_temp):
        return torch.stack([el(model, x, generator, gating_temp)
                            for x in xs])
    return scan


def make_resident_eval_step(model: CCVAE, train_cfg: TrainConfig, dp=None,
                            jit: Optional[bool] = None) -> Callable:
    """Device-resident eval: (model, images, labels, idxs [n, B],
    generator, gating_temp) -> accs [n], batch j gathered from rows
    idxs[j]; the generator advances as in the per-batch path. Captured,
    a pass (a whole eval epoch in the Trainer) is one replay that gathers
    its rows inside the graph (on a mesh, one exchange)."""
    if resolve_jit(jit, dp):
        return _eval_pass(model, train_cfg, dp).resident
    ev = make_eval_step(model, train_cfg, dp, jit=False)
    gather = resident_gather(dp)

    def resident(model: CCVAE, images, labels, idxs, generator,
                 gating_temp):
        return torch.stack([ev(model, x, y, generator, gating_temp)
                            for x, y in gather([(images, labels)] * len(idxs),
                                               idxs)])
    return resident


def make_resident_elbo_step(model: CCVAE, train_cfg: TrainConfig, dp=None,
                            jit: Optional[bool] = None) -> Callable:
    """Device-resident ELBO: (model, images, idxs [n, B], generator,
    gating_temp) -> elbos [n] (captured: one replay)."""
    if resolve_jit(jit, dp):
        jp = _elbo_pass(model, dp)
        return lambda model, images, idxs, generator, gating_temp: \
            jp.resident(model, images, None, idxs, generator, gating_temp)
    el = make_elbo_eval_step(model, train_cfg, dp, jit=False)
    gather = resident_gather(dp)

    def resident(model: CCVAE, images, idxs, generator, gating_temp):
        return torch.stack([el(model, x, generator, gating_temp)
                            for x, _ in gather([(images, None)] * len(idxs),
                                               idxs)])
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
