"""Training engine: epochs with the reference's sup/unsup interleave
(counterpart of gltvae/train/loop.py, single device).

Schedule semantics as in the reference Learner.train (gated_ccvae.py:
313-419) and the JAX Trainer:
- batches/epoch = ceil(n_sup/bs) [+ ceil(n_unsup/bs) when semi-supervised];
- a supervised batch every floor(total/sup_batches) steps, capped at
  sup_batches an epoch;
- validation accuracy after each epoch, the best checkpoint by it;
- gating temperature ×0.99 an epoch for learnable gating;
- a NaN-gate guard checked every ``nan_check_every`` steps.

**Device-resident splits** (the default, as in the JAX Trainer): a train
or eval split that fits its byte budget (``resident_train_max_bytes``,
``resident_eval_max_bytes``) is copied to the device once as uint8 rows;
each dispatch then gathers its batches on the device from [n, B] index
rows. A train epoch's rows go to the device in one copy at its start,
drawn from the loaders' ``_next_batch_idxs`` in the order of the epoch's
steps (the index stream the host iterators consume), and each dispatch
takes its slice of them there, so nothing in a dispatch waits for the
device and the host queues dispatch n + 1 while dispatch n runs; an eval
or ELBO pass copies its rows once. Params, metrics and eval values equal
the host-shipped path's bit for bit. Resident training is off for
augmented runs, for host-sharded loaders, over budget, or when the sup
and unsup images differ in shape; a split that does not fit is logged and
streamed from the host.

Otherwise each dispatch ships its uint8 batches to the device in one copy.
Metrics stay on the device until the logger flushes. With
``steps_per_dispatch`` n > 1 a dispatch is a chunk of up to n steps, cut
by the JAX Trainer's rule (resident training always dispatches chunks);
eval and ELBO batches go in chunks of n too. A chunk equals n per-step
dispatches bit for bit.

With ``TrainConfig.augment_pad`` P > 0 the train batches arrive padded to
S+2P and the augment kernel crops each back to S x S (random offset,
random horizontal flip, x * 1/255) on the device, one launch per dispatch:
inside the captured step's or chunk's graph, its offsets drawn by the
host part into static buffers, or, eagerly, before the step. The draw for
global step s comes from a generator seeded by ``step_seed(seed + 2,
s)`` (``graphs.Crop``), so the crops do not depend on
``steps_per_dispatch``. Eval batches are never augmented.

**A mesh** (``mesh=``, a ``parallel.mesh.Mesh``; the JAX Trainer's
``mesh=``): one Trainer per rank, each on its rank's device, every step the
DP step of ``parallel/dp.py`` (the global batch's draws, this rank's rows,
gradients averaged over the ranks), so a run equals the one-device run at
the same global batch. Each rank takes its rows of each global batch
(``local_batches=False``) or gets only them from a host-sharded loader
(``local_batches=True``). A resident split lives as each rank's ⌈N/D⌉
rows and each dispatch exchanges the rows its batches need; residency is
decided on the split's total bytes and is off for host-sharded loaders.
The augment draw is the global batch's, each rank cropping its rows, so
the crops depend neither on the world size nor on ``steps_per_dispatch``.
Rank 0 alone writes metrics.csv, events, μ exports and checkpoints, and
the others wait at a barrier after each save; every rank restores the same
checkpoint on resume; the throughput meter counts global images.

**Captured dispatches** (``jit``, by default on one device and on an NCCL
mesh of any size; gltvae's jitted dispatches; ``steps.resolve_jit``):
every dispatch is a CUDA graph,
captured at its first call for each kind, mask pattern, input shape and
noise form and replayed from then on (``train/graphs.py``; the host part
draws the raw noise, and the graph makes the gate Gumbels from their
uniforms): a train step, a chunk of n steps (one replay, one graph a
sup/unsup pattern), the augment kernel inside the step's or chunk's
graph, and each eval and ELBO pass (one replay a shipped chunk, one a
resident epoch). On a mesh each rank's
graphs hold its collectives (the gradient all-reduce, the eval's
all_gather, a resident dispatch's row exchange), and every rank captures
and replays the same graphs in the same order. The Trainer passes the
gating temperature at every dispatch, so the per-epoch decay reaches the
graphs' static temperature; a resume or ``load_params`` writes into the
tensors the graphs read, on every rank. When the process leaves its
group (``parallel.mesh.shutdown``, as ``cli.main`` ends) a mesh Trainer's
graphs are released, held or not, and its dispatches raise from then on.
``jit=False`` runs every dispatch eagerly, for comparison. On the CPU the static-buffer path runs eagerly;
on a gloo mesh over CUDA tensors the dispatches are eager, and
``jit=True`` there raises (``steps.resolve_jit``).

**Spans** (``gltvae_torch.trace``): an epoch is a ``train.epoch`` span and
each dispatch a ``train.dispatch`` span, whose request id is its first
global step, holding a shipped batch's ``train.batch`` and ``train.h2d``,
the step's host part and ``train.log``; an eval or ELBO pass is an ``eval.pass`` whose
request id is its number; the host's waits on the device are ``wait.*``
spans (``wait.h2d`` a blocking copy, inside its ``train.h2d``: the
resident index rows', one in a resident train epoch, before its first
dispatch, and one in a resident pass; a shipped batch's, one a streamed
dispatch or eval chunk). They record nothing unless the tracer is on or
a profiler runs.

``tensorboard_dir`` adds TensorBoard scalar events beside metrics.csv
(``MetricsLogger``). ``debug_nans`` checks every train and eval dispatch
for NaN and names the first op that made one (``utils/debug_nans.py``,
the counterpart of ``jax_debug_nans``); a captured dispatch with a NaN is
replayed op by op through its eager counterpart.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from gltvae_torch import resolve_device, trace
from gltvae_torch.config import (CELEBA_EASY_LABELS, CELEBA_LABELS,
                                 ModelConfig, TrainConfig, apply_precision,
                                 check_supported)
from gltvae_torch.ops import preprocess
from gltvae_torch.train.checkpoint import (CheckpointManager,
                                           export_gating_matrix)
from gltvae_torch.train.metrics import MetricsLogger, Throughput
from gltvae_torch.train.state import create_train_state, init_model, step_seed
from gltvae_torch.train.steps import (
    make_resident_elbo_step, make_resident_eval_step,
    make_resident_mixed_scan_train_step, make_resident_scan_train_steps,
    make_scan_elbo_step, make_scan_eval_step, make_train_steps, mixed_chunk,
    resolve_jit, train_crop)
from gltvae_torch.utils.debug_nans import nan_checked

logger = logging.getLogger(__name__)


class NanGateError(RuntimeError):
    """Raised when sampled gates go NaN (the reference exits the process,
    gated_ccvae.py:371-375)."""


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 mu_init: Optional[np.ndarray] = None,
                 checkpoint_dir: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 nan_check_every: int = 50,
                 steps_per_dispatch: int = 1,
                 device=None,
                 mesh=None,
                 local_batches: bool = False,
                 resident_eval: str = 'auto',
                 resident_eval_max_bytes: int = 768 * 2**20,
                 resident_train: str = 'auto',
                 resident_train_max_bytes: int = 3 * 2**30,
                 debug_nans: bool = False,
                 jit: Optional[bool] = None):
        check_supported(model_cfg, train_cfg, mesh=mesh)
        # captured dispatches by default, but on a gloo mesh over CUDA
        # tensors, where asking for them raises
        self._jit = resolve_jit(jit, mesh)
        for name, mode in (('resident_eval', resident_eval),
                           ('resident_train', resident_train)):
            if mode not in ('auto', 'off'):
                raise ValueError(f"{name} must be 'auto' or 'off'")
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f'device {device} is not the mesh rank\'s '
                                 f'device {mesh.device}')
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        apply_precision(model_cfg)
        self.cfg = train_cfg
        self.mesh = mesh
        self.local_batches = local_batches and mesh is not None
        self._is_main = mesh is None or mesh.is_main
        # the DP semantics every step maker takes (None: one device)
        dp = None
        if mesh is not None:
            from gltvae_torch.parallel.dp import DataParallel
            dp = DataParallel(mesh)
        self._dp = dp
        self.nan_check_every = nan_check_every
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        model = init_model(model_cfg, train_cfg, mu_init, self.device)
        self.model = model
        self.state = create_train_state(model, train_cfg)
        self._replicate()
        self._sup_step, self._unsup_step = make_train_steps(
            model, train_cfg, dp, jit=self._jit)
        # a chunk of n > 1 steps, each kind as its flag says (uniform
        # chunks are mixed chunks of one kind): one replay of the graph of
        # its mask pattern when captured, else the steps in a loop
        self._chunk_step = (mixed_chunk(self._sup_step, self._unsup_step)
                            if self.steps_per_dispatch > 1 else None)
        evals = (('_scan_eval', make_scan_eval_step),
                 ('_scan_elbo', make_scan_elbo_step),
                 ('_resident_eval_step', make_resident_eval_step),
                 ('_resident_elbo_step', make_resident_elbo_step))
        for name, make in evals:
            setattr(self, name, make(model, train_cfg, dp, jit=self._jit))
        self._debug_nans = debug_nans
        if debug_nans:
            # a dispatch with a NaN is replayed op by op through its eager
            # counterpart (as jax_debug_nans re-runs a jitted call
            # de-optimised); on a mesh the data-parallel one, whose
            # collectives every rank's replay meets
            eager = {}
            if self._jit:
                sup, unsup = make_train_steps(model, train_cfg, dp,
                                              jit=False)
                eager = {'_sup_step': sup, '_unsup_step': unsup,
                         '_chunk_step': mixed_chunk(sup, unsup)}
                eager.update((name, make(model, train_cfg, dp, jit=False))
                             for name, make in evals)
            for name in ('_sup_step', '_unsup_step', '_chunk_step',
                         '_scan_eval', '_scan_elbo', '_resident_eval_step',
                         '_resident_elbo_step'):
                fn = getattr(self, name)
                if fn is not None:
                    setattr(self, name, nan_checked(fn, mesh,
                                                    eager.get(name)))
        # 'auto' = resident when the splits fit their budget; 'off' = always
        # shipped from the host
        self._resident_eval_mode = resident_eval
        self._resident_eval_budget = resident_eval_max_bytes
        self._resident_train_mode = resident_train
        self._resident_train_budget = resident_train_max_bytes
        self._resident_data: dict = {}   # id(loader) -> (loader, x, y)
        self._resident_train_fns: dict = {}
        self.gating_temp = train_cfg.gating_temp_for(model_cfg)
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self._steps_saved: set = set()  # steps persisted by THIS run
        self._gating_hist = None        # lazy {epoch: mu} snapshot store
        # every rank keeps the rows; rank 0 writes them
        self.metrics = MetricsLogger(
            metrics_path if self._is_main else None,
            tensorboard_dir=tensorboard_dir if self._is_main else None)
        self.throughput = Throughput()
        # eval draws: one generator from seed+1, advanced batch by batch
        self._eval_gen = torch.Generator(device=self.device)
        self._eval_gen.manual_seed(step_seed(train_cfg.seed + 1, 0))
        #: eval and ELBO passes run so far (their spans' request ids)
        self._passes = 0

    def _replicate(self) -> None:
        """Rank 0's state on every rank (a collective; no-op off a mesh)."""
        if self.mesh is not None:
            from gltvae_torch.parallel.dp import shard_state
            shard_state(self.state, self.mesh)

    def _place(self, batch, stacked: bool = False):
        """A host batch on the device: on a mesh, this rank's rows of it
        (batch axis 1 when `stacked`). The copies block, so they are a
        ``wait.h2d`` inside the ``train.h2d``; ``trace.h2d_bytes`` counts
        what they ship."""
        with trace.span('train.h2d'):
            if self.mesh is not None:
                from gltvae_torch.parallel.dp import (shard_batch,
                                                      shard_stacked_batch)
                batch = (shard_stacked_batch if stacked else shard_batch)(
                    batch, self.mesh, local=self.local_batches)
            x = np.ascontiguousarray(batch[0])
            y = np.asarray(batch[1], np.float32)
            trace.h2d_bytes += x.nbytes + y.nbytes
            # pageable memory: each copy waits for the stream
            with trace.span('wait.h2d'):
                return (torch.from_numpy(x).to(self.device),
                        torch.from_numpy(y).to(self.device))

    def _augment(self, u8: torch.Tensor) -> torch.Tensor:
        """The augment stage of a padded train batch, [B, ...] or stacked
        [n, B, ...]: checked against ``augment_pad``, then, with captured
        steps, returned as it is (the step's or chunk's graph crops it,
        its host part drawing the offsets), else cropped, flipped and
        scaled here, on the device, in one launch. Inner step i of a
        dispatch draws the global batch's crops from global step
        ``state.step + i``; on a mesh `u8` is this rank's rows and it crops
        those."""
        pad, size = self.cfg.augment_pad, self.model.cfg.image_size
        expect = size + 2 * pad
        if u8.shape[-3] != expect or u8.shape[-2] != expect:
            raise ValueError(
                f'augment_pad desync: TrainConfig.augment_pad={pad} '
                f'expects {expect}x{expect} train images but the '
                f'loader produced {u8.shape[-3]}x{u8.shape[-2]} — set '
                f'DataConfig.augment_pad to the same value')
        if self._jit:
            return u8
        n = u8.shape[0] if u8.dim() == 5 else 1
        crop = train_crop(self.model, self.cfg, self._dp)
        draws = [crop.draw(self.state.step + i, u8.shape[-4], self.device)
                 for i in range(n)]
        dy, dx, fl = (torch.stack(v) for v in zip(*draws))
        if u8.dim() == 5:
            return preprocess.fused_augment_stacked_given(u8, dy, dx, fl,
                                                          size)
        return preprocess.fused_augment_given(u8, dy[0], dx[0], fl[0], size)

    @torch.no_grad()
    def load_params(self, state_dict) -> None:
        """Swap in parameters loaded elsewhere (e.g. a reference .h5
        checkpoint through utils/h5_import), copied in place onto the
        Trainer's device. The step, the Adam moments and count stay; a
        frozen μ (fixed gate schemes) takes the loaded value and stays
        frozen. Called on a new Trainer, this is a warm start with fresh
        moments, as the reference's: it cannot resume its optimizer
        either. On a mesh it is collective: every rank calls it, and rank
        0's loaded parameters go to all."""
        self.model.load_state_dict(state_dict, strict=True)
        self._replicate()

    # ------------------------------ schedule ------------------------------
    def epoch_schedule(self, loaders) -> tuple[int, int, int]:
        """(batches_per_epoch, period_sup_batches, sup_batches)."""
        sup = self.cfg.perc_supervision
        bs = self.cfg.batch_size
        if sup == 1.0:
            n = math.ceil(loaders['sup'].n_s / bs)
            return n, 1, n
        if sup > 0.0:
            sup_b = math.ceil(loaders['sup'].n_s / bs)
            unsup_b = math.ceil(loaders['unsup'].n_s / bs)
            total = sup_b + unsup_b
            return total, int(total / sup_b), sup_b
        if sup == 0.0:
            return math.ceil(loaders['unsup'].n_s / bs), 0, 0
        raise ValueError(f'bad supervision fraction {sup}')

    @staticmethod
    def _schedule_flags(total: int, period: int, sup_batches: int):
        """Step i is supervised iff i % period == 0 and the supervised quota
        is unspent."""
        flags, ctr = [], 0
        for i in range(total):
            f = period > 0 and i % period == 0 and ctr < sup_batches
            ctr += int(f)
            flags.append(bool(f))
        return flags

    @staticmethod
    def _chunk_sizes(flags, steps_per_dispatch: int, mixed: bool):
        """The dispatch sizes of one epoch, by the JAX Trainer's rule: up to
        steps_per_dispatch steps each; unless mixed, a chunk also stops at
        the first flip of kind."""
        sizes, i = [], 0
        while i < len(flags):
            n = min(steps_per_dispatch, len(flags) - i)
            if not mixed:
                run = 1
                while run < n and flags[i + run] == flags[i]:
                    run += 1
                n = run
            sizes.append(n)
            i += n
        return sizes

    # ------------------------------- train -------------------------------
    def train(self, loaders: Dict, param_dir: Optional[str] = None,
              epochs: Optional[int] = None, log_every: int = 50,
              resume: bool = False) -> Dict:
        cfg = self.cfg
        epochs = cfg.n_epochs if epochs is None else epochs
        best_metric = -np.inf   # val accuracy (sup) or val ELBO (unsup)
        best_val_acc = -np.inf
        history = []
        start_epoch = 0

        if resume and self.ckpt is not None and \
                self.ckpt.latest_step() is not None:
            self.ckpt.restore(self.state, step=self.ckpt.latest_step())
            self._steps_saved.add(int(self.state.step))
            total, _, _ = self.epoch_schedule(loaders)
            start_epoch = int(self.state.step) // total
            if self.model.cfg.gate_type == 'learnable':
                self.gating_temp = (
                    self.cfg.gating_temp_for(self.model.cfg)
                    * cfg.gating_temp_decay ** start_epoch)
            logger.info('resumed at step %d (epoch %d), gating temp %.4f',
                        int(self.state.step), start_epoch, self.gating_temp)

        # resident training: the train split(s) go to the device once and
        # every dispatch below sends only an [n, B] index tensor; None
        # (gated off or over budget) -> the host-shipped path
        res_train = self._resident_train_splits(loaders)
        scan_on = self._chunk_step is not None or res_train is not None
        semi_res = res_train is not None and len(res_train) == 2

        for epoch in range(start_epoch, epochs):
            with trace.span('train.epoch', epoch=epoch):
                total, period, sup_batches = self.epoch_schedule(loaders)
                flags = self._schedule_flags(total, period, sup_batches)
                iters = None
                if res_train is None:
                    iters = {m: iter(loaders[m]) for m in ('sup', 'unsup')
                             if m in loaders}
                t_epoch = time.perf_counter()
                epoch_imgs0 = self.throughput.images_total
                # semi-sup interleaves (period >= 2) dispatch mixed chunks,
                # and so do resident sup+unsup splits; other schedules cut
                # uniform chunks at the first kind flip
                mixed = (scan_on and period > 1) or semi_res
                self._dispatch_epoch(loaders, res_train, iters, flags, mixed,
                                     epoch, log_every)

                # --------------------- validation ---------------------
                if cfg.perc_supervision and 'valid' in loaders:
                    val_acc = self.evaluate(loaders['valid'])
                    val_metric = val_acc
                elif 'valid' in loaders:
                    val_acc = -np.inf
                    val_metric = self.test_elbo(loaders['valid'])
                else:
                    val_acc = val_metric = -np.inf
                epoch_time = time.perf_counter() - t_epoch
                epoch_imgs = self.throughput.images_total - epoch_imgs0
                logger.info('[Epoch %03d] Val Acc %.3f (%.1fs, %.0f img/s)',
                            epoch, val_acc, epoch_time,
                            epoch_imgs / epoch_time if epoch_time > 0
                            else 0.0)
                history.append({'epoch': epoch, 'val_accuracy': val_acc,
                                'val_metric': val_metric,
                                'epoch_time': epoch_time})

                if val_metric > best_metric:
                    best_metric = val_metric
                    best_val_acc = val_acc
                    self._save(param_dir, 'best',
                               {'val_accuracy': val_metric})

                if self.model.cfg.gate_type == 'learnable':
                    self.gating_temp *= cfg.gating_temp_decay
                    if param_dir is not None:
                        self._snapshot_gating(param_dir, epoch)

        # 'last' carries the final epoch's metric, so best_step() keeps
        # pointing at the genuinely best state
        last_metric = history[-1]['val_metric'] if history else -np.inf
        self._save(param_dir, 'last', {'val_accuracy': last_metric})
        self.metrics.flush()
        return {'best_val_accuracy': best_val_acc,
                'best_val_metric': best_metric, 'history': history,
                'images_per_sec': self.throughput.images_per_sec}

    def _dispatch_epoch(self, loaders, res_train: Optional[dict],
                        iters: Optional[dict], flags, mixed: bool,
                        epoch: int, log_every: int) -> None:
        """The train dispatches of one epoch of step kinds `flags`: resident
        chunks from `res_train` on slices of the epoch's index rows, copied
        to the device first, else batches taken from the loaders'
        iterators `iters`; each a ``train.dispatch`` span whose request is
        its first global step."""
        total, pending_gates, i = len(flags), [], 0
        if res_train is not None:
            rows = self._epoch_rows(loaders, flags)
        for n in self._chunk_sizes(flags, self.steps_per_dispatch, mixed):
            chunk = flags[i:i + n]
            with trace.span('train.dispatch', request=int(self.state.step)):
                if res_train is not None:
                    self.state, ms = self._resident_chunk(
                        res_train, rows[i:i + n], chunk)
                    n_imgs = n * self.cfg.batch_size
                else:
                    with trace.span('train.batch'):
                        bx, by = zip(*(next(iters['sup' if f else 'unsup'])
                                       for f in chunk))
                        # n > 1: one stacked copy
                        batch = ((np.stack(bx), np.stack(by)) if n > 1
                                 else (bx[0], by[0]))
                    x, y = self._place(batch, stacked=n > 1)
                    if self.cfg.augment_pad > 0:
                        x = self._augment(x)
                    if n > 1:
                        self.state, ms = self._chunk_step(
                            self.state, x, y, chunk, self.gating_temp)
                    else:
                        step_fn = (self._sup_step if chunk[0]
                                   else self._unsup_step)
                        self.state, ms = step_fn(self.state, x, y,
                                                 self.gating_temp)
                    n_imgs = n * len(bx[0]) * (
                        self.mesh.world if self.local_batches else 1)
                stacked = res_train is not None or n > 1    # metrics [n]
                pending_gates.append(ms['c_nan'].any())
                with trace.span('train.log'):
                    self.throughput.step(n_imgs)
                    # every inner step on the log_every cadence gets its
                    # own row, so metrics.csv is the same for any
                    # steps_per_dispatch
                    for j in range(n):
                        if (i + j) % log_every == 0:
                            self.metrics.log(
                                int(i + j + epoch * total),
                                {k: (v[j] if stacked else v)
                                 for k, v in ms.items() if k != 'c_nan'},
                                epoch=epoch, supervised=int(chunk[j]))
                i += n
                if i % self.nan_check_every < n or i == total:
                    with trace.span('wait.nan_check'):
                        nan = bool(torch.stack(pending_gates).any())
                    if nan:
                        raise NanGateError(
                            f'NaN gates at epoch {epoch} step {i}')
                    pending_gates.clear()

    def _snapshot_gating(self, param_dir: str, epoch: int) -> None:
        """Append this epoch's μ to gating_history.npz ([n, zc, y] + epochs);
        rewritten whole each epoch, extended on resume. Rank 0's job on a
        mesh."""
        if not self._is_main:
            return
        path = os.path.join(param_dir, 'gating_history.npz')
        if self._gating_hist is None:
            self._gating_hist = {}
            if os.path.exists(path):
                try:
                    with np.load(path) as z:
                        self._gating_hist = {int(e): m for e, m in
                                             zip(z['epochs'], z['mu'])}
                except (OSError, ValueError, KeyError):
                    pass    # torn write from a prior crash: start afresh
        self._gating_hist[epoch] = (
            self.model.mu.detach().cpu().numpy().astype(np.float32))
        eps = sorted(self._gating_hist)
        os.makedirs(param_dir, exist_ok=True)
        tmp = path + '.tmp.npz'
        np.savez(tmp, epochs=np.asarray(eps, np.int32),
                 mu=np.stack([self._gating_hist[e] for e in eps]))
        os.replace(tmp, path)

    def _save(self, param_dir: Optional[str], model_id: str, metrics: dict):
        """Checkpoint and μ export, by rank 0 on a mesh; the other ranks
        wait for them at a barrier."""
        metrics = {k: v for k, v in metrics.items() if np.isfinite(v)}
        step = int(self.state.step)
        if self.ckpt is not None and step not in self._steps_saved:
            # a leftover same-step checkpoint of an earlier run is replaced
            if self._is_main:
                self.ckpt.save(self.state, metrics=metrics)
            self._steps_saved.add(step)
        if param_dir and self.model.cfg.gate_type == 'learnable' \
                and self._is_main:
            y_dim = self.model.cfg.y_dim
            names = (CELEBA_EASY_LABELS if y_dim == len(CELEBA_EASY_LABELS)
                     else list(CELEBA_LABELS)[:y_dim])
            export_gating_matrix(self.model.mu, param_dir, model_id, names)
        if self.mesh is not None:
            self.mesh.barrier()

    # ----------------------------- resident -----------------------------
    def _resident_split(self, loader, budget: int):
        """(images, labels) of `loader`'s split on the device, if it fits
        `budget` bytes, else None. Copied once per loader and cached. Off
        for host-sharded loaders (they hold only this process's rows) and
        loaders without the index-stream API."""
        if getattr(loader, 'shard', None) is not None \
                or not hasattr(loader, 'epoch_indices'):
            return None
        ent = self._resident_data.get(id(loader))
        if ent is not None:
            return ent[1], ent[2]
        ds = loader.dataset
        x0, y0 = ds.fetch(np.asarray([0]))
        if (x0.nbytes + y0.nbytes) * len(ds) > budget:
            logger.info('resident: a split of %d rows (%d MB) is over the '
                        '%d MB budget; streaming it from the host', len(ds),
                        (x0.nbytes + y0.nbytes) * len(ds) >> 20,
                        budget >> 20)
            return None
        with trace.setup_span('resident.copy', rows=len(ds)):
            if self.mesh is not None:
                # this rank's ⌈N/D⌉ rows, the labels whole
                from gltvae_torch.parallel.dp import place_resident_split
                x, y = place_resident_split(*ds.fetch(np.arange(len(ds))),
                                            self.mesh)
            else:
                x, y = self._place(ds.fetch(np.arange(len(ds))))
        self._resident_data[id(loader)] = (loader, x, y)
        return x, y

    def _resident_eval_split(self, loader):
        if self._resident_eval_mode == 'off':
            return None
        return self._resident_split(loader, self._resident_eval_budget)

    def _resident_train_splits(self, loaders) -> Optional[dict]:
        """{'sup'/'unsup': (images, labels)} on the device when every train
        split fits the combined budget, else None. Augmented runs stay
        host-shipped (the augment kernel takes padded batches), and the sup
        and unsup images must have one shape."""
        if self._resident_train_mode == 'off' or self.cfg.augment_pad > 0:
            return None
        modes = [m for m in ('sup', 'unsup') if m in loaders]
        total, shapes = 0, set()
        for m in modes:
            loader = loaders[m]
            if getattr(loader, 'shard', None) is not None \
                    or not hasattr(loader, '_next_batch_idxs'):
                return None
            x0, y0 = loader.dataset.fetch(np.asarray([0]))
            total += (x0.nbytes + y0.nbytes) * len(loader.dataset)
            shapes.add(x0.shape[1:])
        if not modes or len(shapes) != 1:
            return None
        if total > self._resident_train_budget:
            logger.info('resident train: %d MB over the %d MB budget; '
                        'streaming batches from the host', total >> 20,
                        self._resident_train_budget >> 20)
            return None
        out = {m: self._resident_split(loaders[m], total) for m in modes}
        if any(v is None for v in out.values()):
            return None
        logger.info('resident train: %d MB copied to the device once (%s)',
                    total >> 20, '+'.join(modes))
        return out

    def _get_resident_train_fn(self, kind: str):
        """The resident chunk of `kind` ('sup', 'unsup' or 'mixed'), built
        on first use."""
        fn = self._resident_train_fns.get(kind)
        if fn is None:
            def make(jit: bool):
                if kind == 'mixed':
                    return make_resident_mixed_scan_train_step(
                        self.model, self.cfg, self._dp, jit=jit)
                return make_resident_scan_train_steps(
                    self.model, self.cfg, self._dp, jit=jit)[kind == 'unsup']
            fn = make(self._jit)
            if self._debug_nans:
                fn = nan_checked(fn, self.mesh,
                                 make(False) if self._jit else None)
            self._resident_train_fns[kind] = fn
        return fn

    def _resident_chunk(self, res_train: dict, idxs: torch.Tensor, chunk):
        """One resident dispatch: the resident chunk step on the chunk's
        [n, B] index rows, already on the device; it copies nothing from
        the host and waits for nothing."""
        if len(res_train) == 2:
            (xs, ys), (xu, yu) = res_train['sup'], res_train['unsup']
            return self._get_resident_train_fn('mixed')(
                self.state, xs, ys, xu, yu, idxs, chunk, self.gating_temp)
        kind = 'sup' if chunk[0] else 'unsup'
        x, y = res_train[kind]
        return self._get_resident_train_fn(kind)(self.state, x, y, idxs,
                                                 self.gating_temp)

    def _epoch_rows(self, loaders, flags) -> torch.Tensor:
        """A resident train epoch's index rows [len(flags), B] on the
        device: row i the next batch of the sup loader where flags[i], else
        of the unsup one, drawn in step order, as the host iterators draw
        them."""
        with trace.span('train.batch'):
            idx = np.stack([(loaders['sup'] if f else loaders['unsup'])
                            ._next_batch_idxs() for f in flags])
        return self._upload_rows(idx)

    def _upload_rows(self, idx: np.ndarray) -> torch.Tensor:
        """Index rows [n, B] on the device, in one copy: a resident train
        epoch's or a resident pass's (``trace.index_uploads`` counts them).
        The copy blocks: it waits for the stream, so for the work queued
        before it."""
        trace.index_uploads += 1
        with trace.span('train.h2d'), trace.span('wait.h2d'):
            return torch.from_numpy(idx.astype(np.int64)).to(self.device)

    # ------------------------------- eval -------------------------------
    def _eval_chunks(self, loader):
        """The eval epoch's batches as (x, y) on the device: chunks of up to
        steps_per_dispatch batches stacked in one copy each."""
        it = iter(loader)
        n_batches, i = loader.epoch_batches, 0
        while i < n_batches:
            n = min(self.steps_per_dispatch, n_batches - i)
            bx, by = zip(*(next(it) for _ in range(n)))
            yield self._place((np.stack(bx), np.stack(by)), stacked=True)
            i += n

    def evaluate(self, loader, gating_temp: Optional[float] = None) -> float:
        """Mean accuracy over ceil(n/bs) batches: one resident pass when
        the split fits, else shipped chunks; the eval generator advances
        batch by batch either way, so the values are the same."""
        return self._pass(loader, gating_temp, elbo=False)

    def test(self, loader) -> float:
        """Test protocol: the gating temperature is the eval temperature."""
        return self.evaluate(loader, gating_temp=self.cfg.eval_gating_temp)

    def test_elbo(self, loader, gating_temp: Optional[float] = None) -> float:
        """Mean unsupervised ELBO over ceil(n/bs) batches (resident or
        shipped, as ``evaluate``)."""
        return self._pass(loader, gating_temp, elbo=True)

    def _pass(self, loader, gating_temp: Optional[float],
              elbo: bool) -> float:
        """One eval (accuracy) or ELBO pass over `loader` at `gating_temp`
        (None: the Trainer's), the mean of its batches' values; an
        ``eval.pass`` span whose request is the pass's number (inside its
        ``train.epoch`` span when it is the epoch's validation)."""
        temp = self.gating_temp if gating_temp is None else gating_temp
        self._passes += 1
        res = self._resident_eval_split(loader)
        with trace.span('eval.pass', request=self._passes,
                        kind='elbo' if elbo else 'accuracy',
                        resident=res is not None):
            if res is not None:
                idxs = self._upload_rows(loader.epoch_indices())
                if elbo:
                    vals = self._resident_elbo_step(
                        self.model, res[0], idxs, self._eval_gen, temp)
                else:
                    vals = self._resident_eval_step(
                        self.model, *res, idxs, self._eval_gen, temp)
            elif elbo:
                vals = torch.cat([self._scan_elbo(self.model, xs,
                                                  self._eval_gen, temp)
                                  for xs, _ in self._eval_chunks(loader)])
            else:
                vals = torch.cat([self._scan_eval(self.model, xs, ys,
                                                  self._eval_gen, temp)
                                  for xs, ys in self._eval_chunks(loader)])
            with trace.span('wait.result'):
                return float(vals.mean())

    def restore(self, step: Optional[int] = None):
        if self.ckpt is None:
            raise ValueError('no checkpoint_dir configured')
        return self.ckpt.restore(self.state, step=step)
