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

Each dispatch ships its uint8 batches to the device in one copy and runs
the train steps there; metrics stay on the device until the logger
flushes. With ``steps_per_dispatch`` n > 1 a dispatch is a chunk of up to
n steps (``make_mixed_scan_train_step``), cut by the JAX Trainer's rule; it
equals n per-step dispatches bit for bit.

With ``TrainConfig.augment_pad`` P > 0 the train batches arrive padded to
S+2P and the augment kernel crops each back to S x S (random offset,
random horizontal flip, x * 1/255) on the device, one launch per dispatch.
The draw for global step s comes from a generator seeded by
``step_seed(seed + 2, s)``, so the crops do not depend on
``steps_per_dispatch``. Eval batches are never augmented. Resident
splits, TensorBoard and a mesh are not ported yet; a mesh raises
NotImplementedError.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from gltvae_torch import resolve_device
from gltvae_torch.config import (CELEBA_EASY_LABELS, CELEBA_LABELS,
                                 ModelConfig, TrainConfig, apply_precision,
                                 check_supported)
from gltvae_torch.ops import preprocess
from gltvae_torch.train.checkpoint import (CheckpointManager,
                                           export_gating_matrix)
from gltvae_torch.train.metrics import MetricsLogger, Throughput
from gltvae_torch.train.state import create_train_state, init_model, step_seed
from gltvae_torch.train.steps import (make_elbo_eval_step, make_eval_step,
                                      make_mixed_scan_train_step,
                                      make_train_steps)

logger = logging.getLogger(__name__)


class NanGateError(RuntimeError):
    """Raised when sampled gates go NaN (the reference exits the process,
    gated_ccvae.py:371-375)."""


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 mu_init: Optional[np.ndarray] = None,
                 checkpoint_dir: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 nan_check_every: int = 50,
                 steps_per_dispatch: int = 1,
                 device=None,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                'mesh: ROADMAP Queue 1 item 12 (data parallelism)')
        check_supported(model_cfg, train_cfg)
        self.device = resolve_device(device)
        apply_precision(model_cfg)
        self.cfg = train_cfg
        self.nan_check_every = nan_check_every
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        model = init_model(model_cfg, train_cfg, mu_init, self.device)
        self.model = model
        self.state = create_train_state(model, train_cfg)
        self._sup_step, self._unsup_step = make_train_steps(model, train_cfg)
        # a chunk of n > 1 steps: the same steps in a loop, each kind as
        # its flag says (uniform chunks are mixed chunks of one kind)
        self._chunk_step = (make_mixed_scan_train_step(model, train_cfg)
                            if self.steps_per_dispatch > 1 else None)
        self._eval_step = make_eval_step(model, train_cfg)
        self._elbo_step = make_elbo_eval_step(model, train_cfg)
        self.gating_temp = train_cfg.gating_temp_for(model_cfg)
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self._steps_saved: set = set()  # steps persisted by THIS run
        self._gating_hist = None        # lazy {epoch: mu} snapshot store
        self.metrics = MetricsLogger(metrics_path)
        self.throughput = Throughput()
        # eval draws: one generator from seed+1, advanced batch by batch
        self._eval_gen = torch.Generator(device=self.device)
        self._eval_gen.manual_seed(step_seed(train_cfg.seed + 1, 0))

    def _place(self, batch):
        x, y = batch
        x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        y = torch.from_numpy(np.asarray(y, np.float32)).to(self.device)
        return x, y

    def _augment(self, u8: torch.Tensor) -> torch.Tensor:
        """Crop + flip + scale a padded train batch, [B, ...] or stacked
        [n, B, ...], on the device: one launch. Inner step i of a dispatch
        draws from global step ``state.step + i``."""
        pad, size = self.cfg.augment_pad, self.model.cfg.image_size
        expect = size + 2 * pad
        if u8.shape[-3] != expect or u8.shape[-2] != expect:
            raise ValueError(
                f'augment_pad desync: TrainConfig.augment_pad={pad} '
                f'expects {expect}x{expect} train images but the '
                f'loader produced {u8.shape[-3]}x{u8.shape[-2]} — set '
                f'DataConfig.augment_pad to the same value')
        n = u8.shape[0] if u8.dim() == 5 else 1
        gens = []
        for i in range(n):
            g = torch.Generator(device=self.device)
            g.manual_seed(step_seed(self.cfg.seed + 2, self.state.step + i))
            gens.append(g)
        if u8.dim() == 5:
            return preprocess.fused_augment_stacked(u8, gens, size)
        return preprocess.fused_augment(u8, gens[0], size)

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

        for epoch in range(start_epoch, epochs):
            total, period, sup_batches = self.epoch_schedule(loaders)
            flags = self._schedule_flags(total, period, sup_batches)
            sup_iter = iter(loaders['sup']) if 'sup' in loaders else None
            unsup_iter = (iter(loaders['unsup']) if 'unsup' in loaders
                          else None)
            pending_gates = []
            t_epoch = time.perf_counter()
            epoch_imgs0 = self.throughput.images_total
            # semi-sup interleaves (period >= 2) dispatch mixed chunks;
            # other schedules cut uniform chunks at the first kind flip
            mixed = self.steps_per_dispatch > 1 and period > 1
            i = 0
            for n in self._chunk_sizes(flags, self.steps_per_dispatch, mixed):
                chunk = flags[i:i + n]
                bx, by = zip(*(next(sup_iter if f else unsup_iter)
                               for f in chunk))
                if n > 1:                       # one stacked copy
                    x, y = self._place((np.stack(bx), np.stack(by)))
                else:
                    x, y = self._place((bx[0], by[0]))
                if self.cfg.augment_pad > 0:
                    x = self._augment(x)
                if n > 1:
                    self.state, ms = self._chunk_step(
                        self.state, x, y, chunk, self.gating_temp)
                else:
                    step_fn = self._sup_step if chunk[0] else self._unsup_step
                    self.state, ms = step_fn(self.state, x, y,
                                             self.gating_temp)
                pending_gates.append(ms['c_nan'].any())
                self.throughput.step(n * len(bx[0]))
                # every inner step on the log_every cadence gets its own
                # row, so metrics.csv is the same for any steps_per_dispatch
                for j in range(n):
                    if (i + j) % log_every == 0:
                        self.metrics.log(
                            int(i + j + epoch * total),
                            {k: (v[j] if n > 1 else v)
                             for k, v in ms.items() if k != 'c_nan'},
                            epoch=epoch, supervised=int(chunk[j]))
                i += n
                if i % self.nan_check_every < n or i == total:
                    if bool(torch.stack(pending_gates).any()):
                        raise NanGateError(
                            f'NaN gates at epoch {epoch} step {i}')
                    pending_gates.clear()

            # ----------------------- validation -----------------------
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
                        epoch_imgs / epoch_time if epoch_time > 0 else 0.0)
            history.append({'epoch': epoch, 'val_accuracy': val_acc,
                            'val_metric': val_metric,
                            'epoch_time': epoch_time})

            if val_metric > best_metric:
                best_metric = val_metric
                best_val_acc = val_acc
                self._save(param_dir, 'best', {'val_accuracy': val_metric})

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

    def _snapshot_gating(self, param_dir: str, epoch: int) -> None:
        """Append this epoch's μ to gating_history.npz ([n, zc, y] + epochs);
        rewritten whole each epoch, extended on resume."""
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
        metrics = {k: v for k, v in metrics.items() if np.isfinite(v)}
        step = int(self.state.step)
        if self.ckpt is not None and step not in self._steps_saved:
            # a leftover same-step checkpoint of an earlier run is replaced
            self.ckpt.save(self.state, metrics=metrics)
            self._steps_saved.add(step)
        if param_dir and self.model.cfg.gate_type == 'learnable':
            y_dim = self.model.cfg.y_dim
            names = (CELEBA_EASY_LABELS if y_dim == len(CELEBA_EASY_LABELS)
                     else list(CELEBA_LABELS)[:y_dim])
            export_gating_matrix(self.model.mu, param_dir, model_id, names)

    # ------------------------------- eval -------------------------------
    def evaluate(self, loader, gating_temp: Optional[float] = None) -> float:
        """Mean accuracy over ceil(n/bs) batches."""
        temp = self.gating_temp if gating_temp is None else gating_temp
        it = iter(loader)
        accs = []
        for _ in range(loader.epoch_batches):
            x, y = self._place(next(it))
            accs.append(self._eval_step(self.model, x, y, self._eval_gen,
                                        temp))
        return float(torch.stack(accs).mean())

    def test(self, loader) -> float:
        """Test protocol: the gating temperature is the eval temperature."""
        return self.evaluate(loader, gating_temp=self.cfg.eval_gating_temp)

    def test_elbo(self, loader, gating_temp: Optional[float] = None) -> float:
        """Mean unsupervised ELBO over ceil(n/bs) batches."""
        temp = self.gating_temp if gating_temp is None else gating_temp
        it = iter(loader)
        vals = []
        for _ in range(loader.epoch_batches):
            x, _ = self._place(next(it))
            vals.append(self._elbo_step(self.model, x, self._eval_gen, temp))
        return float(torch.stack(vals).mean())

    def restore(self, step: Optional[int] = None):
        if self.ckpt is None:
            raise ValueError('no checkpoint_dir configured')
        return self.ckpt.restore(self.state, step=step)
