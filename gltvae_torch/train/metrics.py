"""Structured training metrics: per-step ELBO decomposition as CSV and,
optionally, TensorBoard scalar events, and an images/sec meter (counterpart
of gltvae/train/metrics.py).

Rows are queued with their values still on the device and fetched together
at flush, so logging never makes the train loop wait for the device. The
CSV has the JAX package's columns: step, time, the metrics, epoch and
supervised, sorted by name. With ``tensorboard_dir`` each flush also writes
every numeric cell but step and time as a scalar at ``int(row['step'])``,
through ``gltvae_torch.utils.tb_events`` (no tensorflow).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional

import torch

from gltvae_torch import trace
from gltvae_torch.utils.tb_events import EventFileWriter


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, flush_every: int = 50,
                 tensorboard_dir: Optional[str] = None):
        self.path = path
        self.flush_every = flush_every
        self._pending: List[Dict] = []   # values may be device tensors
        self._rows: List[Dict] = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # a resumed run appends to the existing CSV: one header per file
        self._header_written = bool(path and os.path.exists(path)
                                    and os.path.getsize(path) > 0)
        # the directory now, so a bad path fails before training; the
        # event file at the first flush
        self.tensorboard_dir = tensorboard_dir
        self._tb: Optional[EventFileWriter] = None
        if tensorboard_dir:
            os.makedirs(tensorboard_dir, exist_ok=True)

    def log(self, step: int, metrics: Dict, **extra):
        """Queue a row without waiting for the device."""
        self._pending.append({'step': step, 'time': time.time(), **metrics,
                              **extra})
        if len(self._pending) >= self.flush_every:
            self.flush()

    def flush(self) -> List[Dict]:
        if not self._pending:
            return self._rows
        cells = [(i, k) for i, r in enumerate(self._pending)
                 for k, v in r.items() if isinstance(v, torch.Tensor)]
        # one device->host copy for the whole flush
        with trace.span('wait.flush'):
            values = (torch.stack([self._pending[i][k].reshape(())
                                   .to(torch.float32) for i, k in cells])
                      .tolist() if cells else [])
        rows = [dict(r) for r in self._pending]
        for (i, k), v in zip(cells, values):
            rows[i][k] = float(v)
        self._rows.extend(rows)
        self._pending.clear()
        if self.tensorboard_dir:
            if self._tb is None:
                self._tb = EventFileWriter(self.tensorboard_dir)
            for r in rows:
                self._tb.write(int(r['step']), {
                    k: v for k, v in r.items() if k not in ('step', 'time')
                    and isinstance(v, (int, float))})
        if self.path:
            write_header = not self._header_written
            with open(self.path, 'a', newline='') as f:
                w = csv.DictWriter(f, fieldnames=sorted(rows[0].keys()))
                if write_header:
                    w.writeheader()
                    self._header_written = True
                for r in rows:
                    w.writerow(r)
        return self._rows

    @property
    def rows(self) -> List[Dict]:
        self.flush()
        return self._rows


class Throughput:
    """images/sec meter that leaves out the first `warmup_steps` steps."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup = warmup_steps
        self._count = 0
        self._images = 0
        self._images_raw = 0
        self._t0 = None

    def step(self, batch_images: int):
        self._count += 1
        self._images_raw += batch_images
        if self._count == self.warmup + 1:
            self._t0 = time.perf_counter()
            self._images = 0
        if self._count > self.warmup:
            self._images += batch_images

    @property
    def images_total(self) -> int:
        """All images stepped, warmup included."""
        return self._images_raw

    @property
    def images_per_sec(self) -> float:
        if self._t0 is None or self._images == 0:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else 0.0
