"""Full-state checkpoints with torch.save, and the μ export in the
reference's format (counterpart of gltvae/train/checkpoint.py).

A checkpoint is ``<directory>/<step>/state.pt`` (the TrainState's
state_dict: params, Adam moments and count, step, seed) with
``metrics.json`` beside it. The manager keeps the ``max_to_keep`` best
checkpoints by ``val_accuracy`` and always the latest one, so ``restore()``
with no step returns the best state and a resume finds the latest.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Sequence

import numpy as np
import torch

from gltvae_torch.ops.gating import save_labeled_csv
from gltvae_torch.train.state import TrainState

_STATE = 'state.pt'
_METRICS = 'metrics.json'


class CheckpointManager:
    """best/last checkpoint slots over a directory of step folders."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, _STATE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _metric(self, step: int) -> float:
        path = os.path.join(self._dir(step), _METRICS)
        if not os.path.exists(path):
            return -np.inf
        with open(path) as f:
            return json.load(f).get('val_accuracy', -np.inf)

    def best_step(self) -> Optional[int]:
        steps = self.all_steps()
        if not steps:
            return None
        return max(steps, key=lambda s: (self._metric(s), s))

    def save(self, state: TrainState, metrics: Optional[dict] = None):
        step = int(state.step)
        d = self._dir(step)
        tmp = d + '.tmp'
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state.state_dict(), os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _METRICS), 'w') as f:
            json.dump(metrics or {}, f)
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
        self._collect()

    def _collect(self):
        """Keep the max_to_keep best by val_accuracy, plus the latest."""
        steps = self.all_steps()
        ranked = sorted(steps, key=lambda s: (self._metric(s), s),
                        reverse=True)
        keep = set(ranked[:self.max_to_keep]) | {steps[-1]}
        for s in steps:
            if s not in keep:
                self.delete(s)

    def load(self, step: Optional[int] = None) -> dict:
        """A checkpoint's TrainState state_dict, on the CPU: the best one
        unless a step is given."""
        if step is None:
            step = self.best_step()
        if step is None:
            raise FileNotFoundError(f'no checkpoint in {self.directory}')
        return torch.load(os.path.join(self._dir(step), _STATE),
                          map_location='cpu', weights_only=True)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a checkpoint into `state` (in place): the best one unless a
        step is given."""
        state.load_state_dict(self.load(step))
        return state

    def delete(self, step: int):
        shutil.rmtree(self._dir(step), ignore_errors=True)


def export_gating_matrix(mu, param_dir: str, model_id: str,
                         label_names: Sequence[str]):
    """learned_gating_matrix_{id}.npy and a labeled .csv (rows z1..zN,
    attribute-name columns), the reference's gated_ccvae.py:395-401; both
    files byte-equal to the JAX package's."""
    os.makedirs(param_dir, exist_ok=True)
    if isinstance(mu, torch.Tensor):
        mu = mu.detach().cpu().numpy()
    mu = np.asarray(mu)
    stem = os.path.join(param_dir, f'learned_gating_matrix_{model_id}')
    np.save(stem + '.npy', mu)
    save_labeled_csv(mu, label_names, stem + '.csv')
