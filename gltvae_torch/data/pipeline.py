"""Host input pipeline: in-memory dataset and the batch index stream
(counterpart of gltvae/data/pipeline.py, synchronous iterator only).

Batches stay uint8 numpy arrays on the host; the train step dequantizes on
the device. The same seed gives the same index stream as the JAX package's
``BatchLoader``: the seeded permutation, the reference's wrap-around final
batch (utils_data.py:65-72) and the per-epoch reshuffle. The threaded
iterator and host sharding are not ported yet (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class ArrayDataset:
    """In-memory dataset: uint8 images + float labels."""
    images: np.ndarray           # (N, H, W, C) uint8
    labels: np.ndarray           # (N, y_dim)

    def __post_init__(self):
        if len(self.images) != len(self.labels):
            raise ValueError(f'{len(self.images)} images but '
                             f'{len(self.labels)} label rows')

    def __len__(self):
        return len(self.images)

    def fetch(self, idxs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.images[idxs], self.labels[idxs]


class BatchLoader:
    """Infinite wrap-around batch stream. ``n_s`` and ``epoch_batches``
    follow the reference loader's accounting (ceil(n_s / bs) a epoch)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 reshuffle_each_epoch: bool = True, seed: int = 0):
        self.dataset = dataset
        self.bs = batch_size
        self.n_s = len(dataset)
        self.shuffle = shuffle
        self.reshuffle_each_epoch = reshuffle_each_epoch
        self._seed = seed
        self.reset()

    @property
    def epoch_batches(self) -> int:
        return int(np.ceil(self.n_s / self.bs))

    def _next_batch_idxs(self) -> np.ndarray:
        """The next batch's indices; a batch that runs past the end is
        completed from the front, and the permutation is reshuffled."""
        s, bs, n = self._start, self.bs, self.n_s
        if s + bs < n:
            out = self._idxs[s:s + bs].copy()
            self._start = s + bs
        else:
            out = np.concatenate([self._idxs[s:], self._idxs[:bs - (n - s)]])
            self._start = (s + bs) % n
            if self.reshuffle_each_epoch and self.shuffle:
                self._rng.shuffle(self._idxs)
        return out

    def epoch_indices(self) -> np.ndarray:
        """[epoch_batches, bs] indices of the next epoch's batches."""
        return np.stack([self._next_batch_idxs()
                         for _ in range(self.epoch_batches)])

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.dataset.fetch(self._next_batch_idxs())

    def reset(self):
        """Back to the post-init state: the seeded permutation, offset 0."""
        self._rng = np.random.RandomState(self._seed)
        self._idxs = np.arange(self.n_s)
        if self.shuffle:
            self._rng.shuffle(self._idxs)
        self._start = 0
