"""The grain backend's loader without grain (counterpart of
gltvae/data/grain_loader.py).

``gltvae`` feeds this backend through Google Grain; grain imports JAX, so
the port rebuilds the same chain of indices in numpy and decodes with the
same cv2 calls:

    source (baked in a seeded order when not reshuffling)
    -> [shard_index::shard_count]
    -> shuffle(seed): epoch e in the order index_shuffle(k, n - 1,
       (seed + e) mod 2**32, rounds=4) (grain's ShuffleMapDataset)
    -> repeat forever -> batches of batch_size, across epoch boundaries

``num_workers`` threads decode items in stream order with
``max(2, num_workers) * 2`` items in flight (grain's ReadOptions).

The one departure is the permutation itself. grain's per-epoch order comes
from its compiled ``index_shuffle``, which neither its pure-Python
fallback nor TF's RandomIndexShuffle reproduces, so the port's default is
its own Feistel permutation (``feistel_index_shuffle``): the same chain,
another order. ``index_shuffle=`` takes any function with grain's
signature applied elementwise to an index array; with grain's compiled
one passed in, the batches equal ``gltvae``'s byte for byte
(tests/test_torch_grain.py).
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np


class ShardOptions(NamedTuple):
    """This process's slice of the source, ``[shard_index::shard_count]``
    (the fields of ``grain.ShardOptions``)."""
    shard_index: int
    shard_count: int


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer on uint64 arrays (wrapping arithmetic)."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def feistel_index_shuffle(index, max_index: int, seed: int,
                          rounds: int = 4):
    """The position of `index` (an int or an integer array) in a seeded
    pseudorandom permutation of [0, max_index]: a `rounds`-round Feistel
    network on the smallest even number of bits that holds max_index,
    cycle-walked back into range. grain's signature; vectorized, so one
    call orders a whole epoch."""
    if max_index < 0:
        raise ValueError(f'max_index must be >= 0, got {max_index}')
    idx = np.asarray(index, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() > max_index):
        raise ValueError(f'index out of [0, {max_index}]')
    half = max(1, (int(max_index).bit_length() + 1) // 2)
    mask = np.uint64((1 << half) - 1)
    keys = [_mix64(np.full(1, (seed & 0xFFFFFFFF) << 8 | r, np.uint64)
                   + np.uint64(0x9E3779B97F4A7C15))
            for r in range(rounds)]
    x = np.atleast_1d(idx).astype(np.uint64)
    walk = np.ones(x.shape, bool)
    with np.errstate(over='ignore'):
        while walk.any():
            a, b = x[walk] >> np.uint64(half), x[walk] & mask
            for k in keys:
                a, b = b, a ^ (_mix64(b ^ k) & mask)
            x[walk] = a << np.uint64(half) | b
            walk = x > np.uint64(max_index)
    out = x.astype(np.int64)
    return int(out[0]) if idx.ndim == 0 else out.reshape(idx.shape)


class _DecodeMap:
    """Decode one record: (image path, label row) -> (uint8 image, f32 y),
    with gltvae's cv2 calls (BGR -> RGB, an optional center crop,
    ``INTER_LINEAR`` to image_size)."""

    def __init__(self, image_dir: str, ids, labels, image_size: int,
                 center_crop: bool = False):
        self.image_dir = image_dir
        self.ids = list(ids)
        self.labels = np.asarray(labels, np.float32)
        self.image_size = image_size
        self.center_crop = center_crop

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i: int):
        import cv2
        path = os.path.join(self.image_dir, self.ids[i])
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f'cv2 cannot read {path!r}')
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if self.center_crop:
            h, w = img.shape[:2]
            s = min(h, w)
            img = img[(h - s) // 2:(h + s) // 2, (w - s) // 2:(w + s) // 2]
        img = cv2.resize(img, (self.image_size, self.image_size),
                         interpolation=cv2.INTER_LINEAR)
        return img.astype(np.uint8), self.labels[i]


class GrainLoader:
    """BatchLoader-compatible facade (``n_s``, ``epoch_batches``,
    ``__iter__``) over one persistent stream: every ``iter()`` resumes
    after the last batch any earlier iterator yielded, as gltvae's facade
    does with its one grain iterator. ``close()`` stops the decode
    threads."""

    def __init__(self, source: _DecodeMap, batch_size: int, *, seed: int,
                 reshuffle: bool, shard: Optional[ShardOptions],
                 num_workers: int, index_shuffle: Callable):
        self.source = source
        self.bs = batch_size
        self._seed = seed
        self._reshuffle = reshuffle
        self._index_shuffle = index_shuffle
        n = len(source)
        self._start, self._step = ((0, 1) if shard is None
                                   else (shard.shard_index, shard.shard_count))
        # per-host epoch: under sharding each process counts its slice
        self.n_s = len(range(self._start, n, self._step))
        if self.n_s == 0:
            raise ValueError(f'shard {shard} of {n} records is empty')
        self._pool = ThreadPoolExecutor(max(1, num_workers))
        self._ahead = max(2, num_workers) * 2
        self._items = self._item_indices()
        self._inflight: collections.deque = collections.deque()

    @property
    def epoch_batches(self) -> int:
        return int(np.ceil(self.n_s / self.bs))

    def epoch_order(self, epoch: int) -> np.ndarray:
        """Source indices of one epoch of this shard, in stream order."""
        k = np.arange(self.n_s)
        if self._reshuffle:
            k = np.asarray(self._index_shuffle(
                k, max_index=self.n_s - 1,
                seed=(self._seed + epoch) % 2**32, rounds=4), np.int64)
        return self._start + k * self._step

    def _item_indices(self) -> Iterator[int]:
        epoch = 0
        while True:
            yield from self.epoch_order(epoch).tolist()
            epoch += 1

    def _next_item(self):
        while len(self._inflight) < self._ahead:
            self._inflight.append(self._pool.submit(
                self.source.__getitem__, next(self._items)))
        return self._inflight.popleft().result()

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        imgs, ys = zip(*(self._next_item() for _ in range(self.bs)))
        return np.stack(imgs), np.stack(ys)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._inflight.clear()


def make_grain_loader(image_dir: str, ids, labels, *, batch_size: int,
                      image_size: int = 64, seed: int = 0,
                      shuffle: bool = True,
                      reshuffle_each_epoch: bool = True,
                      num_workers: int = 0,
                      center_crop: bool = False,
                      shard_options: Optional[ShardOptions] = None,
                      index_shuffle: Callable = feistel_index_shuffle
                      ) -> GrainLoader:
    """gltvae's ``make_grain_loader``: an endless stream of (uint8 [B, S, S,
    3], f32 [B, y]) batches. ``reshuffle_each_epoch=False`` (the --parity
    loader) bakes one ``np.random.RandomState(seed).permutation`` into the
    source order and replays it every epoch; ``shuffle=False`` keeps the
    file order."""
    if shuffle and not reshuffle_each_epoch:
        ids_list = list(ids)
        perm = np.random.RandomState(seed).permutation(len(ids_list))
        ids = [ids_list[i] for i in perm]
        labels = np.asarray(labels)[perm]
    source = _DecodeMap(image_dir, ids, labels, image_size,
                        center_crop=center_crop)
    return GrainLoader(source, batch_size, seed=seed,
                       reshuffle=shuffle and reshuffle_each_epoch,
                       shard=shard_options, num_workers=num_workers,
                       index_shuffle=index_shuffle)
