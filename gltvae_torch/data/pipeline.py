"""Host input pipeline: in-memory dataset, the batch index stream, worker
prefetch and host sharding (counterpart of gltvae/data/pipeline.py).

Batches stay uint8 numpy arrays on the host; the train step dequantizes on
the device. The same seed gives the same index stream as the JAX package's
``BatchLoader``: the seeded permutation, the reference's wrap-around final
batch (utils_data.py:65-72) and the per-epoch reshuffle, whatever the
worker count.

- ``num_workers`` > 0 fetches (decodes) on worker threads behind one feeder
  thread; batches come out in sequence order, the feeder stalls once
  ``2 * prefetch + num_workers`` batches are produced and not consumed, and
  the loader's cursor advances only on consumed batches, so an iterator
  abandoned mid-epoch loses nothing.
- ``shard=(process_index, process_count)`` fetches only this process's
  contiguous 1/N slice of every global batch; the index stream stays the
  global one on every process.

One departure from the JAX package: an exception in a worker's fetch is
raised in the consuming thread (the JAX package's consumer waits for the
lost batch forever).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

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
    """Infinite wrap-around batch stream with optional worker prefetch.
    ``n_s`` and ``epoch_batches`` follow the reference loader's accounting
    (ceil(n_s / bs) a epoch)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 reshuffle_each_epoch: bool = True, seed: int = 0,
                 num_workers: int = 0, prefetch: int = 4,
                 shard: Optional[Tuple[int, int]] = None):
        if shard is not None:
            pid, pc = shard
            if not (0 <= pid < pc):
                raise ValueError(f'shard process_index {pid} out of range '
                                 f'for process_count {pc}')
            if batch_size % pc:
                raise ValueError(
                    f'host-sharded loading needs batch_size divisible by '
                    f'process_count (got {batch_size} % {pc}) — rows would '
                    f'be silently dropped')
        self.dataset = dataset
        self.bs = batch_size
        self.shard = shard
        self.n_s = len(dataset)
        self.shuffle = shuffle
        self.reshuffle_each_epoch = reshuffle_each_epoch
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._seed = seed
        self.reset()

    class _Cursor:
        """Index-stream state: (permutation, offset, rng). The loader owns
        the authoritative cursor; a threaded iterator runs a speculative
        clone ahead of consumption (generation is deterministic, so both
        give the same stream)."""

        __slots__ = ('idxs', 'start', 'rng')

        def __init__(self, idxs, start, rng):
            self.idxs, self.start, self.rng = idxs, start, rng

        def clone(self) -> 'BatchLoader._Cursor':
            rng = np.random.RandomState()
            rng.set_state(self.rng.get_state())
            return BatchLoader._Cursor(self.idxs.copy(), self.start, rng)

    @property
    def _start(self):
        return self._cur.start

    @property
    def _idxs(self):
        return self._cur.idxs

    @property
    def _rng(self):
        return self._cur.rng

    @property
    def epoch_batches(self) -> int:
        return int(np.ceil(self.n_s / self.bs))

    def _advance(self, cur: '_Cursor') -> np.ndarray:
        """The next batch's indices from `cur` (advanced in place); a batch
        that runs past the end is completed from the front, and the
        permutation is reshuffled."""
        s, bs, n = cur.start, self.bs, self.n_s
        if s + bs < n:
            # a copy: the reshuffle below is in place, and prefetched
            # batches must not see it
            out = cur.idxs[s:s + bs].copy()
            cur.start = s + bs
        else:
            out = np.concatenate([cur.idxs[s:], cur.idxs[:bs - (n - s)]])
            cur.start = (s + bs) % n
            if self.reshuffle_each_epoch and self.shuffle:
                cur.rng.shuffle(cur.idxs)
        return out

    def _next_batch_idxs(self) -> np.ndarray:
        return self._advance(self._cur)

    def epoch_indices(self) -> np.ndarray:
        """[epoch_batches, bs] global indices of the next epoch's batches
        (the authoritative cursor advances past them)."""
        return np.stack([self._next_batch_idxs()
                         for _ in range(self.epoch_batches)])

    def _local(self, idxs: np.ndarray) -> np.ndarray:
        """This process's slice of a global batch's indices (all of them
        when unsharded)."""
        if self.shard is None:
            return idxs
        pid, pc = self.shard
        ls = len(idxs) // pc
        return idxs[pid * ls:(pid + 1) * ls]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.num_workers > 0:
            return self._threaded_iter()
        return self._sync_iter()

    def _sync_iter(self):
        while True:
            yield self.dataset.fetch(self._local(self._next_batch_idxs()))

    def _threaded_iter(self):
        """One feeder thread generates the index stream on a speculative
        cursor clone; workers fetch; the consumer takes batches in sequence
        order, commits each to the authoritative cursor as it yields it, and
        raises a worker's exception. Closing the iterator stops and joins
        the threads."""
        spec = self._cur.clone()
        cap = self.prefetch * 2 + self.num_workers
        idx_q: queue.Queue = queue.Queue(maxsize=self.prefetch * 2)
        out: dict = {}
        cv = threading.Condition()
        counters = {'consumed': 0}
        errors: list = []
        stop = threading.Event()
        # for tests of the backpressure cap
        self._iter_buffers = {'out': out, 'idx_q': idx_q,
                              'counters': counters, 'cap': cap}

        def feeder():
            seq, item = 0, None
            while not stop.is_set():
                with cv:
                    while (seq - counters['consumed'] >= cap
                           and not stop.is_set()):
                        cv.wait(timeout=0.1)
                if stop.is_set():
                    return
                if item is None:    # generate once; retry it while Full
                    item = (seq, self._advance(spec))
                    seq += 1
                try:
                    idx_q.put(item, timeout=0.1)
                    item = None
                except queue.Full:
                    continue

        def worker():
            while not stop.is_set():
                try:
                    seq, idxs = idx_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    batch = self.dataset.fetch(self._local(idxs))
                except Exception as e:      # raised by the consumer
                    with cv:
                        errors.append(e)
                        cv.notify_all()
                    return
                with cv:
                    out[seq] = batch
                    cv.notify_all()

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True)
                    for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            seq = 0
            while True:
                with cv:
                    while seq not in out:
                        if errors:
                            raise errors[0]
                        cv.wait(timeout=1.0)
                    batch = out.pop(seq)
                    counters['consumed'] = seq + 1
                    cv.notify_all()
                self._advance(self._cur)        # commit this batch
                seq += 1
                yield batch
        finally:
            # wait for the threads: a decode still running in native code
            # when the interpreter exits aborts the process
            stop.set()
            for t in threads:
                t.join()

    def reset(self):
        """Back to the post-init state: the seeded permutation, offset 0."""
        rng = np.random.RandomState(self._seed)
        idxs = np.arange(self.n_s)
        if self.shuffle:
            rng.shuffle(idxs)
        self._cur = BatchLoader._Cursor(idxs, 0, rng)
