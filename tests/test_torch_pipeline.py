"""gltvae_torch.data.pipeline against gltvae.data.pipeline: the same seed
gives the same index stream and the same batches, bit for bit (tolerance
0), whatever the worker count, sharding or abandoned iterators."""

import threading
import time

import numpy as np
import pytest

from gltvae.data.pipeline import ArrayDataset as JArrayDataset
from gltvae.data.pipeline import BatchLoader as JBatchLoader

from gltvae_torch.data.pipeline import ArrayDataset, BatchLoader


def make_ds(cls, n=23, y=3, seed=0):
    r = np.random.RandomState(seed)
    return cls(images=r.randint(0, 256, (n, 2, 2, 3), dtype=np.uint8),
               labels=(r.rand(n, y) > 0.5).astype(np.float32))


def _take(loader, n):
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize('workers', [0, 1, 4])
@pytest.mark.parametrize('reshuffle', [True, False])
def test_batches_equal_gltvae(workers, reshuffle):
    """5 epochs of n=23 at bs 5 (wrap-around tails): gltvae's synchronous
    stream against the port's at 0, 1 and 4 workers."""
    kw = dict(shuffle=True, reshuffle_each_epoch=reshuffle, seed=7)
    want = _take(JBatchLoader(make_ds(JArrayDataset), 5, **kw), 25)
    got = _take(BatchLoader(make_ds(ArrayDataset), 5, num_workers=workers,
                            **kw), 25)
    _assert_same(got, want)


def test_unshuffled_and_index_stream_equal_gltvae():
    j = JBatchLoader(make_ds(JArrayDataset), 4, shuffle=False)
    t = BatchLoader(make_ds(ArrayDataset), 4, shuffle=False)
    for _ in range(13):
        np.testing.assert_array_equal(t._next_batch_idxs(),
                                      j._next_batch_idxs())
        assert t._start == j._start
    assert t.epoch_batches == j.epoch_batches == 6
    np.testing.assert_array_equal(t._idxs, j._idxs)


def test_abandoned_iterator_resumes_where_consumption_stopped():
    """Fresh iterators abandoned mid-epoch with batches in flight (as the
    Trainer makes one per epoch) skip nothing: the port's threaded stream
    equals gltvae's threaded and synchronous streams."""
    want = _take(JBatchLoader(make_ds(JArrayDataset, n=40), 4, seed=11), 20)
    for cls, ds_cls in ((BatchLoader, ArrayDataset),
                        (JBatchLoader, JArrayDataset)):
        loader = cls(make_ds(ds_cls, n=40), 4, seed=11, num_workers=3,
                     prefetch=4)
        got = []
        for n in (3, 5, 1, 11):
            got += _take(loader, n)
        _assert_same(got, want)


def test_reset_and_epoch_indices_equal_gltvae():
    j = JBatchLoader(make_ds(JArrayDataset), 4, seed=5)
    t = BatchLoader(make_ds(ArrayDataset), 4, seed=5)
    for _ in range(3):
        np.testing.assert_array_equal(t.epoch_indices(), j.epoch_indices())
    _take(t, 2)
    _take(j, 2)
    t.reset()
    j.reset()
    np.testing.assert_array_equal(t.epoch_indices(), j.epoch_indices())
    t.reset()
    _assert_same(_take(t, 8), _take(JBatchLoader(make_ds(JArrayDataset), 4,
                                                 seed=5), 8))


@pytest.mark.parametrize('workers', [0, 2])
def test_shards_of_two_processes_concatenate_to_the_global_batch(workers):
    """Two "processes" (shard (0, 2) and (1, 2)) each fetch bs/2 rows; side
    by side they are the unsharded batch, and gltvae's shards equal the
    port's."""
    full = _take(BatchLoader(make_ds(ArrayDataset), 8, seed=5), 9)
    parts = [_take(BatchLoader(make_ds(ArrayDataset), 8, seed=5,
                               shard=(p, 2), num_workers=workers), 9)
             for p in range(2)]
    jparts = [_take(JBatchLoader(make_ds(JArrayDataset), 8, seed=5,
                                 shard=(p, 2)), 9) for p in range(2)]
    for p in range(2):
        _assert_same(parts[p], jparts[p])
    for i, (x, y) in enumerate(full):
        assert parts[0][i][0].shape[0] == 4
        np.testing.assert_array_equal(
            x, np.concatenate([parts[0][i][0], parts[1][i][0]]))
        np.testing.assert_array_equal(
            y, np.concatenate([parts[0][i][1], parts[1][i][1]]))


@pytest.mark.parametrize('kw,match', [
    (dict(batch_size=5, shard=(0, 2)), 'divisible'),
    (dict(batch_size=4, shard=(2, 2)), 'out of range'),
    (dict(batch_size=4, shard=(-1, 2)), 'out of range'),
])
def test_shard_errors_equal_gltvae(kw, match):
    for cls, ds_cls in ((BatchLoader, ArrayDataset),
                        (JBatchLoader, JArrayDataset)):
        with pytest.raises(ValueError, match=match):
            cls(make_ds(ds_cls, n=10), kw['batch_size'], shard=kw['shard'])


def test_backpressure_cap_holds():
    """With the consumer stalled, the feeder stays within
    2 * prefetch + num_workers batches of consumption, the cursor counts
    only consumed batches, and the stream afterwards is gltvae's."""
    loader = BatchLoader(make_ds(ArrayDataset, n=64), 4, seed=0,
                         num_workers=2, prefetch=2)
    it = iter(loader)
    first = next(it)
    time.sleep(0.5)
    buf = loader._iter_buffers
    assert buf['cap'] == 2 * 2 + 2
    assert len(buf['out']) <= buf['cap']
    assert buf['idx_q'].qsize() <= 2 * loader.prefetch
    assert loader._start == 4
    rest = [next(it) for _ in range(10)]
    it.close()
    _assert_same([first] + rest,
                 _take(JBatchLoader(make_ds(JArrayDataset, n=64), 4, seed=0),
                       11))


def test_a_worker_exception_reaches_the_consumer_and_threads_stop():
    class Failing(ArrayDataset):
        def fetch(self, idxs):
            if 3 in idxs:
                raise OSError('unreadable image 3')
            return super().fetch(idxs)
    ds = make_ds(ArrayDataset, n=12)
    loader = BatchLoader(Failing(ds.images, ds.labels), 4, shuffle=False,
                         num_workers=2)
    before = threading.active_count()
    with pytest.raises(OSError, match='unreadable image 3'):
        _take(loader, 1)
    assert threading.active_count() == before
    assert loader._start == 0
