"""The grain backend's loader (gltvae_torch.data.grain_loader) against
gltvae.data.grain_loader.make_grain_loader on CelebA-shaped JPEGs.

grain's per-epoch order comes from its compiled ``index_shuffle``, which
the port does not reproduce (its default is its own Feistel permutation),
so the parity cases inject grain's compiled function into the port, as
the step tests inject gltvae's threefry noise. Then every batch of 3
epochs is byte-equal (tolerance 0) in each mode: reshuffled, shuffled
once (--parity), unshuffled, center-cropped and host-sharded, on a 12- and
a 13-image split with batch sizes 5 and 4, so batches cross epoch
boundaries. Those cases skip where grain is absent."""

import numpy as np
import pytest

import gltvae_torch.data.celeba as tc
from gltvae_torch.data import grain_loader as tg
from gltvae_torch.data.synthetic import write_celeba_corpus

N = 13


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('celeba')
    write_celeba_corpus(str(root), N, 1, 1, seed=4)
    ids, labels = tc.load_attr_csv(str(root / 'list_attr_celeba.csv'))
    return str(root / 'img_align_celeba'), ids[:N], labels[:N]


def grain_index_shuffle():
    """grain's compiled index_shuffle, applied to an index array."""
    pytest.importorskip('grain')
    from grain._src.python.experimental.index_shuffle.python import \
        index_shuffle_module as m

    def shuffle(index, max_index, seed, rounds):
        return np.array([m.index_shuffle(int(i), max_index=max_index,
                                         seed=seed, rounds=rounds)
                         for i in np.atleast_1d(index)], np.int64)
    return shuffle


def _batches(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


CASES = {
    'reshuffle_12_bs5': dict(n=12, batch_size=5),
    'reshuffle_13_bs4': dict(n=13, batch_size=4),
    'shuffle_once_13_bs5': dict(n=13, batch_size=5,
                                reshuffle_each_epoch=False),
    'no_shuffle_12_bs5': dict(n=12, batch_size=5, shuffle=False),
    'center_crop_13_bs4': dict(n=13, batch_size=4, center_crop=True,
                               image_size=24),
    'shard_0_of_2_13_bs4': dict(n=13, batch_size=4, shard=(0, 2)),
    'shard_1_of_2_13_bs4': dict(n=13, batch_size=4, shard=(1, 2)),
    'shard_1_of_2_once_12_bs5': dict(n=12, batch_size=5, shard=(1, 2),
                                     reshuffle_each_epoch=False, seed=3),
}


@pytest.mark.parametrize('case', list(CASES), ids=list(CASES))
def test_batches_byte_equal_gltvae_with_grains_shuffle(corpus, case):
    shuffle = grain_index_shuffle()
    import grain.python as grain
    from gltvae.data.grain_loader import make_grain_loader as j_make
    image_dir, ids, labels = corpus
    kw = dict(CASES[case])
    n, shard = kw.pop('n'), kw.pop('shard', None)
    kw = dict(dict(image_size=16, seed=7, num_workers=2), **kw)
    j = j_make(image_dir, ids[:n], labels[:n], **kw, shard_options=(
        None if shard is None else grain.ShardOptions(*shard)))
    t = tg.make_grain_loader(image_dir, ids[:n], labels[:n], **kw,
                             index_shuffle=shuffle, shard_options=(
                                 None if shard is None
                                 else tg.ShardOptions(*shard)))
    try:
        assert t.n_s == j.n_s and t.epoch_batches == j.epoch_batches
        count = -(-3 * t.n_s // kw['batch_size'])          # 3 epochs
        for (x, y), (jx, jy) in zip(_batches(t, count), _batches(j, count)):
            assert x.dtype == jx.dtype == np.uint8 and y.dtype == jy.dtype
            assert x.shape == jx.shape and np.array_equal(x, jx)
            assert np.array_equal(y, jy)
    finally:
        t.close()


def test_a_fresh_iter_resumes_where_the_last_stopped(corpus):
    image_dir, ids, labels = corpus
    kw = dict(batch_size=5, image_size=16, seed=1, num_workers=2)
    one = tg.make_grain_loader(image_dir, ids, labels, **kw)
    two = tg.make_grain_loader(image_dir, ids, labels, **kw)
    try:
        stream = _batches(one, 7)
        got = []
        for take in (2, 1, 4):          # abandoned iterators in between
            it = iter(two)
            got += [next(it) for _ in range(take)]
            it.close()
        for (x, y), (sx, sy) in zip(got, stream):
            assert np.array_equal(x, sx) and np.array_equal(y, sy)
    finally:
        one.close()
        two.close()


def test_default_permutation_orders_every_epoch_anew(corpus):
    """The port's own permutation: each epoch is a permutation of the
    split, epochs differ, and the batches of the first epoch hold each
    image once."""
    image_dir, ids, labels = corpus
    loader = tg.make_grain_loader(image_dir, ids, labels, batch_size=N,
                                  image_size=16, seed=2, num_workers=2)
    try:
        orders = [loader.epoch_order(e) for e in range(4)]
        for o in orders:
            assert sorted(o.tolist()) == list(range(N))
        assert len({tuple(o) for o in orders}) == 4
        (x, y), = _batches(loader, 1)
        source = [loader.source[i] for i in orders[0]]
        assert np.array_equal(x, np.stack([s[0] for s in source]))
        assert np.array_equal(y, np.stack([s[1] for s in source]))
    finally:
        loader.close()
    for n in (1, 2, 3, 64, 1000):
        for seed in (0, 5, 2**32 - 1):
            p = tg.feistel_index_shuffle(np.arange(n), n - 1, seed)
            assert sorted(p.tolist()) == list(range(n))
            assert tg.feistel_index_shuffle(n // 2, n - 1, seed) == \
                p[n // 2]


def test_celeba_reader_shards_grain_batches(corpus, tmp_path):
    """CelebAReader's grain branch: host-sharded loading needs bs %
    process_count == 0 (gltvae's message), and each process batches its
    bs/pc rows of its ids[pid::pc] slice."""
    from gltvae_torch.config import DataConfig
    root = str(tmp_path / 'celeba')
    write_celeba_corpus(root, 12, 4, 4, seed=4)
    cfg = DataConfig(data_dir=root, split_file='list_eval_partition.csv',
                     decode_backend='grain', image_size=16, num_workers=2)
    with pytest.raises(ValueError, match='divisible by process_count'):
        tc.CelebAReader(cfg, 1.0, 5, shard=(0, 2)).setup_data_loaders()
    loaders = tc.CelebAReader(cfg, 1.0, 4, shard=(1, 2)).setup_data_loaders()
    try:
        sup = loaders['sup']
        assert isinstance(sup, tg.GrainLoader)
        assert sup.n_s == 6 and sup.bs == 2 and sup.epoch_batches == 3
        assert set(sup.epoch_order(0).tolist()) == {1, 3, 5, 7, 9, 11}
    finally:
        for ld in loaders.values():
            ld.close()
