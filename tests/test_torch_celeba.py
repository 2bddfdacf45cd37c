"""gltvae_torch.data.celeba against gltvae.data.celeba on CelebA-shaped
files (218x178 JPEGs written with PIL, the Kaggle attribute CSV, a
partition CSV): parsers, splits, flag conflicts, decode, and both decoded
caches. Every comparison is exact (tolerance 0: bytes, labels, ids,
messages)."""

import os

import numpy as np
import pytest
import torch

import gltvae.config as jcfg
import gltvae.data.celeba as jc

import gltvae_torch.config as tcfg
import gltvae_torch.data.celeba as tc
from gltvae_torch.data.synthetic import write_celeba_corpus

N_TRAIN, N_VALID, N_TEST = 24, 8, 8


@pytest.fixture
def corpus(tmp_path):
    root = tmp_path / 'celeba'
    write_celeba_corpus(str(root), N_TRAIN, N_VALID, N_TEST, seed=3)
    return root


def _cfgs(root, **kw):
    kw.setdefault('num_workers', 0)
    return (jcfg.DataConfig(data_dir=str(root), **kw),
            tcfg.DataConfig(data_dir=str(root), **kw))


def _readers(root, sup=0.5, bs=8, reader_kw=None, **kw):
    jd, td = _cfgs(root, **kw)
    reader_kw = reader_kw or {}
    return (jc.CelebAReader(jd, sup, bs, **reader_kw),
            tc.CelebAReader(td, sup, bs, **reader_kw))


# ------------------------------- parsers -------------------------------

@pytest.mark.parametrize('easy', [True, False])
def test_attr_csv_both_layouts_equal_gltvae(corpus, tmp_path, easy):
    comma = str(corpus / 'list_attr_celeba.csv')
    ids, lab = tc.load_attr_csv(comma, easy)
    jids, jlab = jc.load_attr_csv(comma, easy)
    assert ids == jids and lab.dtype == jlab.dtype
    assert np.array_equal(lab, jlab)
    assert lab.shape == (N_TRAIN + N_VALID + N_TEST, 18 if easy else 40)
    assert set(np.unique(lab)) <= {0, 1}
    # the original space layout: a count line, a header line, then rows
    lines = open(comma).read().splitlines()
    txt = tmp_path / 'list_attr_celeba.txt'
    txt.write_text(f'{len(lines) - 1}\n'
                   + ' '.join(lines[0].split(',')[1:]) + '\n'
                   + '\n'.join(' '.join(r.split(',')) for r in lines[1:])
                   + '\n')
    sids, slab = tc.load_attr_csv(str(txt), easy)
    assert sids == ids and np.array_equal(slab, lab)
    assert np.array_equal(slab, jc.load_attr_csv(str(txt), easy)[1])


@pytest.mark.parametrize('body', [
    'image_id,partition\n000001.jpg,0\n000002.jpg\n',
    'image_id,partition\n000001.jpg,\n',
    'image_id,partition\n000001.jpg,train\n',
    ',0\n',
])
def test_partition_errors_equal_gltvae(tmp_path, body):
    p = tmp_path / 'part.csv'
    p.write_text(body)
    with pytest.raises(ValueError) as te:
        tc.load_partition_csv(str(p))
    with pytest.raises(ValueError) as je:
        jc.load_partition_csv(str(p))
    assert str(te.value) == str(je.value)
    assert 'part.csv:' in str(te.value)


def test_partition_layouts_equal_gltvae(corpus, tmp_path):
    comma = str(corpus / 'list_eval_partition.csv')
    assert tc.load_partition_csv(comma) == jc.load_partition_csv(comma)
    space = tmp_path / 'list_eval_partition.txt'
    space.write_text('000001.jpg 0\n000002.jpg 2\n\n000003.jpg 1\n')
    assert tc.load_partition_csv(str(space)) == \
        jc.load_partition_csv(str(space)) == \
        {'000001.jpg': 0, '000002.jpg': 2, '000003.jpg': 1}


# -------------------------------- splits --------------------------------

def _assert_splits_equal(j, t):
    assert sorted(t.splits) == sorted(j.splits)
    for k in j.splits:
        assert t.splits[k].ids == j.splits[k].ids, k
        assert np.array_equal(t.splits[k].labels, j.splits[k].labels), k
    assert t.init_gating_prob.dtype == j.init_gating_prob.dtype
    assert np.array_equal(t.init_gating_prob, j.init_gating_prob)


@pytest.mark.parametrize('sup', [0.0, 0.5, 1.0])
@pytest.mark.parametrize('how', ['split_file', 'prefix', 'prefix_n_test'])
def test_reader_splits_equal_gltvae(corpus, sup, how):
    kw = {'split_file': dict(split_file='list_eval_partition.csv'),
          'prefix': dict(n_train=20, n_valid=10, n_test=10),
          'prefix_n_test': dict(n_train=16, n_valid=8, n_test=4)}[how]
    j, t = _readers(corpus, sup, **kw)
    _assert_splits_equal(j, t)
    want = {'split_file': (24, 8, 8), 'prefix': (20, 10, 10),
            'prefix_n_test': (16, 8, 4)}[how]
    assert tuple(len(t.splits[m]) for m in ('train', 'valid', 'test')) \
        == want
    if 0 < sup < 1:
        assert len(t.splits['sup']) == int(want[0] * sup)
    jl, tl = j.setup_data_loaders(), t.setup_data_loaders()
    assert list(tl) == list(jl)
    for m in tl:
        assert tl[m].n_s == jl[m].n_s


@pytest.mark.parametrize('kw,match', [
    (dict(), '--n-train'),                        # the official defaults
    (dict(n_train=40, n_valid=10, n_test=10), 'empty'),
])
def test_empty_split_error_equals_gltvae(corpus, kw, match):
    jd, td = _cfgs(corpus, **kw)
    with pytest.raises(ValueError, match=match) as te:
        tc.CelebAReader(td, 0.5, 8)
    with pytest.raises(ValueError) as je:
        jc.CelebAReader(jd, 0.5, 8)
    assert str(te.value) == str(je.value)


def test_split_file_missing_image_error_equals_gltvae(corpus):
    p = corpus / 'list_eval_partition.csv'
    p.write_text('\n'.join(p.read_text().splitlines()[:-1]) + '\n')
    jd, td = _cfgs(corpus, split_file='list_eval_partition.csv')
    with pytest.raises(ValueError, match='absent from') as te:
        tc.CelebAReader(td, 1.0, 8)
    with pytest.raises(ValueError) as je:
        jc.CelebAReader(jd, 1.0, 8)
    assert str(te.value) == str(je.value)


SPLIT = dict(split_file='list_eval_partition.csv')


@pytest.mark.parametrize('kw,reader_kw', [
    (dict(decode_backend='grain', cache_decoded=True), {}),
    (dict(decode_backend='grain', cache_dir='CACHE'), {}),
    (dict(cache_dir='CACHE', cache_decoded=True), {}),
    (dict(cache_dir='CACHE', device_resize=True), {}),
    (dict(decode_backend='native', device_resize=True), {}),
    (dict(decode_backend='grain', device_resize=True), {}),
    (dict(cache_decoded=True, device_resize=True), {}),
    (dict(augment_pad=4, device_resize=True), {}),
    (dict(cache_dir='CACHE'), dict(shard=(0, 2))),
], ids=['grain+cache_decoded', 'grain+cache_dir', 'cache_dir+cache_decoded',
        'cache_dir+device_resize', 'native+device_resize',
        'grain+device_resize', 'cache_decoded+device_resize',
        'augment_pad+device_resize', 'cache_dir+shard_incomplete'])
def test_flag_conflicts_raise_gltvae_errors(corpus, tmp_path, kw,
                                            reader_kw):
    """Each conflict raises gltvae's ValueError, word for word, before any
    decode."""
    kw = {k: (str(tmp_path / 'cache') if v == 'CACHE' else v)
          for k, v in kw.items()}
    j, t = _readers(corpus, 0.5, reader_kw=reader_kw, **SPLIT, **kw)
    with pytest.raises(ValueError) as te:
        t.setup_data_loaders()
    with pytest.raises(ValueError) as je:
        j.setup_data_loaders()
    assert str(te.value) == str(je.value)


def test_grain_backend_is_not_ported(corpus):
    _, t = _readers(corpus, 0.5, **SPLIT, decode_backend='grain')
    with pytest.raises(NotImplementedError, match='ROADMAP Queue 1 item 8'):
        t.setup_data_loaders()


# -------------------------------- decode --------------------------------

@pytest.mark.parametrize('backend', ['pil', 'cv2'])
@pytest.mark.parametrize('center_crop', [False, True])
@pytest.mark.parametrize('host_resize', [True, False])
def test_image_folder_bytes_equal_gltvae(corpus, backend, center_crop,
                                         host_resize):
    ids, lab = tc.load_attr_csv(str(corpus / 'list_attr_celeba.csv'))
    split = tc._SplitData(ids, lab)
    jsplit = jc._SplitData(ids, lab)
    img_dir = str(corpus / 'img_align_celeba')
    size = 128 if center_crop else 64
    t = tc.ImageFolderDataset(img_dir, split, size, center_crop, backend,
                              host_resize)
    j = jc.ImageFolderDataset(img_dir, jsplit, size, center_crop, backend,
                              host_resize)
    idxs = np.array([0, 5, 17, 3, 39])
    (x, y), (jx, jy) = t.fetch(idxs), j.fetch(idxs)
    assert x.dtype == jx.dtype == np.uint8 and y.dtype == jy.dtype
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    shape = ((size, size) if host_resize
             else (178, 178) if center_crop else (218, 178))
    assert x.shape == (5, *shape, 3)


def test_auto_backend_is_cv2_where_cv2_imports(corpus):
    ids, lab = tc.load_attr_csv(str(corpus / 'list_attr_celeba.csv'))
    t = tc.ImageFolderDataset(str(corpus), tc._SplitData(ids, lab), 64)
    j = jc.ImageFolderDataset(str(corpus), jc._SplitData(ids, lab), 64)
    assert t.backend == j.backend == 'cv2'


@pytest.mark.parametrize('sup', [0.5, 1.0])
def test_loader_batches_equal_gltvae(corpus, sup):
    """Two epochs of every loader, port at 4 decode threads, gltvae
    synchronous: the same u8 batches and labels. Under augment_pad the
    train splits decode at S + 2P and the eval splits at S."""
    for kw in (dict(), dict(augment_pad=4)):
        j, t = _readers(corpus, sup, **SPLIT, **kw)
        t.num_workers = 4
        jl, tl = j.setup_data_loaders(), t.setup_data_loaders()
        for m in jl:
            n = 2 * jl[m].epoch_batches
            ij, it = iter(jl[m]), iter(tl[m])
            for _ in range(n):
                (x, y), (jx, jy) = next(it), next(ij)
                assert np.array_equal(x, jx) and np.array_equal(y, jy)
            it.close()
            pad = kw.get('augment_pad', 0) if m in ('sup', 'unsup') else 0
            assert x.shape[1:] == (64 + 2 * pad, 64 + 2 * pad, 3), m
            assert tl[m].num_workers == 4


# -------------------------------- caches --------------------------------

def _split_ds(corpus, cls_mod, n=None, size=64):
    ids, lab = tc.load_attr_csv(str(corpus / 'list_attr_celeba.csv'))
    n = n or len(ids)
    return cls_mod.ImageFolderDataset(str(corpus / 'img_align_celeba'),
                                      cls_mod._SplitData(ids[:n], lab[:n]),
                                      size, backend='pil')


class _Counting:
    """A dataset wrapper that counts the rows its inner fetch decodes."""

    def __init__(self, ds):
        self.ds, self.split, self.rows = ds, ds.split, 0
        self.image_size = ds.image_size
        self.center_crop = ds.center_crop

    def __len__(self):
        return len(self.ds)

    def fetch(self, idxs):
        self.rows += len(idxs)
        return self.ds.fetch(idxs)


def test_cached_dataset_equals_gltvae_and_decodes_once(corpus):
    inner = _Counting(_split_ds(corpus, tc))
    t = tc.CachedDataset(inner)
    j = jc.CachedDataset(_split_ds(corpus, jc))
    order = np.random.RandomState(0).permutation(len(t))
    for _ in range(2):
        for lo in range(0, len(t), 7):
            idxs = order[lo:lo + 7]
            (x, y), (jx, jy) = t.fetch(idxs), j.fetch(idxs)
            assert np.array_equal(x, jx) and np.array_equal(y, jy)
    assert inner.rows == len(t)


@pytest.mark.parametrize('filler', ['gltvae', 'port'])
def test_disk_cache_filled_by_one_serves_the_other(corpus, tmp_path, filler):
    """A cache directory one package filled serves the other with no
    decode, the same bytes under the same file names."""
    cache = str(tmp_path / 'cache')
    fill_mod, read_mod = (jc, tc) if filler == 'gltvae' else (tc, jc)
    fill = fill_mod.DiskCachedDataset(_split_ds(corpus, fill_mod), cache,
                                      'sup')
    idx = np.arange(len(fill))
    for lo in range(0, len(fill), 9):
        fill.fetch(idx[lo:lo + 9])
    assert fill.complete
    names = sorted(os.listdir(cache))
    assert [n.rsplit('.', 1)[1] for n in names] == ['complete', 'json',
                                                    'u8']
    assert names[0].startswith('sup_64px_')
    inner = _Counting(_split_ds(corpus, read_mod))
    read = read_mod.DiskCachedDataset(inner, cache, 'sup')
    assert read.complete
    x, y = read.fetch(idx[::-1])
    assert inner.rows == 0
    want, wy = _split_ds(corpus, tc).fetch(idx[::-1])
    assert np.array_equal(x, want) and np.array_equal(y, wy)
    assert sorted(os.listdir(cache)) == names


def test_disk_cache_files_equal_gltvae(corpus, tmp_path):
    for mod, d in ((tc, 't'), (jc, 'j')):
        ds = mod.DiskCachedDataset(_split_ds(corpus, mod, size=72),
                                   str(tmp_path / d), 'unsup')
        ds.fetch(np.arange(len(ds)))
    ft = {n: open(tmp_path / 't' / n, 'rb').read()
          for n in os.listdir(tmp_path / 't')}
    fj = {n: open(tmp_path / 'j' / n, 'rb').read()
          for n in os.listdir(tmp_path / 'j')}
    assert ft == fj and len(ft) == 3


def test_stale_fills_are_reaped_and_live_ones_kept(corpus, tmp_path):
    cache = tmp_path / 'cache'
    probe = tc.DiskCachedDataset(_split_ds(corpus, tc), str(cache), 'test')
    data_path = probe._data_path
    mine = f'{data_path}.{os.getpid()}.fill'
    dead = f'{data_path}.999999999.fill'
    open(dead, 'wb').close()
    tc.DiskCachedDataset(_split_ds(corpus, tc), str(cache), 'test')
    assert not os.path.exists(dead)
    assert os.path.exists(mine)


def test_incomplete_cache_with_shards_raises(corpus, tmp_path):
    _, t = _readers(corpus, 1.0, reader_kw=dict(shard=(1, 2)), **SPLIT,
                    cache_dir=str(tmp_path / 'cache'))
    with pytest.raises(ValueError, match='needs a COMPLETE cache'):
        t.setup_data_loaders()
    # filled once unsharded, the sharded run serves it read-only
    _, full = _readers(corpus, 1.0, **SPLIT,
                       cache_dir=str(tmp_path / 'cache'))
    for m, ld in full.setup_data_loaders().items():
        ld.dataset.fetch(np.arange(ld.n_s))
    loaders = t.setup_data_loaders()
    assert all(ld.dataset.complete for ld in loaders.values())
    x, _ = next(iter(loaders['sup']))
    assert x.shape == (4, 64, 64, 3)


# ----------------------- the Trainer's resident fetch -----------------------

def _train(corpus, tmp_path, cache, **trainer_kw):
    """One epoch at sup 0.5 of a narrow 16 px model from the corpus, through
    the reader's loaders wrapped in `cache`; returns the Trainer."""
    from gltvae_torch.train.loop import Trainer
    kw = {'none': {}, 'ram': dict(cache_decoded=True),
          'disk': dict(cache_dir=str(tmp_path / 'cache'))}[cache]
    cfg = tcfg.DataConfig(data_dir=str(corpus), image_size=16,
                          num_workers=2, **SPLIT, **kw)
    reader = tc.CelebAReader(cfg, 0.5, 8)
    model_cfg = tcfg.ModelConfig(image_size=16, z_dim=24, y_dim=18,
                                 enc_features=(8, 8), enc_hidden=16,
                                 dec_features=(16, 8))
    train_cfg = tcfg.TrainConfig(batch_size=8, perc_supervision=0.5,
                                 classifier_mc_samples=4, n_epochs=1)
    trainer = Trainer(model_cfg, train_cfg, mu_init=reader.init_gating_prob,
                      device='cpu', **trainer_kw)
    loaders = reader.setup_data_loaders()
    trainer.train(loaders)
    trainer.test_acc = trainer.test(loaders['test'])
    trainer.loaders = loaders
    return trainer


@pytest.mark.parametrize('cache', ['none', 'ram', 'disk'])
def test_resident_splits_fetch_from_each_dataset(corpus, tmp_path, cache):
    """_resident_split fetches row 0, then the whole split, from an
    ImageFolderDataset, a CachedDataset or a DiskCachedDataset: every split
    goes resident, and params and test accuracy equal the host-shipped
    run's."""
    res = _train(corpus, tmp_path, cache)
    shipped = _train(corpus, tmp_path, cache, resident_train='off',
                     resident_eval='off')
    assert {k for k, ld in res.loaders.items()
            if id(ld) in res._resident_data} == set(res.loaders)
    assert not shipped._resident_data
    want = shipped.model.state_dict()
    for k, v in res.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert res.test_acc == shipped.test_acc
    if cache == 'disk':
        assert all(ld.dataset.complete for ld in res.loaders.values())


def test_a_resident_fetch_error_raises(corpus, tmp_path):
    """gltvae streams from the host when the resident fetch raises
    (gltvae/train/loop.py:592-595, :640-643); the port raises it."""
    os.remove(corpus / 'img_align_celeba' / '000001.jpg')
    with pytest.raises(Exception, match='000001.jpg'):
        _train(corpus, tmp_path, 'none')
