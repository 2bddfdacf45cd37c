"""CelebA from its files: attribute and partition CSVs, splits, decode on
fetch, decoded-image caches and the split loaders (counterpart of
gltvae/data/celeba.py; same data semantics, numpy on the host).

- attribute CSV: the Kaggle comma layout and the original space layout,
  -1 -> 0, the 40 -> 18 "easy" labels;
- splits: prefix sizes (the reference's 162770/19867/19962) or the
  partition file (0 train, 1 valid, 2 test); sup/unsup is the leading
  ``sup_frac`` of train;
- decode: cv2 (BGR -> RGB, ``INTER_LINEAR``) or PIL (the default resample
  of ``.resize((s, s))``, antialiased bicubic: the reference's
  byte-parity backend), a center crop for the 128 px model, or full
  resolution for the device resize; the C++ pool in
  ``gltvae_torch.data.native_loader``;
- caches: ``CachedDataset`` in RAM, ``DiskCachedDataset`` as memmaps whose
  file names and keys are the JAX package's, so a cache directory filled
  by either package serves the other with no decode;
- ``decode_backend='grain'``: cv2 decode through
  ``gltvae_torch.data.grain_loader`` (grain's index chain without grain).
"""

from __future__ import annotations

import csv
import glob
import hashlib
import json
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from gltvae_torch.config import CELEBA_EASY_LABELS, CELEBA_LABELS, DataConfig
from gltvae_torch.data.pipeline import BatchLoader
from gltvae_torch.ops.gating import gating_matrix_from_labels

DECODE_BACKENDS = ('auto', 'cv2', 'pil', 'native', 'grain')


def load_attr_csv(path: str, use_easy_labels: bool = True
                  ) -> Tuple[List[str], np.ndarray]:
    """list_attr_celeba.csv (comma) or .txt (space) -> (image ids, 0/1
    int64 label matrix)."""
    with open(path) as f:
        rows = list(csv.reader(f, delimiter=' ', skipinitialspace=True))
    # the csv has one header row; the txt a count line and a header line
    if len(rows[0]) == 1 and rows[0][0].split(',')[0] == 'image_id':
        rows = rows[1:]
    elif rows[0] and rows[0][0].isdigit():
        rows = rows[2:]
    elif rows[0] and rows[0][0] == 'image_id':
        rows = rows[1:]
    ids, data = [], []
    for row in rows:
        if not row:
            continue
        if ',' in row[0]:
            parts = row[0].split(',')
            ids.append(parts[0])
            data.append([int(v) for v in parts[1:]])
        else:
            ids.append(row[0])
            data.append([int(v) for v in row[1:]])
    labels = np.asarray(data, dtype=np.int64)
    labels[labels == -1] = 0
    if use_easy_labels:
        keep = [i for i, name in enumerate(CELEBA_LABELS)
                if name in CELEBA_EASY_LABELS]
        labels = labels[:, keep]
    return ids, labels


def load_partition_csv(path: str) -> Dict[str, int]:
    """list_eval_partition.csv (comma, header 'image_id,partition') or .txt
    (space) -> {image_id: 0 train | 1 valid | 2 test}."""
    out: Dict[str, int] = {}
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            parts = line.split(',') if ',' in line else line.split()
            if parts[0] == 'image_id':
                continue
            if len(parts) < 2 or not parts[0]:
                raise ValueError(
                    f'{path}:{lineno}: malformed partition row {line!r} '
                    f'— expected "<image_id>,<partition>" (or '
                    f'space-separated); is the file truncated?')
            try:
                out[parts[0]] = int(parts[1])
            except ValueError:
                raise ValueError(
                    f'{path}:{lineno}: partition column {parts[1]!r} is '
                    f'not an integer (expected 0=train, 1=valid, 2=test) '
                    f'in row {line!r}') from None
    return out


@dataclass
class _SplitData:
    ids: List[str]
    labels: np.ndarray

    def __len__(self):
        return len(self.ids)


def resolve_backend(backend: str) -> str:
    """'auto' -> 'cv2' where cv2 imports, else 'pil'."""
    if backend != 'auto':
        return backend
    try:
        import cv2  # noqa: F401
        return 'cv2'
    except ImportError:
        return 'pil'


class ImageFolderDataset:
    """Decode-on-fetch dataset over a directory of images: ``fetch`` decodes
    a batch to uint8 (N, S, S, 3), or (N, H, W, 3) at full resolution with
    ``host_resize=False``. PIL and cv2 release the GIL while decoding, so
    BatchLoader's worker threads decode in parallel."""

    def __init__(self, image_dir: str, split: _SplitData, image_size: int,
                 center_crop: bool = False, backend: str = 'auto',
                 host_resize: bool = True):
        if backend not in ('auto', 'cv2', 'pil'):
            raise ValueError(f"ImageFolderDataset decodes with 'cv2' or "
                             f"'pil' ('auto' picks one), not {backend!r}")
        self.image_dir = image_dir
        self.split = split
        self.image_size = image_size
        self.center_crop = center_crop
        self.host_resize = host_resize
        self.backend = resolve_backend(backend)

    def __len__(self):
        return len(self.split)

    def _decode(self, path: str) -> np.ndarray:
        s = self.image_size
        if self.backend == 'cv2':
            import cv2
            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                raise IOError(f'cv2 cannot read {path!r}')
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            if self.center_crop:
                img = _center_crop(img)
            if not self.host_resize:
                return np.asarray(img, dtype=np.uint8)
            return cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
        import PIL.Image
        # grayscale, RGBA and palette images land as 3-channel RGB
        img = PIL.Image.open(path).convert('RGB')
        if self.center_crop:
            img = PIL.Image.fromarray(_center_crop(np.asarray(img)))
        if not self.host_resize:
            return np.asarray(img, dtype=np.uint8)
        # the reference's resize: the default resample of .resize((s, s)),
        # antialiased bicubic (cv2's INTER_LINEAR is not antialiased)
        return np.asarray(img.resize((s, s)), dtype=np.uint8)

    def fetch(self, idxs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        imgs = np.stack([
            self._decode(os.path.join(self.image_dir, self.split.ids[i]))
            for i in idxs])
        return imgs, self.split.labels[idxs].astype(np.float32)


def _center_crop(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return img[top:top + s, left:left + s]


class CachedDataset:
    """In-RAM decoded-image cache around any fetch(idxs) dataset: the first
    fetch of a row decodes it through the wrapped dataset, later fetches
    are numpy gathers.

    Thread safety under BatchLoader's workers: the one allocation is
    double-checked under a lock (a second worker must not rebind ``_imgs``
    and orphan rows already flagged in ``_have``); after it, rows are
    written before their flags, and two workers decoding one row write the
    same bytes."""

    def __init__(self, ds):
        self.ds = ds
        self.split = ds.split
        self._imgs = None
        self._have = np.zeros(len(ds), dtype=bool)
        self._alloc_lock = threading.Lock()

    def __len__(self):
        return len(self.ds)

    def fetch(self, idxs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        idxs = np.asarray(idxs)
        miss = idxs[~self._have[idxs]]
        if miss.size:
            imgs, _ = self.ds.fetch(miss)
            if self._imgs is None:
                with self._alloc_lock:
                    if self._imgs is None:
                        self._imgs = np.empty(
                            (len(self.ds),) + imgs.shape[1:], dtype=np.uint8)
            self._imgs[miss] = imgs
            self._have[miss] = True
        return self._imgs[idxs], self.split.labels[idxs].astype(np.float32)


class DiskCachedDataset:
    """Decoded-image cache on disk (np.memmap), persistent across runs.

    Rows go to ``{cache_dir}/{name}_{size}px_{key}.u8``, where ``key`` is the
    first 16 hex digits of sha256(ids joined by newlines + '|size|crop'),
    so another corpus or geometry never hits. A fill goes to a file of its
    own process (``.{pid}.fill``); when every row is in, it is renamed onto
    the ``.u8`` and a ``.complete`` marker is written, both atomically. A
    complete cache is opened read-only and never calls the inner dataset.
    An incomplete one is filled again; fill files of dead processes are
    removed. Thread safety as CachedDataset: rows before flags, and a
    racing double decode writes the same bytes."""

    def __init__(self, ds, cache_dir: str, name: str):
        self.ds = ds
        self.split = ds.split
        n = len(ds)
        size = ds.image_size
        key = hashlib.sha256(
            ('\n'.join(ds.split.ids)
             + f'|{size}|{getattr(ds, "center_crop", False)}')
            .encode()).hexdigest()[:16]
        os.makedirs(cache_dir, exist_ok=True)
        base = os.path.join(cache_dir, f'{name}_{size}px_{key}')
        self._data_path = base + '.u8'
        self._marker_path = base + '.complete'
        self._shape = (n, size, size, 3)
        if os.path.exists(self._marker_path):
            self._mm = np.memmap(self._data_path, dtype=np.uint8, mode='r',
                                 shape=self._shape)
            self._have = None
        else:
            self._reap_stale_fills()
            # never 'w+' on the shared path: it would zero rows that a
            # sibling process has written and flagged
            self._fill_path = f'{self._data_path}.{os.getpid()}.fill'
            self._mm = np.memmap(self._fill_path, dtype=np.uint8,
                                 mode='w+', shape=self._shape)
            self._have = np.zeros(n, dtype=bool)
            with open(base + '.json', 'w') as f:
                json.dump({'n': n, 'size': size, 'key': key}, f)
        self._mark_lock = threading.Lock()

    def _reap_stale_fills(self):
        """Remove the fill files of processes that are gone; live fillers'
        files stay."""
        for p in glob.glob(self._data_path + '.*.fill'):
            try:
                pid = int(p.rsplit('.', 2)[-2])
                os.kill(pid, 0)
            except (ValueError, ProcessLookupError):
                try:
                    os.remove(p)
                except OSError:
                    pass
            except PermissionError:
                pass                        # alive, under another uid

    def __len__(self):
        return self._shape[0]

    @property
    def complete(self) -> bool:
        return self._have is None

    def _finalize(self):
        with self._mark_lock:
            if self._have is None or not self._have.all():
                return
            self._mm.flush()
            os.replace(self._fill_path, self._data_path)
            tmp = self._marker_path + '.tmp'
            with open(tmp, 'w') as f:
                f.write('ok')
            os.replace(tmp, self._marker_path)
            self._mm = np.memmap(self._data_path, dtype=np.uint8, mode='r',
                                 shape=self._shape)
            self._have = None

    def fetch(self, idxs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        idxs = np.asarray(idxs)
        # locals: another worker's _finalize may swap the map and drop the
        # flags during this fetch
        have, mm = self._have, self._mm
        if have is not None:
            miss = idxs[~have[idxs]]
            if miss.size:
                imgs, _ = self.ds.fetch(miss)
                mm[miss] = imgs
                have[miss] = True
                if have.all():
                    self._finalize()
        return np.asarray(mm[idxs]), \
            self.split.labels[idxs].astype(np.float32)


class CelebAReader:
    """Splits, gating init and loaders of a CelebA folder (the reference's
    CelebAReader, utils_data.py:83-196)."""

    def __init__(self, cfg: DataConfig, sup_frac: float, batch_size: int,
                 *, seed: int = 0, num_workers: Optional[int] = None,
                 reshuffle_each_epoch: bool = True,
                 shard: Optional[Tuple[int, int]] = None):
        if cfg.decode_backend not in DECODE_BACKENDS:
            raise ValueError(f'decode_backend must be one of '
                             f'{DECODE_BACKENDS}, got {cfg.decode_backend!r}')
        self.cfg = cfg
        self.sup_frac = sup_frac
        self.batch_size = batch_size
        self.seed = seed
        self.shard = shard
        self.num_workers = (cfg.num_workers if num_workers is None
                            else num_workers)
        self.reshuffle = reshuffle_each_epoch
        ids, labels = load_attr_csv(
            os.path.join(cfg.data_dir, cfg.attr_file), cfg.use_easy_labels)
        self.splits = self._make_splits(ids, labels)
        self.init_gating_prob = self._init_gating()

    def _make_splits(self, ids, labels) -> Dict[str, _SplitData]:
        cfg = self.cfg
        if cfg.split_file is not None:
            part = load_partition_csv(
                os.path.join(cfg.data_dir, cfg.split_file))
            missing = sum(1 for i in ids if i not in part)
            if missing:
                raise ValueError(
                    f'{missing}/{len(ids)} attr-CSV images are absent from '
                    f'split file {cfg.split_file}; the two files must '
                    'cover the same images')
            out = {}
            for name, code in (('train', 0), ('valid', 1), ('test', 2)):
                keep = [k for k, i in enumerate(ids) if part[i] == code]
                out[name] = _SplitData([ids[k] for k in keep], labels[keep])
            sizes_msg = (f'split file {cfg.split_file} assigns '
                         + '/'.join(str(len(out[m]))
                                    for m in ('train', 'valid', 'test')))
        else:
            n_tr, n_va = cfg.n_train, cfg.n_valid
            n_end = n_tr + n_va + cfg.n_test
            out = {'train': _SplitData(ids[:n_tr], labels[:n_tr]),
                   'valid': _SplitData(ids[n_tr:n_tr + n_va],
                                       labels[n_tr:n_tr + n_va]),
                   'test': _SplitData(ids[n_tr + n_va:n_end],
                                      labels[n_tr + n_va:n_end])}
            sizes_msg = (f'the configured split sizes are n_train={n_tr}, '
                         f'n_valid={n_va} (defaults are the official '
                         'CelebA 162770/19867). For a smaller corpus pass '
                         '--n-train/--n-valid sized to the corpus')
        empty = [m for m in ('train', 'valid', 'test') if len(out[m]) == 0]
        if empty:
            raise ValueError(
                f'split(s) {empty} are empty: the attribute CSV lists '
                f'{len(ids)} images but {sizes_msg}.')
        tr = out['train']
        if self.sup_frac == 0.0:
            out['unsup'] = tr
        elif self.sup_frac == 1.0:
            out['sup'] = tr
        else:
            k = int(len(tr) * self.sup_frac)
            out['sup'] = _SplitData(tr.ids[:k], tr.labels[:k])
            out['unsup'] = _SplitData(tr.ids[k:], tr.labels[k:])
        return out

    def _init_gating(self) -> np.ndarray:
        y_dim = self.splits['train'].labels.shape[1]
        sup = self.splits['sup'].labels if 'sup' in self.splits else None
        return gating_matrix_from_labels(
            sup, self.splits['valid'].labels, y_dim, self.sup_frac,
            cache_dir=self.cfg.data_dir,
            label_names=(CELEBA_EASY_LABELS if self.cfg.use_easy_labels
                         else CELEBA_LABELS))

    def setup_data_loaders(self) -> Dict[str, BatchLoader]:
        if self.sup_frac == 0.0:
            # a valid loader too: unsupervised runs keep the best checkpoint
            # by validation ELBO
            modes = ['unsup', 'test', 'valid']
        elif self.sup_frac == 1.0:
            modes = ['sup', 'test', 'valid']
        else:
            modes = ['unsup', 'test', 'sup', 'valid']
        image_dir = os.path.join(self.cfg.data_dir, self.cfg.image_dir)
        backend = self.cfg.decode_backend
        if backend == 'grain' and self.cfg.cache_decoded:
            raise ValueError('cache_decoded applies to the cv2/pil/native '
                             'fetch() datasets; grain manages its own '
                             'pipeline (drop one of the two flags)')
        if self.cfg.cache_dir is not None:
            if backend == 'grain':
                raise ValueError('cache_dir applies to the cv2/pil/native '
                                 'fetch() datasets; grain manages its own '
                                 'pipeline (drop one of the two flags)')
            if self.cfg.cache_decoded:
                raise ValueError('cache_dir already serves rows from the '
                                 'OS page cache once filled; stacking the '
                                 'in-RAM cache_decoded on top doubles host '
                                 'memory for nothing (drop one)')
            if self.cfg.device_resize:
                raise ValueError('cache_dir stores host-resized fixed-'
                                 'shape uint8 rows; with device_resize '
                                 'rows are full-resolution (~19 GB for '
                                 'CelebA) — drop one of the two flags')
        if backend == 'native' and self.cfg.device_resize:
            raise ValueError('decode_backend=native always resizes on the '
                             'host (the C++ pool decodes straight into the '
                             'target-size buffer); drop device_resize or '
                             'use cv2/pil')
        if backend == 'grain' and self.cfg.device_resize:
            raise ValueError('decode_backend=grain always resizes on the '
                             'host (the grain DecodeMap resizes via cv2); '
                             'drop device_resize or use cv2/pil')
        if self.cfg.cache_decoded and self.cfg.device_resize:
            raise ValueError('cache_decoded stores host-resized uint8 rows '
                             '(~1.9 GB at 64px); with device_resize the '
                             'cache would hold full-resolution 178x218 '
                             'images (~19 GB for CelebA) — drop one of the '
                             'two flags')
        return {mode: self._make_loader(mode, image_dir, backend)
                for mode in modes}

    def _make_loader(self, mode: str, image_dir: str, backend: str):
        """One split's loader. Every backend yields the same kind of batch,
        (uint8 [B, S, S, 3], f32 [B, y]); train splits decode at S + 2P
        under augment_pad."""
        split = self.splits[mode]
        size = self.cfg.image_size
        if self.cfg.augment_pad and mode in ('sup', 'unsup', 'train'):
            if self.cfg.device_resize:
                raise ValueError('augment_pad with device_resize is '
                                 'unsupported (pick one device-side '
                                 'input stage)')
            size = size + 2 * self.cfg.augment_pad
        if backend == 'grain':
            from gltvae_torch.data.grain_loader import (ShardOptions,
                                                        make_grain_loader)
            # grain's sharding: this process's dataset is the slice
            # ids[pid::pc] and it batches bs/pc rows of each global batch
            # (other rows share a batch than in a one-process run)
            shard_options, bs = None, self.batch_size
            if self.shard is not None:
                pid, pc = self.shard
                if bs % pc:
                    raise ValueError(
                        f'host-sharded grain loading needs batch_size '
                        f'divisible by process_count (got {bs} % {pc})')
                shard_options = ShardOptions(shard_index=pid, shard_count=pc)
                bs //= pc
            return make_grain_loader(
                image_dir, split.ids, split.labels, batch_size=bs,
                image_size=size, seed=self.seed,
                reshuffle_each_epoch=self.reshuffle,
                num_workers=self.num_workers,
                center_crop=self.cfg.center_crop,
                shard_options=shard_options)
        if backend == 'native':
            from gltvae_torch.data.native_loader import \
                NativeImageFolderDataset
            ds = NativeImageFolderDataset(
                image_dir, split, size, center_crop=self.cfg.center_crop,
                num_threads=self.num_workers)
        else:
            ds = ImageFolderDataset(image_dir, split, size,
                                    center_crop=self.cfg.center_crop,
                                    backend=backend,
                                    host_resize=not self.cfg.device_resize)
        if self.cfg.cache_dir is not None:
            ds = DiskCachedDataset(ds, self.cfg.cache_dir, mode)
            if self.shard is not None and not ds.complete:
                raise ValueError(
                    f'cache_dir with host-sharded loading (shard=) needs a '
                    f'COMPLETE cache, but split {mode!r} is unfilled: each '
                    f'process only decodes its 1/N slice, so a sharded '
                    f'first-fill can never reach completion and decode '
                    f'would be silently re-paid every run. Pre-fill once '
                    f'with an unsharded pass over the same corpus/size, '
                    f'then sharded runs serve it read-only.')
        elif self.cfg.cache_decoded:
            ds = CachedDataset(ds)
        return BatchLoader(
            ds, self.batch_size, shuffle=True,
            reshuffle_each_epoch=self.reshuffle, seed=self.seed,
            # the native pool decodes in parallel inside fetch(); one loader
            # thread keeps the prefetch ahead
            num_workers=1 if backend == 'native' else self.num_workers,
            prefetch=self.cfg.prefetch_batches, shard=self.shard)
