"""Synthetic CelebA-shaped fixture: random uint8 images + correlated
labels (counterpart of gltvae/data/synthetic.py; byte-identical output for
the same arguments)."""

from __future__ import annotations

import numpy as np

from gltvae_torch.data.pipeline import ArrayDataset


def synthetic_celeba(n: int = 512, image_size: int = 64, y_dim: int = 18,
                     seed: int = 0,
                     learnable_signal: bool = False) -> ArrayDataset:
    """learnable_signal=False: labels with co-occurrence structure but
    independent of the image. True: label j is the brightness of the j-th
    image patch, which a classifier can learn."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, size=(n, image_size, image_size, 3),
                         dtype=np.uint8)
    if learnable_signal:
        g = int(np.ceil(np.sqrt(y_dim)))
        ph = max(1, image_size // g)
        labels = np.zeros((n, y_dim), np.float32)
        on = rng.rand(n, y_dim) > 0.5
        for j in range(y_dim):
            r, c = divmod(j, g)
            sl = np.s_[:, r * ph:(r + 1) * ph, c * ph:(c + 1) * ph, :]
            images[sl] = np.where(on[:, j, None, None, None],
                                  np.minimum(images[sl] // 2 + 160, 255),
                                  images[sl] // 4)
            labels[:, j] = on[:, j]
    else:
        factors = rng.rand(n, 4) > 0.5
        assign = rng.randint(0, 4, size=y_dim)
        probs = np.where(factors[:, assign], 0.8, 0.15)
        labels = (rng.rand(n, y_dim) < probs).astype(np.float32)
    # no all-zero label rows (a CelebA property the gating init relies on)
    zero = labels.sum(1) == 0
    labels[zero, rng.randint(0, y_dim, size=int(zero.sum()))] = 1.0
    return ArrayDataset(images=images, labels=labels)


def synthetic_splits(n_train: int = 256, n_valid: int = 64, n_test: int = 64,
                     sup_frac: float = 0.5, image_size: int = 64,
                     y_dim: int = 18, seed: int = 0,
                     learnable_signal: bool = False,
                     train_pad: int = 0):
    """{'sup', 'unsup', 'valid', 'test'} ArrayDatasets by sup_frac. With
    train_pad the train images come out at image_size + 2*train_pad and the
    eval splits are center-cropped from the same generation."""
    gen_size = image_size + 2 * train_pad
    full = synthetic_celeba(n_train + n_valid + n_test, gen_size, y_dim,
                            seed, learnable_signal=learnable_signal)
    p = train_pad
    eval_im = full.images[n_train:, p:p + image_size, p:p + image_size]
    train_im, train_lb = full.images[:n_train], full.labels[:n_train]
    out = {}
    if sup_frac == 0.0:
        out['unsup'] = ArrayDataset(train_im, train_lb)
    elif sup_frac == 1.0:
        out['sup'] = ArrayDataset(train_im, train_lb)
    else:
        k = int(n_train * sup_frac)
        out['sup'] = ArrayDataset(train_im[:k], train_lb[:k])
        out['unsup'] = ArrayDataset(train_im[k:], train_lb[k:])
    out['valid'] = ArrayDataset(eval_im[:n_valid],
                                full.labels[n_train:n_train + n_valid])
    out['test'] = ArrayDataset(eval_im[n_valid:],
                               full.labels[n_train + n_valid:])
    return out


def write_celeba_corpus(root: str, n_train: int, n_valid: int, n_test: int,
                        seed: int = 0, height: int = 218, width: int = 178,
                        quality: int = 95) -> dict:
    """A CelebA-shaped folder under `root`, made from `seed`: JPEGs of
    height x width written with PIL at `quality` in ``img_align_celeba/``
    (000001.jpg, ...), the Kaggle ``list_attr_celeba.csv`` (40 ±1 columns)
    and ``list_eval_partition.csv`` (the first n_train images train, then
    valid, then test). Attribute j is the brightness of the j-th cell of a
    7x7 grid over the image, so a classifier can learn it. Returns the
    counts and the encode seconds."""
    import os
    import time

    import PIL.Image
    from gltvae_torch.config import CELEBA_LABELS
    n = n_train + n_valid + n_test
    n_attr = len(CELEBA_LABELS)
    rng = np.random.RandomState(seed)
    on = rng.rand(n, n_attr) > 0.5
    g = int(np.ceil(np.sqrt(n_attr)))
    ph, pw = height // g, width // g
    image_dir = os.path.join(root, 'img_align_celeba')
    os.makedirs(image_dir, exist_ok=True)
    ids = [f'{i + 1:06d}.jpg' for i in range(n)]
    encode_s = 0.0
    for i, name in enumerate(ids):
        img = rng.randint(0, 256, (height, width, 3), dtype=np.uint8)
        for j in range(n_attr):
            r, c = divmod(j, g)
            cell = img[r * ph:(r + 1) * ph, c * pw:(c + 1) * pw]
            cell[...] = (np.minimum(cell // 2 + 160, 255) if on[i, j]
                         else cell // 4)
        t = time.perf_counter()
        PIL.Image.fromarray(img).save(os.path.join(image_dir, name),
                                      quality=quality)
        encode_s += time.perf_counter() - t
    with open(os.path.join(root, 'list_attr_celeba.csv'), 'w') as f:
        f.write('image_id,' + ','.join(CELEBA_LABELS) + '\n')
        for name, row in zip(ids, on):
            f.write(name + ',' + ','.join('1' if v else '-1' for v in row)
                    + '\n')
    with open(os.path.join(root, 'list_eval_partition.csv'), 'w') as f:
        f.write('image_id,partition\n')
        for i, name in enumerate(ids):
            part = 0 if i < n_train else (1 if i < n_train + n_valid else 2)
            f.write(f'{name},{part}\n')
    return {'train': n_train, 'valid': n_valid, 'test': n_test,
            'encode_s': encode_s}


def make_bench_corpus(root: str, n: int, size=(218, 178)) -> list:
    """The bench's CelebA-format corpus (tools/bench_data.py's
    ``make_corpus``, byte for byte): ``root/img_align_celeba/000000.jpg``...
    of uniform noise written with PIL at quality 90, and
    ``list_attr_celeba.csv`` with 40 random ±1 columns, all from
    ``RandomState(0)``. Returns the image paths."""
    import os

    import PIL.Image
    from gltvae_torch.config import CELEBA_LABELS
    img_dir = os.path.join(root, 'img_align_celeba')
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    paths, lines = [], ['image_id,' + ','.join(CELEBA_LABELS)]
    for i in range(n):
        img = rng.randint(0, 255, (*size, 3), dtype=np.uint8)
        name = f'{i:06d}.jpg'
        p = os.path.join(img_dir, name)
        PIL.Image.fromarray(img).save(p, quality=90)
        paths.append(p)
        lines.append(name + ',' + ','.join(
            map(str, rng.choice([-1, 1], size=40))))
    with open(os.path.join(root, 'list_attr_celeba.csv'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return paths
