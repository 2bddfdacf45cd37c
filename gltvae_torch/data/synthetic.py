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
