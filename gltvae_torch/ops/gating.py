"""Gating-matrix initialization from label co-occurrence, with the npy
cache (numpy; the counterpart of gltvae/ops/gating.py).

Cache protocol, as in the JAX package: ``gating_matrix_{sup}.npy`` (18
labels) or ``gating_matrix_{sup}_{y_dim}.npy`` (other widths) under
``cache_dir`` short-circuits the computation. A cache this code wrote
carries a ``.npy.sha256`` sidecar and is trusted; an unmarked cache is
checked against a fresh computation, adopted (and marked) when they agree,
used with a warning when they differ; a cache of the wrong shape is
recomputed. A fresh computation writes the npy, the sidecar and the
labeled CSV, byte-equal to the JAX package's files (the CSV is written
with the ``csv`` module in pandas' ``to_csv`` layout).
"""

from __future__ import annotations

import csv
import hashlib
import logging
import os
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def cooccurrence_gating_matrix(labels: np.ndarray) -> np.ndarray:
    """μ[i,j] = (# samples with labels i and j both 1) / N⁺ for i≠j, μ[i,i]=1,
    with N⁺ the number of samples having at least one positive label (the
    reference's utils.py:132-149)."""
    labels = np.asarray(labels, dtype=np.float64)
    n_pos = int((labels.sum(axis=1) > 0).sum())
    counts = labels.T @ labels
    np.fill_diagonal(counts, 0.0)
    mu = counts / float(max(n_pos, 1))
    np.fill_diagonal(mu, 1.0)
    return mu


def identity_gating_matrix(z_classify: int, y_dim: int) -> np.ndarray:
    """Fixed one-to-one gating: μ = I."""
    return np.eye(z_classify, y_dim, dtype=np.float32)


def uniform_gating_matrix(y_dim: int) -> np.ndarray:
    """Unsupervised fallback: all 0.5 with unit diagonal."""
    mu = np.full((y_dim, y_dim), 0.5, dtype=np.float64)
    np.fill_diagonal(mu, 1.0)
    return mu


def gating_matrix_from_labels(
    sup_labels: Optional[np.ndarray],
    valid_labels: Optional[np.ndarray],
    y_dim: int,
    sup_frac: float,
    cache_dir: Optional[str] = None,
    label_names: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """μ init from the supervised + validation labels (uniform when
    unsupervised), through the npy cache under `cache_dir` when given."""
    def compute() -> np.ndarray:
        if sup_frac == 0.0 or sup_labels is None:
            return uniform_gating_matrix(y_dim)
        parts = [sup_labels]
        if valid_labels is not None:
            parts.append(valid_labels)
        return cooccurrence_gating_matrix(np.concatenate(parts, axis=0))

    if cache_dir is None:
        return compute()
    # the reference's file name at 18 labels; other widths get a suffix so
    # the two never read each other's cache in a shared data directory
    stem = (f'gating_matrix_{sup_frac}' if y_dim == 18
            else f'gating_matrix_{sup_frac}_{y_dim}')
    cache_npy = os.path.join(cache_dir, f'{stem}.npy')
    if os.path.exists(cache_npy):
        cached = np.load(cache_npy)
        if cached.shape != (y_dim, y_dim):
            logger.warning('stale gating cache %s has shape %s, expected %s; '
                           'recomputing', cache_npy, cached.shape,
                           (y_dim, y_dim))
        elif _sidecar_valid(cache_npy):
            return cached
        else:
            mu = compute()
            if np.allclose(cached, mu, atol=1e-8):
                _write_sidecar(cache_npy)
                return cached
            logger.warning(
                'cached gating matrix %s does NOT match recomputation from '
                'the current labels (max |Δ|=%.3g) — it was written by '
                'divergent code or different data. Using the cache for '
                'reference-protocol parity; delete the file to recompute.',
                cache_npy, float(np.abs(cached - mu).max()))
            return cached

    mu = compute()
    os.makedirs(cache_dir, exist_ok=True)
    np.save(cache_npy, mu)
    _write_sidecar(cache_npy)
    if label_names is not None:
        save_labeled_csv(mu, label_names,
                         os.path.join(cache_dir, f'{stem}.csv'))
    return mu


def _npy_sha256(path: str) -> str:
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


def _write_sidecar(cache_npy: str) -> None:
    try:
        with open(cache_npy + '.sha256', 'w') as f:
            f.write(_npy_sha256(cache_npy) + '\n')
    except OSError:
        # a read-only cache directory: the next run verifies again
        pass


def _sidecar_valid(cache_npy: str) -> bool:
    side = cache_npy + '.sha256'
    if not os.path.exists(side):
        return False
    with open(side) as f:
        return f.read().strip() == _npy_sha256(cache_npy)


def save_labeled_csv(mu: np.ndarray, label_names: Sequence[str],
                     path: str) -> None:
    """Rows z1..zN, attribute-name columns (the reference's CSV layout):
    the bytes ``pandas.DataFrame(mu, index, columns).to_csv(path)`` writes,
    whose float cells are numpy's ``astype(str)``."""
    mu = np.asarray(mu)
    with open(path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow([''] + list(label_names))
        for i, row in enumerate(mu.astype(str)):
            w.writerow([f'z{i + 1}'] + row.tolist())
