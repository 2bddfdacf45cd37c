"""Gating-matrix initialization from label co-occurrence (numpy; the
counterpart of gltvae/ops/gating.py without its npy cache and CSV
helpers)."""

from __future__ import annotations

from typing import Optional

import numpy as np


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


def gating_matrix_from_labels(sup_labels: Optional[np.ndarray],
                              valid_labels: Optional[np.ndarray],
                              y_dim: int, sup_frac: float) -> np.ndarray:
    """μ init from the supervised + validation labels (uniform when
    unsupervised), as gltvae's gating_matrix_from_labels computes it when it
    has no cache directory."""
    if sup_frac == 0.0 or sup_labels is None:
        return uniform_gating_matrix(y_dim)
    parts = [sup_labels]
    if valid_labels is not None:
        parts.append(valid_labels)
    return cooccurrence_gating_matrix(np.concatenate(parts, axis=0))
