"""Gating-matrix analysis: which off-diagonal latent↔attribute ties the
model learned (counterpart of gltvae/eval/analysis.py; the reference's
Quantitative_analysis.py thresholds and counting)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULT_THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def off_diagonal_gates(mu: np.ndarray, threshold: float = 0.6,
                       label_names: Sequence[str] = ()
                       ) -> List[Tuple[int, int, float]]:
    """(z_idx, y_idx, value) of each off-diagonal gate above `threshold`."""
    zs, ys = np.where(mu > threshold)
    return [(int(z), int(y), float(mu[z, y]))
            for z, y in zip(zs, ys) if z != y]


def gating_threshold_analysis(mu: np.ndarray,
                              thresholds: Sequence[float] = DEFAULT_THRESHOLDS
                              ) -> List[Tuple[float, int]]:
    """(threshold, count of off-diagonal gates above it) per threshold."""
    off = mu[~np.eye(mu.shape[0], mu.shape[1], dtype=bool)]
    return [(float(t), int((off > t).sum())) for t in thresholds]


def compare_init_vs_learned(init_mu: np.ndarray, learned_mu: np.ndarray,
                            thresholds: Sequence[float] = DEFAULT_THRESHOLDS
                            ) -> Dict[str, List[Tuple[float, int]]]:
    return {'init': gating_threshold_analysis(init_mu, thresholds),
            'learned': gating_threshold_analysis(learned_mu, thresholds)}
