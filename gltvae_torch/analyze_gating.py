"""Gating-matrix analysis CLI (counterpart of tools/analyze_gating.py and
the reference's Quantitative_analysis.py), driven by
gltvae_torch.eval.analysis. Prints the JAX tool's text: the off-diagonal
gates above the threshold in the init and the learned μ of each sup
fraction, then the threshold-count dicts.

    python -m gltvae_torch.analyze_gating --data-dir ./data \\
        --models-dir ./models --sup 1.0 0.5 0.2 --threshold 0.6

Reads ``<data-dir>/gating_matrix_<sup>.npy`` (the gating cache a run
writes) and ``<models-dir>/params_<sup>_learnable/
learned_gating_matrix_best.npy``. Host-only (numpy).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gltvae_torch.config import CELEBA_EASY_LABELS
from gltvae_torch.eval.analysis import (gating_threshold_analysis,
                                        off_diagonal_gates)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data-dir', default='./data')
    p.add_argument('--models-dir', default='./models')
    p.add_argument('--sup', type=float, nargs='*', default=[1.0, 0.5, 0.2])
    p.add_argument('--threshold', type=float, default=0.6)
    args = p.parse_args(argv)

    labels = list(CELEBA_EASY_LABELS)
    init_counts, learned_counts = {}, {}
    for sup in args.sup:
        print(f'\nSupervision: {sup}')
        init_path = os.path.join(args.data_dir, f'gating_matrix_{sup}.npy')
        learned_path = os.path.join(args.models_dir,
                                    f'params_{sup}_learnable',
                                    'learned_gating_matrix_best.npy')
        print('-' * 20, 'Init Gating Matrix', '-' * 20)
        init_mu = np.load(init_path)
        for z, y, v in off_diagonal_gates(init_mu, args.threshold):
            print(f'z_{z + 1}-{labels[y]}: {v}')
        print('-' * 20, 'Learned Gating Matrix', '-' * 20)
        learned_mu = np.load(learned_path)
        for z, y, v in off_diagonal_gates(learned_mu, args.threshold):
            print(f'z_{z + 1}({labels[z]})-{labels[y]}: {v}')
        init_counts[str(sup)] = gating_threshold_analysis(init_mu)
        learned_counts[str(sup)] = gating_threshold_analysis(learned_mu)

    print(init_counts)
    print(learned_counts)
    return init_counts, learned_counts


if __name__ == '__main__':
    main()
