"""Standalone gating-matrix generator (counterpart of
tools/gen_gating_matrix.py, the reference's gen_intial_gating_matrix.py):
the label co-occurrence matrix over the FULL attribute CSV (all rows, not
the sup/valid subset the in-pipeline init uses), saved as npy + labeled
csv with the JAX tool's bytes.

    python -m gltvae_torch.gen_gating_matrix \\
        --attr-csv ./data/list_attr_celeba.csv [--out-dir ./data] \\
        [--all-labels]

Host-only (numpy): no device is touched.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gltvae_torch.config import CELEBA_EASY_LABELS, CELEBA_LABELS
from gltvae_torch.data.celeba import load_attr_csv
from gltvae_torch.ops.gating import (cooccurrence_gating_matrix,
                                     save_labeled_csv)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--attr-csv', required=True)
    p.add_argument('--out-dir', default=None,
                   help='defaults to the CSV directory')
    p.add_argument('--all-labels', action='store_true',
                   help='use all 40 attributes instead of the 18 easy ones')
    args = p.parse_args(argv)

    _, labels = load_attr_csv(args.attr_csv,
                              use_easy_labels=not args.all_labels)
    mu = cooccurrence_gating_matrix(labels)
    names = CELEBA_LABELS if args.all_labels else CELEBA_EASY_LABELS

    out_dir = args.out_dir or os.path.dirname(os.path.abspath(args.attr_csv))
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, 'gating_matrix.npy'), mu)
    save_labeled_csv(mu, names, os.path.join(out_dir, 'gating_matrix.csv'))
    print(mu)
    print(f'saved gating_matrix.npy/.csv to {out_dir} '
          f'({labels.shape[0]} samples, {labels.shape[1]} labels)')
    return mu


if __name__ == '__main__':
    main()
