"""Re-evaluate reference-format .h5 checkpoint folders through the port's
own test protocol (counterpart of tools/eval_reference_checkpoints.py).

The reference's ``*_results`` files are re-evals of its saved models
(its gated_ccvae.py:531-537: load_model('best'), gating temp 0.3,
stochastic accuracy). This tool composes the same protocol from the
port's pieces (utils/h5_import loader -> Trainer.test, stochastic eval at
temp 0.3) over every ``params_*`` folder under --models-dir, and writes
the JAX tool's per-checkpoint records (an error record where a folder
fails) to --out-json.

    python -m gltvae_torch.eval_reference_checkpoints \\
        --models-dir /data/reference/models --data-dir /data/celeba \\
        [--split-file list_eval_partition.csv] [--out-json r.json] \\
        [--device cpu]

Accuracies mean something only on the real CelebA test split. Needs h5py
to read the .h5 files; runs on ``cuda`` unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

_DIR_RE = re.compile(
    r'params_(?P<sup>[\d._]+?)_(?P<gate>learnable|fixed_one-one|'
    r'fixed_inferred)$')


def parse_run_dir(name):
    """'params_1.0_learnable' -> (sup, gate_type, gate_subtype) or None.
    Combined dirs like params_0.2_0.5_fixed_inferred take the LAST
    fraction for the μ-cache lookup."""
    m = _DIR_RE.match(name)
    if not m:
        return None
    sup = m.group('sup').strip('_').split('_')[-1]
    gate = m.group('gate')
    if gate == 'learnable':
        return sup, 'learnable', 'inferred'
    return sup, 'fixed', gate.split('_', 1)[1]


def mu_for(models_root, sup, gate_type, gate_subtype):
    """μ fallback for fixed modes (stored outside the checkpoint dir, the
    reference's gated_ccvae.py:48-57): identity for one-one, the cached
    co-occurrence matrix ``<models_root>/../data/gating_matrix_<sup>.npy``
    for inferred."""
    if gate_type == 'learnable':
        return None   # learned_gating_matrix npy lives in the dir
    if gate_subtype == 'one-one':
        return np.eye(18, dtype=np.float32)
    cache = os.path.join(os.path.dirname(models_root.rstrip('/')),
                         'data', f'gating_matrix_{sup}.npy')
    if os.path.exists(cache):
        return np.load(cache).astype(np.float32)
    raise FileNotFoundError(f'no gating cache {cache} for fixed/inferred')


def make_loaders(data_cfg, batch_size=64):
    """One reader for the whole sweep: with cache_decoded the test split
    decodes once and the other checkpoint evals read from RAM."""
    from gltvae_torch.data.celeba import CelebAReader
    reader = CelebAReader(data_cfg, sup_frac=1.0, batch_size=batch_size,
                          reshuffle_each_epoch=False)
    return reader.setup_data_loaders()


def evaluate_checkpoint(param_dir, mu, data_cfg, batch_size=64,
                        model_id='best', seed=0, loaders=None,
                        device='cuda'):
    """h5 dir -> test accuracy via the port's own Trainer.test."""
    from gltvae_torch.config import ModelConfig, TrainConfig
    from gltvae_torch.train.loop import Trainer
    from gltvae_torch.utils.h5_import import load_reference_checkpoint

    state_dict = load_reference_checkpoint(param_dir, model_id, mu=mu)
    model_cfg = ModelConfig()          # reference CelebA-64 architecture
    train_cfg = TrainConfig(batch_size=batch_size, seed=seed)
    if loaders is None:
        loaders = make_loaders(data_cfg, batch_size)
    trainer = Trainer(model_cfg, train_cfg,
                      mu_init=state_dict['mu'].numpy(), device=device)
    trainer.load_params(state_dict)
    return trainer.test(loaders['test'])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--models-dir', default='./models',
                   help='folder of params_* checkpoint folders (the '
                        "reference's models/)")
    p.add_argument('--data-dir', required=True,
                   help='CelebA-format corpus root (attr csv + images)')
    p.add_argument('--model-id', default='best', choices=['best', 'last'])
    p.add_argument('--batch-size', type=int, default=64)
    p.add_argument('--n-train', type=int, default=None)
    p.add_argument('--n-valid', type=int, default=None)
    p.add_argument('--n-test', type=int, default=None)
    p.add_argument('--split-file', default=None, metavar='CSV',
                   help='split by the official partition file (e.g. '
                        'list_eval_partition.csv, relative to --data-dir) '
                        'instead of prefix sizes: for re-evals on the '
                        'officially-partitioned real CelebA')
    p.add_argument('--only', default=None,
                   help='substring filter on run-dir names')
    p.add_argument('--out-json', default=None)
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    args = p.parse_args(argv)
    from gltvae_torch import resolve_device
    device = resolve_device(args.device)

    from gltvae_torch.config import DataConfig
    overrides = {k: v for k, v in (('n_train', args.n_train),
                                   ('n_valid', args.n_valid),
                                   ('n_test', args.n_test))
                 if v is not None}
    data_cfg = DataConfig(data_dir=args.data_dir, cache_decoded=True,
                          split_file=args.split_file, **overrides)
    loaders = make_loaders(data_cfg, args.batch_size)

    results = {}
    for name in sorted(os.listdir(args.models_dir)):
        parsed = parse_run_dir(name)
        if parsed is None or (args.only and args.only not in name):
            continue
        if not os.path.isdir(os.path.join(args.models_dir, name)):
            # the reference ships two params_0.2_0.5_* training-LOG
            # files alongside its checkpoint directories: skip files
            continue
        sup, gate_type, gate_subtype = parsed
        param_dir = os.path.join(args.models_dir, name)
        try:
            mu = mu_for(args.models_dir, sup, gate_type, gate_subtype)
            acc = evaluate_checkpoint(param_dir, mu, data_cfg,
                                      args.batch_size, args.model_id,
                                      loaders=loaders, device=device)
            results[name] = {'test_accuracy': float(acc), 'sup': sup,
                             'gate': f'{gate_type}/{gate_subtype}'}
            print(f'{name:40s} acc={acc:.3f}')
        except Exception as e:     # keep sweeping; report the failure
            results[name] = {'error': f'{type(e).__name__}: {e}'}
            print(f'{name:40s} ERROR {e}')
    if args.out_json:
        with open(args.out_json, 'w') as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == '__main__':
    main()
