"""Command-line entry point of the port (counterpart of train.py).

    python -m gltvae_torch.cli --synthetic --do-train --epochs 2 --sup 0.5 \\
        -bs 256 --output-dir runs/torch [--device cuda|cpu] \\
        [--augment-pad 4] [--steps-per-dispatch 4]

Runs on ``cuda`` unless ``--device cpu`` is given. Per supervision fraction
it builds the configs, the loaders and the gating init, trains and/or tests
a Trainer, and writes ``model_config.json``, ``metrics.csv``, checkpoints,
the μ export and ``result.json`` under ``<output-dir>/<run name>``. It takes
the subset of train.py's flags that the port supports; CelebA files wait
for the data layer (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

logger = logging.getLogger('gltvae_torch.cli')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('-n', '--epochs', type=int, default=75)
    p.add_argument('--z-dim', type=int, default=45)
    p.add_argument('-lr', '--lr', type=float, default=1e-4)
    p.add_argument('-bs', '--batch-size', type=int, default=256)
    p.add_argument('--l1-reg', type=float, default=0.2)
    p.add_argument('--gate-type', default='learnable',
                   choices=['learnable', 'fixed'])
    p.add_argument('--gate-subtype', default='inferred',
                   choices=['one-one', 'inferred'])
    p.add_argument('--sup', type=float, nargs='*', default=[1.0, 0.5, 0.2],
                   help='supervision fractions to sweep')
    p.add_argument('--do-train', action='store_true', default=False)
    p.add_argument('--do-test', action='store_true', default=True)
    p.add_argument('--no-test', dest='do_test', action='store_false')
    p.add_argument('--image-size', type=int, default=64, choices=[64, 128])
    p.add_argument('--synthetic', action='store_true',
                   help='use the synthetic fixture (required for now)')
    p.add_argument('--synthetic-n', type=int, default=512,
                   help='synthetic train-set size')
    p.add_argument('--synthetic-signal', action='store_true',
                   help='image-correlated synthetic labels (learnable)')
    p.add_argument('--compute-dtype', default='float32',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--posterior-locs', default='relu',
                   choices=['relu', 'linear'])
    p.add_argument('--deterministic-eval', action='store_true')
    p.add_argument('--resume', action='store_true',
                   help='resume from the latest checkpoint if one exists')
    p.add_argument('--augment-pad', type=int, default=0, metavar='P',
                   help='train-time augmentation: train images are made at '
                        'S+2P and the augment kernel crops them back to S '
                        'on the device (random offset, random horizontal '
                        'flip, x/255 as a multiply). 0 = off (reference '
                        'semantics)')
    p.add_argument('--steps-per-dispatch', type=int, default=1,
                   help='train steps per dispatch: one host->device copy '
                        'and one augment launch per chunk of N steps; '
                        'results equal per-step dispatch bit for bit')
    p.add_argument('--parity', action='store_true',
                   help='shuffle once at init (the reference loader) '
                        'instead of every epoch')
    p.add_argument('--output-dir', default='./models')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_configs(args, sup):
    from gltvae_torch.config import ModelConfig, TrainConfig, celeba128
    if args.image_size == 128:
        model_cfg, _ = celeba128(gate_type=args.gate_type, sup=sup,
                                 gate_subtype=args.gate_subtype)
        model_cfg = dataclasses.replace(
            model_cfg, compute_dtype=args.compute_dtype,
            posterior_locs=args.posterior_locs)
    else:
        model_cfg = ModelConfig(z_dim=args.z_dim, gate_type=args.gate_type,
                                gate_subtype=args.gate_subtype,
                                compute_dtype=args.compute_dtype,
                                posterior_locs=args.posterior_locs)
    train_cfg = TrainConfig(n_epochs=args.epochs, batch_size=args.batch_size,
                            lr=args.lr, perc_supervision=sup,
                            gating_reg=args.l1_reg, seed=args.seed,
                            deterministic_eval=args.deterministic_eval,
                            augment_pad=args.augment_pad)
    return model_cfg, train_cfg


def make_loaders(args, model_cfg, train_cfg):
    if not args.synthetic:
        raise NotImplementedError(
            'CelebA files: ROADMAP Queue 1 item 8 (standalone data layer); '
            'pass --synthetic')
    from gltvae_torch.data.pipeline import BatchLoader
    from gltvae_torch.data.synthetic import synthetic_splits
    from gltvae_torch.ops.gating import gating_matrix_from_labels
    splits = synthetic_splits(
        n_train=args.synthetic_n, n_valid=max(64, args.synthetic_n // 8),
        n_test=max(64, args.synthetic_n // 8),
        sup_frac=train_cfg.perc_supervision,
        image_size=model_cfg.image_size, y_dim=model_cfg.y_dim,
        seed=args.seed, learnable_signal=args.synthetic_signal,
        train_pad=train_cfg.augment_pad)
    loaders = {k: BatchLoader(v, train_cfg.batch_size, seed=args.seed,
                              reshuffle_each_epoch=not args.parity)
               for k, v in splits.items()}
    sup_lbl = splits['sup'].labels if 'sup' in splits else None
    mu = gating_matrix_from_labels(sup_lbl, splits['valid'].labels,
                                   model_cfg.y_dim, train_cfg.perc_supervision)
    return loaders, mu


def run(args, sup: float):
    from gltvae_torch.config import load_model_config, save_model_config
    from gltvae_torch.train.loop import Trainer
    logger.info('----- supervision %.1f -----', sup)
    model_cfg, train_cfg = build_configs(args, sup)
    if args.gate_type == 'learnable':
        run_name = f'params_{sup}_{args.gate_type}'
    else:
        run_name = f'params_{sup}_{args.gate_type}_{args.gate_subtype}'
    param_dir = os.path.join(args.output_dir, run_name)

    # a test-only rerun adopts the architecture the training run recorded
    recorded = load_model_config(param_dir)
    if not args.do_train and recorded is not None and recorded != model_cfg:
        logger.info('test-only rerun: using the recorded architecture '
                    'from %s/model_config.json', param_dir)
        model_cfg = recorded

    loaders, mu_init = make_loaders(args, model_cfg, train_cfg)
    trainer = Trainer(model_cfg, train_cfg, mu_init=mu_init,
                      checkpoint_dir=os.path.join(param_dir, 'checkpoints'),
                      metrics_path=os.path.join(param_dir, 'metrics.csv'),
                      steps_per_dispatch=args.steps_per_dispatch,
                      device=args.device)
    os.makedirs(param_dir, exist_ok=True)
    if args.do_train or recorded is None:
        save_model_config(model_cfg, param_dir)

    result = None
    if args.do_train:
        result = trainer.train(loaders, param_dir=param_dir,
                               resume=args.resume)
        logger.info('train done: best val acc %.3f, %.0f img/s',
                    result['best_val_accuracy'], result['images_per_sec'])
    acc = None
    if args.do_test:
        try:
            trainer.restore()      # the best checkpoint
        except FileNotFoundError:
            logger.warning('no checkpoint to restore; testing fresh init')
        acc = trainer.test(loaders['test'])
        logger.info('Test Accuracy (best model): %.3f', acc)
    if result is not None or acc is not None:
        payload = {'test_accuracy': acc, 'device': str(trainer.device)}
        if result is not None:
            payload.update(result)
        with open(os.path.join(param_dir, 'result.json'), 'w') as f:
            json.dump(payload, f, indent=2, default=float)
    return acc


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format='%(asctime)s %(levelname)s '
                        '%(name)s %(message)s')
    args = parse_args(argv)
    results = {sup: run(args, sup) for sup in args.sup}
    logger.info('sweep results: %s', results)
    return results


if __name__ == '__main__':
    main()
