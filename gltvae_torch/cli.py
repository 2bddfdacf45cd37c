"""Command-line entry point of the port (counterpart of train.py).

    python -m gltvae_torch.cli --data-dir /data/celeba \\
        --split-file list_eval_partition.csv --do-train --epochs 2 \\
        --sup 0.5 -bs 256 --output-dir runs/torch [--device cuda|cpu] \\
        [--decode-backend auto|cv2|pil|native] [--num-workers 8] \\
        [--cache-decoded | --cache-dir DIR] [--augment-pad 4] \\
        [--steps-per-dispatch 4] [--image-size 128 --compute-dtype \\
         bfloat16 --input-s2d on --output-s2d on --remat dots] \\
        [--resident-train off]
    python -m gltvae_torch.cli --synthetic --do-train ...   # no files

Runs on ``cuda`` unless ``--device cpu`` is given. Per supervision fraction
it builds the configs, the loaders and the gating init (from the CelebA
folder under ``--data-dir``: ``img_align_celeba/``, ``list_attr_celeba.csv``
and, with ``--split-file``, the partition file; or the synthetic fixture),
trains and/or tests a Trainer, and writes ``model_config.json``,
``metrics.csv``, checkpoints, the μ export and ``result.json`` under
``<output-dir>/<run name>``. It takes the subset of train.py's flags that
the port supports (not yet: ``--tensorboard``, ``--mesh``,
``--init-from-h5``, the grain backend).
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
    p.add_argument('--data-dir', default='./data',
                   help='CelebA folder: img_align_celeba/, '
                        'list_attr_celeba.csv[, the --split-file]')
    p.add_argument('--synthetic', action='store_true',
                   help='use the synthetic fixture instead of CelebA')
    p.add_argument('--synthetic-n', type=int, default=512,
                   help='synthetic train-set size')
    p.add_argument('--synthetic-signal', action='store_true',
                   help='image-correlated synthetic labels (learnable)')
    p.add_argument('--compute-dtype', default='float32',
                   choices=['float32', 'bfloat16'],
                   help='bfloat16: convs and dense layers in bf16 with f32 '
                        'params, Adam, scale heads, classifier product and '
                        'losses')
    p.add_argument('--remat', default='none',
                   choices=['none', 'full', 'dots'],
                   help='recompute the loss forward in the backward pass '
                        "(torch.utils.checkpoint): 'full' keeps only its "
                        "inputs, 'dots' keeps the 2-d matmul outputs. Same "
                        'math')
    p.add_argument('--input-s2d', default='off', choices=['on', 'off'],
                   help="space-to-depth form of the encoder's first conv "
                        '(s2d(2) + 2x2/s1): same params, same math')
    p.add_argument('--output-s2d', default='off', choices=['on', 'off'],
                   help="space-to-depth form of the decoder's last "
                        'transposed conv; the recon loss compares in s2d '
                        'space: same params, same math')
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
    p.add_argument('--resident-eval', default='auto',
                   choices=['auto', 'off'],
                   help="'auto' copies a fitting val/test split to the "
                        'device once and gathers each eval batch there '
                        "(same values); 'off' ships every batch")
    p.add_argument('--resident-train', default='auto',
                   choices=['auto', 'off'],
                   help="'auto' copies fitting train splits to the device "
                        'once; each dispatch then sends only an index '
                        "tensor (same params); 'off' ships every batch. "
                        'Off with --augment-pad or over the budget')
    p.add_argument('--parity', action='store_true',
                   help='shuffle once at init (the reference loader) '
                        'instead of every epoch')
    p.add_argument('--num-workers', type=int, default=8,
                   help='decode threads per loader')
    p.add_argument('--decode-backend', default='auto',
                   choices=['auto', 'cv2', 'pil', 'native', 'grain'],
                   help="host decode: 'native' = the C++ libjpeg pool (built "
                        "on first use), 'auto' = cv2 with PIL fallback; "
                        "'grain' is not ported and raises")
    p.add_argument('--cache-decoded', action='store_true',
                   help='keep every decoded uint8 image in host RAM after '
                        'its first decode')
    p.add_argument('--cache-dir', default=None, metavar='DIR',
                   help='decoded uint8 rows on disk (np.memmap) under DIR, '
                        'served to later runs with no decode; the JAX '
                        "package's file names, so either package fills it "
                        'for the other')
    p.add_argument('--n-train', type=int, default=None,
                   help='train-split size (default: official 162770)')
    p.add_argument('--n-valid', type=int, default=None)
    p.add_argument('--n-test', type=int, default=None)
    p.add_argument('--split-file', default=None, metavar='CSV',
                   help='split by the partition file (e.g. '
                        'list_eval_partition.csv, relative to --data-dir; '
                        '0=train 1=valid 2=test) instead of prefix sizes')
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
            posterior_locs=args.posterior_locs,
            input_s2d=args.input_s2d == 'on',
            output_s2d=args.output_s2d == 'on')
    else:
        model_cfg = ModelConfig(z_dim=args.z_dim, gate_type=args.gate_type,
                                gate_subtype=args.gate_subtype,
                                compute_dtype=args.compute_dtype,
                                posterior_locs=args.posterior_locs,
                                input_s2d=args.input_s2d == 'on',
                                output_s2d=args.output_s2d == 'on')
    train_cfg = TrainConfig(n_epochs=args.epochs, batch_size=args.batch_size,
                            lr=args.lr, perc_supervision=sup,
                            gating_reg=args.l1_reg, seed=args.seed,
                            deterministic_eval=args.deterministic_eval,
                            augment_pad=args.augment_pad, remat=args.remat)
    return model_cfg, train_cfg


def build_data_config(args, model_cfg):
    """train.py's DataConfig for a model: easy labels at 64 px, a center
    crop at 128 px."""
    from gltvae_torch.config import DataConfig
    split_overrides = {k: v for k, v in
                       (('n_train', args.n_train), ('n_valid', args.n_valid),
                        ('n_test', args.n_test)) if v is not None}
    return DataConfig(data_dir=args.data_dir,
                      image_size=model_cfg.image_size,
                      use_easy_labels=(model_cfg.y_dim == 18),
                      center_crop=(model_cfg.image_size == 128),
                      num_workers=args.num_workers,
                      decode_backend=args.decode_backend,
                      augment_pad=args.augment_pad,
                      cache_decoded=args.cache_decoded,
                      cache_dir=args.cache_dir,
                      split_file=args.split_file,
                      **split_overrides)


def make_loaders(args, model_cfg, train_cfg):
    """(loaders by split, μ init): CelebA files through CelebAReader, or the
    synthetic fixture."""
    if not args.synthetic:
        from gltvae_torch.data.celeba import CelebAReader
        reader = CelebAReader(build_data_config(args, model_cfg),
                              train_cfg.perc_supervision,
                              train_cfg.batch_size, seed=args.seed,
                              reshuffle_each_epoch=not args.parity)
        return reader.setup_data_loaders(), reader.init_gating_prob
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
                      device=args.device,
                      resident_eval=args.resident_eval,
                      resident_train=args.resident_train)
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
    _write_result_json(param_dir, result, acc, str(trainer.device))
    return acc


def _write_result_json(param_dir, result, test_accuracy, device):
    """result.json: the training record and the test accuracy. A test-only
    rerun keeps the training run's record and refreshes the accuracy."""
    path = os.path.join(param_dir, 'result.json')
    if result is None and test_accuracy is None:
        return
    payload = {'test_accuracy': test_accuracy, 'device': device}
    if result is not None:
        payload.update(result)
    elif os.path.exists(path):
        try:
            with open(path) as f:
                prior = json.load(f)
        except (OSError, json.JSONDecodeError):
            prior = {}
        prior.update(payload)
        payload = prior
    with open(path, 'w') as f:
        json.dump(payload, f, indent=2, default=float)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format='%(asctime)s %(levelname)s '
                        '%(name)s %(message)s')
    args = parse_args(argv)
    results = {sup: run(args, sup) for sup in args.sup}
    logger.info('sweep results: %s', results)
    return results


if __name__ == '__main__':
    main()
