"""Command-line entry point of the port (counterpart of train.py).

    python -m gltvae_torch.cli --data-dir /data/celeba \\
        --split-file list_eval_partition.csv --do-train --epochs 2 \\
        --sup 0.5 -bs 256 --output-dir runs/torch [--device cuda|cpu] \\
        [--decode-backend auto|cv2|pil|native] [--num-workers 8] \\
        [--cache-decoded | --cache-dir DIR] [--augment-pad 4] \\
        [--steps-per-dispatch 4] [--image-size 128 --compute-dtype \\
         bfloat16 --input-s2d on --output-s2d on --remat dots] \\
        [--resident-train off] [--tensorboard DIR] [--debug-nans] \
        [--trace-out run.trace.json]
    python -m gltvae_torch.cli --synthetic --do-train ...   # no files
    torchrun --nproc-per-node=N -m gltvae_torch.cli --mesh ...  # DP
    python -m gltvae_torch.cli --dist-coordinator HOST:PORT \
        --dist-num-processes N --dist-process-id I ...     # one per rank

Runs on ``cuda`` unless ``--device cpu`` is given. Per supervision fraction
it builds the configs, the loaders and the gating init (from the CelebA
folder under ``--data-dir``: ``img_align_celeba/``, ``list_attr_celeba.csv``
and, with ``--split-file``, the partition file; or the synthetic fixture),
trains and/or tests a Trainer, and writes ``model_config.json``,
``metrics.csv``, checkpoints, the μ export and ``result.json`` under
``<output-dir>/<run name>``, and with ``--tensorboard DIR`` scalar events
under ``DIR/<run name>``. ``--init-from-h5 DIR`` starts from a
reference-format .h5 checkpoint folder; without ``--do-train`` it tests
those weights. ``--debug-nans`` raises FloatingPointError naming the first
op that made a NaN.

``--mesh`` trains data-parallel over the ranks of a process group, one
rank per device (``parallel/``; NCCL on CUDA, gloo with ``--device
cpu``): started by ``torchrun``, or once per rank with the three
``--dist-*`` flags (all or none); either makes a run with more than one
process a mesh run. The global batch is ``-bs``; each rank's loaders are
host-sharded and decode only its rows; rank 0 writes the run's files.
On an NCCL mesh of any size every dispatch is a CUDA graph with its
collectives inside, as on one device (``train/graphs.py``,
``train/steps.py::resolve_jit``); the run leaves its group through
``parallel.mesh.shutdown``, which releases those graphs first.

``--trace-out PATH`` records the host loop's spans and counters for the
whole run (``gltvae_torch.trace``) and writes them, when the run ends, as
a Chrome trace that Perfetto opens: PATH on one device, PATH.rank<k> for
rank k of a mesh of more than one rank.

It takes train.py's flags but ``--prng`` and the compilation-cache flags;
``--device`` stands for ``--platform``.
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
    p.add_argument('--init-from-h5', default=None, metavar='DIR',
                   help='warm-start from a reference-format .h5 checkpoint '
                        'folder (utils/h5_import); where it has no '
                        'learned_gating_matrix .npy, mu is the identity '
                        'for fixed one-one gating, else the computed init')
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
                        "on first use), 'auto' = cv2 with PIL fallback, "
                        "'grain' = cv2 decode through the grain-ordered "
                        'loader (data/grain_loader.py)')
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
    p.add_argument('--tensorboard', default=None, metavar='DIR',
                   help='also write TensorBoard scalar events under '
                        'DIR/<run_name> (CSV metrics are always written)')
    p.add_argument('--debug-nans', action='store_true',
                   help='check every train and eval dispatch for NaN and '
                        'raise FloatingPointError naming the first op that '
                        "made one (jax_debug_nans' counterpart)")
    p.add_argument('--mesh', action='store_true',
                   help='data-parallel over the ranks of a process group '
                        '(torchrun or the --dist-* flags; one rank per '
                        'device); -bs is the global batch')
    p.add_argument('--dist-coordinator', default=None, metavar='HOST:PORT',
                   help='multi-process coordinator address (process 0 '
                        'serves it; or a tcp:// or file:// URL); needs '
                        '--dist-num-processes and --dist-process-id')
    p.add_argument('--dist-num-processes', type=int, default=None)
    p.add_argument('--dist-process-id', type=int, default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; the rank's card on a mesh) or "
                        "'cpu'")
    p.add_argument('--trace-out', default=None, metavar='PATH',
                   help="record the host loop's spans and counters and "
                        'write them as a Chrome trace: PATH on one device, '
                        'PATH.rank<k> on a mesh')
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


def make_loaders(args, model_cfg, train_cfg, shard=None):
    """(loaders by split, μ init): CelebA files through CelebAReader, or the
    synthetic fixture. `shard` (rank, world) host-shards every loader: it
    yields only this rank's rows of each global batch."""
    if not args.synthetic:
        from gltvae_torch.data.celeba import CelebAReader
        reader = CelebAReader(build_data_config(args, model_cfg),
                              train_cfg.perc_supervision,
                              train_cfg.batch_size, seed=args.seed,
                              reshuffle_each_epoch=not args.parity,
                              shard=shard)
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
                              reshuffle_each_epoch=not args.parity,
                              shard=shard)
               for k, v in splits.items()}
    sup_lbl = splits['sup'].labels if 'sup' in splits else None
    mu = gating_matrix_from_labels(sup_lbl, splits['valid'].labels,
                                   model_cfg.y_dim, train_cfg.perc_supervision)
    return loaders, mu


def run(args, sup: float, mesh=None):
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

    # host-sharded input on a mesh of more than one rank (train.py's rule)
    shard = (mesh.rank, mesh.world) if mesh is not None and mesh.world > 1 \
        else None
    loaders, mu_init = make_loaders(args, model_cfg, train_cfg, shard)
    main_rank = mesh is None or mesh.is_main
    trainer = Trainer(model_cfg, train_cfg, mu_init=mu_init,
                      checkpoint_dir=os.path.join(param_dir, 'checkpoints'),
                      metrics_path=os.path.join(param_dir, 'metrics.csv'),
                      tensorboard_dir=(os.path.join(args.tensorboard,
                                                    run_name)
                                       if args.tensorboard else None),
                      steps_per_dispatch=args.steps_per_dispatch,
                      device=args.device if mesh is None else None,
                      mesh=mesh, local_batches=shard is not None,
                      resident_eval=args.resident_eval,
                      resident_train=args.resident_train,
                      debug_nans=args.debug_nans)
    os.makedirs(param_dir, exist_ok=True)
    if (args.do_train or recorded is None) and main_rank:
        save_model_config(model_cfg, param_dir)

    if args.init_from_h5:
        from gltvae_torch.utils.h5_import import load_reference_checkpoint
        # a fixed-gate .h5 folder carries no μ .npy; the fallback follows
        # the gate scheme (one-one is the identity, not the co-occurrence
        # init)
        if model_cfg.gate_type == 'fixed' and \
                model_cfg.gate_subtype == 'one-one':
            from gltvae_torch.ops.gating import identity_gating_matrix
            fallback_mu = identity_gating_matrix(model_cfg.z_classify,
                                                 model_cfg.y_dim)
        else:
            fallback_mu = mu_init
        trainer.load_params(load_reference_checkpoint(args.init_from_h5,
                                                      mu=fallback_mu))
        logger.info('warm-started from %s', args.init_from_h5)

    result = None
    if args.do_train:
        result = trainer.train(loaders, param_dir=param_dir,
                               resume=args.resume)
        logger.info('train done: best val acc %.3f, %.0f img/s',
                    result['best_val_accuracy'], result['images_per_sec'])
    acc = None
    if args.do_test:
        if args.init_from_h5 and not args.do_train:
            # the user asked for exactly these weights: a checkpoint left
            # in param_dir by an earlier run must not replace them
            logger.info('testing the --init-from-h5 weights directly')
        else:
            try:
                trainer.restore()      # the best checkpoint
            except FileNotFoundError:
                logger.warning('no checkpoint to restore; testing fresh '
                               'init')
        acc = trainer.test(loaders['test'])
        logger.info('Test Accuracy (best model): %.3f', acc)
    if main_rank:
        _write_result_json(param_dir, result, acc, str(trainer.device))
    if mesh is not None:
        mesh.barrier()      # no rank leaves before rank 0's files are written
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


def make_mesh(args):
    """The run's mesh, or None: joins the ``--dist-*`` group (all three
    flags or none, as train.py) or torchrun's; a run of more than one
    process is a mesh run."""
    dist_flags = (args.dist_coordinator, args.dist_num_processes,
                  args.dist_process_id)
    if any(f is not None for f in dist_flags) and \
            any(f is None for f in dist_flags):
        raise SystemExit(
            'multi-host runs need all three of --dist-coordinator, '
            '--dist-num-processes, --dist-process-id '
            f'(got {dist_flags}); a partial set would silently run '
            'single-host or crash inside torch.distributed')
    import torch.distributed as dist
    from gltvae_torch.parallel import mesh as pmesh
    if args.dist_num_processes and args.dist_num_processes > 1:
        pmesh.initialize_multihost(args.dist_coordinator,
                                   args.dist_num_processes,
                                   args.dist_process_id, device=args.device)
    if not (args.mesh or dist.is_initialized()
            or int(os.environ.get('WORLD_SIZE', '1')) > 1):
        return None
    mesh = pmesh.create_mesh(args.device)
    logger.info('mesh: rank %d of %d on %s (%s)', mesh.rank, mesh.world,
                mesh.device, mesh.backend or 'no group')
    return mesh


def _write_trace(path: str, mesh) -> None:
    """The run's spans and counters as a Chrome trace at `path`, or at
    `path`.rank<k> for rank k of a mesh of more than one rank."""
    from gltvae_torch import trace
    rank = 0 if mesh is None else mesh.rank
    if mesh is not None and mesh.world > 1:
        path = f'{path}.rank{rank}'
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    trace.write(path, rank)
    logger.info('trace: %d spans (%d dropped) -> %s', len(trace.records()),
                trace.dropped(), path)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format='%(asctime)s %(levelname)s '
                        '%(name)s %(message)s')
    args = parse_args(argv)
    import torch.distributed as dist

    from gltvae_torch import trace
    owned = not dist.is_initialized()      # a group this run joins, it ends
    was = trace.mode()
    mesh = None
    try:
        mesh = make_mesh(args)
        if args.trace_out:
            trace.reset()
            trace.set_mode('on')
        results = {sup: run(args, sup, mesh) for sup in args.sup}
    finally:
        if args.trace_out and trace.mode() == 'on':
            trace.set_mode(was)
            _write_trace(args.trace_out, mesh)
        if owned:
            from gltvae_torch.parallel.mesh import shutdown
            shutdown()
    logger.info('sweep results: %s', results)
    return results


if __name__ == '__main__':
    main()
