"""Batch attribute inference: a folder of photos in, per-attribute
predictions out (counterpart of tools/infer.py).

    python -m gltvae_torch.infer --checkpoint runs/torch/params_0.5_learnable \\
        --images photos/ --output preds.csv [--model-id best|last] \\
        [--batch-size 256] [--stochastic --temp 0.3] [--device cuda|cpu]

``--checkpoint`` is a run folder of the port's CLI: ``checkpoints/`` and
``model_config.json`` (without the latter the model comes from the
``--image-size``/``--gate-type``/``--gate-subtype``/``--z-dim`` flags). The
folder's jpg/jpeg/png files, sorted by name, are decoded as training
decodes them (a direct resize at 64 px, a center crop at 128 px) on
``--num-workers`` threads, and each batch goes through the dequant kernel's
divide form on the device and the model's ``predict_probs``: posterior
mean and expected gates by default, sampled z and gates at ``--temp`` with
``--stochastic``. The CSV has ``image_id``, one 0/1 column per attribute
(1 iff p > 0.5) and one ``p_<attribute>`` column (``%.4f``).

Not ported: ``--mesh`` (ROADMAP Queue 1 item 12) and reference-format .h5
checkpoints with ``--mu`` (item 11).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('--checkpoint', required=True,
                   help='run folder of the port (checkpoints/, '
                        'model_config.json)')
    p.add_argument('--model-id', default='best', choices=['best', 'last'])
    p.add_argument('--images', required=True,
                   help='directory of JPEG/PNG images')
    p.add_argument('--output', default='predictions.csv')
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--image-size', type=int, default=None, choices=[64, 128],
                   help='default 64 (ignored when the run folder records '
                        'model_config.json)')
    p.add_argument('--gate-type', default=None,
                   choices=['learnable', 'fixed'])
    p.add_argument('--gate-subtype', default=None,
                   choices=['one-one', 'inferred'])
    p.add_argument('--z-dim', type=int, default=None)
    p.add_argument('--num-workers', type=int, default=4,
                   help='decode threads (overlap decode with inference)')
    p.add_argument('--stochastic', action='store_true',
                   help='sampled z and gates (the reference eval protocol); '
                        'default: posterior mean and expected gates')
    p.add_argument('--temp', type=float, default=0.3,
                   help='gating temperature for --stochastic')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--mesh', action='store_true',
                   help='not ported (ROADMAP Queue 1 item 12)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def resolve_model_config(args):
    """The run folder's model_config.json when present (the recorded
    architecture wins over any flag that disagrees, with a note), else the
    flags."""
    from gltvae_torch.config import ModelConfig, celeba128, load_model_config
    recorded = load_model_config(args.checkpoint)
    if recorded is not None:
        for flag, val in (('image-size', args.image_size),
                          ('gate-type', args.gate_type),
                          ('gate-subtype', args.gate_subtype),
                          ('z-dim', getattr(args, 'z_dim', None))):
            rec = getattr(recorded, flag.replace('-', '_'))
            if val is not None and rec != val:
                print(f'note: run dir records --{flag}={rec}; ignoring '
                      f'the conflicting CLI value {val}')
        return recorded
    cfg = celeba128()[0] if args.image_size == 128 else ModelConfig()
    overrides = {}
    if args.gate_type is not None:
        overrides['gate_type'] = args.gate_type
    if args.gate_subtype is not None:
        overrides['gate_subtype'] = args.gate_subtype
    if getattr(args, 'z_dim', None) is not None:
        overrides['z_dim'] = args.z_dim
    return dataclasses.replace(cfg, **overrides)


def load_model(args, cfg, device):
    """The CCVAE of `cfg` on `device` with the run folder's best (or last)
    checkpoint's parameters."""
    from gltvae_torch.config import apply_precision
    from gltvae_torch.models.ccvae import CCVAE
    from gltvae_torch.train.checkpoint import CheckpointManager
    apply_precision(cfg)        # TF32 off, as in training
    ckpt_dir = os.path.join(args.checkpoint, 'checkpoints')
    if not os.path.isdir(ckpt_dir):
        if glob.glob(os.path.join(args.checkpoint, '*.h5')):
            raise NotImplementedError(
                'reference-format .h5 checkpoints: ROADMAP Queue 1 item 11 '
                '(interchange); pass a run folder of gltvae_torch.cli')
        raise SystemExit(f'{args.checkpoint} has no checkpoints/ folder')
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step() if args.model_id == 'last' else None
    sd = mgr.load(step)
    model = CCVAE(cfg, mu_init=np.eye(cfg.z_classify, cfg.y_dim,
                                      dtype=np.float32))
    model.load_state_dict(sd['params'])
    return model.to(device).eval()


def make_predict(model, stochastic: bool, temp: float):
    """predict(x_u8, generator=None, noise=None) -> probabilities [B, y]:
    the dequant kernel's divide form, then ``predict_probs`` (the shared
    eval protocol). The stochastic draws come from `generator`, or from
    `noise` (eps_z, g1, g2) when given."""
    from gltvae_torch.models.ccvae import Temps
    from gltvae_torch.ops.preprocess import dequant

    @torch.no_grad()
    def predict(x_u8, generator=None, noise=None):
        x = dequant(x_u8, 'div')
        return model.predict_probs(x, Temps(gating=temp),
                                   deterministic=not stochastic,
                                   noise=noise, generator=generator)
    return predict


def attribute_names(y_dim: int):
    from gltvae_torch.config import CELEBA_EASY_LABELS, CELEBA_LABELS
    return (list(CELEBA_EASY_LABELS) if y_dim == 18
            else list(CELEBA_LABELS)[:y_dim])


def write_rows(writer, names, probs: np.ndarray) -> None:
    """One CSV row per image: hard labels (1 iff p > 0.5, as the eval's
    round-half-to-even) and the probabilities to 4 decimals (display only,
    so a printed 0.5000 may sit beside a hard 1)."""
    hard = (probs > 0.5).astype(int)
    p4 = np.round(probs, 4)
    for name, h, p in zip(names, hard, p4):
        writer.writerow([name] + h.tolist() + [f'{v:.4f}' for v in p])


def main(argv=None):
    args = parse_args(argv)
    from gltvae_torch import resolve_device
    from gltvae_torch.data.celeba import ImageFolderDataset, _SplitData
    from gltvae_torch.data.pipeline import BatchLoader
    from gltvae_torch.train.state import step_seed
    if args.mesh:
        raise NotImplementedError(
            '--mesh: ROADMAP Queue 1 item 12 (data parallelism)')
    device = resolve_device(args.device)
    cfg = resolve_model_config(args)
    model = load_model(args, cfg, device)

    names = sorted(f for f in os.listdir(args.images)
                   if f.lower().endswith(('.jpg', '.jpeg', '.png')))
    if not names:
        raise SystemExit(f'no images found in {args.images}')
    ds = ImageFolderDataset(args.images,
                            _SplitData(names, np.zeros((len(names), 1))),
                            cfg.image_size,
                            center_crop=(cfg.image_size == 128))
    # in name order; the wrap-around tail batch keeps one batch shape, its
    # extra rows are dropped
    loader = BatchLoader(ds, args.batch_size, shuffle=False,
                         num_workers=args.num_workers)
    predict = make_predict(model, args.stochastic, args.temp)
    labels = attribute_names(cfg.y_dim)
    t0 = time.perf_counter()
    it = iter(loader)
    try:
        with open(args.output, 'w', newline='') as f:
            w = csv.writer(f)
            w.writerow(['image_id'] + labels + [f'p_{n}' for n in labels])
            for b in range(loader.epoch_batches):
                x, _ = next(it)
                gen = None
                if args.stochastic:
                    gen = torch.Generator(device=device)
                    gen.manual_seed(step_seed(args.seed, b))
                probs = predict(torch.from_numpy(x).to(device), gen)
                lo = b * args.batch_size
                batch_names = names[lo:lo + args.batch_size]
                write_rows(w, batch_names,
                           probs.cpu().numpy()[:len(batch_names)])
    finally:
        it.close()
    wall = time.perf_counter() - t0
    print(f'{len(names)} images -> {args.output} ({len(names) / wall:.1f} '
          f'img/s on {device}, decode included)')
    return args.output


if __name__ == '__main__':
    main()
