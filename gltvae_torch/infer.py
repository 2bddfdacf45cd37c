"""Batch attribute inference: a folder of photos in, per-attribute
predictions out (counterpart of tools/infer.py).

    python -m gltvae_torch.infer --checkpoint runs/torch/params_0.5_learnable \\
        --images photos/ --output preds.csv [--model-id best|last] \\
        [--batch-size 256] [--stochastic --temp 0.3] [--device cuda|cpu]
    python -m gltvae_torch.infer --checkpoint <reference .h5 folder> \\
        --images photos/ [--mu gating_matrix.npy]

``--checkpoint`` is a run folder of the port's CLI (``checkpoints/`` and
``model_config.json``) or a reference-format folder of ``*_<model-id>.h5``
files (``utils/h5_import``; ``--mu`` gives μ where it has no
``learned_gating_matrix`` .npy, as a fixed-gate folder has not). Without
``model_config.json`` the model comes from the
``--image-size``/``--gate-type``/``--gate-subtype``/``--z-dim`` flags. The
folder's jpg/jpeg/png files, sorted by name, are decoded as training
decodes them (a direct resize at 64 px, a center crop at 128 px) on
``--num-workers`` threads, and each batch goes through the dequant kernel's
divide form on the device and the model's ``predict_probs``: posterior
mean and expected gates by default, sampled z and gates at ``--temp`` with
``--stochastic``. The CSV has ``image_id``, one 0/1 column per attribute
(1 iff p > 0.5) and one ``p_<attribute>`` column (``%.4f``). On a CUDA
device the forward is one CUDA graph a batch (``make_predict``), on an
NCCL mesh of any size with its gather inside (``steps.resolve_jit``).

``--mesh`` labels data-parallel over the ranks of a process group (run
under ``torchrun --nproc-per-node=N``; one process is a mesh of one):
``--batch-size`` is the global batch and must be a multiple of the world
size; each rank decodes its rows of each batch, runs them through the
dequant kernel and ``predict_probs`` (the global batch's draws, its rows,
with ``--stochastic``), the probabilities are gathered in rank order and
rank 0 writes the CSV. It is the one-process CSV at ``--batch-size``
wherever a row's arithmetic does not depend on the rows labelled with it
(the CPU; ``parallel/dp.py``); on a card, the deterministic labels equal
one process's at ``--batch-size`` / world, the rows a card labels at
once.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import os
import time
from typing import Optional

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('--checkpoint', required=True,
                   help='run folder of the port (checkpoints/, '
                        'model_config.json) or a reference-format folder '
                        'of *_best.h5 files')
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
    p.add_argument('--mu', default=None,
                   help='gating-matrix .npy for .h5 folders that store no '
                        'learned_gating_matrix (fixed gate schemes)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--mesh', action='store_true',
                   help='data-parallel inference over the ranks of a '
                        'process group (torchrun); --batch-size must be a '
                        'multiple of the world size')
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
    """The CCVAE of `cfg` on `device` with the best (or last) parameters
    of a port run folder or of a reference-format .h5 folder."""
    from gltvae_torch.config import apply_precision
    from gltvae_torch.models.ccvae import CCVAE
    from gltvae_torch.train.checkpoint import CheckpointManager
    apply_precision(cfg)        # TF32 off, as in training
    ckpt_dir = os.path.join(args.checkpoint, 'checkpoints')
    if os.path.isdir(ckpt_dir):
        mgr = CheckpointManager(ckpt_dir)
        step = mgr.latest_step() if args.model_id == 'last' else None
        params = mgr.load(step)['params']
    elif glob.glob(os.path.join(args.checkpoint, f'*_{args.model_id}.h5')):
        from gltvae_torch.utils.h5_import import load_reference_checkpoint
        mu = np.load(args.mu) if getattr(args, 'mu', None) else None
        params = load_reference_checkpoint(args.checkpoint, args.model_id,
                                           mu=mu)
    else:
        raise SystemExit(f'{args.checkpoint} has no checkpoints/ folder '
                         f'and no *_{args.model_id}.h5 files')
    model = CCVAE(cfg, mu_init=np.eye(cfg.z_classify, cfg.y_dim,
                                      dtype=np.float32))
    model.load_state_dict(params)
    return model.to(device).eval()


def make_predict(model, stochastic: bool, temp: float, dp=None,
                 jit: Optional[bool] = None):
    """predict(x_u8, generator=None, noise=None) -> probabilities [B, y]:
    the dequant kernel's divide form, then ``predict_probs`` (the shared
    eval protocol). The stochastic draws come from `generator`, or from
    `noise` (eps_z with the gate Gumbels g1, g2 or their uniforms u1, u2)
    when given. With `dp` (a ``parallel.dp.
    DataParallel``), x_u8 is this rank's rows of a global batch, the draws
    are the global batch's (`noise` too) of which the rank keeps its rows,
    and the probabilities of the global batch come back, gathered over the
    ranks in rank order.

    Captured by ``train/steps.py``'s rule (``resolve_jit``; tools/infer.py
    jits its forward on one device and on the mesh): the forward, with the
    gather on a mesh, is a CUDA graph over a static uint8 batch, one a
    batch shape (the wrap-around tail batch keeps the one shape) and noise
    form (``graphs.noise_form``): the host part draws z's normals and the
    gate uniforms into its static buffers and the graph makes the Gumbels,
    while given or injected Gumbels have a graph of their own. On the CPU
    the same static-buffer path runs eagerly. ``jit=False`` gives the
    eager forward. On a mesh, leaving the group (``parallel.mesh.
    shutdown``) releases the graphs of a `predict` still held, which then
    raises."""
    from gltvae_torch.models.ccvae import Temps
    from gltvae_torch.ops.preprocess import dequant
    from gltvae_torch.train.graphs import CapturedPass, graph_pool, noise_form
    from gltvae_torch.train import steps
    world = 1 if dp is None else dp.mesh.world
    temps = Temps(gating=temp)

    def forward(x_u8, noise, generator=None):
        """The device part: `noise` the global batch's draws (the gate
        uniforms made Gumbels here), or None."""
        x = dequant(x_u8, 'div')
        noise = steps.gate_gumbels(noise)
        if noise is not None and dp is not None:
            noise = dp.rows_of(noise)
        probs = model.predict_probs(x, temps, deterministic=not stochastic,
                                    noise=noise, generator=generator)
        return probs if dp is None else dp.mesh.all_gather(probs)

    if not steps.resolve_jit(jit, dp):
        @torch.no_grad()
        def predict(x_u8, generator=None, noise=None):
            if stochastic and noise is None and dp is not None:
                noise = steps.draw_eval_noise(model, len(x_u8) * world,
                                              generator)
            return forward(x_u8, noise, generator)
        return predict

    device = model.mu.device
    pool = graph_pool(device)
    draws = steps.PassDraws()
    passes = {}

    def predict(x_u8, generator=None, noise=None):
        form = None if not stochastic else (
            draws.form if noise is None else noise_form(noise))
        key = (tuple(x_u8.shape), x_u8.dtype, form)
        p = passes.get(key)
        if p is None:
            p = passes[key] = CapturedPass(
                lambda model, x, y, t, noise: forward(x, noise), 1,
                ((1,) + key[0], key[1]), None, device, pool,
                stochastic=stochastic, dp=dp)
        p.check(model)
        p.load(x_u8[None], None)
        if stochastic:
            if noise is None:
                noise = draws(model, p.batch, generator, out=p.noise.out(0))
            p.noise.fill(0, noise)
        return p(model)['value'][0]
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
    import torch.distributed as dist
    owned = not dist.is_initialized()      # a group this run joins, it ends
    try:
        return label(args)
    finally:
        if owned:
            from gltvae_torch.parallel.mesh import shutdown
            shutdown()


def label(args):
    """Label ``args.images`` into ``args.output`` (``main``'s work, in the
    group ``--mesh`` joins)."""
    from gltvae_torch import resolve_device
    from gltvae_torch.data.celeba import ImageFolderDataset, _SplitData
    from gltvae_torch.data.pipeline import BatchLoader
    from gltvae_torch.train.state import step_seed
    mesh = dp = None
    if args.mesh:
        from gltvae_torch.parallel.dp import DataParallel
        from gltvae_torch.parallel.mesh import create_mesh
        mesh = create_mesh(args.device)
        if args.batch_size % mesh.world:
            raise SystemExit(f'--batch-size {args.batch_size} must be a '
                             f'multiple of the {mesh.world}-device mesh')
        dp = DataParallel(mesh)
        device = mesh.device
        print(f'mesh inference over {mesh.world} devices')
    else:
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
    # on a mesh each rank decodes only its rows of each batch
    shard = (mesh.rank, mesh.world) if mesh is not None and mesh.world > 1 \
        else None
    loader = BatchLoader(ds, args.batch_size, shuffle=False,
                         num_workers=args.num_workers, shard=shard)
    predict = make_predict(model, args.stochastic, args.temp, dp)
    labels = attribute_names(cfg.y_dim)
    writes = mesh is None or mesh.is_main
    t0 = time.perf_counter()
    it = iter(loader)
    try:
        with open(args.output if writes else os.devnull, 'w',
                  newline='') as f:
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
    if mesh is not None:
        mesh.barrier()      # no rank leaves before rank 0's CSV is written
    wall = time.perf_counter() - t0
    print(f'{len(names)} images -> {args.output} ({len(names) / wall:.1f} '
          f'img/s on {device}, decode included)')
    return args.output


if __name__ == '__main__':
    main()
