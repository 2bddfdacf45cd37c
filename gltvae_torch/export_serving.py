"""Export a trained model as a self-contained ``torch.export`` serving
artifact (counterpart of tools/export_serving.py).

    python -m gltvae_torch.export_serving --checkpoint runs/torch/params_1.0_learnable \\
        --output model.pt2 [--with-reconstruct] [--device cuda|cpu]

``--checkpoint`` is a port run folder or a reference-format .h5 folder
(``--mu`` for a fixed-gate one), as ``python -m gltvae_torch.infer`` reads
them. The artifact (``utils/serving``) maps uint8 [b, S, S, 3] to the
deterministic attribute probabilities, weights baked in, for any b; it
carries its weights on ``--device``, where it will serve. Before writing,
the artifact is loaded back and checked against the live model on seeded
random pixels (max abs 1e-5, else the command exits non-zero).
``--with-reconstruct`` also writes ``<output>.recon``, the posterior-mean
reconstruction program.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

#: the round-trip check's limit, max abs against the live model
TOL = 1e-5


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('--checkpoint', required=True,
                   help='run folder of the port or a reference-format '
                        'folder of *_best.h5 files')
    p.add_argument('--model-id', default='best', choices=['best', 'last'])
    p.add_argument('--output', required=True,
                   help='artifact path (e.g. model.pt2); with '
                        '--with-reconstruct also <output>.recon')
    p.add_argument('--with-reconstruct', action='store_true',
                   help='also export the reconstruction program')
    p.add_argument('--image-size', type=int, default=None, choices=[64, 128])
    p.add_argument('--gate-type', default=None,
                   choices=['learnable', 'fixed'])
    p.add_argument('--gate-subtype', default=None,
                   choices=['one-one', 'inferred'])
    p.add_argument('--z-dim', type=int, default=None)
    p.add_argument('--mu', default=None,
                   help='gating-matrix .npy for fixed-gate .h5 folders')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu': where the artifact's "
                        'weights live')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from gltvae_torch import infer, resolve_device
    from gltvae_torch.utils import serving
    device = resolve_device(args.device)
    cfg = infer.resolve_model_config(args)
    model = infer.load_model(args, cfg, device)

    blob = serving.export_predict(model)
    s = cfg.image_size
    u8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (4, s, s, 3), dtype=np.uint8)).to(device)
    got = serving.load_serving(blob)(u8)
    want = infer.make_predict(model, stochastic=False, temp=1.0)(u8)
    diff = float((got - want).abs().max())
    if not diff <= TOL:
        raise SystemExit(f'round-trip verification FAILED (max abs diff '
                         f'{diff:.3e} > {TOL})')
    with open(args.output, 'wb') as f:
        f.write(blob)
    print(f'predict artifact: {args.output} ({len(blob)} bytes, weights on '
          f'{device}, verified max diff {diff:.2e})')

    if args.with_reconstruct:
        rblob = serving.export_reconstruct(model)
        rec = serving.load_serving(rblob)(u8)
        if tuple(rec.shape) != tuple(u8.shape):
            raise SystemExit(f'reconstruct artifact gave {tuple(rec.shape)} '
                             f'for {tuple(u8.shape)}')
        rpath = args.output + '.recon'
        with open(rpath, 'wb') as f:
            f.write(rblob)
        print(f'reconstruct artifact: {rpath} ({len(rblob)} bytes)')
    return args.output


if __name__ == '__main__':
    main()
