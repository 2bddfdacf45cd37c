"""Export a run folder of the port to the reference's Keras .h5 format
(counterpart of tools/export_h5.py).

    python -m gltvae_torch.export_h5 --checkpoint runs/torch/params_1.0_learnable \\
        --out for_reference/ [--model-id best|last] [--device cuda|cpu]

Writes ``{encoder_model,decoder_model,classifier,cond_prior}_<id>.h5``
and ``learned_gating_matrix_<id>.npy`` + labeled ``.csv`` (``utils/
h5_export``), which the reference's ``Learner.load_model`` reads, and
which ``python -m gltvae_torch.infer``/``render``/``export_serving`` and
``cli --init-from-h5`` read back. The model comes from the run folder's
``model_config.json``, else from the flags.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('--checkpoint', required=True,
                   help='run folder of the port (checkpoints/, '
                        'model_config.json)')
    p.add_argument('--model-id', default='best', choices=['best', 'last'],
                   help="which checkpoint to export ('best' by val "
                        'accuracy)')
    p.add_argument('--out', default=None,
                   help='output folder (default: the run folder itself)')
    p.add_argument('--image-size', type=int, default=None, choices=[64, 128])
    p.add_argument('--gate-type', default=None,
                   choices=['learnable', 'fixed'])
    p.add_argument('--gate-subtype', default=None,
                   choices=['one-one', 'inferred'])
    p.add_argument('--z-dim', type=int, default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from gltvae_torch import infer, resolve_device
    from gltvae_torch.utils.h5_export import export_reference_checkpoint
    if not os.path.isdir(os.path.join(args.checkpoint, 'checkpoints')):
        raise SystemExit(f'{args.checkpoint} has no checkpoints/ folder: '
                         'this exports run folders of the port (reference '
                         '.h5 folders are already in the target format)')
    cfg = infer.resolve_model_config(args)
    model = infer.load_model(args, cfg, resolve_device(args.device))
    out = args.out or args.checkpoint
    export_reference_checkpoint(model, out, args.model_id,
                                label_names=infer.attribute_names(cfg.y_dim))
    print(f'exported {args.model_id} -> {out}')
    return out


if __name__ == '__main__':
    main()
